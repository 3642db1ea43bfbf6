"""Nearest-exact 1-D resampling, torch ``F.interpolate(mode="nearest-exact")`` semantics,
and the video frame-resampling indices (``foley_tpu/ops/interp.py`` counterpart).
Nearest-exact index rule: out[i] = in[floor((i+0.5)*Lin/Lout)].

The resize's gradient sums each input position's outputs in index order, one add at a
time, on every device (``_NearestExact``): ``index_select``'s own backward adds them with
atomics on a card, in an order that changes from run to run, so a train step through the
denoiser's sync path would not repeat bit for bit there. On the CPU the sums are the ones
``index_add_`` makes.
"""

from __future__ import annotations

import numpy as np
import torch


def nearest_exact_indices(in_len: int, out_len: int) -> np.ndarray:
    """Host-side gather indices (fp32 arithmetic, as the JAX package computes them)."""
    idx = np.floor((np.arange(out_len, dtype=np.float32) + 0.5) * np.float32(in_len / out_len))
    return np.clip(idx.astype(np.int64), 0, in_len - 1)


def nearest_exact_resize(x: torch.Tensor, out_len: int, dim: int) -> torch.Tensor:
    """Resize ``x`` along ``dim`` to ``out_len`` with nearest-exact gathering (its gradient
    deterministic: the module docstring)."""
    if x.shape[dim] == out_len:
        return x
    return _NearestExact.apply(x, out_len, dim % x.ndim)


class _NearestExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_len: int, dim: int):
        idx = nearest_exact_indices(x.shape[dim], out_len)
        ctx.idx, ctx.in_len, ctx.dim = idx, x.shape[dim], dim
        return torch.index_select(x, dim, torch.from_numpy(idx).to(x.device))

    @staticmethod
    def backward(ctx, grad):
        """Each input position's gradient: the sum of its outputs' (a run of consecutive
        outputs: the indices never decrease), added in order from zero."""
        idx, dim = ctx.idx, ctx.dim
        counts = np.bincount(idx, minlength=ctx.in_len)
        starts = np.searchsorted(idx, np.arange(ctx.in_len))
        shape = [1] * grad.ndim
        shape[dim] = ctx.in_len
        out = grad.new_zeros(grad.shape[:dim] + (ctx.in_len,) + grad.shape[dim + 1:])
        for t in range(int(counts.max())):
            take = torch.from_numpy(np.minimum(starts + t, len(idx) - 1)).to(grad.device)
            valid = torch.from_numpy(t < counts).to(grad.device).view(shape)
            out = out + torch.where(valid, torch.index_select(grad, dim, take), 0)
        return out, None, None


def linspace_resample_indices(in_len: int, out_len: int) -> np.ndarray:
    """Frame-resampling indices of the JAX package's ``linspace_resample_indices``: the floor
    of ``jnp.linspace(0.0, in_len - 1, out_len)``, clipped to ``[0, in_len - 1]``.

    The reference resamples with ``torch.linspace(0, T-1, n).long()``; the port follows the
    JAX package, whose line is float32 arithmetic as XLA compiles it. ``jnp.linspace``
    writes ``start * (1 - s) + stop * s`` with ``s = iota / (n - 1)``; XLA turns the
    division by the constant into a product with ``float32(1 / (n - 1))`` and folds it
    with ``stop`` into one float32 slope, so point ``i < n - 1`` is
    ``float32(i) * float32(stop * float32(1 / (n - 1)))`` and the last point is ``stop``.
    That floors one frame early for about 5% of (in, out) pairs against ``torch.linspace``
    or a float64 ``np.linspace`` (for (250, 250), 248 of 250 indices), so neither may stand
    in for it."""
    if out_len == 1:
        return np.zeros((1,), np.int64)
    div = out_len - 1
    stop = np.float32(in_len - 1)
    slope = np.float32(stop * (np.float32(1.0) / np.float32(div)))
    line = np.append(np.arange(div, dtype=np.float32) * slope, stop)
    return np.clip(np.floor(line).astype(np.int64), 0, in_len - 1)
