"""Nearest-exact 1-D resampling, torch ``F.interpolate(mode="nearest-exact")`` semantics,
and the video frame-resampling indices (``foley_tpu/ops/interp.py`` counterpart).
Nearest-exact index rule: out[i] = in[floor((i+0.5)*Lin/Lout)].
"""

from __future__ import annotations

import numpy as np
import torch


def nearest_exact_indices(in_len: int, out_len: int) -> np.ndarray:
    """Host-side gather indices (fp32 arithmetic, as the JAX package computes them)."""
    idx = np.floor((np.arange(out_len, dtype=np.float32) + 0.5) * np.float32(in_len / out_len))
    return np.clip(idx.astype(np.int64), 0, in_len - 1)


def nearest_exact_resize(x: torch.Tensor, out_len: int, dim: int) -> torch.Tensor:
    """Resize ``x`` along ``dim`` to ``out_len`` with nearest-exact gathering."""
    in_len = x.shape[dim]
    if in_len == out_len:
        return x
    idx = torch.from_numpy(nearest_exact_indices(in_len, out_len)).to(x.device)
    return torch.index_select(x, dim, idx)


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
