"""Pillow's 8-bit resampler in integer arithmetic on any device: the counterpart of every
``PIL.Image.resize`` the JAX package calls (the encoders' ``preprocess_frames``, the
letterbox and crop transforms of ``pipeline/transforms.py``), equal to it byte for byte,
without PIL (the card's machine has none).

Pillow's ``Resample.c`` (``ImagingResample`` over 8-bit bands), for each axis whose size
changes, the horizontal pass first into a uint8 image, then the vertical one:

- ``scale = in / out``, ``filterscale = max(scale, 1)``, ``support = filter_support *
  filterscale``, ``ksize = 2 * ceil(support) + 1`` taps an output;
- output ``xx``: ``center = (xx + 0.5) * scale``, ``xmin = max(int(center - support + 0.5),
  0)``, ``n = min(int(center + support + 0.5), in) - xmin`` taps, weights
  ``filter((x + xmin - center + 0.5) / filterscale)`` summed in order and normalised to 1;
  all of this in float64 on the host, in Pillow's order of operations;
- each weight as a fixed-point integer, ``trunc(w * 2**22 +- 0.5)`` with the sign of ``w``;
- an output is ``clip((2**21 + sum(pixel * weight)) >> 22, 0, 255)``.

The weighted sums run in int64 over gathers of the taps (``torch.matmul`` has no integer
CUDA path), so the bytes are the same on the CPU and on the card. BICUBIC is Pillow's Keys
cubic with ``a = -0.5`` (support 2), BILINEAR the triangle (support 1).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

BICUBIC = "bicubic"
BILINEAR = "bilinear"
_PRECISION_BITS = 32 - 8 - 2
_SUPPORT = {BICUBIC: 2.0, BILINEAR: 1.0}
_CHUNK_ELEMENTS = 1 << 25  # a pass's int64 accumulator holds at most this many (256 MiB)


def _filter(kind: str, x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    if kind == BILINEAR:
        return np.where(x < 1.0, 1.0 - x, 0.0)
    a = -0.5
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=64)
def coefficients(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's tap tables for one axis: (index [out, ksize] int64, each tap's input
    position clamped into the image; weight [out, ksize] int64, the fixed-point weights,
    0 past an output's taps). Read-only: the cache shares them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT[kind] * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's int(): truncation
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)[None, :]
    valid = taps < xmax[:, None]
    w = np.where(valid, _filter(kind, ((taps + xmin[:, None]) - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # summed in tap order, as Pillow sums
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    index = np.minimum(xmin[:, None] + taps, in_size - 1)
    index.flags.writeable = False
    fixed.flags.writeable = False
    return index, fixed


def _pass(x: torch.Tensor, dim: int, out_size: int, kind: str) -> torch.Tensor:
    """One axis of uint8 ``x`` resampled to ``out_size``: uint8 out."""
    index, weight = coefficients(x.shape[dim], out_size, kind)
    index = torch.tensor(index, device=x.device)
    weight = torch.tensor(weight, device=x.device)
    shape = [1] * x.ndim
    shape[dim] = out_size
    acc = torch.full((), 1 << (_PRECISION_BITS - 1), dtype=torch.int64, device=x.device)
    for k in range(index.shape[1]):
        tap = x.index_select(dim, index[:, k]).to(torch.int64)
        acc = acc + tap * weight[:, k].reshape(shape)
    return torch.clamp(acc >> _PRECISION_BITS, 0, 255).to(torch.uint8)


def resize(frames: torch.Tensor, size: Tuple[int, int], kind: str = BICUBIC) -> torch.Tensor:
    """``Image.resize((width, height), kind)`` of every frame: uint8 ``[..., H, W, C]`` ->
    ``[..., height, width, C]`` uint8, on the frames' device. An axis whose size is
    unchanged is not resampled (Pillow skips its pass)."""
    if frames.dtype != torch.uint8:
        raise TypeError(f"resize takes uint8 frames (Pillow's 8-bit path), not {frames.dtype}")
    if kind not in _SUPPORT:
        raise ValueError(f"resample filter {kind!r}: expected {BICUBIC!r} or {BILINEAR!r}")
    width, height = size
    if width < 1 or height < 1:
        raise ValueError(f"resize to {size}: both sides must be at least 1")
    if frames.ndim > 3:  # frame by frame in chunks, to bound the accumulators
        h, w, c = frames.shape[-3:]
        per_frame = max(h * width, height * width) * c
        n = max(1, _CHUNK_ELEMENTS // per_frame)
        flat = frames.reshape(-1, h, w, c)
        out = torch.cat([_resize_frames(chunk, width, height, kind)
                         for chunk in flat.split(n)])
        return out.reshape(*frames.shape[:-3], height, width, c)
    return _resize_frames(frames, width, height, kind)


def _resize_frames(x: torch.Tensor, width: int, height: int, kind: str) -> torch.Tensor:
    frames = x
    if width != x.shape[-2]:
        x = _pass(x, x.ndim - 2, width, kind)
    if height != x.shape[-3]:
        x = _pass(x, x.ndim - 3, height, kind)
    return x if x is not frames else frames.clone()
