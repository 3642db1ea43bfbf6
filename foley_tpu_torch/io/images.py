"""Host-side frame byte utilities shared by the vision encoders (``foley_tpu/io/images.py``
counterpart, copied bit for bit: both run in numpy on the host)."""

from __future__ import annotations

import numpy as np


def frames_to_u8(frames: np.ndarray) -> np.ndarray:
    """[0, 1] float -> uint8 (clip, *255, truncate), the PIL preprocessing route's
    quantization; uint8 input passes through. Shipping uint8 quarters the host->device
    bytes."""
    if frames.dtype == np.uint8:
        return frames
    return (np.clip(frames, 0.0, 1.0) * 255).astype(np.uint8)


def box_downsample_u8(frames: np.ndarray, target_short_side: int) -> np.ndarray:
    """Integer k x k box-downsample of uint8 [T, H, W, C] frames, k = the largest integer
    with short_side/k >= target_short_side (k=1 returns the input unchanged).

    The encoders only need ``target_short_side`` pixels after their antialiased bicubic
    device resize, so a source taller than twice that ships k^2 fewer bytes to the card.
    A k x k mean is the antialias prefilter the downscaling bicubic applies anyway. Sums are
    uint16 (uint32 past k = 16), rounded half up."""
    t, h, w, c = frames.shape
    k = min(h, w) // max(target_short_side, 1)
    if k <= 1:
        return frames
    hk, wk = (h // k) * k, (w // k) * k
    acc_dtype = np.uint16 if k * k * 255 <= np.iinfo(np.uint16).max else np.uint32
    acc = np.zeros((t, hk // k, wk // k, c), acc_dtype)
    for i in range(k):
        for j in range(k):
            acc += frames[:, i:hk:k, j:wk:k]
    return ((acc + (k * k) // 2) // (k * k)).astype(np.uint8)
