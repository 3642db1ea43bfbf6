"""Rotary position embeddings: tables and the pair-adjacent rotation
(``foley_tpu/ops/rope.py`` counterpart).

Feature pairs (2j, 2j+1) share an angle (``repeat_interleave(2)`` tables) and
``rotate_half`` maps each pair (re, im) to (-im, re). This is the reference's pair-adjacent
layout (``attn_layers.py:112-114``), not the split-half layout of many other models: a
split-half rotation would be silently wrong here.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_table(length: int, dim: int, theta: float = 10000.0, freq_scaling: float = 1.0,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape [length, dim] (fp32)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)
    idx = torch.arange(0, dim, 2, dtype=torch.float32, device=device)[: dim // 2]
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), -(idx / dim))
    freqs = freqs * freq_scaling
    angles = torch.outer(pos, freqs)  # [L, D/2]
    cos = torch.repeat_interleave(torch.cos(angles), 2, dim=1)
    sin = torch.repeat_interleave(torch.sin(angles), 2, dim=1)
    return cos, sin


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(re, im) pairs -> (-im, re), pair-adjacent layout."""
    x2 = x.unflatten(-1, (-1, 2))
    re, im = x2[..., 0], x2[..., 1]
    return torch.stack([-im, re], dim=-1).flatten(-2)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [B, L, H, D] by the [L, D] table; fp32 compute, cast back to ``x.dtype``."""
    cos, sin = cos[None, :, None], sin[None, :, None]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def interleave_sequences(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Interleave two [B, N, H, C] sequences token by token -> [B, 2 * N1, H, C]; ``x2`` is
    first resized to ``N1`` by nearest-exact gathering when the lengths differ (reference
    ``hifi_foley.py:35-47``)."""
    from foley_tpu_torch.ops.interp import nearest_exact_resize

    n1 = x1.shape[1]
    x2 = nearest_exact_resize(x2, n1, dim=1)
    return torch.stack([x1, x2], dim=2).reshape(x1.shape[0], n1 * 2, *x1.shape[2:])


def decouple_interleaved(x: torch.Tensor, len1: int, len2: int) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """The inverse of ``interleave_sequences`` (reference ``hifi_foley.py:49-60``): the
    second stream resized back to ``len2``."""
    from foley_tpu_torch.ops.interp import nearest_exact_resize

    b, n = x.shape[:2]
    if n % 2 or n // 2 != len1:
        raise ValueError(f"interleaved length {n} does not hold {len1} pairs")
    x = x.reshape(b, n // 2, 2, *x.shape[2:])
    return x[:, :, 0], nearest_exact_resize(x[:, :, 1], len2, dim=1)
