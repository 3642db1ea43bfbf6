"""Nearest-exact 1-D resampling, torch ``F.interpolate(mode="nearest-exact")`` semantics
(``foley_tpu/ops/interp.py`` counterpart). Index rule: out[i] = in[floor((i+0.5)*Lin/Lout)].
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
