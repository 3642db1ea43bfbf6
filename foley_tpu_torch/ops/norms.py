"""Normalization ops: fp32 compute islands (``foley_tpu/ops/norms.py`` counterpart).

RMSNorm normalizes in fp32, casts back to the input dtype, and only then multiplies by the
(storage-dtype) weight, as the reference's ``norm_layers.py:4-52`` does. LayerNorm (no
affine by default, eps 1e-6) is computed in fp32 and cast back.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    out = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
