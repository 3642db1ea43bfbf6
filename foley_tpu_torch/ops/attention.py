"""Plain attention with the JAX package's ``_sdpa_xla`` numerics
(``foley_tpu/ops/attention.py`` counterpart).

fp32 logits, fp32 softmax, ``p`` cast to ``v.dtype`` before ``p @ v``, output in
``v.dtype``. It serves the text cross-attention of the triple blocks, which the JAX package
also computes outside any Pallas kernel, the MAP head of SigLIP2 and the masked calls of
the flash-attention wrapper. Layout: seq-first ``[B, L, H, D]``.
"""

from __future__ import annotations

from typing import Optional

import torch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D]. ``mask``: optional boolean
    [B, 1, Lq, Lk] (True = attend); a masked logit becomes the float32 minimum, as in the
    JAX package."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    # fp32 operands: a bf16 product is exact in fp32, so this is bf16 x bf16 with fp32
    # accumulation, as the JAX einsum's preferred_element_type=float32.
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask.to(torch.bool), torch.finfo(torch.float32).min)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
