"""Plain attention with the JAX package's ``_sdpa_xla`` numerics
(``foley_tpu/ops/attention.py`` counterpart).

fp32 logits, fp32 softmax, ``p`` cast to ``v.dtype`` before ``p @ v``, output in
``v.dtype``. It serves the text cross-attention of the triple blocks, which the JAX package
also computes outside any Pallas kernel. Layout: seq-first ``[B, L, H, D]``.
"""

from __future__ import annotations

import torch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D] (no mask: the port raises on
    ``use_attention_mask``)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    # fp32 operands: a bf16 product is exact in fp32, so this is bf16 x bf16 with fp32
    # accumulation, as the JAX einsum's preferred_element_type=float32.
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
