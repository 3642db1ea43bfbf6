"""Flash attention (unmasked softmax attention): the Hopper kernel and its plain version.

Replaces the TPU kernel ``foley_tpu/ops/pallas/flash_attention.py:60``
(``_flash_attention_bhld``, body ``_attn_kernel`` :34, entry ``flash_attention`` :96). The
CUDA source is ``foley_tpu_torch/csrc/flash_attention.cu`` (sm_90a, bf16, head_dim 64 or
128: a persistent grid, a producer warp's TMA copies into a 4-stage K/V ring, consumer
warpgroups of 64 query rows (three at D 64, two at D 128) taking turns to issue wgmma for
both products, an online softmax in registers; its header says how the design follows from
the card), with the Hopper primitives of ``csrc/hopper.cuh``.

Bound on an H100 SXM (989 TFLOP/s dense bf16, at a 700 W power limit): operations. At
SigLIP2's 5 s call (B 40 frames, L 1024, 12 heads of 64) a launch does 128.8 GFLOP of
products against 251.7 MB of q, k, v and o, about 130 us (75 us for its bytes). The kernel
therefore never writes the logits or p to device memory, reads q, k and v through their
``[B, L, H, D]`` strides (no transposes around it, unlike the TPU wrapper) and keeps the
tensor cores fed from shared memory.

``flash_attention`` launches the kernel for CUDA tensors and takes ``flash_attention_plain``
only for CPU tensors; a ``mask`` goes to the plain masked attention (``ops/attention.sdpa``),
as the TPU wrapper sends it to ``_sdpa_xla``. ``flash_attention.launches`` counts kernel
launches (the plain paths do not count).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from foley_tpu_torch.ops.attention import sdpa
from foley_tpu_torch.ops.kernels.common import (
    check_launch,
    check_operand,
    count_launch,
    on_device,
)

HEAD_DIMS = (64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's arithmetic on whole tensors: q [B, Lq, H, D], k/v [B, Lk, H, D].

    fp32 logits q.k scaled after the product by 1/sqrt(D), a full-row fp32 softmax, p cast to
    ``v.dtype``, p @ v accumulated in fp32 and returned in ``q.dtype``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


_fn = None


def _kernel_fn():
    """The C entry of the built library, with its argument types declared."""
    global _fn
    if _fn is None:
        from foley_tpu_torch.ops.kernels.build import library

        p = ctypes.c_void_p
        fn = library("flash_attention").flash_attention_bf16
        fn.argtypes = [p] * 4 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 5 + [p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIMS}, got {d}")
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(b, lq, lk, h) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x)
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out) for s in (
        x.stride(0), x.stride(1), x.stride(2))))
    with on_device(q.device):
        err = _kernel_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                           b, h, lq, lk, d, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    count_launch(flash_attention)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over seq-first tensors: q [B, Lq, H, D], k/v [B, Lk, H, D] ->
    [B, Lq, H, D].

    Unmasked CUDA tensors launch the kernel (bf16, D 64 or 128; anything else raises);
    unmasked CPU tensors take ``flash_attention_plain``. ``mask`` (boolean [B, 1, Lq, Lk],
    True = attend) takes the plain masked attention on any device, as the TPU wrapper does."""
    if mask is not None:
        return sdpa(q, k, v, mask)
    if q.device.type == "cuda":
        return _launch(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return flash_attention_plain(q, k, v)


flash_attention.launches = 0
