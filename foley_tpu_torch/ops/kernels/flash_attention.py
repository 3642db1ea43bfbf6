"""Flash attention (unmasked softmax attention): the Hopper kernel and its plain version.

Replaces the TPU kernel ``foley_tpu/ops/pallas/flash_attention.py:60``
(``_flash_attention_bhld``, body ``_attn_kernel`` :34, entry ``flash_attention`` :96),
head_dim 64 or 128, in three element types, one C entry each:
- bf16 and fp16: ``foley_tpu_torch/csrc/flash_attention.cu`` (sm_90a, the element type a
  template: a persistent grid, a producer warp's TMA copies into a 4-stage K/V ring,
  consumer warpgroups of 64 query rows (three at D 64, two at D 128) taking turns to issue
  wgmma for both products, an online softmax in registers; its header says how the design
  follows from the card), with the Hopper primitives of ``csrc/hopper.cuh``;
- fp32: ``foley_tpu_torch/csrc/attention_f32.cu`` (``flash_attention_f32``: both products
  on the tensor cores in 3xTF32, each fp32 operand split into tf32 hi and lo and a.b formed
  as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, which keeps the accuracy of the JAX package's
  ``_mha`` in fp32 at ``Precision.HIGHEST``; a single TF32 pass would not).
  ``common.attention_tf32`` is a CPU model of that arithmetic.

Bound on an H100 SXM (989 TFLOP/s dense bf16 and fp16, 495 TFLOP/s TF32, at a 700 W power
limit): operations. At SigLIP2's 5 s call (B 40 frames, L 1024, 12 heads of 64) a launch
does 128.8 GFLOP of products: about 130 us in 16 bits (75 us for its 251.7 MB of q, k, v
and o), 781 us in fp32 at three TF32 products each. The kernels therefore never write the
logits or p to device memory, read q, k and v through their ``[B, L, H, D]`` strides (no
transposes around them, unlike the TPU wrapper) and keep the products fed from shared
memory.

``flash_attention`` launches the kernel of the operands' type for CUDA tensors and takes
``flash_attention_plain`` only for CPU tensors; a ``mask`` goes to the plain masked attention
(``ops/attention.sdpa``), as the TPU wrapper sends it to ``_sdpa_xla``.
``flash_attention.launches`` counts kernel launches, and ``flash_attention.launches_by_dtype``
counts them for each element type (the plain paths do not count).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from foley_tpu_torch.ops.attention import sdpa
from foley_tpu_torch.ops.kernels.common import (
    ATTENTION_DTYPES,
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


_fns = {}


def _kernel_fn(dtype: torch.dtype):
    """The C entry for ``dtype`` of the built library, with its argument types declared:
    ``flash_attention_{bf16,f16}`` of ``flash_attention.cu``, ``flash_attention_f32`` of
    ``attention_f32.cu``."""
    if dtype not in _fns:
        from foley_tpu_torch.ops.kernels.build import library

        suffix = ATTENTION_DTYPES[dtype]
        lib = library("attention_f32" if suffix == "f32" else "flash_attention")
        p = ctypes.c_void_p
        fn = getattr(lib, f"flash_attention_{suffix}")
        fn.argtypes = [p] * 4 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 5 + [p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


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
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, ATTENTION_DTYPES)
    if q.dtype == torch.float32 and b * h > 65535:  # one block row per (batch, head)
        raise ValueError(f"batch * heads = {b * h} exceeds the fp32 kernel's grid (65535)")
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out) for s in (
        x.stride(0), x.stride(1), x.stride(2))))
    with on_device(q.device):
        err = _kernel_fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  strides, b, h, lq, lk, d,
                                  torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    count_launch(flash_attention, q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention over seq-first tensors: q [B, Lq, H, D], k/v [B, Lk, H, D] ->
    [B, Lq, H, D].

    Unmasked CUDA tensors launch the kernel of their type (bf16, fp16 or fp32, D 64 or 128;
    anything else raises);
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
flash_attention.launches_by_dtype = {}
