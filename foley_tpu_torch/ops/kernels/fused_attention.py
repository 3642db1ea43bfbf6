"""Fused qk-RMSNorm + RoPE + softmax attention: the Hopper kernel and its plain version.

Replaces the TPU kernel ``foley_tpu/ops/pallas/fused_attention.py:82``
(``fused_qk_attention_headfirst``, wrapper ``fused_qk_attention`` :127). The CUDA source is
``foley_tpu_torch/csrc/fused_qk_attention.cu`` (sm_90a, bf16, head_dim 128: TMA copies of Q,
K and V into a 5-stage ring, the norm + RoPE pass on warps of its own, wgmma for both
products, an online softmax over 64-key tiles; its header says how the design follows from
the card), with the Hopper primitives of ``csrc/hopper.cuh``.

Bound on an H100 SXM (3.35 TB/s, at a 700 W power limit): bytes. At the XXL 5 s joint call
(B=2, L=290, H=12, D=128) a launch must move q, k, v and o in bf16 and the per-position
cos/sin (about 3.6 MB) against about 1 GFLOP, about 1 us; what holds it back at that size is
the latency of each block's copy -> norm -> product chain, which the design overlaps. The
kernel reads every operand once through its strides and never writes the normalised q and
k, the logits or P to device memory.

``fused_qk_attention`` launches the kernel for CUDA tensors and takes
``fused_qk_attention_plain`` only for CPU tensors. ``fused_qk_attention.launches`` counts
kernel launches (the plain path does not count).
"""

from __future__ import annotations

import ctypes

import torch

from foley_tpu_torch.ops.kernels.common import check_launch, check_operand, on_device
from foley_tpu_torch.ops.rope import _rotate_half

HEAD_DIM = 128


def _norm_rope(x: torch.Tensor, w: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               eps: float) -> torch.Tensor:
    """[B, L, H, D] raw -> fp32 RMS-norm * per-position weight, pair-adjacent rotation,
    cast back to ``x.dtype`` (the TPU kernel's ``_norm_rope``)."""
    w, cos, sin = (t.float()[None, :, None, :] for t in (w, cos, sin))
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def fused_qk_attention_plain(q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k, eps=1e-6):
    """The TPU kernel's arithmetic on whole tensors: q/k/v [B, L, H, D] raw, tables [L, D].

    Normalised/rotated q and k in the input dtype, fp32 logits q.k/sqrt(D), fp32 softmax,
    p cast to ``v.dtype``, p @ v accumulated in fp32 and returned in ``q.dtype``."""
    qn = _norm_rope(q, wq, cos_q, sin_q, eps)
    kn = _norm_rope(k, wk, cos_k, sin_k, eps)
    logits = torch.einsum("bqhd,bkhd->bhqk", qn.float(), kn.float()) * (q.shape[-1] ** -0.5)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _table(t: torch.Tensor, length: int, device: torch.device) -> torch.Tensor:
    """``t`` as the kernel reads it: fp32 [length, D], contiguous, 16-byte aligned. The
    denoiser's tables already are, and pass through untouched."""
    if (t.dtype == torch.float32 and t.shape == (length, HEAD_DIM) and t.is_contiguous()
            and t.device == device and t.data_ptr() % 16 == 0):
        return t
    t = t.to(device=device, dtype=torch.float32).expand(length, HEAD_DIM).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_fn = None


def _kernel_fn():
    """The C entry of the built library, with its argument types declared."""
    global _fn
    if _fn is None:
        from foley_tpu_torch.ops.kernels.build import library

        p = ctypes.c_void_p
        fn = library("fused_qk_attention").fused_qk_attention_bf16
        fn.argtypes = [p] * 10 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 4 + [
            ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k, eps):
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if b * h > 65535:  # one block row per (batch, head): the grid's y extent
        raise ValueError(f"batch * heads = {b * h} exceeds the kernel's grid (65535)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x)
    dev = q.device
    tq = [_table(t, lq, dev) for t in (wq, cos_q, sin_q)]
    tk = [_table(t, lk, dev) for t in (wk, cos_k, sin_k)]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=dev)
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out) for s in (
        x.stride(0), x.stride(1), x.stride(2))))
    with on_device(dev):
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            tq[0].data_ptr(), tk[0].data_ptr(), tq[1].data_ptr(), tq[2].data_ptr(),
            tk[1].data_ptr(), tk[2].data_ptr(), strides, b, h, lq, lk, float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("fused_qk_attention", err)
    fused_qk_attention.launches += 1
    return out


def fused_qk_attention(q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k, eps=1e-6):
    """q/k/v [B, L, H, D] raw (pre-norm, pre-rope); wq/cos_q/sin_q [Lq, D] and wk/cos_k/sin_k
    [Lk, D] per-position tables (a [D] weight broadcasts). Returns [B, Lq, H, D].

    CUDA tensors launch the kernel (bf16, D=128; anything else raises); CPU tensors take
    ``fused_qk_attention_plain``."""
    if q.device.type == "cuda":
        return _launch(q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k, eps)
    if q.device.type != "cpu":
        raise ValueError(f"fused_qk_attention runs on cuda or cpu, got {q.device}")
    lq, lk = q.shape[1], k.shape[1]
    wq, wk = wq.expand(lq, q.shape[-1]), wk.expand(lk, k.shape[-1])
    return fused_qk_attention_plain(q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k, eps)


fused_qk_attention.launches = 0
