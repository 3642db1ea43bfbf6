"""Fused qk-RMSNorm + RoPE + softmax attention: the Hopper kernel and its plain version.

Replaces the TPU kernel ``foley_tpu/ops/pallas/fused_attention.py:82``
(``fused_qk_attention_headfirst``, wrapper ``fused_qk_attention`` :127). At head_dim 128 (XL,
XXL) in three element types, one C entry each:
- bf16 and fp16: ``foley_tpu_torch/csrc/fused_qk_attention.cu`` (sm_90a, the element type a
  template: TMA copies of Q, K and V into a 5-stage ring, the norm + RoPE pass on warps of
  its own, wgmma for both products, an online softmax over 64-key tiles; its header says how
  the design follows from the card), with the Hopper primitives of ``csrc/hopper.cuh``;
- fp32: ``foley_tpu_torch/csrc/attention_f32.cu`` (``fused_qk_attention_f32``: the same
  prologue in fp32, then both products on the tensor cores in 3xTF32, each fp32 operand
  split into tf32 hi and lo and a.b formed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, which keeps
  the accuracy of the JAX package's fp32 attention at ``Precision.HIGHEST``; a single TF32
  pass would not). ``common.attention_tf32`` is a CPU model of that arithmetic.

At every other even head width up to 256 (TINY's 32; 64 and 96 for a 1536-wide denoiser
with 24 or 16 heads), in the same three types:
``foley_tpu_torch/csrc/fused_qk_attention_mma.cu`` (``fused_qk_attention_mma_*``: 128 query
rows a block, 16 a warp, 64-key tiles double-buffered through cp.async and normalised and
rotated in shared memory, both products by ``mma.sync`` on the tensor cores, fp32 in
3xTF32; the width padded to a multiple of 16 in shared memory; its header says how the
design follows from the card). Past 256 a block's fp32 output would not fit its registers:
such widths raise, as do odd ones (the rotation pairs adjacent columns).

Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 and fp16, 495 TFLOP/s TF32, at a 700 W
power limit). At the XXL 5 s joint call (B=2, L=290, H=12, D=128) a launch does about 1
GFLOP. In 16 bits it must move q, k, v and o and the per-position cos/sin (about 3.6 MB):
bound by bytes, about 1 us; what holds it back at that size is the latency of each block's
copy -> norm -> product chain, which the design overlaps. In fp32 it is bound by operations
at three TF32 products each, 6.3 us (its 14.3 MB of bytes take 4.3 us). The kernels read
every operand once through its strides and never write the normalised q and k, the logits
or P to device memory.

``fused_qk_attention`` launches the kernel of the operands' type and head width for CUDA
tensors and takes
``fused_qk_attention_plain`` only for CPU tensors. ``fused_qk_attention.launches`` counts
kernel launches, and ``fused_qk_attention.launches_by_dtype`` counts them for each element
type (the plain path does not count).
"""

from __future__ import annotations

import ctypes

import torch

from foley_tpu_torch.ops.kernels.common import (
    ATTENTION_DTYPES,
    check_launch,
    check_operand,
    count_launch,
    on_device,
    refuse_grad,
)
from foley_tpu_torch.ops.rope import _rotate_half

HEAD_DIM = 128  # the wgmma kernels'
MMA_MAX_HEAD_DIM = 256  # fused_qk_attention_mma.cu's: every other even width up to it
#: fused_qk_attention_mma.cu's part for each element type: (source, macro), built apart
MMA_LIBS = {dtype: ("fused_qk_attention_mma", f"K1_MMA_{suffix.upper()}")
            for dtype, suffix in ATTENTION_DTYPES.items()}


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


def _table(t: torch.Tensor, length: int, device: torch.device,
           d: int = HEAD_DIM) -> torch.Tensor:
    """``t`` as the kernel reads it: fp32 [length, d], contiguous, 16-byte aligned. The
    denoiser's tables already are, and pass through untouched."""
    if (t.dtype == torch.float32 and t.shape == (length, d) and t.is_contiguous()
            and t.device == device and t.data_ptr() % 16 == 0):
        return t
    t = t.to(device=device, dtype=torch.float32).expand(length, d).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_fns = {}


def _kernel_fn(dtype: torch.dtype, mma: bool = False):
    """The C entry for ``dtype`` of the built library, with its argument types declared:
    ``fused_qk_attention_{bf16,f16}`` of ``fused_qk_attention.cu``,
    ``fused_qk_attention_f32`` of ``attention_f32.cu``, and with ``mma``
    ``fused_qk_attention_mma_{bf16,f16,f32}`` of ``fused_qk_attention_mma.cu`` (which take
    the head width and the load's chunk bytes after the lengths)."""
    if (dtype, mma) not in _fns:
        from foley_tpu_torch.ops.kernels.build import library

        suffix = ATTENTION_DTYPES[dtype]
        p = ctypes.c_void_p
        if mma:
            fn = getattr(library(*MMA_LIBS[dtype]), f"fused_qk_attention_mma_{suffix}")
            ints = 6
        else:
            lib = library("attention_f32" if suffix == "f32" else "fused_qk_attention")
            fn = getattr(lib, f"fused_qk_attention_{suffix}")
            ints = 4
        fn.argtypes = [p] * 10 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * ints + [
            ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fns[dtype, mma] = fn
    return _fns[dtype, mma]


def check_head_dim(d: int) -> None:
    """Raises for a head width no CUDA kernel takes: an odd one (the rotation pairs adjacent
    columns) or one past ``MMA_MAX_HEAD_DIM`` (a block's fp32 output, 16 rows x D a warp,
    would not fit its registers beside the logits)."""
    if d % 2 or not 2 <= d <= MMA_MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take an even head_dim from 2 to {MMA_MAX_HEAD_DIM} "
                         f"(past {MMA_MAX_HEAD_DIM} a block's fp32 output would not fit its "
                         f"registers), got {d}")


def chunk_bytes(*xs: torch.Tensor) -> int:
    """The widest cp.async chunk, 16, 8 or 4 bytes, that divides each operand's row bytes,
    its strides in bytes and its pointer: what ``fused_qk_attention_mma.cu`` loads its
    [B, L, H, D] rows in (a width that is not a multiple of 8 in 16 bits gives 4). Raises
    for a last stride other than 1 or rows that are not 4-byte aligned."""
    for vec in (16, 8, 4):
        if all(x.stride(-1) == 1 and x.data_ptr() % vec == 0
               and all(n * x.element_size() % vec == 0 for n in (x.shape[-1], *x.stride()[:-1]))
               for x in xs):
            return vec
    raise ValueError(f"the kernel reads rows of 4-byte pairs; it needs a unit last stride and "
                     f"4-byte aligned rows, got strides {[tuple(x.stride()) for x in xs]}")


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The C entry a call of these operands takes, and its arguments after the lengths, read
    from the operands alone: ``(False, ())`` for the wgmma kernels at head_dim 128 (16-byte
    rows, ``common.check_operand``), ``(True, (d, chunk))`` for ``fused_qk_attention_mma.cu``
    at every other even head_dim up to 256 (``chunk_bytes``). Raises for anything else."""
    d = q.shape[-1]
    check_head_dim(d)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d == HEAD_DIM:
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_operand(name, x, ATTENTION_DTYPES)
        return False, ()
    if q.dtype not in ATTENTION_DTYPES:
        raise TypeError(f"q: the CUDA kernel takes bfloat16, float16, float32, got {q.dtype}")
    return True, (d, chunk_bytes(q, k, v))


def _launch(q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k, eps):
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(b, lq, lk, h) < 1:  # with no keys a kernel would wait for a tile that never comes
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if b * h > 65535:  # one block row per (batch, head): the grid's y extent
        raise ValueError(f"batch * heads = {b * h} exceeds the kernel's grid (65535)")
    mma, extra = kernel_route(q, k, v)
    dev = q.device
    tq = [_table(t, lq, dev, d) for t in (wq, cos_q, sin_q)]
    tk = [_table(t, lk, dev, d) for t in (wk, cos_k, sin_k)]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=dev)
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, out) for s in (
        x.stride(0), x.stride(1), x.stride(2))))
    with on_device(dev):
        err = _kernel_fn(q.dtype, mma)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            tq[0].data_ptr(), tk[0].data_ptr(), tq[1].data_ptr(), tq[2].data_ptr(),
            tk[1].data_ptr(), tk[2].data_ptr(), strides, b, h, lq, lk, *extra, float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("fused_qk_attention", err)
    count_launch(fused_qk_attention, q.dtype)
    return out


def fused_qk_attention(q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k, eps=1e-6):
    """q/k/v [B, L, H, D] raw (pre-norm, pre-rope); wq/cos_q/sin_q [Lq, D] and wk/cos_k/sin_k
    [Lk, D] per-position tables (a [D] weight broadcasts). Returns [B, Lq, H, D].

    CUDA tensors launch the kernel of their type and head width (bf16, fp16 or fp32; D 128
    on the wgmma kernels, every other even D up to 256 on the ``mma.sync`` kernel; anything
    else raises), and raise where autograd would record the call (``common.refuse_grad``);
    CPU tensors take ``fused_qk_attention_plain``."""
    if q.device.type == "cuda":
        refuse_grad("fused_qk_attention", 'the plain route, MMDiT.forward(..., attn_impl="xla"), '
                    "as training does", q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k)
        return _launch(q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k, eps)
    if q.device.type != "cpu":
        raise ValueError(f"fused_qk_attention runs on cuda or cpu, got {q.device}")
    lq, lk = q.shape[1], k.shape[1]
    wq, wk = wq.expand(lq, q.shape[-1]), wk.expand(lk, k.shape[-1])
    return fused_qk_attention_plain(q, k, v, wq, wk, cos_q, sin_q, cos_k, sin_k, eps)


fused_qk_attention.launches = 0
fused_qk_attention.launches_by_dtype = {}
