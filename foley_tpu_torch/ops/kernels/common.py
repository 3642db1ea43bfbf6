"""What the kernels' wrappers share around their C entries: the operand check every kernel
needs (16-byte rows: a TMA tensor map's, or the fp32 kernels' 16-byte loads), the element
types the attention kernels take and the suffix of each one's C entry, the current-device
context a launch runs in, how a C entry's return code is read, and the launch counters
(one in all and one for each element type). Also a model of the fp32 kernels' 3xTF32
arithmetic (``split_tf32``, ``attention_tf32``), which only the tests and ``chip_smoke.py``
use: it pins the numeric design on the CPU. Nothing is built or loaded when this module is
imported."""

from __future__ import annotations

import contextlib
import threading

import torch


#: The element types of K1's and K2's C entries, and each one's suffix: the 16-bit types
#: run the wgmma kernels (``fused_qk_attention.cu``, ``flash_attention.cu``), fp32 the
#: 3xTF32 wgmma kernels of ``attention_f32.cu``.
ATTENTION_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}


def check_operand(name: str, x: torch.Tensor, dtypes=(torch.bfloat16,)) -> None:
    """The kernels' precondition on an operand they read in 16-byte rows (K1's and K2's
    [B, L, H, D], K3's x [M, K] and w [B, K, N], through a TMA tensor map or, in fp32, 16-byte
    loads): one of ``dtypes`` (K3 takes bf16 alone), a unit last stride, other strides
    multiples of 16 bytes, a 16-byte aligned pointer."""
    if x.dtype not in dtypes:
        names = ", ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: the CUDA kernel takes {names}, got {x.dtype}")
    per_row = 16 // x.element_size()
    if x.stride(-1) != 1 or any(s % per_row for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte rows; it needs a unit last stride, "
                         f"strides that are multiples of {per_row} and a 16-byte aligned "
                         f"pointer, got strides {x.stride()}")


def on_device(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device (the C entries launch on the
    current device): no context at all when it already is, which the 2,700 launches of a
    request save the cost of."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check_launch(kernel: str, err: int) -> None:
    """Raises on a failed launch: -1 is an operand the driver cannot describe as a tensor
    map, -2 a driver without the tensor-map encoder, anything else a cudaError."""
    if err == -1:
        raise ValueError(f"{kernel}: the driver cannot describe an operand's strides as a TMA "
                         f"tensor map")
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{'no cuTensorMapEncodeTiled' if err == -2 else f'cudaError {err}'}")


_launch_lock = threading.Lock()


def count_launch(wrapper, dtype: torch.dtype = torch.bfloat16) -> None:
    """Add one to ``wrapper.launches`` (the wrapper's count of its kernel's launches) and to
    ``wrapper.launches_by_dtype[dtype]`` under a lock: the server's request threads launch
    concurrently, and a bare ``+=`` on the attribute could lose a count. So the counts stay
    exact under concurrent requests."""
    with _launch_lock:
        wrapper.launches += 1
        by_dtype = wrapper.launches_by_dtype
        by_dtype[dtype] = by_dtype.get(dtype, 0) + 1


def reset_launches(wrapper) -> None:
    """Set a wrapper's launch counts, in all and by element type, to 0."""
    with _launch_lock:
        wrapper.launches = 0
        wrapper.launches_by_dtype = {}


def split_tf32(x: torch.Tensor):
    """fp32 ``x`` as the fp32 kernels split it: ``hi`` is x rounded to tf32 (1 + 10 bits of
    mantissa) to nearest with ties away from zero, on the bit pattern (half a tf32 step added
    to the magnitude, the low 13 bits cleared, as ``hopper.cuh::tf32_rna`` does), and ``lo``
    is ``x - hi`` rounded the same way. Both are fp32 tensors whose low 13 bits are zero, and
    hi + lo is x within 2^-22 of it."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` on fp32 operands as the tensor cores take them in tf32: with ``passes`` 3,
    a_lo b_hi + a_hi b_lo + a_hi b_hi (the fp32 kernels' 3xTF32); with 1, a_hi b_hi alone (a
    single TF32 pass). Each product of two tf32 values is exact in fp32; the sums are fp32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    if passes != 3:
        raise ValueError(f"passes is 1 or 3, got {passes}")
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def attention_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   passes: int = 3) -> torch.Tensor:
    """Softmax attention on fp32 q [B, Lq, H, D], k / v [B, Lk, H, D] with both products in
    ``_matmul_tf32``, as the fp32 kernels compute it: logits q . k scaled after the product by
    1/sqrt(D), p = exp(logits - row max) in fp32, p V, then divided by the row sums of p.
    K1's q and k go in already normalised and rotated (in fp32, as the kernel's converters
    do before they split them). Returns fp32 [B, Lq, H, D]."""
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, L, D]
    logits = _matmul_tf32(qh, kh.transpose(-1, -2), passes) * (1.0 / q.shape[-1] ** 0.5)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    o = _matmul_tf32(p, vh, passes) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2)
