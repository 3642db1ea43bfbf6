"""Chained weight-streaming GEMM sweep: the Hopper kernel and its plain version.

Replaces the TPU kernel ``tools/probe_gemm_pallas.py:93`` (``main``'s ``pallas_call``, body
``kernel`` :70-91), which times a stack of GEMMs of the single block's fused qkv projection
shape with the activation kept resident. The CUDA source is
``foley_tpu_torch/csrc/gemm_sweep.cu`` (sm_90a, bf16: one persistent cooperative launch a
sweep; 64 x 192 output tiles in clusters of 2 x 2 blocks; a producer thread's TMA ring of
64-deep stages, multicast within the cluster, a consumer warpgroup on wgmma, tanh -> bf16 in
the epilogue; the chain between weight blocks carried by a release / acquire flag per row
panel; its header says how the design follows from the card).

Bound on an H100: operations. At the probe's shape (x [784, 1536], 36 weight blocks of
which the chain uses [1536, 1536]) a sweep does 133.2 GFLOP against 174.7 MB of weights, x
and output, 134.7 us at 989 TFLOP/s (52.1 us for its bytes). The kernel therefore reads
only the K columns the chain uses (the TPU kernel computes all N and keeps a third), keeps
x in L2 rather than in an SM, and streams the next block's weights while a row panel waits
for the previous block's output.

``gemm_sweep`` launches the kernel for CUDA tensors and takes ``gemm_sweep_plain`` only for
CPU tensors. ``gemm_sweep.launches`` counts kernel launches, one a sweep (the plain path
does not count).
"""

from __future__ import annotations

import ctypes

import torch

from foley_tpu_torch.ops.kernels.common import (
    check_launch,
    check_operand,
    count_launch,
    on_device,
)
from foley_tpu_torch.ops.nn import true_fp32

K_STEP = 64  # the kernel's contraction slab: K must be a multiple of it
MAX_ROWS = 2 ** 31 - 2 ** 8  # the kernel's row coordinates are int32
PANEL = 64  # the rows of a tile: one flag (int32) a row panel


def gemm_sweep_plain(x: torch.Tensor, w: torch.Tensor,
                     acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The TPU kernel's arithmetic on whole tensors: x [M, K], w [B, K, N] with N >= K.

    For each block, fp32 products x @ w[b, :, :K] summed in fp32 (TF32 off), tanh in fp32,
    one rounding to ``x.dtype``; returns the last x [M, K]. ``acc_dtype=torch.float64`` sums
    in fp64 instead: the same chain with less rounding inside each block, which shows how
    far the chain drifts through its bf16 roundings alone."""
    k = x.shape[1]
    with true_fp32():
        for b in range(w.shape[0]):
            x = torch.tanh(x.to(acc_dtype) @ w[b, :, :k].to(acc_dtype)).to(x.dtype)
    return x


_fn = None


def _kernel_fn():
    """The C entry of the built library, with its argument types declared."""
    global _fn
    if _fn is None:
        from foley_tpu_torch.ops.kernels.build import library

        p = ctypes.c_void_p
        fn = library("gemm_sweep").gemm_sweep_bf16
        fn.argtypes = [p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 3 + [p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    m, k = x.shape
    blocks = w.shape[0]
    if x.device != w.device:
        raise ValueError("x and w must lie on one device")
    for name, t in (("x", x), ("w", w)):
        check_operand(name, t)
    if k < K_STEP or k % K_STEP:
        raise ValueError(f"the CUDA kernel takes K a multiple of {K_STEP}, got {k}")
    if not 1 <= m <= MAX_ROWS or blocks < 1:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_ROWS} rows and at least one weight "
                         f"block, got M {m}, {blocks} blocks")
    bufs = [torch.empty((m, k), dtype=x.dtype, device=x.device) for _ in range(min(blocks, 2))]
    ptrs = [b.data_ptr() for b in bufs] + [None] * (2 - len(bufs))
    # the row panels' flags; the C entry zeroes them on the stream before the launch
    counters = torch.empty(-(-m // PANEL), dtype=torch.int32, device=x.device)
    with on_device(x.device):
        err = _kernel_fn()(x.data_ptr(), w.data_ptr(), *ptrs, counters.data_ptr(), m, k,
                           blocks, x.stride(0), w.stride(0), w.stride(1),
                           torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("gemm_sweep", err)
    count_launch(gemm_sweep)
    return bufs[(blocks - 1) % 2]


def gemm_sweep(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x = tanh(x @ w[b, :, :K]) for each of the B blocks of w [B, K, N] (N >= K), from
    x [M, K]; returns the last x [M, K] in ``x.dtype``.

    CUDA tensors launch the kernel, once a sweep (bf16, K a multiple of 64, 16-byte rows;
    anything else raises); CPU tensors take ``gemm_sweep_plain``."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"gemm_sweep takes x [M, K] and w [B, K, N], got x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if w.shape[1] != x.shape[1] or w.shape[2] < x.shape[1]:
        raise ValueError(f"w must be [B, K, N] with K = {x.shape[1]} and N >= K, got "
                         f"{tuple(w.shape)}")
    if x.device.type == "cuda":
        return _launch(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"gemm_sweep runs on cuda or cpu, got {x.device}")
    return gemm_sweep_plain(x, w)


gemm_sweep.launches = 0
gemm_sweep.launches_by_dtype = {}
