"""Probe: the hand-written GEMM sweep kernel against the library's scan of GEMMs, at the XXL
single block's weight-streaming shape.

The counterpart of ``tools/probe_gemm_pallas.py``. It chains x -> tanh(x @ W_b[:, :K]) over
36 stacked ``[1536, 4608]`` bf16 weights (the fused qkv projection, ``models/mmdit.py``'s
``linear_qkv``) from x ``[784, 1536]`` (CFG batch 2 x 392 tokens), and times:

- ``kernel``: ``ops/kernels/gemm_sweep.gemm_sweep``, one launch of the hand-written kernel
  per weight block, on the K columns the chain uses;
- ``library_sweep``: per block ``torch.matmul`` in bf16 on the ``[1536, 1536]`` head view,
  then tanh (the tool's ``xla_sweep``, which rounds the product to bf16 before tanh), as a
  yardstick only;
- ``library_sweep_full``: the same over the full ``[1536, 4608]`` block, with tanh of the
  head: the tool's variant as written, three times the products;
- ``plain``: ``gemm_sweep_plain``, the kernel's arithmetic in fp32.

Times come from CUDA events around many sweeps queued behind a GPU spin (no dispatch loop
is needed to hide launch latency): ``ms_per_sweep`` as the sweep runs eagerly, where the
host's cost of launching it shows if it exceeds the device's time, and
``graph_ms_per_sweep`` from replays of the sweep captured in a CUDA graph, the device's time
alone. The floors are the H100's: 989 TFLOP/s dense bf16 and 3.35 TB/s, for the head work
the port does and, apart, for the tool's full-width count.

Run on a machine with a CUDA card: ``python -m foley_tpu_torch.tools.probe_gemm`` prints
one JSON line. ``--device cpu`` runs it on the CPU, where the kernel's wrapper takes the
plain version and the times are host times.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.ops.kernels.gemm_sweep import gemm_sweep, gemm_sweep_plain

M, K, N = 784, 1536, 4608  # 784 = CFG batch 2 x a 392-token single stream
BLOCKS = 36
ITERS, PLAIN_ITERS = 50, 5  # sweeps timed per variant; the plain version is ~4x slower
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU spin while the host enqueues a timed loop


def make_inputs(device: DeviceLike = None, seed: int = 0):
    """x [M, K] and w [BLOCKS, K, N] in bf16 on the device, drawn as the tool draws them:
    normal x, and w scaled by 1/sqrt(K) so the chained x stays at unit scale."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M, K))).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(BLOCKS, K, N)) / np.sqrt(K)).to(dev, torch.bfloat16)
    return x, w


def library_sweep(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tool's ``xla_sweep`` on the head the chain uses: per block a bf16 product (rounded
    to bf16), then tanh."""
    k = x.shape[1]
    for b in range(w.shape[0]):
        x = torch.tanh(torch.matmul(x, w[b, :, :k])).to(torch.bfloat16)
    return x


def library_sweep_full(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tool's ``xla_sweep`` as written: the product over the whole block, tanh of its
    first K columns."""
    k = x.shape[1]
    for b in range(w.shape[0]):
        x = torch.tanh(torch.matmul(x, w[b])[:, :k]).to(torch.bfloat16)
    return x


def time_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Time per call: on a card, CUDA events around ``iters`` calls queued behind a GPU spin
    (the host's launch cost shows where it exceeds the device's time); on the CPU, the host
    clock."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Device time per call: ``fn`` captured once in a CUDA graph, then ``time_ms`` of its
    replays, so the host's launch cost never shows."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm up off the capture, as torch.cuda.graph asks
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters, device)


def floors(flops: int, weight_bytes: int) -> dict:
    return {"flops": flops, "weight_bytes": weight_bytes,
            "compute_floor_ms": flops / H100_BF16_FLOPS * 1e3,
            "weight_stream_floor_ms": weight_bytes / H100_HBM_BYTES_PER_S * 1e3}


def measure(device: DeviceLike = None) -> dict:
    """The probe's record: each variant's time a sweep and its rates, the kernel's error
    against its plain version (beside the plain chain's own drift from fp64 sums), and the
    H100's floors for the head work and for the tool's full-width count."""
    dev = resolve_device(device)
    x, w = make_inputs(dev)
    m, k, n, blocks = M, K, N, BLOCKS
    before = gemm_sweep.launches
    got = gemm_sweep(x, w)
    launches = gemm_sweep.launches - before
    ref = gemm_sweep_plain(x, w).float()
    diff = got.float() - ref
    drift = gemm_sweep_plain(x, w, torch.float64).float() - ref
    head_w, full_w = blocks * k * k * 2, blocks * k * n * 2
    head, full = 2 * blocks * m * k * k, 2 * blocks * m * k * n
    kernel_calls = 0

    def kernel():
        nonlocal kernel_calls
        kernel_calls += 1
        return gemm_sweep(x, w)

    variants = {"kernel": (kernel, ITERS, head, head_w),
                "library_sweep": (lambda: library_sweep(x, w), ITERS, head, head_w),
                "library_sweep_full": (lambda: library_sweep_full(x, w), ITERS, full, full_w),
                "plain": (lambda: gemm_sweep_plain(x, w), PLAIN_ITERS, head, head_w)}
    timed = {}
    for name, (fn, reps, flops, w_bytes) in variants.items():
        ms = time_ms(fn, reps, dev)
        timed[name] = {"ms_per_sweep": ms, "tflops": flops / ms / 1e9,
                       "weight_gbps": w_bytes / ms / 1e6,
                       "graph_ms_per_sweep": graph_ms(fn, reps, dev) if dev.type == "cuda"
                       else None}

    def speedup(key):
        return timed["library_sweep"][key] / timed["kernel"][key]

    return {
        "measure": f"gemm_sweep_{blocks}x[{m}x{k}]x[{k}x{k}]_of_[{k}x{n}]_bf16",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "launches_per_sweep": launches,
        "kernel_sweeps": 1 + kernel_calls,  # calls of the wrapper; graph replays make none
        "max_abs_err": float(diff.abs().max()),
        "rel_l2_err": float(diff.norm() / ref.norm()),
        # the plain chain against itself summed in fp64: the drift of bf16 rounding alone
        "plain_fp64_rel_l2": float(drift.norm() / ref.norm()),
        **floors(head, head_w),  # the head work the port does
        "full_width": floors(full, full_w),  # the tool's count
        **timed,
        "kernel_speedup": speedup("ms_per_sweep"),
        "kernel_speedup_graph": speedup("graph_ms_per_sweep") if dev.type == "cuda" else None,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    print(json.dumps(measure(ap.parse_args(argv).device)))


if __name__ == "__main__":
    main()
