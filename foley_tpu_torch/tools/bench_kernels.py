"""Time the port's kernels at the shapes their paths give them, on one CUDA card: K1
(``fused_qk_attention``), K2 (``flash_attention``) and K3 (``gemm_sweep``, the GEMM sweep
probe's kernel).

Run from the repository root: ``python3 foley_tpu_torch/tools/bench_kernels.py``. With
``--root DIR`` it imports ``foley_tpu_torch`` from another checkout instead (for example an
older commit unpacked with ``git archive`` under ``build/``), so that two versions of the
kernels are timed on one card in one call; the wrappers' interface is the same in both.
``--kernels k3`` times only K3 (a comma-separated list of ``k1``, ``k2``, ``k3``).

It prints the card (``nvidia-smi`` name and power limit), then one JSON line per case.
K1 and K2: the kernel's device time a launch (CUDA events around a queue of launches held
behind a GPU spin, so the host's launch cost stays hidden), the wrapper's host time a launch
(the same loop on the host clock), the one PyTorch call of the same function
(``library_ms``), and the kernel's largest error against its plain version. K3, at the
probe's shape (that tree's ``tools/probe_gemm.py``: its inputs, timers and library sweep):
the sweep's device time from CUDA-graph replays and eager, the wrapper's host time a sweep,
the library sweep's graph time, the error against the plain version, and the sweep cut to
``K3_BLOCKS`` weight blocks, whose slope against the intercept separates a block's work from
the fixed cost a launch or a sweep. It exits non-zero without a card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU spin while the host enqueues a timed loop
ITERS = 200                 # timed launches of a K1 case (a quarter of it for K2's)

# K1: (batch, length, heads, visual rows of a joint [v_cond; audio] sequence or 0)
K1_CASES = {"joint_5s": (2, 290, 12, 40), "single_5s": (2, 250, 12, 0), "l64": (2, 64, 12, 0),
            "l128": (2, 128, 12, 0), "joint_30s": (2, 1740, 12, 240)}
# K2: (batch, lq, lk, heads, head_dim)
K2_CASES = {"siglip2_5s": (40, 1024, 1024, 12, 64), "cross_1024x77": (2, 1024, 77, 12, 128)}
# K3: the probe's shape (M, K, N, BLOCKS of tools/probe_gemm.py), and the cut sweeps
K3_SHAPE = (784, 1536, 4608, 36)
K3_BLOCKS = (1, 2, 4, 9, 36)
K3_ITERS = 50  # timed sweeps a case


def timed(torch, fn, iters: int):
    """(device ms, host ms) a call of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def k1_cases(torch, dev, iters: int):
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.rope import rope_table

    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (b, length, h, visual) in K1_CASES.items():
        d = 128
        q, k, v = (torch.randn(b, length, h, d, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(3))

        def weights():  # one [D] weight per stream, per-position as the joint blocks build it
            rows = [torch.empty(d, device=dev).uniform_(0.5, 1.5, generator=gen)
                    .expand(n, d) for n in (visual, length - visual)]
            return torch.cat(rows).contiguous()

        wq, wk = weights(), weights()
        cos, sin = rope_table(length, d, device=dev)
        args = (q, k, v, wq, wk, cos, sin, cos, sin)
        err = float((FA.fused_qk_attention(*args).float()
                     - FA.fused_qk_attention_plain(*args).float()).abs().max())

        def library_call():
            qn = FA._norm_rope(q, wq, cos, sin, 1e-6).transpose(1, 2)
            kn = FA._norm_rope(k, wk, cos, sin, 1e-6).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                qn, kn, v.transpose(1, 2)).transpose(1, 2)

        ms, host_ms = timed(torch, lambda: FA.fused_qk_attention(*args), iters)
        yield {"kernel": "fused_qk_attention", "case": name, "b": b, "l": length, "h": h,
               "visual": visual, "kernel_ms": ms, "host_ms": host_ms,
               "library_ms": timed(torch, library_call, max(iters // 10, 5))[0],
               "max_abs_err": err}


def k2_cases(torch, dev, iters: int):
    from foley_tpu_torch.ops.kernels import flash_attention as FL

    gen = torch.Generator(device=dev).manual_seed(2)
    for name, (b, lq, lk, h, d) in K2_CASES.items():
        q = torch.randn(b, lq, h, d, device=dev, generator=gen).to(torch.bfloat16)
        k, v = (torch.randn(b, lk, h, d, device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(2))
        err = float((FL.flash_attention(q, k, v).float()
                     - FL.flash_attention_plain(q, k, v).float()).abs().max())

        def library_call():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)

        ms, host_ms = timed(torch, lambda: FL.flash_attention(q, k, v), iters)
        yield {"kernel": "flash_attention", "case": name, "b": b, "lq": lq, "lk": lk, "h": h,
               "d": d, "kernel_ms": ms, "host_ms": host_ms,
               "library_ms": timed(torch, library_call, max(iters // 4, 5))[0],
               "max_abs_err": err}


def k3_cases(torch, dev, iters: int):
    from foley_tpu_torch.ops.kernels import gemm_sweep as GS
    from foley_tpu_torch.tools import probe_gemm as PG

    shape = (PG.M, PG.K, PG.N, PG.BLOCKS)
    if shape != K3_SHAPE:
        raise RuntimeError(f"the probe's shape is {shape}, the bench's {K3_SHAPE}")
    x, w = PG.make_inputs(dev)
    err = float((GS.gemm_sweep(x, w).float() - GS.gemm_sweep_plain(x, w).float()).abs().max())

    def sweep(blocks):
        wb = w[:blocks]
        return lambda: GS.gemm_sweep(x, wb)

    before = GS.gemm_sweep.launches
    GS.gemm_sweep(x, w)
    launches = GS.gemm_sweep.launches - before
    ms, host_ms = timed(torch, sweep(PG.BLOCKS), iters)
    yield {"kernel": "gemm_sweep", "case": "probe_full", "m": PG.M, "k": PG.K, "n": PG.N,
           "blocks": PG.BLOCKS, "launches_per_sweep": launches,
           "graph_ms": PG.graph_ms(sweep(PG.BLOCKS), iters, dev), "kernel_ms": ms,
           "host_ms": host_ms,
           "library_graph_ms": PG.graph_ms(lambda: PG.library_sweep(x, w), iters, dev),
           "max_abs_err": err}
    for blocks in K3_BLOCKS:
        yield {"kernel": "gemm_sweep", "case": f"blocks_{blocks}", "blocks": blocks,
               "graph_ms": PG.graph_ms(sweep(blocks), iters, dev),
               "kernel_ms": timed(torch, sweep(blocks), iters)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose foley_tpu_torch is timed (default: this one)")
    ap.add_argument("--kernels", default="k1,k2,k3", help="which kernels: k1, k2, k3")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    import foley_tpu_torch

    check = Path(foley_tpu_torch.__file__).resolve().parents[1]
    if str(check) != root:
        raise RuntimeError(f"imported foley_tpu_torch from {check}, not from {root}")
    cases = {"k1": lambda: k1_cases(torch, dev, ITERS),
             "k2": lambda: k2_cases(torch, dev, ITERS // 4),
             "k3": lambda: k3_cases(torch, dev, K3_ITERS)}
    for name in args.kernels.split(","):
        for rec in cases[name]():
            rec["root"] = root
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
