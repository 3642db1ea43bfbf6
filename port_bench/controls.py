"""The readings the limits of ``correct`` are set from: the program's numbers, its control's
and its CFG faults' on given seeds, each at the cell's own sizes and load, in one process.

    python3 port_bench/controls.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed it sets the cell up as a run does (``harness.load``, ``harness.set_up``),
runs as many requests as a run compares (the traffic's ``window`` with a vanishing length,
repeated, on the same request seeds for every side), and prints one JSON line of the
compared numbers for each side. ``--seeds`` reads the program alone; ``--control-seeds``
reads every side:
- ``program``: the program as the configuration states it;
- ``fault_uncond_dropped``, ``fault_guidance_wrong``: the program with a CFG fault planted
  (``faults.py``);
- ``control_fp8``: the program with its own lower-precision path switched on, the
  denoiser's weights stored in fp8 e4m3 (``io/quantize.py``, ``--quantization fp8_e4m3fn``:
  the step below the configuration's bf16);
- ``control_tf32_decode`` (cells whose entry returns latents): the reference's decode of
  the program's latents with TF32 let in, the step below the codec's fp32, judged as the
  program's decode is.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell_name: str, seed: int, device, control: bool):
    """[(side, {check: value})] of one seed: the program's, and with ``control`` its
    faults' and controls'."""
    import numpy as np
    import torch

    from port_bench import compare, faults, harness

    run, traffic = harness.load(cell_name, seed, device, time.monotonic())
    harness.set_up(run, traffic)
    check = run.cell["check"]
    n = check.get("requests", 0) or check.get("groups", 0) * run.params.get("max_batch", 1)

    def requests():
        run.restart_seeds(2)
        run.requests, run.groups = [], []
        while len(run.requests) < n:
            traffic.window(run, 1e-3)
        return run.requests, run.groups

    sides = {"program": requests()}
    if control:
        from foley_tpu_torch.io.quantize import quantize_params

        for name in faults.CFG:
            with faults.FAULTS[name]():
                sides[f"fault_{name}"] = requests()
        quantize_params(run.bundle.mmdit, "fp8_e4m3fn")
        sides["control_fp8"] = requests()
    if hasattr(traffic, "close"):
        traffic.close(run)
    run.free_program()
    out = []
    for side, (run.requests, run.groups) in sides.items():
        out.append((side, {c.name: c.value for c in traffic.judge(run)}))
    if control and run.cell["traffic"] != "served":
        run.requests, run.groups = sides["program"]
        D = compare.codec_weights(run)
        lat = torch.from_numpy(np.stack([r.latents for r in run.requests])).to(device)
        exact = compare.decode_pcm(run, D, lat)
        tf32 = compare.decode_pcm(run, D, lat, tf32=True)
        out.append(("control_tf32_decode", {"decode_rel_err": max(
            compare.rel(tf32[i], exact[i]) for i in range(len(run.requests)))}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        for side, values in readings(args.workload, seed, dev, seed in controls):
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
