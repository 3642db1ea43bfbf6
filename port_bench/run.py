"""One run of one benchmark cell of ``foley_tpu_torch`` on a CUDA card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It sets up the cell from ``--seed`` (weights, inputs), warms
up with the cell's shapes, measures for ``--seconds`` (every request started in that time
runs to its end), reads the trace with ``--trace 1``, compares the window's outputs with the
plain reference, and prints one JSON object as its last line: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), then ``checks``: each
number compared with its limit, also printed as the last lines of standard error.

It exits non-zero without printing a result when there is no CUDA card, when the program
cannot be imported, or when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.monotonic()  # the set-up's start, before the imports

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: the benchmark runs on the card only", file=sys.stderr)
        return 2
    import foley_tpu_torch  # noqa: F401  (a checkout without the program stops here)

    from port_bench import harness

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    out = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
