"""K1's share of its roofline: the sum of each of the window's K1 calls' least time (bytes
at 3.35 TB/s or operations at 989 TFLOP/s, the larger; ``flops.k1_step``, from the cell's
lengths and each generation's rows, doubled by CFG) over the summed device time of the
``fused_qk_attention`` kernels in the trace, in percent. The calls the shapes give are
checked against the wrapper's launch counter and the trace's kernel count: where the three
disagree, the shapes are not what ran, and the metric is left out (None)."""

import sys

from port_bench import flops
from port_bench.reference.sampling import t2a_lengths


def read(run):
    if run.trace is None:
        return None
    seconds, count = run.trace.seconds_of(lambda n: "fused_qk_attention" in n)
    if not count:
        return None
    m, p = run.config["model"], run.params
    la, lv, _ = t2a_lengths(run.config["pipeline"], p["duration_s"])
    bound, calls = 0.0, 0
    for g in run.groups:
        for n, b, f in flops.k1_step(m, la, lv, 2 * g.rows):
            bound += p["steps"] * n * flops.least_s(b, f)
            calls += p["steps"] * n
    if not (calls == run.counters.get("k1_launches") == count):
        print(f"k1_roofline: {calls} calls by the shapes, {run.counters.get('k1_launches')} "
              f"counted by the wrapper, {count} kernels in the trace: left out", file=sys.stderr)
        return None
    return 100.0 * bound / seconds
