"""On the card (marked ``card``; they skip without one): one traced run of the first cell
through the benchmark's command line, and the controls and CFG faults the cell's
limits stand between. Run them with ``python -m pytest port_bench/tests -m card -q`` from
the root of a checkout on a machine with the card (about 5 minutes)."""

import json
import subprocess
import sys

import pytest

from port_bench import controls, harness

from conftest import ROOT

CELL = "xxl-t2a-5s"


@pytest.mark.card
def test_a_traced_run(cuda_device):
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELL, "--seed", str(2 ** 31 + 101),
         "--seconds", "3", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(out["metrics"]) == set(harness.metric_names(bench, CELL, True))
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
    assert 0 < out["metrics"]["k1_roofline"]["value"] < 100
    assert 0 < out["metrics"]["mfu"]["value"] < 100
    assert out["breakdown"]["device_ops"] and list(out)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.card
def test_the_controls_fail_the_limits(cuda_device):
    limits = json.loads(harness.cell_file(CELL).read_text())["check"]["limits"]
    got = dict(controls.readings(CELL, 2 ** 31 + 102, cuda_device, True))
    assert got["program"]["latent_rel_err"] < limits["latent_rel_err"]
    for side in ("control_fp8", "fault_uncond_dropped", "fault_guidance_wrong"):
        assert got[side]["latent_rel_err"] > limits["latent_rel_err"], side
    assert got["program"]["decode_rel_err"] < limits["decode_rel_err"]
    assert got["control_tf32_decode"]["decode_rel_err"] > limits["decode_rel_err"]
