"""A run of each kind of cell, its look for a card skipped, at TINY on the CPU: ``correct``
comes out true on the program as it is, and false with the timed path broken underneath
(``faults.py``), once for each fault such a cell can have:
- a solver step that returns its state unchanged;
- half of the batch left out: the unconditional CFG half (every cell), and the second half
  of a served group's rows answered with the first half's audio;
- the guidance scale half a unit off;
- an answer altered where it is produced (the audio the entry hands back).
One card, so no exchange between chips can be left out."""

import time

import pytest
import torch

from port_bench import faults, harness

from conftest import DATA

SEED = 2 ** 32 + 5


def run_cell(cell):
    return harness.execute(str(DATA / f"{cell}.json"), SEED, 0.5, False, torch.device("cpu"),
                           time.monotonic(), metrics=["audio_s_per_s", "request_s", "setup_s"],
                           log=lambda s: None)


@pytest.mark.parametrize("cell", ["tiny-t2a", "tiny-served"])
def test_the_program_as_it_is_is_correct(cell):
    out = run_cell(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    ("tiny-t2a", "step_unchanged"), ("tiny-t2a", "uncond_dropped"),
    ("tiny-t2a", "guidance_wrong"), ("tiny-t2a", "altered"),
    ("tiny-served", "step_unchanged"), ("tiny-served", "uncond_dropped"),
    ("tiny-served", "guidance_wrong"), ("tiny-served", "half_batch"),
    ("tiny-served", "altered")])
def test_a_fault_is_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        out = run_cell(cell)
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]
