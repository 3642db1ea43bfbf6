"""The controls and CFG faults the limits are set from, at TINY on the CPU
(``controls.readings``): the program with its fp8 weight storage switched on, and the
program with its unconditional CFG half left out or its guidance scale off, each land
farther from the reference than the program as the configuration states it. On the card
the same readings are taken at each cell's own size (``python3 port_bench/controls.py``);
PERF.md gives them."""

import pytest
import torch

from port_bench import controls

from conftest import DATA


@pytest.mark.parametrize("cell,number", [("tiny-t2a", "latent_rel_err"),
                                         ("tiny-served", "pcm_rel_err")])
def test_the_fp8_control_reads_higher(cell, number):
    got = dict(controls.readings(str(DATA / f"{cell}.json"), 2 ** 31 + 3,
                                 torch.device("cpu"), True))
    assert got["program"][number] < 1e-4  # the program in fp32
    for side in ("control_fp8", "fault_uncond_dropped", "fault_guidance_wrong"):
        assert got[side][number] > 100 * got["program"][number], side
