"""The yardstick's operation counts (``port_bench/flops``) against
``torch.utils.flop_counter.FlopCounterMode``'s count of the reference: the denoiser's
forward at TINY on the CPU and at XXL and XL width (one triple and one single block, on the
meta device), the DAC decode at TINY and at the codec's full width."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops
from port_bench.reference import dac, layout, mmdit, sampling

from conftest import DATA, ROOT


def config(name):
    path = DATA / "tiny.json" if name == "tiny" else ROOT / "port_bench" / "configs" / f"{name}.json"
    return json.loads(path.read_text())


def zeros(entries, device):
    return {k: torch.zeros(shape, device=device) for k, shape, _, _ in entries}


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name,device,depth", [
    ("tiny", "cpu", None), ("xxl", "meta", (1, 1)), ("xl", "meta", (1, 1))])
@pytest.mark.parametrize("duration", [1.0, 5.0, 30.0])
def test_denoiser_flops(name, device, depth, duration):
    c = config(name)
    m = dict(c["model"])
    if depth:
        m["depth_triple_blocks"], m["depth_single_blocks"] = depth
    la, lv, ls = sampling.t2a_lengths(c["pipeline"], duration)
    rows = 2
    W = zeros(layout.mmdit_entries(m), device)
    args = [torch.zeros(rows, la, m["audio_vae_latent_dim"], device=device),
            torch.zeros(rows, device=device),
            torch.zeros(rows, 77, m["condition_dim"], device=device),
            torch.zeros(rows, lv, m["clip_dim"], device=device),
            torch.zeros(rows, ls, m["sync_feat_dim"], device=device)]
    got = counted(lambda: mmdit.forward(W, m, *args))
    assert got == flops.denoiser_flops(m, la, lv, 77, ls, rows)


@pytest.mark.parametrize("name,device,frames", [("tiny", "cpu", 50), ("xxl", "meta", 250),
                                                ("xxl", "meta", 1500)])
def test_decode_flops(name, device, frames):
    d = config(name)["dac"]
    W = zeros(layout.dac_entries(d), device)
    z = torch.zeros(1, frames, d["latent_dim"], device=device)
    assert counted(lambda: dac.decode(W, d, z)) == flops.decode_flops(d, frames, 1)


def test_k1_counts():
    m = config("xxl")["model"]
    (nt, jb, jf), (ns, sb, sf) = flops.k1_step(m, 250, 40, 2)
    assert (nt, ns) == (18, 36)
    assert jf == 4 * 2 * 12 * 290 * 290 * 128 and sf == 4 * 2 * 12 * 250 * 250 * 128
    assert jb == 4 * 2 * 290 * 12 * 128 * 2 + 2 * 290 * 128 * 4 + 2 * 2 * 128 * 4
    # bytes bind the 5 s calls, operations the 30 s ones (PERF.md's kernel table)
    assert jb / flops.HBM_BYTES_PER_S > jf / flops.BF16_FLOPS
    _, b30, f30 = flops.k1_step(m, 1500, 240, 2)[0]
    assert f30 / flops.BF16_FLOPS > b30 / flops.HBM_BYTES_PER_S


def test_parameter_counts():
    assert layout.count(layout.mmdit_entries(config("xxl")["model"])) == 5_134_014_848
    assert layout.count(layout.mmdit_entries(config("xl")["model"])) == 2_912_962_688
