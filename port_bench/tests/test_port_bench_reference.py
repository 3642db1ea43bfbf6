"""The frozen reference agrees with the port at TINY on the CPU, in fp32, on the same
checkpoint-layout weights (the port's through its converter): the denoiser's velocity at the
T2A shapes of several durations, the DAC decode, and a whole generation's final latents.
This test imports both; the reference itself imports nothing of the port."""

import json

import numpy as np
import pytest
import torch

from port_bench import weights
from port_bench.reference import dac as ref_dac
from port_bench.reference import mmdit as ref_mmdit
from port_bench.reference import sampling

from conftest import DATA

CONFIG = json.loads((DATA / "tiny.json").read_text())
SEED = 2 ** 33 + 7  # wider than 32 bits, as a check's seeds may be


def port_models(seed):
    from foley_tpu_torch.io.convert import (convert_dac_state_dict, convert_mmdit_state_dict,
                                            module_from_state_dict)
    from foley_tpu_torch.models.dac_vae import DAC
    from foley_tpu_torch.models.mmdit import MMDiT
    from port_bench.harness import Run

    run = Run({"params": {}}, CONFIG, seed, torch.device("cpu"), 0.0)
    cfg = run.pipeline_cfg()
    sd = weights.mmdit(CONFIG["model"], seed, "cpu", torch.float32)
    model = module_from_state_dict(MMDiT, convert_mmdit_state_dict(dict(sd), cfg.model, strict=True),
                                   cfg.model, "cpu", torch.float32)
    dsd = weights.dac(CONFIG["dac"], CONFIG["weights"]["dac_gains"], seed, "cpu")
    dac = module_from_state_dict(DAC, convert_dac_state_dict(dict(dsd), cfg.dac, strict=True),
                                 cfg.dac, "cpu", torch.float32)
    return cfg, model, sd, dac, dsd


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("duration", [1.0, 2.0, 5.0])
def test_velocity(duration):
    _, model, sd, _, _ = port_models(SEED)
    m = CONFIG["model"]
    la, lv, ls = sampling.t2a_lengths(CONFIG["pipeline"], duration)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, la, m["audio_vae_latent_dim"], generator=g)
    t = torch.tensor([900.0, 900.0])
    cond = torch.randn(2, 77, m["condition_dim"], generator=g)
    clip = torch.randn(2, lv, m["clip_dim"], generator=g)
    sync = torch.randn(2, ls, m["sync_feat_dim"], generator=g)
    with torch.no_grad():
        got = model(x, t, cond, clip, sync)
        ref = ref_mmdit.forward(sd, m, x, t, cond, clip, sync)
    assert rel(got, ref) < 1e-5


def test_decode():
    from foley_tpu_torch.models import dac_vae

    _, _, _, dac, dsd = port_models(SEED)
    z = torch.randn(1, 50, CONFIG["dac"]["latent_dim"], generator=torch.Generator().manual_seed(2))
    got = dac_vae.decode(dac, z)[..., 0]
    ref = ref_dac.decode(dsd, CONFIG["dac"], z)
    assert rel(got, ref) < 1e-5
    assert float(ref.abs().max()) < 0.9  # the codec's gains keep tanh off its rails


def test_generation_latents():
    from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio

    cfg, model, sd, dac, _ = port_models(SEED)
    bundle = ModelBundle(mmdit=model, dac=dac, pipeline_cfg=cfg, compute_dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    text, uncond = (torch.randn(1, 77, CONFIG["model"]["condition_dim"], generator=g)
                    for _ in range(2))
    res = generate_audio(bundle, text, uncond, 1.0, guidance_scale=4.5, num_inference_steps=4,
                         seed=11, return_latents=True)
    ref = sampling.t2a_latents(sd, CONFIG, [11], 1.0, 4, 4.5, text, uncond, "cpu")
    assert rel(torch.from_numpy(res.latents), ref) < 1e-5
    noise = sampling.initial_noise(11, ref.shape[1], ref.shape[2], "cpu")
    assert rel(ref, noise) > 0.1  # the denoiser moved the latents
    assert not np.array_equal(res.latents, noise.numpy())
