"""The port's SDEdit (``pipeline/edit.py::edit_audio``) against the JAX ``edit_audio`` at the
TINY config on the CPU, in fp32: the same weights on both sides (``io/from_jax.py``; the
denoiser's drawn by the port's ``init``, ``torch_helpers.py``, the DAC's by the JAX ``init``;
the denoiser's zero leaves and the DAC's alphas and biases made random, its conv weights
scaled by 0.65 so the decode stays out of tanh saturation) and the same renoising draw (the
JAX draw, injected into the port: ``jax.random`` and a ``torch.Generator`` give other bits
for one seed). Each side's final latents are read at its decode's input.

Tolerance: final latents atol 5e-5 / rtol 1e-4 (the denoise tests' tolerance, with the
encoder's own fp32 error carried through); audio atol 5e-5 / rtol 1e-4, the DAC decode's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import dac_vae as jdac
from foley_tpu.models import mmdit as jmm
from foley_tpu.pipeline import edit as jedit
from foley_tpu.pipeline import generate as jgen
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import dac_from_jax, mmdit_from_jax
from foley_tpu_torch.models import dac_vae as tdac
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.pipeline import edit as tedit
from foley_tpu_torch.pipeline import generate as tgen
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

LATENT_TOL = dict(atol=5e-5, rtol=1e-4)
AUDIO_TOL = dict(atol=5e-5, rtol=1e-4)
STEPS = 5
SR = TINY.dac.sample_rate


def _seeded(params, rng, scale_w=1.0):
    def fill(path, x):
        x = np.array(x)
        if path[-1].key == "w":
            x = x * scale_w
        if not np.any(x):
            return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
        if path[-1].key in ("alpha", "alpha1", "alpha2", "alpha_out"):
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(fill, jax.device_get(params))


@pytest.fixture(scope="module")
def bundles():
    rng = np.random.default_rng(21)
    mm = _seeded(jax_tree_from_port(tmm.init(TINY.model, torch.Generator().manual_seed(0),
                                             device="cpu"), jmm.init, J_TINY.model), rng)
    dac = _seeded(jax.jit(jdac.init, static_argnums=1)(jax.random.PRNGKey(1), J_TINY.dac), rng,
                  scale_w=0.65)
    return (jgen.ModelBundle(mm, dac, J_TINY, compute_dtype=jnp.float32),
            tgen.ModelBundle(mmdit_from_jax(mm, TINY.model, device="cpu"),
                             dac_from_jax(dac, TINY.dac, device="cpu"), TINY,
                             compute_dtype=torch.float32))


def _capture(monkeypatch, module, name, index, store):
    """Wrap ``module.name`` so its positional argument ``index`` is kept in ``store``."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        store.append(np.asarray(args[index]))
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapper)


@pytest.mark.parametrize("strength", [0.6, 1.0])
def test_edit_audio_matches_jax(bundles, monkeypatch, strength):
    j_bundle, t_bundle = bundles
    rng = np.random.default_rng(5)
    n = SR + 700  # off the hop grid: both sides pad, decode, and trim back to n
    t = np.arange(n) / SR
    src = (0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.normal(size=n)).astype(np.float32)
    text, neg = (rng.normal(size=(1, 16, 16)).astype(np.float32) for _ in range(2))
    kw = dict(strength=strength, guidance_scale=4.5, num_inference_steps=STEPS, seed=3)

    j_latents, t_latents = [], []
    _capture(monkeypatch, jedit, "_decode_jit", 1, j_latents)
    ref = jedit.edit_audio(j_bundle, src, jnp.asarray(text), jnp.asarray(neg), **kw)

    def jax_noise(gen, b, length, dim):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(3),
                                                           (b, length, dim), jnp.float32)))

    monkeypatch.setattr(tedit, "prepare_latents", jax_noise)
    _capture(monkeypatch, tdac, "decode", 1, t_latents)
    got = tedit.edit_audio(t_bundle, src, torch.from_numpy(text), torch.from_numpy(neg), **kw)

    assert got.audio_batch.shape == ref.audio_batch.shape == (1, 1, n)
    (j_lat,), (t_lat,) = j_latents, t_latents
    assert t_lat.shape == (1, -(-n // TINY.dac.hop_length), TINY.model.audio_vae_latent_dim)
    np.testing.assert_allclose(t_lat, j_lat, **LATENT_TOL)
    np.testing.assert_allclose(got.audio_batch, np.asarray(ref.audio_batch), **AUDIO_TOL)
    assert 0.01 < float(np.std(got.audio_batch)) < 0.95  # a signal, not saturation


class _Planned(Exception):
    pass


def test_strength_selects_the_resume_step(bundles, monkeypatch):
    """``begin_index = round((1 - strength) * steps)``, clamped to [0, steps - 1]: the plan
    alone, read where the denoise would start (the runs themselves are held above)."""
    _, t_bundle = bundles
    seen = []

    def spy(*args, begin_index, **kw):
        seen.append(begin_index)
        raise _Planned

    monkeypatch.setattr(tedit, "denoise_latents", spy)
    monkeypatch.setattr(tedit, "encode_latents", lambda bundle, wav: torch.zeros(
        wav.shape[0], wav.shape[1] // TINY.dac.hop_length, TINY.model.audio_vae_latent_dim))
    src = np.zeros(SR, np.float32)
    text = torch.zeros(1, 16, 16)
    for strength in (1.0, 0.6, 0.25, 0.01):
        with pytest.raises(_Planned):
            tedit.edit_audio(t_bundle, src, text, text, strength=strength, guidance_scale=1.0,
                             num_inference_steps=STEPS, seed=0)
    assert seen == [0, 2, 4, 4]
    with pytest.raises(ValueError, match="strength"):
        tedit.edit_audio(t_bundle, src, text, text, strength=0.0)
