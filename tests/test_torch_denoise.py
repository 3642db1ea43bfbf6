"""The port's denoise loop against the JAX package's, at the TINY config, on the CPU.

Both sides get the same weights (through ``io/from_jax.py``, zero leaves made random), the
same CFG-stacked features and the same initial noise, drawn with numpy: ``jax.random`` and a
``torch.Generator`` give different bits for one seed. The loop runs in fp32 on both sides
(atol 2e-5 / rtol 1e-4 after four steps of a model whose outputs agree to 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import dac_vae as jdac
from foley_tpu.models import mmdit as jmm
from foley_tpu.sampling import denoise as jden
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import dac_from_jax, mmdit_from_jax
from foley_tpu_torch.sampling import denoise as tden
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=2e-5, rtol=1e-4)
STEPS = 4
T_LAT = 20


def _seeded(params, rng, scale_w=1.0):
    def fill(path, x):
        x = np.array(x)
        if path[-1].key == "w":
            x = x * scale_w
        if not np.any(x):
            return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
        if path[-1].key in ("weight", "alpha", "alpha1", "alpha2", "alpha_out"):
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return x.astype(x.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(params))


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(5)
    params = _seeded(jax.jit(jmm.init, static_argnums=1)(jax.random.PRNGKey(0), J_TINY.model), rng)
    # conv weights scaled so the random decoder stays out of tanh saturation (test_torch_dac)
    dac_params = _seeded(jax.jit(jdac.init, static_argnums=1)(jax.random.PRNGKey(1), J_TINY.dac),
                         rng, scale_w=0.65)
    return (params, mmdit_from_jax(params, TINY.model, device="cpu"),
            dac_params, dac_from_jax(dac_params, TINY.dac, device="cpu"))


def _data(shared_visuals=False, seed=6):
    rng = np.random.default_rng(seed)
    c = TINY.model
    latents = rng.normal(size=(1, T_LAT, c.audio_vae_latent_dim)).astype(np.float32)
    cond = rng.normal(size=(2, 8, c.condition_dim)).astype(np.float32)
    clip = rng.normal(size=(2, 4, c.clip_dim)).astype(np.float32)
    sync = rng.normal(size=(2, 8, c.sync_feat_dim)).astype(np.float32)
    if shared_visuals:
        clip, sync = np.repeat(clip[:1], 2, 0), np.repeat(sync[:1], 2, 0)
    known = rng.normal(size=(1, 5, c.audio_vae_latent_dim)).astype(np.float32)
    return latents, (cond, clip, sync), known


def _both(models, solver, *, known_frames=0, begin_index=0, shared=False):
    params, model, _, _ = models
    latents, feats, known = _data(shared)
    kw = dict(num_steps=STEPS, solver=solver, begin_index=begin_index, known_frames=known_frames,
              visual_rows_shared=shared)
    ref = jden.denoise_latents(
        params, jnp.asarray(latents), jden.DenoiseFeatures(*map(jnp.asarray, feats)),
        jnp.float32(4.5), jnp.asarray(known) if known_frames else None, cfg=J_TINY.model,
        diffusion=J_TINY.diffusion, attn_impl="xla", compute_dtype=jnp.float32, **kw)
    got = tden.denoise_latents(
        model, torch.from_numpy(latents), tden.DenoiseFeatures(*map(torch.from_numpy, feats)),
        4.5, torch.from_numpy(known) if known_frames else None, diffusion=TINY.diffusion,
        compute_dtype=torch.float32, **kw)
    return got.numpy(), np.asarray(ref), latents, known


@pytest.mark.parametrize("solver", ["euler", "heun-2", "midpoint-2", "kutta-4"])
def test_denoise_latents_matches_jax(models, solver):
    got, ref, latents, _ = _both(models, solver)
    assert float(np.abs(ref - latents).max()) > 0.1  # the model moved the sample
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("solver", ["euler", "kutta-4"])
def test_known_frames_matches_jax(models, solver):
    got, ref, _, known = _both(models, solver, known_frames=5)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got[:, :5], known)  # the final hard set


def test_begin_index_and_shared_visuals_match_jax(models):
    got, ref, _, _ = _both(models, "heun-2", begin_index=2, shared=True)
    np.testing.assert_allclose(got, ref, **TOL)


def test_denoise_and_decode_pcm16_matches_jax(models):
    """int16 PCM after clip, *32767 and round half to even on both sides: equal except one
    LSB on at most 1% of samples (an fp32 difference of ~1e-6 in the waveform crosses a
    rounding boundary of the 1/32767 grid on a few samples)."""
    params, model, dac_params, dac = models
    latents, feats, _ = _data()
    _, ref = jden.denoise_and_decode(
        params, dac_params, jnp.asarray(latents), jden.DenoiseFeatures(*map(jnp.asarray, feats)),
        jnp.float32(4.5), cfg=J_TINY.model, diffusion=J_TINY.diffusion, dac_cfg=J_TINY.dac,
        num_steps=STEPS, attn_impl="xla", compute_dtype=jnp.float32, output_pcm16=True)
    _, got = tden.denoise_and_decode(
        model, dac, torch.from_numpy(latents), tden.DenoiseFeatures(*map(torch.from_numpy, feats)),
        4.5, diffusion=TINY.diffusion, dac_cfg=TINY.dac, num_steps=STEPS,
        compute_dtype=torch.float32, output_pcm16=True)
    ref, got = np.asarray(ref).astype(np.int32), got.numpy().astype(np.int32)
    assert got.shape == ref.shape == (1, T_LAT * TINY.dac.hop_length, 1)
    assert np.std(ref) > 1000  # an audible signal, not silence
    diff = np.abs(got - ref)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.01


def test_prepare_latents_is_seeded():
    a = tden.prepare_latents(torch.Generator().manual_seed(3), 2, 7, 4)
    b = tden.prepare_latents(torch.Generator().manual_seed(3), 2, 7, 4)
    assert a.shape == (2, 7, 4) and a.dtype == torch.float32 and torch.equal(a, b)
