"""The port's DAC codec against the JAX ``dac_vae`` at the TINY DAC (real rates, hop 960), on
the CPU, in fp32 with TF32 off: ``decode`` / ``decode_chunked``, ``encode`` with its
posterior, and ``preprocess``.

Tolerance atol 5e-5 / rtol 1e-4: about twenty fp32 convolutions in a row, summed in another
order by each framework. The He-scaled random decoder amplifies its input by orders of
magnitude and would leave nearly every sample in tanh saturation, where a rounding
difference flips a sample's sign near a zero crossing; the test scales every conv weight by
0.65, which keeps the output's std near 0.2. The encode is held to the same tolerance: about
twenty fp32 convolutions too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import dac_vae as jdac
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import dac_from_jax
from foley_tpu_torch.models import dac_vae as tdac
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CFG, J_CFG = TINY.dac, J_TINY.dac
TOL = dict(atol=5e-5, rtol=1e-4)
W_SCALE = 0.65


@pytest.fixture(scope="module")
def models():
    params = jax.device_get(jax.jit(jdac.init, static_argnums=1)(jax.random.PRNGKey(0), J_CFG))
    rng = np.random.default_rng(0)

    def fill(path, x):
        # alphas (ones at init) and biases (zeros) made random, so every parameter matters
        if path[-1].key == "w":
            return x * W_SCALE
        if np.all(x == 1):
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)

    params = jax.tree_util.tree_map_with_path(fill, params)
    return params, dac_from_jax(params, CFG, device="cpu")


decode_jax = jax.jit(jdac.decode, static_argnames="cfg")
decode_chunked_jax = jax.jit(jdac.decode_chunked,
                             static_argnames=("cfg", "chunk_frames", "overlap_frames"))


def _latents(b, t, seed):
    return np.random.default_rng(seed).normal(size=(b, t, CFG.latent_dim)).astype(np.float32)


def test_decode_matches_jax(models):
    params, dac = models
    z = _latents(2, 25, 1)
    ref = np.asarray(decode_jax(params, jnp.asarray(z), cfg=J_CFG))
    got = tdac.decode(dac, torch.from_numpy(z))
    assert got.shape == (2, 25 * CFG.hop_length, 1) and got.dtype == torch.float32
    assert 0.05 < float(np.std(ref)) < 0.9  # signal, not saturation
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("t,chunk", [(200, 48), (96, 48), (40, 48), (113, 37)])
def test_decode_chunked_matches_jax(models, t, chunk):
    params, dac = models
    z = _latents(1, t, 2)
    ref = np.asarray(decode_chunked_jax(params, jnp.asarray(z), cfg=J_CFG, chunk_frames=chunk,
                                        overlap_frames=16))
    got = tdac.decode_chunked(dac, torch.from_numpy(z), chunk, overlap_frames=16).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
    # exact against the port's own full decode too (overlap >> receptive field)
    np.testing.assert_allclose(got, tdac.decode(dac, torch.from_numpy(z)).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_init_is_he_scaled():
    dac = tdac.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    w = dac.decoder.blocks[0].res[0].conv1.weight  # [out, in, 7]
    std = (2.0 / (w.shape[1] * 7)) ** 0.5
    assert float(w.abs().max()) <= 2 * std + 1e-6
    assert 0.6 * std < float(w.std()) < 1.0 * std  # truncation at 2 std leaves ~0.88 std
    assert not dac.decoder.conv_in.bias.any()


encode_jax = jax.jit(jdac.encode, static_argnames="cfg")


def _audio(b, frames, seed):
    t = np.arange(frames * CFG.hop_length) / CFG.sample_rate
    rng = np.random.default_rng(seed)
    tone = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * rng.uniform(50, 4000) * t
                                              + rng.uniform(0, 6)) for _ in range(4))
    return (tone + 0.05 * rng.normal(size=(b, t.size))).astype(np.float32)[..., None]


def test_encode_matches_jax(models):
    params, dac = models
    wav = _audio(2, 12, 3)  # [2, 12 * hop, 1]
    ref = encode_jax(params, jnp.asarray(wav), cfg=J_CFG)
    got = tdac.encode(dac, torch.from_numpy(wav))
    assert got.mean.shape == (2, 12, CFG.latent_dim) and got.mean.dtype == torch.float32
    assert float(np.std(np.asarray(ref.mean))) > 1e-2  # a signal reaches the latents
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), **TOL)
    np.testing.assert_allclose(got.logvar.numpy(), np.asarray(ref.logvar), **TOL)
    assert got.mode() is got.mean
    np.testing.assert_allclose(got.std.numpy(), np.asarray(ref.std), **TOL)
    np.testing.assert_allclose(got.kl().numpy(), np.asarray(ref.kl()), **TOL)


def test_posterior_clamps_logvar_and_samples_with_injected_noise():
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(2, 5, CFG.latent_dim)).astype(np.float32)
    logvar = rng.uniform(-40.0, 30.0, mean.shape).astype(np.float32)
    ref = jdac.GaussianPosterior(jnp.asarray(mean), jnp.clip(jnp.asarray(logvar), -30.0, 20.0))
    got = tdac.GaussianPosterior(torch.from_numpy(mean),
                                 torch.clamp(torch.from_numpy(logvar), -30.0, 20.0))
    np.testing.assert_allclose(got.kl().numpy(), np.asarray(ref.kl()), rtol=1e-5)
    # the port's draw, injected into the JAX formula (jax.random gives other bits)
    sample = got.sample(torch.Generator().manual_seed(7))
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(7))
    np.testing.assert_allclose(sample.numpy(), np.asarray(ref.mean + ref.std * noise.numpy()),
                               rtol=1e-6, atol=1e-6)
    assert not torch.equal(sample, got.sample(torch.Generator().manual_seed(8)))


@pytest.mark.parametrize("samples", [1, 959, 960, 961, 5000])
def test_preprocess_pads_to_a_hop_multiple(samples):
    wav = np.random.default_rng(samples).normal(size=(2, samples, 1)).astype(np.float32)
    got = tdac.preprocess(torch.from_numpy(wav), CFG).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdac.preprocess(jnp.asarray(wav), J_CFG)))
    assert got.shape[1] % CFG.hop_length == 0


def test_bridge_loads_the_whole_tree(models):
    """Every JAX leaf, encoder and ``quant_conv`` included, lands in the port's module."""
    params, dac = models
    leaves = jax.tree_util.tree_leaves(params)
    assert sum(x.size for x in leaves) == sum(p.numel() for p in dac.parameters())
    assert len(leaves) == len(dac.state_dict())
    np.testing.assert_array_equal(
        dac.quant_conv.weight.numpy(), np.asarray(params["quant_conv"]["w"]).transpose(2, 1, 0))
