"""The port's DAC decoder against the JAX ``dac_vae.decode`` / ``decode_chunked`` at the
TINY DAC (real rates, hop 960), on the CPU, in fp32 with TF32 off.

Tolerance atol 5e-5 / rtol 1e-4: about twenty fp32 convolutions in a row, summed in another
order by each framework. The He-scaled random decoder amplifies its input by orders of
magnitude and would leave nearly every sample in tanh saturation, where a rounding
difference flips a sample's sign near a zero crossing; the test scales every conv weight by
0.65, which keeps the output's std near 0.2.
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
