"""The port's video-to-audio path against the JAX package's, on the CPU: the host frame
utilities bit for bit, the frame-resampling indices exactly, and ``encode_video`` +
``generate_audio`` against the sampler node's ``_encode_video`` + ``generate_audio`` on the
device-preprocess route, at the TINY config in fp32.

Both sides get the same weights (through ``io/from_jax.py``, zero leaves made random) and
the same initial noise (the JAX draw, injected into the port: ``jax.random`` and a
``torch.Generator`` give different bits for one seed). Tolerance: features atol 2e-5 /
rtol 1e-4; final latents atol 5e-5 / rtol 1e-4 after three steps, the denoise test's
tolerance with the features' own error carried through.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.api.nodes import HunyuanFoleySampler
from foley_tpu.configs import TINY as J_TINY
from foley_tpu.configs import SynchformerConfig as JSyncCfg
from foley_tpu.io import images as jimg
from foley_tpu.models import dac_vae as jdac
from foley_tpu.models import mmdit as jmm
from foley_tpu.models import siglip2 as jsig
from foley_tpu.models import synchformer as jsync
from foley_tpu.ops.interp import linspace_resample_indices as j_indices
from foley_tpu.pipeline import features as jfeat
from foley_tpu.pipeline import generate as jgen
from foley_tpu.sampling import denoise as jden
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.configs import SynchformerConfig as TSyncCfg
from foley_tpu_torch.io import images as timg
from foley_tpu_torch.io.from_jax import (
    dac_from_jax,
    mmdit_from_jax,
    siglip2_from_jax,
    synchformer_from_jax,
)
from foley_tpu_torch.models import siglip2 as tsig
from foley_tpu_torch.models import synchformer as tsync
from foley_tpu_torch.ops.interp import linspace_resample_indices
from foley_tpu_torch.pipeline import features as tfeat
from foley_tpu_torch.pipeline import generate as tgen
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

FEAT_TOL = dict(atol=2e-5, rtol=1e-4)
LATENT_TOL = dict(atol=5e-5, rtol=1e-4)
STEPS = 3


@pytest.mark.parametrize("in_lens", [range(1, 100), range(100, 400, 7), [499, 750, 1500]])
def test_linspace_resample_indices_equals_jax(in_lens):
    outs = list(range(1, 33)) + [40, 47, 63, 125, 240, 250, 400]
    for a in in_lens:
        for b in outs:
            np.testing.assert_array_equal(linspace_resample_indices(a, b),
                                          np.asarray(j_indices(a, b)), err_msg=f"({a}, {b})")


@pytest.mark.parametrize("in_len,out_len", [(3, 15), (250, 250), (125, 40), (125, 125)])
def test_linspace_resample_indices_named_pairs(in_len, out_len):
    """Pairs where ``torch.linspace(...).long()`` disagrees with the JAX package, or the
    5 s clip's own resampling (125 frames at 25 fps to 8 and 25 fps)."""
    got = linspace_resample_indices(in_len, out_len)
    np.testing.assert_array_equal(got, np.asarray(j_indices(in_len, out_len)))
    if (in_len, out_len) in ((3, 15), (250, 250)):
        assert not np.array_equal(got, torch.linspace(0, in_len - 1, out_len).long().numpy())


@pytest.mark.parametrize("fps,duration,target", [(25, 5.0, 8), (25, 5.0, 25), (30, 2.0, 25),
                                                 (16, 3.0, 8), (24, 1.5, 25)])
def test_resample_frames_matches_jax(fps, duration, target):
    n = int(fps * 2.2)  # shorter than some durations: padded with the last frame
    frames = np.arange(n, dtype=np.float32)[:, None, None, None] * np.ones((1, 2, 3, 1))
    np.testing.assert_array_equal(tfeat.resample_frames(frames, fps, duration, target),
                                  jfeat.resample_frames(frames, fps, duration, target))


@pytest.mark.parametrize("shape,target", [((3, 720, 1280, 3), 224), ((2, 720, 1280, 3), 512),
                                          ((2, 1080, 1920, 3), 224), ((1, 70, 90, 3), 32),
                                          ((1, 4000, 60, 1), 3)])
def test_box_downsample_u8_is_bit_exact(shape, target):
    u8 = np.random.default_rng(shape[1]).integers(0, 256, shape, dtype=np.uint8)
    got = timg.box_downsample_u8(u8, target)
    np.testing.assert_array_equal(got, jimg.box_downsample_u8(u8, target))
    assert got.dtype == np.uint8


def test_frames_to_u8_is_bit_exact():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, (3, 8, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(timg.frames_to_u8(x), jimg.frames_to_u8(x))
    u8 = timg.frames_to_u8(x)
    assert timg.frames_to_u8(u8) is u8


def _seeded(params, rng, scale_w=1.0):
    def fill(path, x):
        x = np.array(x)
        if path[-1].key == "w":
            x = x * scale_w
        if not np.any(x):
            return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
        if path[-1].key in ("weight", "alpha", "alpha1", "alpha2", "alpha_out"):
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(fill, jax.device_get(params))


@pytest.fixture(scope="module")
def stacks():
    """The same TINY denoiser, DAC and dimension-matched tiny encoders on both sides."""
    rng = np.random.default_rng(11)
    mm = _seeded(jax.jit(jmm.init, static_argnums=1)(jax.random.PRNGKey(0), J_TINY.model), rng)
    dac = _seeded(jax.jit(jdac.init, static_argnums=1)(jax.random.PRNGKey(1), J_TINY.dac), rng,
                  scale_w=0.65)
    sig_cfg = jsig.SiglipVisionConfig(hidden_size=16, intermediate_size=32,
                                      num_hidden_layers=2, num_attention_heads=2,
                                      image_size=32, patch_size=8)
    sync_fields = dict(img_size=32, patch_size=8, temporal_patch_size=2, num_frames=16,
                       embed_dim=16, depth=2, num_heads=2, mlp_ratio=2.0)
    sig = _seeded(jsig.init(jax.random.PRNGKey(2), sig_cfg), rng)
    sync = _seeded(jsync.init(jax.random.PRNGKey(3), JSyncCfg(**sync_fields)), rng)
    j_deps = {"siglip2": jsig.Siglip2Encoder(sig, sig_cfg, preprocess="device"),
              "synchformer": jsync.SynchformerEncoder(sync, JSyncCfg(**sync_fields),
                                                      preprocess="device")}
    j_bundle = jgen.ModelBundle(mm, dac, J_TINY, compute_dtype=jnp.float32)
    t_sig_cfg = tsig.SiglipVisionConfig(**{f: getattr(sig_cfg, f)
                                           for f in sig_cfg.__dataclass_fields__})
    encoders = {
        "siglip2": tsig.Siglip2Encoder(siglip2_from_jax(sig, t_sig_cfg, device="cpu")),
        "synchformer": tsync.SynchformerEncoder(
            synchformer_from_jax(sync, TSyncCfg(**sync_fields), device="cpu")),
    }
    t_bundle = tgen.ModelBundle(mmdit_from_jax(mm, TINY.model, device="cpu"),
                                dac_from_jax(dac, TINY.dac, device="cpu"), TINY,
                                encoders=encoders, compute_dtype=torch.float32)
    return j_deps, j_bundle, t_bundle


def _jax_noise(monkeypatch, seed, latent_len):
    noise = np.array(jden.prepare_latents(jax.random.PRNGKey(seed), 1, latent_len,
                                            J_TINY.model.audio_vae_latent_dim))
    monkeypatch.setattr(tgen, "prepare_latents", lambda *a, **k: torch.from_numpy(noise))


@pytest.mark.parametrize("frame_rate,duration", [(16, 1.0), (30, 2.0)])
def test_encode_video_and_generate_match_jax(stacks, monkeypatch, frame_rate, duration):
    j_deps, j_bundle, t_bundle = stacks
    rng = np.random.default_rng(frame_rate)
    frames = rng.random((int(frame_rate * duration) - 3, 70, 90, 3)).astype(np.float32)
    j_clip, j_sync = HunyuanFoleySampler._encode_video(j_deps, frames, frame_rate, duration,
                                                       J_TINY)
    clip, sync = tfeat.encode_video(t_bundle.encoders, frames, frame_rate, duration, TINY)
    assert (clip.shape, sync.shape) == ((1, int(duration * 8), 16), tuple(j_sync.shape))
    np.testing.assert_allclose(clip.numpy(), np.asarray(j_clip), **FEAT_TOL)
    np.testing.assert_allclose(sync.numpy(), np.asarray(j_sync), **FEAT_TOL)

    text, neg = (rng.normal(size=(1, 16, 16)).astype(np.float32) for _ in range(2))
    kw = dict(num_inference_steps=STEPS, seed=5, return_latents=True, fetch_pcm16=False)
    ref = jgen.generate_audio(j_bundle, jnp.asarray(text), jnp.asarray(neg), duration,
                              clip_feat=j_clip, sync_feat=j_sync, **kw)
    _jax_noise(monkeypatch, 5, TINY.latent_length(duration))
    got = tgen.generate_audio(t_bundle, torch.from_numpy(text), torch.from_numpy(neg), duration,
                              clip_feat=clip, sync_feat=sync, **kw)
    np.testing.assert_allclose(got.latents, ref.latents, **LATENT_TOL)
    assert got.audio_batch.shape == ref.audio_batch.shape == (1, 1, int(duration * 48000))
    np.testing.assert_allclose(got.audio_batch, ref.audio_batch, atol=1e-4, rtol=0)

    t2a = tgen.generate_audio(t_bundle, torch.from_numpy(text), torch.from_numpy(neg),
                              duration, **kw)  # same noise, learned empty visuals
    assert float(np.abs(t2a.latents - got.latents).max()) > 1e-3  # the video reaches the output
