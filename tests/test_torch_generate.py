"""The port's generation entry points on ``device="cpu"`` at the TINY config: shapes,
determinism per seed, the PCM path and trim, and the CFG feature stacking against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.pipeline import features as jfeat
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.core.params import perturb_zero_leaves
from foley_tpu_torch.models import dac_vae, mmdit
from foley_tpu_torch.pipeline import features as tfeat
from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio, generate_audio_multi
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

STEPS = 3
SR = TINY.dac.sample_rate


@pytest.fixture(scope="module")
def bundle():
    gen = torch.Generator().manual_seed(0)
    model = perturb_zero_leaves(mmdit.init(TINY.model, gen, device="cpu"), gen)
    dac = dac_vae.init(TINY.dac, torch.Generator().manual_seed(1), device="cpu")
    return ModelBundle(model, dac, TINY, compute_dtype=torch.float32)


def _text(n=1, length=16, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, length, TINY.model.condition_dim))
                            .astype(np.float32))


def test_generate_audio_shapes_and_determinism(bundle):
    text, neg = _text(seed=1), _text(seed=2)

    def run(seed, **kw):
        return generate_audio(bundle, text, neg, 1.0, num_inference_steps=STEPS, seed=seed, **kw)

    a, b, c = run(1), run(1), run(2)
    assert a.audio_batch.shape == (1, 1, SR) and a.audio_batch.dtype == np.float32
    assert a.sample_rate == SR and np.isfinite(a.audio_batch).all()
    assert float(np.sqrt(np.mean(a.audio_batch ** 2))) > 0
    assert a.audio_batch.tobytes() == b.audio_batch.tobytes()  # same seed, same bytes
    assert not np.array_equal(a.audio_batch, c.audio_batch)
    batch = run(1, batch_size=2)
    assert batch.audio_batch.shape == (2, 1, SR)
    np.testing.assert_array_equal(batch.audio_first, batch.audio_batch[:1])


def test_pcm16_path_and_trim(bundle):
    text = _text(seed=3)
    pcm = generate_audio(bundle, text, text, 1.01, num_inference_steps=STEPS, seed=4)
    flt = generate_audio(bundle, text, text, 1.01, num_inference_steps=STEPS, seed=4,
                         fetch_pcm16=False)
    # 1.01 s holds 50 latent frames = 48000 samples, under int(1.01 * 48000) = 48480
    n = min(int(1.01 * SR), TINY.latent_length(1.01) * TINY.dac.hop_length)
    assert pcm.audio_batch.shape == flt.audio_batch.shape == (1, 1, n)
    expect = np.round(np.clip(flt.audio_batch, -1.0, 1.0) * 32767.0) / 32767.0
    np.testing.assert_array_equal(pcm.audio_batch, expect.astype(np.float32))
    short = generate_audio(bundle, text, text, 0.5, num_inference_steps=STEPS, seed=4)
    assert short.audio_batch.shape == (1, 1, SR // 2)


def test_generate_audio_multi_rows_are_independent_requests(bundle):
    texts, negs = _text(2, seed=5), _text(2, seed=6)
    multi = generate_audio_multi(bundle, texts, negs, 1.0, [7, 8], num_inference_steps=STEPS,
                                 return_latents=True)
    assert multi.audio_batch.shape == (2, 1, SR)
    for row, seed in enumerate((7, 8)):
        one = generate_audio(bundle, texts[row:row + 1], negs[row:row + 1], 1.0,
                             num_inference_steps=STEPS, seed=seed, return_latents=True)
        np.testing.assert_allclose(multi.latents[row], one.latents[0], atol=1e-5, rtol=1e-5)
    again = generate_audio_multi(bundle, texts, negs, 1.0, [7, 8], num_inference_steps=STEPS)
    assert again.audio_batch.tobytes() == multi.audio_batch.tobytes()


@pytest.mark.parametrize("text_len,batch_size,use_cfg", [(10, 1, True), (90, 2, True),
                                                         (77, 2, False)])
def test_prepare_cfg_features_matches_jax(bundle, text_len, batch_size, use_cfg):
    model = bundle.mmdit
    jparams = {"empty_clip_feat": jnp.asarray(model.empty_clip_feat.numpy()),
               "empty_sync_feat": jnp.asarray(model.empty_sync_feat.numpy())}
    assert model.empty_clip_feat.any()  # perturbed: the uncond rows are not all zero
    text, neg = _text(1, text_len, 9), _text(1, text_len, 10)
    clip, sync = tfeat.t2a_features(model, TINY, 2.0)
    clip = clip + 1.0  # cond visuals that differ from the empty uncond ones
    ref = jfeat.prepare_cfg_features(
        jparams, *(jnp.asarray(x.numpy()) for x in (text, neg, clip, sync)),
        batch_size=batch_size, use_cfg=use_cfg)
    got = tfeat.prepare_cfg_features(model, text, neg, clip, sync, batch_size=batch_size,
                                     use_cfg=use_cfg)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("token_len,cap,sticky", [(5, None, None), (77, None, None),
                                                  (78, None, None), (200, 100, None),
                                                  (5, None, 128)])
def test_text_bucket_and_t2a_lengths(bundle, token_len, cap, sticky):
    assert tfeat.pick_text_bucket(token_len, cap, sticky) == jfeat.pick_text_bucket(
        token_len, cap, sticky)
    clip, sync = tfeat.t2a_features(bundle.mmdit, TINY, 5.0)
    assert clip.shape == (1, 40, TINY.model.clip_dim)
    assert sync.shape == (1, 112, TINY.model.sync_feat_dim)
