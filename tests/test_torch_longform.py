"""The port's long-form path (``pipeline/longform.py``) against the JAX package's, on the CPU
at the TINY config in fp32.

- The pure planning functions (``window_schedule``, ``plan_v2a_long``,
  ``_slice_v2a_window``, ``emitted_samples``, ``default_window_s``) equal the JAX functions
  exactly over a grid, durations off the latent grid and known prefixes included.
- ``generate_audio_long`` (T2A with Euler and with heun-2, and V2A) and ``continue_audio`` /
  ``continue_audio_stream`` (with the ``first_window_s`` ramp) against the JAX functions:
  the same weights on both sides (``io/from_jax.py``; the denoiser's drawn by the port's
  ``init``, ``torch_helpers.py``, the DAC's by the JAX ``init``; zero leaves and the DAC's
  alphas made random, its conv weights scaled by 0.65 so the decode stays out of tanh
  saturation) and the same noise (the JAX draw of the whole stitched sequence, injected into the port:
  ``jax.random`` and a ``torch.Generator`` give other bits for one seed).
- The port's stream against its own batch path: contiguous chunks that cover the duration,
  only the last final, their concatenation within 1.5/32767 of the batch audio (the JAX
  package's own bound).

Tolerance: stitched latents atol 5e-5 / rtol 1e-4 (the denoise tests' tolerance; the
continuation's encoded context carries the DAC encoder's fp32 error too); audio atol 1e-4,
the V2A test's, which carries the latents' error through the decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.configs import XXL as J_XXL
from foley_tpu.models import dac_vae as jdac
from foley_tpu.models import mmdit as jmm
from foley_tpu.pipeline import generate as jgen
from foley_tpu.pipeline import longform as jlong
from foley_tpu.sampling import denoise as jden
from foley_tpu_torch.configs import TINY, XXL
from foley_tpu_torch.io.from_jax import dac_from_jax, mmdit_from_jax
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.pipeline import generate as tgen
from foley_tpu_torch.pipeline import longform as tlong
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

LATENT_TOL = dict(atol=5e-5, rtol=1e-4)
AUDIO_TOL = dict(atol=1e-4, rtol=0)
STREAM_TOL = 1.5 / 32767.0
SR, HOP = TINY.dac.sample_rate, TINY.dac.hop_length
RATE = TINY.model.audio_frame_rate


# ---------------------------------------------------------------------------------
# The plans, exactly
# ---------------------------------------------------------------------------------

def _same_or_both_raise(fn_t, fn_j, *args, **kw):
    try:
        ref = fn_j(*args, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            fn_t(*args, **kw)
        return None
    assert fn_t(*args, **kw) == ref
    return ref


@pytest.mark.parametrize("total,win,ov", [(100, 100, 25), (80, 100, 25), (150, 100, 25),
                                          (500, 200, 50), (777, 150, 30), (175, 100, 25),
                                          (3750, 1500, 250), (1200, 800, 400), (500, 100, 100)])
@pytest.mark.parametrize("covered", [0, 1, 25, 99, 100])
def test_window_schedule_equals_jax(total, win, ov, covered):
    _same_or_both_raise(tlong.window_schedule, jlong.window_schedule, total, win, ov,
                        initial_covered=covered)


@pytest.mark.parametrize("duration", [10.0, 16.0, 20.0, 23.37, 24.0, 40.01, 75.0, 90.5])
@pytest.mark.parametrize("window,overlap", [(16.0, 4.0), (30.0, None), (30.0, 5.0),
                                            (20.0, 2.0), (8.0, 2.0), (12.5, 3.3)])
def test_plan_v2a_long_equals_jax(duration, window, overlap):
    ref = _same_or_both_raise(tlong.plan_v2a_long, jlong.plan_v2a_long, TINY, duration,
                              window, overlap)
    if ref is not None and ref[0] != duration:  # a multi-window plan: starts on the grid
        total, win = TINY.latent_length(ref[0]), TINY.latent_length(window)
        for start, _ in tlong.window_schedule(total, win, TINY.latent_length(ref[2])):
            assert start % (tlong.V2A_GRID_S * RATE) == 0


@pytest.mark.parametrize("feat_s,win_s", [(24, 16), (40, 16), (75, 30), (88, 30)])
def test_slice_v2a_window_equals_jax(feat_s, win_s):
    clip_len, sync_len = TINY.t2a_lengths(float(feat_s))
    clip = np.arange(clip_len, dtype=np.float32)[None, :, None].repeat(3, 2)
    sync = np.arange(sync_len, dtype=np.float32)[None, :, None].repeat(3, 2)
    for t0 in range(0, feat_s - win_s + 1, tlong.V2A_GRID_S):
        args = (t0 * RATE, win_s * RATE)
        got = tlong._slice_v2a_window(TINY, torch.from_numpy(clip), torch.from_numpy(sync),
                                      *args)
        ref = jlong._slice_v2a_window(J_TINY, jnp.asarray(clip), jnp.asarray(sync), *args)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    last = (feat_s - win_s) // tlong.V2A_GRID_S * tlong.V2A_GRID_S
    end = last * TINY.siglip2_fps + TINY.t2a_lengths(float(win_s))[0]  # the last slice's end
    with pytest.raises(ValueError, match="too short"):
        tlong._slice_v2a_window(TINY, torch.from_numpy(clip[:, :end - 1]),
                                torch.from_numpy(sync), last * RATE, win_s * RATE)


@pytest.mark.parametrize("duration", [1.14, 3.54, 0.64, 2.13, 75.0, 90.0, 1 / 3, 57 / 50])
def test_emitted_samples_and_default_window_equal_jax(duration):
    assert tlong.emitted_samples(duration, SR) == jlong.emitted_samples(duration, SR)
    assert tlong.default_window_s(XXL) == jlong.default_window_s(J_XXL) == 30.0
    assert tlong.default_window_s(TINY) == jlong.default_window_s(J_TINY)


# ---------------------------------------------------------------------------------
# Generation against JAX
# ---------------------------------------------------------------------------------

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
def stacks():
    rng = np.random.default_rng(31)
    mm = _seeded(jax_tree_from_port(tmm.init(TINY.model, torch.Generator().manual_seed(0),
                                             device="cpu"), jmm.init, J_TINY.model), rng)
    dac = _seeded(jax.jit(jdac.init, static_argnums=1)(jax.random.PRNGKey(1), J_TINY.dac), rng,
                  scale_w=0.65)
    text, neg = (rng.normal(size=(1, 10, 16)).astype(np.float32) for _ in range(2))
    return (jgen.ModelBundle(mm, dac, J_TINY, compute_dtype=jnp.float32),
            tgen.ModelBundle(mmdit_from_jax(mm, TINY.model, device="cpu"),
                             dac_from_jax(dac, TINY.dac, device="cpu"), TINY,
                             compute_dtype=torch.float32),
            text, neg)


def _inject_jax_noise(monkeypatch, seed):
    def noise(gen, b, length, dim):
        return torch.from_numpy(np.array(jden.prepare_latents(jax.random.PRNGKey(seed), b,
                                                              length, dim)))
    monkeypatch.setattr(tlong, "prepare_latents", noise)


def _both(stacks, monkeypatch, fn, lead, duration, *, seed, **kw):
    """(JAX result, port result) of ``fn(bundle, *lead, text, neg, duration)`` on the same
    inputs and noise."""
    j_bundle, t_bundle, text, neg = stacks
    ref = getattr(jlong, fn)(j_bundle, *lead, jnp.asarray(text), jnp.asarray(neg), duration,
                             seed=seed, **kw)
    _inject_jax_noise(monkeypatch, seed)
    got = getattr(tlong, fn)(t_bundle, *lead, torch.from_numpy(text), torch.from_numpy(neg),
                             duration, seed=seed, **kw)
    return ref, got


@pytest.mark.parametrize("sampler", ["euler", "heun-2"])
def test_generate_audio_long_t2a_matches_jax(stacks, monkeypatch, sampler):
    """3 s in 2 s windows with 0.5 s overlap: two windows, the second clamping 50 frames."""
    ref, got = _both(stacks, monkeypatch, "generate_audio_long", (), 3.0,
                     seed=11, window_s=2.0, overlap_s=0.5, num_inference_steps=3,
                     sampler=sampler, text_bucket=16, return_latents=True, fetch_pcm16=False)
    assert got.timings["windows"] == ref.timings["windows"] == 2.0
    assert got.latents.shape == (1, TINY.latent_length(3.0), TINY.model.audio_vae_latent_dim)
    np.testing.assert_allclose(got.latents, ref.latents, **LATENT_TOL)
    assert got.audio_batch.shape == ref.audio_batch.shape == (1, 1, 3 * SR)
    np.testing.assert_allclose(got.audio_batch, ref.audio_batch, **AUDIO_TOL)
    noise = np.array(jden.prepare_latents(jax.random.PRNGKey(11), 1, got.latents.shape[1],
                                          got.latents.shape[2]))
    assert np.abs(got.latents - noise).max() > 1e-2  # the denoiser moved them


def test_generate_audio_long_v2a_matches_jax(stacks, monkeypatch):
    """12 s of V2A in 10 s windows: the plan snaps to 18 s, two windows at 0 and 8 s, each
    slicing the full features; audio and latents trimmed back to 12 s."""
    feat_dur, win_s, ov_s = tlong.plan_v2a_long(TINY, 12.0, window_s=10.0, overlap_s=2.0)
    assert (feat_dur, win_s, ov_s) == (18.0, 10.0, 2.0)
    clip_len, sync_len = TINY.t2a_lengths(feat_dur)
    rng = np.random.default_rng(7)
    clip = rng.normal(size=(1, clip_len, 16)).astype(np.float32)
    sync = rng.normal(size=(1, sync_len, 16)).astype(np.float32)
    j_bundle, t_bundle, text, neg = stacks
    kw = dict(window_s=win_s, overlap_s=ov_s, num_inference_steps=2, seed=3, text_bucket=16,
              return_latents=True, fetch_pcm16=False)
    ref = jlong.generate_audio_long(j_bundle, jnp.asarray(text), jnp.asarray(neg), 12.0,
                                    clip_feat=jnp.asarray(clip), sync_feat=jnp.asarray(sync),
                                    **kw)
    _inject_jax_noise(monkeypatch, 3)
    got = tlong.generate_audio_long(t_bundle, torch.from_numpy(text), torch.from_numpy(neg),
                                    12.0, clip_feat=torch.from_numpy(clip),
                                    sync_feat=torch.from_numpy(sync), **kw)
    assert got.timings["windows"] == 2.0
    assert got.latents.shape[1] == TINY.latent_length(12.0)
    np.testing.assert_allclose(got.latents, ref.latents, **LATENT_TOL)
    assert got.audio_batch.shape == (1, 1, 12 * SR)
    np.testing.assert_allclose(got.audio_batch, ref.audio_batch, **AUDIO_TOL)
    with pytest.raises(ValueError, match="too short"):  # before any window runs
        tlong.generate_audio_long(t_bundle, torch.from_numpy(text), torch.from_numpy(neg),
                                  12.0, clip_feat=torch.from_numpy(clip[:, :-1]),
                                  sync_feat=torch.from_numpy(sync), **kw)
    with pytest.raises(ValueError, match="both clip_feat and sync_feat"):
        tlong.generate_audio_long(t_bundle, torch.from_numpy(text), torch.from_numpy(neg),
                                  12.0, clip_feat=torch.from_numpy(clip), **kw)


@pytest.mark.parametrize("duration,window,overlap,snap,first,ctx,v2a", [
    (3.0, 2.0, 0.5, False, None, 0, False), (2.7, 2.0, 0.5, True, None, 0, False),
    (2.13, 2.0, 0.5, False, None, 0, False), (3.0, 2.0, 0.5, False, 1.0, 0, False),
    (3.5, 2.0, 0.5, False, 1.0, 25, False), (1.0, 2.0, 0.5, False, None, 0, False),
    (75.0, 30.0, 5.0, False, None, 0, False), (75.0, 30.0, 5.0, True, 8.0, 200, False),
    (20.0, 16.0, 4.0, False, None, 0, True), (20.0, 16.0, 4.0, False, 8.0, 0, True)])
def test_prepare_long_plan_equals_jax(stacks, duration, window, overlap, snap, first, ctx,
                                      v2a):
    """The whole window plan of a run (total frames, the schedule of (start, known) and each
    window's size): grid snapping, the ramp, a continuation's known prefix and V2A's 8 s
    grid, exactly as the JAX package plans them."""
    j_bundle, t_bundle, text, neg = stacks
    prefix = np.zeros((1, ctx, TINY.model.audio_vae_latent_dim), np.float32) if ctx else None
    feats = None, None
    if v2a:
        feat_s = tlong.plan_v2a_long(TINY, duration, window, overlap)[0]
        feats = tuple(np.zeros((1, n, 16), np.float32) for n in TINY.t2a_lengths(feat_s))
    kw = dict(window_s=window, overlap_s=overlap, batch_size=1, seed=0, text_bucket=16,
              snap_to_window_grid=snap, use_cfg=True, first_window_s=first)
    ref = jlong._prepare_long(
        j_bundle, jnp.asarray(text), jnp.asarray(neg), duration,
        clip_feat=None if feats[0] is None else jnp.asarray(feats[0]),
        sync_feat=None if feats[1] is None else jnp.asarray(feats[1]), attn_impl="xla",
        known_prefix=prefix, **kw)
    got = tlong._prepare_long(
        t_bundle, torch.from_numpy(text), torch.from_numpy(neg), duration,
        clip_feat=None if feats[0] is None else torch.from_numpy(feats[0]),
        sync_feat=None if feats[1] is None else torch.from_numpy(feats[1]),
        known_prefix=None if prefix is None else torch.from_numpy(prefix), **kw)
    assert (got.total_frames, got.sched, got.sizes) == (ref.total_frames, ref.sched,
                                                         ref.sizes)
    assert tuple(got.noise.shape) == tuple(ref.noise.shape)


def _source(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return np.clip(0.3 * np.sin(2 * np.pi * 440 * t) + rng.normal(scale=0.05, size=t.size),
                   -1, 1).astype(np.float32)


def test_continue_audio_matches_jax(stacks, monkeypatch):
    """3 s after a 0.5 s context: 25 known frames + 150 new ones, two windows."""
    ref, got = _both(stacks, monkeypatch, "continue_audio", (_source(1.5, 2),), 3.0,
                     seed=9, context_s=0.5, window_s=2.0, overlap_s=0.5,
                     num_inference_steps=2, text_bucket=16, return_latents=True,
                     fetch_pcm16=False)
    assert got.timings["context_frames"] == ref.timings["context_frames"] == 25.0
    assert got.timings["windows"] == ref.timings["windows"] == 2.0
    assert got.latents.shape == (1, TINY.latent_length(3.0), TINY.model.audio_vae_latent_dim)
    np.testing.assert_allclose(got.latents, ref.latents, **LATENT_TOL)
    assert got.audio_batch.shape == ref.audio_batch.shape == (1, 1, 3 * SR)
    np.testing.assert_allclose(got.audio_batch, ref.audio_batch, **AUDIO_TOL)


def test_continue_audio_stream_with_ramp_matches_jax(stacks, monkeypatch):
    """The stream with a 1 s ramp: a preamble window holding the context, then the normal
    plan clamping the preamble; the same chunks as JAX's, and its batch path's audio."""
    kw = dict(seed=9, context_s=0.5, window_s=2.0, overlap_s=0.5, num_inference_steps=2,
              text_bucket=16, fetch_pcm16=False, first_window_s=1.0)
    src = _source(2.0, 4)
    ref, got = _both(stacks, monkeypatch, "continue_audio_stream", (src,), 3.0, **kw)
    ref, got = list(ref), list(got)

    def layout(chunks):
        return [(c.start_sample, c.audio.shape, c.window_index, c.n_windows, c.final)
                for c in chunks]

    assert layout(got) == layout(ref)
    assert len(got) == 3 and got[0].start_sample == 0 and got[-1].final
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.audio, r.audio, **AUDIO_TOL)
    _, t_bundle, text, neg = stacks
    batch = tlong.continue_audio(t_bundle, src, torch.from_numpy(text), torch.from_numpy(neg),
                                 3.0, **kw)
    np.testing.assert_array_equal(np.concatenate([c.audio for c in got], axis=-1),
                                  batch.audio_batch)


def test_continue_audio_guards(stacks):
    _, t_bundle, text, neg = stacks
    src = _source(1.5, 2)
    args = (torch.from_numpy(text), torch.from_numpy(neg), 3.0)
    kw = dict(context_s=0.5, window_s=2.0, num_inference_steps=1, text_bucket=16)
    with pytest.raises(ValueError, match="shorter than the window"):
        tlong.continue_audio(t_bundle, src, *args, **{**kw, "context_s": 1.5, "window_s": 1.0})
    with pytest.raises(ValueError, match="one latent frame"):
        tlong.continue_audio(t_bundle, src[:100], *args, **kw)
    with pytest.raises(ValueError, match="context"):
        tlong.continue_audio(t_bundle, src, *args, **{**kw, "context_s": 1.2,
                                                      "first_window_s": 1.0})


# ---------------------------------------------------------------------------------
# The stream against the batch path
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("duration,first_window_s,n_chunks", [(3.0, None, 2), (3.0, 1.0, 3),
                                                              (2.13, None, 2), (1.0, None, 1)])
def test_stream_matches_batch(stacks, duration, first_window_s, n_chunks):
    _, t_bundle, text, neg = stacks
    args = (t_bundle, torch.from_numpy(text), torch.from_numpy(neg), duration)
    kw = dict(window_s=2.0, overlap_s=0.5, num_inference_steps=2, seed=5, text_bucket=16,
              first_window_s=first_window_s)
    batch = tlong.generate_audio_long(*args, **kw)
    chunks = list(tlong.generate_audio_long_stream(*args, **kw))
    assert len(chunks) == n_chunks and [c.n_windows for c in chunks] == [n_chunks] * n_chunks
    assert chunks[-1].final and not any(c.final for c in chunks[:-1])
    pos = 0
    for c in chunks:
        assert c.start_sample == pos and c.audio.shape[:2] == (1, 1)
        np.testing.assert_array_equal(c.audio[:, 0], c.pcm16.astype(np.float32) / 32767.0)
        pos += c.audio.shape[-1]
    # off the latent grid (2.13 s) the stream emits whole latent frames
    assert pos == min(tlong.emitted_samples(duration, SR), TINY.latent_length(duration) * HOP)
    if first_window_s:
        assert chunks[0].audio.shape[-1] == (TINY.latent_length(first_window_s)
                                             - tlong._STREAM_HALO) * HOP
    streamed = np.concatenate([c.audio for c in chunks], axis=-1)
    assert np.abs(streamed - batch.audio_batch[..., :pos]).max() <= STREAM_TOL
