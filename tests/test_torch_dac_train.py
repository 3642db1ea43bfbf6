"""The DAC codec's training pieces in the port against the JAX package, on the CPU: the 2-D
and grouped convs, the Slaney mel basis, the polyphase resampler, the RVQ (with its
straight-through gradient), every loss, every discriminator family, and one GAN step
(``training/dac_train.py``) against ``foley_tpu.training.dac_train.make_dac_train_steps``.

Both sides see the same weights (the JAX ``init`` trees through ``io/from_jax.py``) and the
same inputs (numpy, from seeds); the step's posterior noise is the JAX draw of its key,
injected into the port (``jax.random`` bits cannot be reproduced).

Tolerances (all relative L2 unless stated): convs, resampling, the RVQ's projections and
the discriminators' maps 1e-5 (the same fp32 products summed in another order); the
losses 1e-5 (XLA's CPU FFT and torch's differ by about 1e-7 relative in a bin); the Slaney
basis equal (both float64 numpy); the RVQ's codes equal. The GAN step: every loss part
within 1e-5 relative (read up to 5.6e-7), the first moments (0.2 x the gradients) within
1e-4 after the step (read up to 6.1e-5), the parameters' updates within 2e-2 (read up to
8.8e-3): a first AdamW update is ``g / (|g| + eps)``, the sign of each gradient element,
and an element whose gradient is a rounding away from zero may take either sign on the two
sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import dac_discriminator as jdisc
from foley_tpu.models import dac_losses as jloss
from foley_tpu.models import dac_vae as jdac
from foley_tpu.models import quantize as jq
from foley_tpu.ops import audio_dsp as jdsp
from foley_tpu.ops import nn as jnn
from foley_tpu.training import dac_train as jtrain
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import (dac_from_jax, discriminator_from_jax, rvq_from_jax,
                                         state_dict_from_jax)
from foley_tpu_torch.models import dac_discriminator as tdisc
from foley_tpu_torch.models import dac_losses as tloss
from foley_tpu_torch.models import quantize as tq
from foley_tpu_torch.ops import audio_dsp as tdsp
from foley_tpu_torch.ops import nn as tnn
from foley_tpu_torch.training import dac_train as ttrain
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

REL = 1e-5
LOSS_REL = 1e-5
STEP_LOSS_REL, MU_REL, UPDATE_REL = 1e-5, 1e-4, 2e-2
RVQ_TINY = dict(input_dim=16, n_codebooks=3, codebook_size=32, codebook_dim=4)
DISC_TINY = dict(periods=(2, 3), rates=(1, 2), fft_sizes=(512,), sample_rate=16000)


def _rel(got, ref) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("stride,padding,groups", [((1, 1), (0, 0), 1), ((3, 1), (2, 0), 1),
                                                   ((1, 2), (1, 4), 2)])
def test_conv2d_matches_jax(stride, padding, groups):
    x = _normal(0, 2, 11, 13, 4)
    w = _normal(1, 3, 5, 4 // groups, 6)  # HWIO
    b = _normal(2, 6)
    ref = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                     padding=padding, groups=groups)
    got = tnn.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     torch.from_numpy(b), stride=stride, padding=padding, groups=groups)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= REL


def test_grouped_conv1d_matches_jax():
    x = _normal(3, 2, 40, 16)
    w = _normal(4, 41, 4, 64)  # [K, in/groups, out]
    ref = jnn.conv1d(jnp.asarray(x), jnp.asarray(w), stride=4, padding=20, groups=4)
    got = tnn.conv1d(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                     stride=4, padding=20, groups=4)
    assert _rel(got, ref) <= REL


@pytest.mark.parametrize("n_freqs,n_mels,sr", [(1025, 150, 48000), (257, 80, 48000),
                                               (257, 40, 16000)])
def test_slaney_mel_basis_equals_jax(n_freqs, n_mels, sr):
    np.testing.assert_array_equal(tdsp.mel_filterbank_slaney(n_freqs, n_mels, sr),
                                  np.asarray(jdsp.mel_filterbank_slaney(n_freqs, n_mels, sr)))


@pytest.mark.parametrize("orig,target", [(2, 1), (4, 1), (3, 2), (1, 2)])
def test_resample_poly_matches_jax(orig, target):
    x = _normal(5, 2, 3, 1000)
    ref = jdsp.resample_poly(jnp.asarray(x), orig, target)
    got = tdsp.resample_poly(torch.from_numpy(x), orig, target)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= REL


# ---------------------------------------------------------------------------------
# RVQ
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rvq():
    j_cfg, t_cfg = jq.RVQConfig(**RVQ_TINY), tq.RVQConfig(**RVQ_TINY)
    params = jax.device_get(jq.init(jax.random.PRNGKey(0), j_cfg))
    return params, j_cfg, rvq_from_jax(params, t_cfg, device="cpu")


def test_rvq_matches_jax(rvq):
    params, j_cfg, model = rvq
    z = _normal(6, 2, 9, j_cfg.input_dim)
    ref = jq.apply(params, jnp.asarray(z), j_cfg)
    got = tq.apply(model, torch.from_numpy(z))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    assert _rel(got.z_q, ref.z_q) <= REL and _rel(got.latents, ref.latents) <= REL
    for name in ("commitment_loss", "codebook_loss"):
        assert abs(float(getattr(got, name)) - float(getattr(ref, name))) <= LOSS_REL * abs(
            float(getattr(ref, name)))
    z_c = tq.from_codes(model, got.codes)
    assert _rel(z_c, jq.from_codes(params, ref.codes)) <= REL
    assert _rel(z_c, got.z_q) <= REL
    z_l, codes_l = tq.from_latents(model, got.latents)
    j_zl, j_codes = jq.from_latents(params, ref.latents, j_cfg)
    np.testing.assert_array_equal(codes_l.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(codes_l.numpy(), got.codes.numpy())
    assert _rel(z_l, j_zl) <= REL


def test_rvq_straight_through_gradient_matches_jax(rvq):
    """The gradient of sum(z_q) with respect to z (straight through every stage) and of the
    codebook loss with respect to the codebooks."""
    params, j_cfg, model = rvq
    z = _normal(7, 1, 5, j_cfg.input_dim)
    j_gz = jax.grad(lambda zz: jnp.sum(jq.apply(params, zz, j_cfg).z_q))(jnp.asarray(z))
    j_gcb = jax.grad(lambda p: jq.apply(p, jnp.asarray(z), j_cfg).codebook_loss)(params)
    zt = torch.from_numpy(z).requires_grad_(True)
    (g_z,) = torch.autograd.grad(tq.apply(model, zt).z_q.sum(), [zt])
    assert np.any(np.asarray(j_gz) != 0) and _rel(g_z, j_gz) <= REL
    books = [q.codebook for q in model.quantizers]
    for b in books:
        b.requires_grad_(True)
    try:
        g_books = torch.autograd.grad(tq.apply(model, torch.from_numpy(z)).codebook_loss, books)
    finally:
        for b in books:
            b.requires_grad_(False)
    for g, q in zip(g_books, j_gcb["quantizers"]):
        assert _rel(g, q["codebook"]) <= REL


# ---------------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------------

def _pair(seed, b=2, t=4096):
    y = _normal(seed, b, t, scale=0.3)
    return y + _normal(seed + 1, b, t, scale=0.05), y


LOSSES = {
    "l1": (jloss.l1_loss, tloss.l1_loss, {}),
    "sisdr": (jloss.sisdr_loss, tloss.sisdr_loss, {}),
    "stft": (jloss.multiscale_stft_loss, tloss.multiscale_stft_loss, {}),
    "mel": (jloss.mel_spectrogram_loss, tloss.mel_spectrogram_loss, {}),
    "mel_16k": (jloss.mel_spectrogram_loss, tloss.mel_spectrogram_loss,
                dict(sample_rate=16000, n_mels=(40,), window_lengths=(512,))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_waveform_losses_match_jax(name):
    j_fn, t_fn, kw = LOSSES[name]
    x, y = _pair(8)
    ref = float(j_fn(jnp.asarray(x), jnp.asarray(y), **kw))
    got = float(t_fn(torch.from_numpy(x), torch.from_numpy(y), **kw))
    assert abs(got - ref) <= LOSS_REL * abs(ref), (got, ref)


def test_loss_gradients_match_jax():
    """The gradients of the STFT and mel losses with respect to the estimate."""
    x, y = _pair(9)
    fn_j = lambda a: (jloss.multiscale_stft_loss(a, jnp.asarray(y))  # noqa: E731
                      + jloss.mel_spectrogram_loss(a, jnp.asarray(y)))
    ref = jax.grad(fn_j)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y)
    (got,) = torch.autograd.grad(tloss.multiscale_stft_loss(xt, yt)
                                 + tloss.mel_spectrogram_loss(xt, yt), [xt])
    assert _rel(got, ref) <= 1e-4


@pytest.mark.parametrize("name", ["discriminator", "generator_adv", "feature_matching"])
def test_gan_losses_match_jax(name):
    shapes = [[(2, 8, 5), (2, 4, 3), (2, 1, 3)], [(2, 6), (2, 1, 7)]]
    real = [[_normal(10 + 3 * i + j, *s) for j, s in enumerate(p)] for i, p in enumerate(shapes)]
    fake = [[_normal(40 + 3 * i + j, *s) for j, s in enumerate(p)] for i, p in enumerate(shapes)]
    jr = [[jnp.asarray(a) for a in p] for p in real]
    jf = [[jnp.asarray(a) for a in p] for p in fake]
    tr = [[torch.from_numpy(a) for a in p] for p in real]
    tf = [[torch.from_numpy(a) for a in p] for p in fake]
    if name == "generator_adv":
        ref, got = jloss.generator_adv_loss(jf), tloss.generator_adv_loss(tf)
    else:
        ref = getattr(jloss, f"{name}_loss")(jr, jf)
        got = getattr(tloss, f"{name}_loss")(tr, tf)
    assert abs(float(got) - float(ref)) <= LOSS_REL * abs(float(ref))


# ---------------------------------------------------------------------------------
# Discriminators
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def disc():
    j_cfg, t_cfg = jdisc.DiscriminatorConfig(**DISC_TINY), tdisc.DiscriminatorConfig(**DISC_TINY)
    params = jax.device_get(jdisc.init(jax.random.PRNGKey(1), j_cfg))
    return params, j_cfg, discriminator_from_jax(params, t_cfg, device="cpu")


def _channels_last(t: torch.Tensor) -> np.ndarray:
    return t.detach().movedim(1, -1).numpy()


def _assert_maps_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = _channels_last(g)
        assert g.shape == r.shape, (g.shape, r.shape)
        assert _rel(g, r) <= REL


@pytest.mark.parametrize("family", ["mpd_2", "mpd_3", "msd_1", "msd_2", "mrd_512"])
def test_discriminator_family_matches_jax(disc, family):
    params, j_cfg, model = disc
    x = _normal(11, 2, 3000, 1, scale=0.3)
    xj = jdisc.preprocess(jnp.asarray(x))
    xt = tdisc.preprocess(torch.from_numpy(x)).transpose(1, 2)
    np.testing.assert_allclose(xt.transpose(1, 2).numpy(), np.asarray(xj), rtol=1e-6, atol=1e-7)
    kind, arg = family.split("_")
    arg = int(arg)
    with tnn.true_fp32():
        if kind == "mpd":
            i = j_cfg.periods.index(arg)
            ref = jdisc.apply_mpd(params["mpd"][i], xj, arg)
            got = tdisc.apply_mpd(model.mpd[i], xt, arg)
        elif kind == "msd":
            i = j_cfg.rates.index(arg)
            ref = jdisc.apply_msd(params["msd"][i], xj, arg)
            got = tdisc.apply_msd(model.msd[i], xt, arg)
        else:
            i = j_cfg.fft_sizes.index(arg)
            ref = jdisc.apply_mrd(params["mrd"][i], xj, arg)
            got = tdisc.apply_mrd(model.mrd[i], xt, arg)
    _assert_maps_close(got, [np.asarray(r) for r in ref])


def test_complex_spectrogram_matches_jax():
    x = _normal(12, 2, 2999)
    ref = np.asarray(jdisc._complex_spectrogram(jnp.asarray(x), 512))  # [B, t, f, 2]
    got = tdisc.complex_spectrogram(torch.from_numpy(x), 512)  # [B, 2, t, f]
    assert _channels_last(got).shape == ref.shape
    assert _rel(_channels_last(got), ref) <= REL


def test_discriminator_apply_and_input_gradient_match_jax(disc):
    params, j_cfg, model = disc
    x = _normal(13, 1, 4000, 1, scale=0.1)
    ref = jdisc.apply(params, jnp.asarray(x), j_cfg)
    got = tdisc.apply(model, torch.from_numpy(x))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        _assert_maps_close(g, [np.asarray(a) for a in r])
    j_g = jax.grad(lambda a: jloss.generator_adv_loss(jdisc.apply(params, a, j_cfg)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_g,) = torch.autograd.grad(tloss.generator_adv_loss(tdisc.apply(model, xt)), [xt])
    assert np.any(np.asarray(j_g) != 0) and _rel(t_g, j_g) <= 1e-4


# ---------------------------------------------------------------------------------
# One GAN step
# ---------------------------------------------------------------------------------

STEP_DISC = dict(periods=(2,), rates=(), fft_sizes=(512,), sample_rate=48000)
STEP_KW = dict(gen_lr=1e-3, disc_lr=1e-3, stft_windows=(512,), mel_cfg=((40, 512),))


def _tone(cfg, hops=2, b=1):
    t = hops * cfg.hop_length
    wave = 0.3 * np.sin(2 * np.pi * 220 * np.arange(t) / cfg.sample_rate)
    return np.tile(wave.reshape(1, t, 1), (b, 1, 1)).astype(np.float32)


def _noise(key, shape):
    k_d, k_g = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
                 for k in (k_d, k_g))


def _conditioned(tree, enc_scale=0.65, dec_scale=0.7):
    """The JAX init with its encoder's conv weights times 0.65 and its decoder's times 0.7.
    At the init's own scale the TINY codec's activations grow through its unnormalised
    layers to latents of 1.9e4 and log-variances clipped at 20 (a KL of 2e9, whose gradient
    ``exp(logvar)`` magnifies fp32 rounding a hundred-million-fold) and a decoder output
    saturated in its tanh; scaled, the latents stay within 0.5, the log-variances within
    0.7 and the output within 0.33."""
    def scale(path, a):
        key = jax.tree_util.keystr(path)
        if "'w'" not in key:
            return a
        return a * (enc_scale if "encoder" in key else dec_scale if "decoder" in key else 1.0)

    return jax.tree_util.tree_map_with_path(scale, tree)


@pytest.fixture(scope="module")
def gan():
    cfg = J_TINY.dac
    gen_params = _conditioned(jax.device_get(jdac.init(jax.random.PRNGKey(0), cfg)))
    disc_params = jax.device_get(jdisc.init(jax.random.PRNGKey(1),
                                            jdisc.DiscriminatorConfig(**STEP_DISC)))
    return gen_params, disc_params


def _port_models(gen_params, disc_params):
    return (dac_from_jax(gen_params, TINY.dac, device="cpu"),
            discriminator_from_jax(disc_params, tdisc.DiscriminatorConfig(**STEP_DISC),
                                   device="cpu"))


def test_gan_step_matches_jax(gan):
    """One discriminator + generator step at TINY's codec with the JAX noise: every loss
    part, both first moments and both parameter updates, and the flags left off."""
    gen_params, disc_params = gan
    j_init, j_step = jtrain.make_dac_train_steps(
        J_TINY.dac, jdisc.DiscriminatorConfig(**STEP_DISC), **STEP_KW)
    audio = _tone(TINY.dac)
    key = jax.random.PRNGKey(10)
    j_state, j_metrics = jax.jit(j_step)(j_init(gen_params, disc_params), jnp.asarray(audio),
                                         key)
    gen, disc = _port_models(gen_params, disc_params)
    before = {**{"g." + k: v.clone() for k, v in gen.state_dict().items()},
              **{"d." + k: v.clone() for k, v in disc.state_dict().items()}}
    t_init, t_step = ttrain.make_dac_train_steps(gen, disc, **STEP_KW)
    latents = (1, audio.shape[1] // TINY.dac.hop_length, TINY.dac.latent_dim)
    state, metrics = t_step(t_init(), torch.from_numpy(audio), noise=_noise(key, latents))
    assert set(metrics) == set(j_metrics)
    for name, ref in j_metrics.items():
        assert abs(float(metrics[name]) - float(ref)) <= STEP_LOSS_REL * abs(float(ref)), name
    j_state = jax.device_get(j_state)
    for prefix, got_params, got_opt, ref_params, ref_opt in (
            ("g.", state.gen_params, state.gen_opt, j_state.gen_params, j_state.gen_opt),
            ("d.", state.disc_params, state.disc_opt, j_state.disc_params, j_state.disc_opt)):
        ref_p = state_dict_from_jax(ref_params)
        ref_mu = state_dict_from_jax(ref_opt[0].mu)
        assert set(ref_p) == set(got_params)
        for name, p in got_params.items():
            moved = (p - before[prefix + name]).numpy()
            ref_moved = ref_p[name].numpy() - before[prefix + name].numpy()
            assert _rel(moved, ref_moved) <= UPDATE_REL, (prefix + name, _rel(moved, ref_moved))
            assert _rel(got_opt.mu[name], ref_mu[name]) <= MU_REL, prefix + name
    assert state.step == 1 and state.gen_opt.count == state.disc_opt.count == 1
    assert not any(p.requires_grad for p in (*gen.parameters(), *disc.parameters()))


def test_gan_steps_reduce_mel_on_one_batch():
    """Four steps on one batch from the port's own init, the noise from a step generator:
    finite losses, and the mel loss falls (as ``tests/test_dac_training.py`` checks of the
    JAX steps)."""
    from foley_tpu_torch.models import dac_vae as tdac
    from foley_tpu_torch.training.loop import step_generator

    gen = tdac.init(TINY.dac, torch.Generator().manual_seed(0), device="cpu")
    disc = tdisc.init(tdisc.DiscriminatorConfig(**STEP_DISC), torch.Generator().manual_seed(1),
                      device="cpu")
    t_init, t_step = ttrain.make_dac_train_steps(gen, disc, **STEP_KW)
    state = t_init()
    audio = torch.from_numpy(_tone(TINY.dac))
    mels = []
    for i in range(4):
        state, metrics = t_step(state, audio, step_generator(0, i, "cpu"))
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
        mels.append(float(metrics["mel"]))
    assert state.step == 4
    assert mels[-1] < mels[0], mels
