"""The codec's artifacts and chunked compress / decompress (``models/dac_codec.py``) and the
RVQ and discriminator checkpoint converters (``io/convert.py``) against the JAX package's,
on the CPU.

- ``DACFile`` files written by either package read back equal in the other.
- ``compress`` / ``decompress`` at TINY's codec on the JAX init (its encoder and decoder
  weights scaled as ``test_torch_dac_train._conditioned`` does, so latents and audio stay
  in range): the latents and the audio within 1e-5 relative L2 of the JAX functions', and
  the round trip equal to ``decode(encode(chunks).mode())`` (and chunk by chunk within the
  tolerances stated there); an artifact of
  RVQ codes decodes through the quantizer, within 1e-5 of JAX's.
- The converters on synthetic reference-layout state dicts (weight-norm pairs in the old
  and the new key style), strict: every key consumed, the result loading strictly into the
  port's module, equal to the JAX converter's tree through ``io/from_jax.py`` (the folded
  weights within 1e-6 relative, the fold's fp32 sum in another order; the rest exactly).
"""

import jax
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.io import convert as jconv
from foley_tpu.models import dac_codec as jcodec
from foley_tpu.models import dac_discriminator as jdisc
from foley_tpu.models import dac_vae as jdac
from foley_tpu.models import quantize as jq
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io import convert as tconv
from foley_tpu_torch.io.from_jax import dac_from_jax, rvq_from_jax, state_dict_from_jax
from foley_tpu_torch.models import dac_codec as tcodec
from foley_tpu_torch.models import dac_discriminator as tdisc
from foley_tpu_torch.models import dac_vae as tdac
from foley_tpu_torch.models import quantize as tq
from test_torch_dac_train import _conditioned, _rel
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

REL = 1e-5
FOLD_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def codec():
    params = _conditioned(jax.device_get(jdac.init(jax.random.PRNGKey(0), J_TINY.dac)))
    return params, dac_from_jax(params, TINY.dac, device="cpu")


def _audio(seconds=0.8, seed=0):
    t = int(seconds * TINY.dac.sample_rate)
    return (0.1 * np.random.default_rng(seed).normal(size=(t,))).astype(np.float32)


# ---------------------------------------------------------------------------------
# DACFile
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("is_codes", [False, True])
def test_dac_file_reads_across_packages(tmp_path, writer, is_codes):
    rng = np.random.default_rng(1)
    payload = (rng.integers(0, 1024, (2, 3, 5)).astype(np.int16) if is_codes
               else rng.normal(size=(2, 5, 8)).astype(np.float32))
    fields = dict(payload=payload, is_codes=is_codes, sample_rate=48000, original_length=9000,
                  chunk_samples=4800)
    write, read = ((jcodec.DACFile, tcodec.DACFile) if writer == "jax"
                   else (tcodec.DACFile, jcodec.DACFile))
    path = str(tmp_path / "clip.dac.npz")
    write(**fields).save(path)
    got = read.load(path)
    np.testing.assert_array_equal(got.payload, payload)
    assert got.payload.dtype == payload.dtype
    for name in ("is_codes", "sample_rate", "original_length", "chunk_samples"):
        assert getattr(got, name) == fields[name], name


# ---------------------------------------------------------------------------------
# compress / decompress
# ---------------------------------------------------------------------------------

def test_compress_decompress_match_jax(codec, tmp_path):
    params, model = codec
    audio = _audio()
    ref = jcodec.compress(params, audio, J_TINY.dac, win_duration_s=0.5)
    got = tcodec.compress(model, audio, win_duration_s=0.5)
    assert got.payload.shape == ref.payload.shape and got.payload.dtype == np.float32
    assert (got.chunk_samples, got.original_length, got.sample_rate) == (
        ref.chunk_samples, ref.original_length, ref.sample_rate)
    assert _rel(got.payload, ref.payload) <= REL
    assert tcodec.codec_delay(TINY.dac) == jcodec.codec_delay(J_TINY.dac) == 0
    path = str(tmp_path / "a.dac.npz")
    got.save(path)
    wav = tcodec.decompress(model, tcodec.DACFile.load(path))
    ref_wav = jcodec.decompress(params, jcodec.DACFile.load(path), J_TINY.dac)
    assert wav.shape == ref_wav.shape == audio.shape
    assert _rel(wav, ref_wav) <= REL
    # the round trip is the mode's decode of the chunks: exactly in one batch; chunk by chunk
    # (the CPU's conv algorithms change with the batch size) the latents within 1e-6 and the
    # audio within 1e-4 (read 1.6e-5: the decoder magnifies the latents' differences)
    chunk = got.chunk_samples
    padded = np.zeros((got.payload.shape[0] * chunk,), np.float32)
    padded[:audio.shape[0]] = audio
    chunks = torch.from_numpy(padded.reshape(-1, chunk, 1))
    z = tdac.encode(model, chunks).mode()
    assert torch.equal(z, torch.from_numpy(got.payload))
    np.testing.assert_array_equal(wav, tdac.decode(model, z).reshape(-1).numpy()[:len(wav)])
    for i, piece in enumerate(chunks):
        z_i = tdac.encode(model, piece[None]).mode()
        assert _rel(z_i[0], got.payload[i]) <= 1e-6
        n = min(chunk, audio.shape[0] - i * chunk)
        assert _rel(tdac.decode(model, z_i)[0, :n, 0], wav[i * chunk: i * chunk + n]) <= 1e-4


def test_decompress_codes_matches_jax(codec):
    params, model = codec
    cfg = dict(input_dim=TINY.dac.latent_dim, n_codebooks=3, codebook_size=32, codebook_dim=4)
    j_rvq = jax.device_get(jq.init(jax.random.PRNGKey(2), jq.RVQConfig(**cfg)))
    rvq = rvq_from_jax(j_rvq, tq.RVQConfig(**cfg), device="cpu")
    codes = np.random.default_rng(3).integers(0, 32, (2, 3, 25)).astype(np.int16)
    artifact = dict(payload=codes, is_codes=True, sample_rate=48000, original_length=40000,
                    chunk_samples=24000)
    got = tcodec.decompress(model, tcodec.DACFile(**artifact), rvq=rvq)
    ref = jcodec.decompress({**params, "rvq": j_rvq}, jcodec.DACFile(**artifact), J_TINY.dac)
    assert got.shape == ref.shape == (40000,)
    assert _rel(got, ref) <= REL
    with pytest.raises(ValueError, match="rvq"):
        tcodec.decompress(model, tcodec.DACFile(**artifact))


# ---------------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------------

def _wn_pair(rng, prefix, shape, style):
    g_key, v_key = ((".weight_g", ".weight_v") if style == "old" else
                    (".parametrizations.weight.original0",
                     ".parametrizations.weight.original1"))
    return {prefix + g_key: rng.uniform(0.5, 1.5, (shape[0],) + (1,) * (len(shape) - 1))
            .astype(np.float32),
            prefix + v_key: rng.normal(size=shape).astype(np.float32),
            prefix + ".bias": rng.normal(size=(shape[0],)).astype(np.float32)}


def _rvq_reference_sd(cfg, style, seed=4):
    rng = np.random.default_rng(seed)
    sd = {}
    for i in range(cfg.n_codebooks):
        q = f"quantizers.{i}"
        sd.update(_wn_pair(rng, f"{q}.in_proj", (cfg.codebook_dim, cfg.input_dim, 1), style))
        sd.update(_wn_pair(rng, f"{q}.out_proj", (cfg.input_dim, cfg.codebook_dim, 1), style))
        sd[f"{q}.codebook.weight"] = rng.normal(
            size=(cfg.codebook_size, cfg.codebook_dim)).astype(np.float32)
    return sd


def _disc_reference_sd(cfg, style, seed=5):
    """A reference-layout discriminator state dict whose shapes are the port's module's."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in tdisc.Discriminator(cfg, device="meta")
              .state_dict().items() if k.endswith(".weight")}
    families = ([f"mpd.{i}" for i in range(len(cfg.periods))]
                + [f"msd.{i}" for i in range(len(cfg.rates))]
                + [f"mrd.{i}" for i in range(len(cfg.fft_sizes))])
    sd = {}
    for idx, family in enumerate(families):
        for name, shape in shapes.items():
            if not name.startswith(family + "."):
                continue
            rest = name[len(family) + 1:-len(".weight")]
            src = "conv_post" if rest == "post" else rest + ".0"
            sd.update(_wn_pair(rng, f"discriminators.{idx}.{src}", shape, style))
    return sd


def _assert_converted(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        if k.endswith(".weight") and not k.endswith("codebook"):
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), **FOLD_TOL, err_msg=k)
        else:
            assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("style", ["old", "new"])
def test_convert_rvq_equals_jax_then_from_jax(style):
    cfg = dict(input_dim=16, n_codebooks=3, codebook_size=32, codebook_dim=4)
    sd = _rvq_reference_sd(tq.RVQConfig(**cfg), style)
    ref = state_dict_from_jax(jax.device_get(
        jconv.convert_rvq_state_dict(dict(sd), jq.RVQConfig(**cfg), strict=True)))
    src = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = tconv.convert_rvq_state_dict(src, tq.RVQConfig(**cfg), strict=True, consume=True)
    assert not src  # every key consumed
    _assert_converted(got, ref)
    tconv.module_from_state_dict(tq.RVQ, got, tq.RVQConfig(**cfg), "cpu")


@pytest.mark.parametrize("style", ["old", "new"])
def test_convert_discriminator_equals_jax_then_from_jax(style):
    kw = dict(periods=(2,), rates=(1,), fft_sizes=(512,), sample_rate=48000)
    cfg = tdisc.DiscriminatorConfig(**kw)
    sd = _disc_reference_sd(cfg, style)
    ref = state_dict_from_jax(jax.device_get(jconv.convert_discriminator_state_dict(
        dict(sd), jdisc.DiscriminatorConfig(**kw), strict=True)))
    src = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = tconv.convert_discriminator_state_dict(src, cfg, strict=True, consume=True)
    assert not src
    _assert_converted(got, ref)
    tconv.module_from_state_dict(tdisc.Discriminator, got, cfg, "cpu")


def test_converters_report_missing_keys():
    cfg = tq.RVQConfig(input_dim=16, n_codebooks=2, codebook_size=8, codebook_dim=4)
    sd = {k: torch.from_numpy(v) for k, v in _rvq_reference_sd(cfg, "old").items()
          if "codebook" not in k}
    with pytest.raises(KeyError, match="2 missing keys"):
        tconv.convert_rvq_state_dict(sd, cfg, strict=True)
    dcfg = tdisc.DiscriminatorConfig(periods=(2,), rates=(), fft_sizes=())
    sd = {k: torch.from_numpy(v) for k, v in _disc_reference_sd(dcfg, "new").items()
          if ".conv_post." not in k}
    with pytest.raises(KeyError, match="missing keys"):
        tconv.convert_discriminator_state_dict(sd, dcfg, strict=True)
