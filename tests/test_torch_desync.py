"""The AV desync scorer on the port (``foley_tpu_torch/ops/audio_dsp.py``, ``models/ast.py``,
``models/sync_scorer.py``, the CLI's ``--desync_score``) against the JAX package's, on the CPU.

Both packages read one state dict under the reference checkpoint's key names, drawn from a
seed (``sync_scorer.random_checkpoint``; no reference checkpoint is in the repo), through
their own converters. The JAX scorer's video encoder takes the device resize
(``preprocess = "device"`` set on the instance), the port's only route.

Tolerances: the STFT power within rtol 1e-4 (torch's FFT and XLA's differ in the last
places); the normalised log-mel within atol 2e-4 on a signal whose quietest mel bin is
above 1e-3 (``log(mel + 1e-6)`` turns an absolute error e of a near-silent bin into e / 1e-6,
so a silent input is held on its louder bins only); AST and the scorer at fp32 atol 1e-4 /
rtol 1e-4 (tiny) and relative L2 1e-5 (real width, one segment); the whole score: the same
offset class as JAX and logits within relative L2 1e-4.
"""

import json
import os
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu import cli as jcli
from foley_tpu.io import audio as jaudio
from foley_tpu.io import avi as javi
from foley_tpu.models import ast as jast
from foley_tpu.models import sync_scorer as jsc
from foley_tpu.models import synchformer as jsync
from foley_tpu.ops import audio_dsp as jdsp
from foley_tpu.pipeline import video as jvideo
from foley_tpu.pipeline.features import sync_segments
from foley_tpu_torch import cli as tcli
from foley_tpu_torch.configs import SynchformerConfig
from foley_tpu_torch.io import audio as taudio
from foley_tpu_torch.io.convert import save_safetensors
from foley_tpu_torch.models import ast as tast
from foley_tpu_torch.models import sync_scorer as tsc
from foley_tpu_torch.ops import audio_dsp as tdsp
from foley_tpu_torch.pipeline import video as tvideo
from test_torch_video import encode_png
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
D = 32
VIDEO = dict(img_size=32, patch_size=8, temporal_patch_size=2, num_frames=16, embed_dim=D,
             depth=1, num_heads=2, mlp_ratio=2.0)
AST_SMALL = dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=64)
SCORER = dict(n_embd=D, n_layer=1, n_head=2)


def _configs():
    return (SynchformerConfig(**VIDEO), tast.ASTConfig(**AST_SMALL),
            tsc.SyncScorerConfig(**SCORER))


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax_scorer(sd_np, preprocess="device"):
    """The JAX ``load_desync_scorer``'s assembly at the small configs, from numpy."""
    vcfg = jsync.SynchformerConfig(**VIDEO)
    video = jsync.SynchformerEncoder(jsync.convert_state_dict(sd_np, vcfg,
                                                              prefix="vfeat_extractor."), vcfg)
    video.preprocess = preprocess
    acfg = jast.ASTConfig(**AST_SMALL)
    ast_params = jast.convert_hf_state_dict(sd_np, acfg, prefix="afeat_extractor.ast.")
    agg = jsync.convert_torch_encoder_layer(sd_np, "afeat_extractor.freq_attn_agg.", D)
    scfg = jsc.SyncScorerConfig(**SCORER)
    return jsc.DesyncScorer(video, ast_params, agg, acfg, jsc.convert_state_dict(sd_np, scfg),
                            scfg)


def _jax_logits(scorer, frames, wav):
    """``jsc.DesyncScorer.score``'s steps, returning the logits."""
    vis = jsync.encode_segments(scorer.video_encoder, sync_segments(frames))
    s = vis.shape[1] // scorer.video_encoder.cfg.out_features_per_segment
    vis = vis.reshape(1, s, -1, vis.shape[-1])
    spec = jdsp.sync_audio_spectrogram(jdsp.segment_audio(jnp.asarray(wav, jnp.float32)[None]))
    sa = spec.shape[1]
    spec_tf = jnp.swapaxes(spec.reshape(sa, *spec.shape[2:]), 1, 2)
    aud = jast.extract_features(scorer.ast_params, scorer.freq_agg_params, spec_tf,
                                scorer.ast_cfg)
    return np.asarray(jsc.compare_v_a(scorer.scorer_params, vis,
                                      aud.reshape(1, sa, -1, aud.shape[-1]),
                                      scorer.scorer_cfg))


def _signal(seconds, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 3100 * t)
            + 0.05 * rng.normal(size=t.shape)).astype(np.float32)


# ---------------------------------------------------------------------------------
# DSP
# ---------------------------------------------------------------------------------

def test_filterbank_window_and_segments_match_jax():
    np.testing.assert_array_equal(tdsp.mel_filterbank(), np.asarray(jdsp.mel_filterbank()))
    np.testing.assert_allclose(tdsp.hann_window(400).numpy(),
                               np.asarray(jdsp.hann_window(400)), atol=1e-7, rtol=0)
    for n in (30000, 10240, 4000):  # several segments, one, shorter than a segment
        x = _signal(n / 16000, seed=n)[None]
        np.testing.assert_array_equal(tdsp.segment_audio(torch.from_numpy(x)).numpy(),
                                      np.asarray(jdsp.segment_audio(jnp.asarray(x))))


def test_spectrogram_matches_audio_dsp():
    x = _signal(0.64, seed=1)[None]
    ref_p = np.asarray(jdsp.stft_power(jnp.asarray(x)))
    got_p = tdsp.stft_power(torch.from_numpy(x)).numpy()
    assert got_p.shape == ref_p.shape == (1, 513, 65)
    np.testing.assert_allclose(got_p, ref_p, rtol=1e-4, atol=1e-4 * float(ref_p.max()))
    ref_mel = np.asarray(jdsp.mel_spectrogram(jnp.asarray(x)))
    assert ref_mel.min() > 1e-3
    ref = np.asarray(jdsp.sync_audio_spectrogram(jnp.asarray(x)))
    got = tdsp.sync_audio_spectrogram(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 128, 66)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    quiet = np.zeros((1, 8000), np.float32)  # silence: the bins sit at log(1e-6)
    np.testing.assert_allclose(tdsp.sync_audio_spectrogram(torch.from_numpy(quiet)).numpy(),
                               np.asarray(jdsp.sync_audio_spectrogram(jnp.asarray(quiet))),
                               atol=2e-4, rtol=0)


# ---------------------------------------------------------------------------------
# AST and the scorer head
# ---------------------------------------------------------------------------------

def _ast_pair(ast_cfg, seed):
    """(JAX params, JAX freq agg, port AST, port freq agg) from one seeded checkpoint."""
    vcfg, _, scfg = _configs()
    sd = tsc.random_checkpoint(seed, vcfg, ast_cfg, tsc.SyncScorerConfig(
        n_embd=ast_cfg.hidden_size, n_layer=1, n_head=2), ast_positions=100)
    sd_np = _np(sd)
    jcfg = jast.ASTConfig(**{f: getattr(ast_cfg, f) for f in jast.ASTConfig.__dataclass_fields__})
    from foley_tpu_torch.io.convert import module_from_state_dict

    port = module_from_state_dict(tast.AST, tast.convert_hf_state_dict(
        sd, ast_cfg, "afeat_extractor.ast."), ast_cfg, "cpu", torch.float32)
    agg = tsc.freq_agg_from_state_dict(sd, "afeat_extractor.freq_attn_agg.",
                                       ast_cfg.hidden_size, "cpu")
    return (jast.convert_hf_state_dict(sd_np, jcfg, prefix="afeat_extractor.ast."),
            jsync.convert_torch_encoder_layer(sd_np, "afeat_extractor.freq_attn_agg.",
                                              ast_cfg.hidden_size), jcfg, port, agg)


def test_ast_matches_jax():
    cfg = tast.ASTConfig(**AST_SMALL)
    j_params, j_agg, jcfg, port, agg = _ast_pair(cfg, 1)
    spec = np.random.default_rng(2).normal(size=(3, 66, 128)).astype(np.float32)
    ref = np.asarray(jast.apply(j_params, jnp.asarray(spec), jcfg))
    with torch.no_grad():
        got = tast.apply(port, torch.from_numpy(spec)).numpy()
    assert got.shape == ref.shape == (3, 2 + 12 * 6, D)
    np.testing.assert_allclose(got, ref, **TOL)
    ref = np.asarray(jast.extract_features(j_params, j_agg, jnp.asarray(spec), jcfg))
    with torch.no_grad():
        got = tast.extract_features(port, agg, torch.from_numpy(spec)).numpy()
    assert got.shape == (3, 6, D)
    np.testing.assert_allclose(got, ref, **TOL)


def test_ast_and_scorer_at_real_width_one_segment():
    """AST base (12 layers of 768, 74 tokens) and the 3-layer 768-wide head, one segment."""
    cfg = tast.ASTConfig()
    j_params, j_agg, jcfg, port, agg = _ast_pair(cfg, 3)
    spec = np.random.default_rng(4).normal(size=(1, 66, 128)).astype(np.float32)
    ref = np.asarray(jast.extract_features(j_params, j_agg, jnp.asarray(spec), jcfg))
    with torch.no_grad():
        got = tast.extract_features(port, agg, torch.from_numpy(spec)).numpy()
    assert got.shape == ref.shape == (1, 6, 768)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5
    scfg = tsc.SyncScorerConfig()
    sd = tsc.random_checkpoint(5, SynchformerConfig(**dict(VIDEO, embed_dim=768)),
                               tast.ASTConfig(**dict(AST_SMALL, hidden_size=768)), scfg)
    j_head = jsc.convert_state_dict(_np(sd), jsc.SyncScorerConfig())
    from foley_tpu_torch.io.convert import module_from_state_dict

    head = module_from_state_dict(tsc.SyncScorer, tsc.convert_state_dict(sd, scfg), scfg,
                                  "cpu", torch.float32)
    rng = np.random.default_rng(6)
    vis = rng.normal(size=(1, 1, 8, 768)).astype(np.float32)
    ref = np.asarray(jsc.compare_v_a(j_head, jnp.asarray(vis), jnp.asarray(ref[:, None]),
                                     jsc.SyncScorerConfig()))
    with torch.no_grad():
        got = tsc.compare_v_a(head, torch.from_numpy(vis), torch.from_numpy(got[:, None]))
    assert got.shape == (1, 21)
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) < 1e-5


def test_from_jax_converters_match():
    """``io/from_jax.py``'s ``ast_from_jax`` and ``sync_scorer_from_jax`` on the JAX
    packages' own trees (``ast.init``, ``sync_scorer.init`` at their tiny configs, the
    frequency pooling from a converted encoder layer): the same features and logits."""
    from foley_tpu_torch.io.from_jax import ast_from_jax, sync_scorer_from_jax

    jcfg, tcfg = jast.ASTConfig.tiny(), tast.ASTConfig.tiny()
    params = jax.device_get(jast.init(jax.random.PRNGKey(1), jcfg))
    agg = jax.device_get(jsync.convert_torch_encoder_layer(
        _np(tsc.random_checkpoint(2, SynchformerConfig(**dict(VIDEO, embed_dim=32)), tcfg,
                                  tsc.SyncScorerConfig(n_embd=32, n_layer=1, n_head=2))),
        "afeat_extractor.freq_attn_agg.", 32))
    port, port_agg = ast_from_jax(params, agg, tcfg, device="cpu")
    spec = np.random.default_rng(3).normal(size=(2, jcfg.max_length,
                                                 jcfg.num_mel_bins)).astype(np.float32)
    ref = np.asarray(jast.extract_features(params, agg, jnp.asarray(spec), jcfg))
    with torch.no_grad():
        got = tast.extract_features(port, port_agg, torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    scfg = jsc.SyncScorerConfig.tiny()
    sparams = jax.device_get(jsc.init(jax.random.PRNGKey(4), scfg))
    head = sync_scorer_from_jax(sparams, tsc.SyncScorerConfig.tiny(), device="cpu")
    rng = np.random.default_rng(5)
    vis = rng.normal(size=(1, 2, 4, 16)).astype(np.float32)
    aud = rng.normal(size=(1, 2, 3, 16)).astype(np.float32)
    ref = np.asarray(jsc.compare_v_a(sparams, jnp.asarray(vis), jnp.asarray(aud), scfg))
    with torch.no_grad():
        got = tsc.compare_v_a(head, torch.from_numpy(vis), torch.from_numpy(aud)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


# ---------------------------------------------------------------------------------
# The whole score and the CLI
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scorer_files(tmp_path_factory):
    """A seeded checkpoint at the small widths, a 2.4 s PNG directory at 16 fps (a moving
    pattern, 40x48) and a 48 kHz WAV of it."""
    root = tmp_path_factory.mktemp("desync")
    vcfg, acfg, scfg = _configs()
    sd = tsc.random_checkpoint(7, vcfg, acfg, scfg)
    save_safetensors(str(root / "synchformer_state_dict.safetensors"), sd)
    frames = root / "frames"
    frames.mkdir()
    yy, xx = np.mgrid[0:40, 0:48]
    for i in range(38):
        img = np.stack([(xx * 5 + i * 11) % 256, (yy * 6 + i * 3) % 256,
                        ((xx - yy) * 4 + i * 7) % 256], -1).astype(np.uint8)
        (frames / f"{i:03d}.png").write_bytes(encode_png(img, (i % 5, 3)))
    pcm = (np.clip(_signal(2.4, sr=48000, seed=3), -1, 1) * 32767).astype("<i2")
    with wave.open(str(root / "audio.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(48000)
        f.writeframes(pcm.tobytes())
    return root, sd


def test_read_wav_resamples_as_jax(scorer_files):
    root, _ = scorer_files
    ref, ref_sr = jaudio.read_wav(str(root / "audio.wav"), target_sr=16000)
    got, sr = taudio.read_wav(str(root / "audio.wav"), target_sr=16000)
    assert sr == ref_sr == 16000
    np.testing.assert_array_equal(got, ref)


def test_desync_scorer_matches_jax(scorer_files):
    """``DesyncScorer`` on the PNG directory (read at 25 fps) and the WAV: the port's loader
    on the file, the JAX scorer assembled from the same state dict."""
    root, sd = scorer_files
    frames, fps = tvideo.read_video_frames(str(root / "frames"), target_fps=25, dir_fps=16.0,
                                           device="cpu")
    j_frames, _ = jvideo.read_video_frames(str(root / "frames"), target_fps=25, dir_fps=16.0)
    np.testing.assert_array_equal(frames, j_frames)
    wav, _ = taudio.read_wav(str(root / "audio.wav"), target_sr=16000)
    vcfg, acfg, scfg = _configs()
    port = tsc.load_desync_scorer(str(root / "synchformer_state_dict.safetensors"), "cpu",
                                  vcfg, acfg, scfg)
    ref = _jax_logits(_jax_scorer(_np(sd)), j_frames, wav)
    got = port.logits(frames, wav).numpy()
    assert got.shape == ref.shape == (1, 21) and np.isfinite(got).all()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4
    assert got.argmax() == ref.argmax()
    np.testing.assert_array_equal(port.score(frames, wav),
                                  _jax_scorer(_np(sd)).score(j_frames, wav))


def test_cli_desync_score_matches_jax(scorer_files, monkeypatch, capsys):
    """``--desync_score`` on a PNG directory plus ``--audio_input``: the same printed offset
    (each package's loader builds the small scorer from the checkpoint file)."""
    root, sd = scorer_files
    vcfg, acfg, scfg = _configs()
    real = tsc.load_desync_scorer
    monkeypatch.setattr(jsc, "load_desync_scorer", lambda path: _jax_scorer(_np(sd)))
    monkeypatch.setattr(tsc, "load_desync_scorer",
                        lambda path, device=None: real(path, device, vcfg, acfg, scfg))
    argv = ["--desync_score", "--single_video", str(root / "frames"), "--frames_fps", "16",
            "--audio_input", str(root / "audio.wav"), "--model_path", str(root)]
    assert jcli.main(argv) == 0
    ref = capsys.readouterr().out.strip().splitlines()[-1]
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == ref and got.startswith("predicted AV offset: ")
    offset = float(got.split(": ")[1].split()[0])
    assert np.isclose(tsc.make_class_grid(), offset, atol=5e-3).any()


class _Recorder:
    """A scorer that records what it is given (``tests/test_video_frames.py``'s FakeScorer)."""

    def __init__(self):
        self.seen = []

    def score(self, frames, waveform):
        self.seen.append((np.asarray(frames), np.asarray(waveform, np.float32)))
        return np.asarray([0.4], np.float32)


def test_audio_routes_match_jax(tmp_path, monkeypatch, capsys):
    """The scorer's audio when no ``--audio_input`` is given, by the JAX CLI's routes: an
    MJPEG AVI's PCM track (resampled to 16 kHz), else ffmpeg's f32le extraction (the argv
    recorded by a stand-in ``ffmpeg``); without ffmpeg, the JAX error."""
    rng = np.random.default_rng(8)
    audio = (0.3 * np.sin(np.arange(24000) / 5.0)).astype(np.float32)
    avi = javi.mux_frames_audio_avi(rng.random((4, 8, 8, 3)).astype(np.float32), 8.0, audio,
                                    48000, str(tmp_path / "c.avi"))
    rec = _Recorder()
    monkeypatch.setattr(jsc, "load_desync_scorer", lambda path: rec)
    assert jcli.main(["--desync_score", "--single_video", avi]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(tcli._desync_waveform(avi, None), rec.seen[-1][1])

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "argv.jsonl"
    np.save(tmp_path / "clip.npy", rng.integers(0, 256, (20, 4, 6, 3), dtype=np.uint8))
    np.save(tmp_path / "tone.npy", _signal(1.0, seed=9))
    head = f"#!{sys.executable}\nimport json, sys\nimport numpy as np\n" \
           f"open({str(log)!r}, 'a').write(json.dumps(sys.argv) + '\\n')\n"
    (bin_dir / "ffprobe").write_text(head + "print(json.dumps({'streams': [{'width': 6, "
                                            "'height': 4, 'avg_frame_rate': '25/1'}]}))\n")
    (bin_dir / "ffmpeg").write_text(
        head + f"if 'rawvideo' in sys.argv:\n"
        f"    sys.stdout.buffer.write(np.load({str(tmp_path / 'clip.npy')!r}).tobytes())\n"
        f"else:\n    sys.stdout.buffer.write(np.load({str(tmp_path / 'tone.npy')!r}).tobytes())\n")
    for name in ("ffmpeg", "ffprobe"):
        os.chmod(bin_dir / name, 0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\0" * 64)
    assert jcli.main(["--desync_score", "--single_video", str(video)]) == 0
    ref_out = capsys.readouterr().out
    ref_argv = log.read_text().splitlines()
    log.write_text("")
    monkeypatch.setattr(tsc, "load_desync_scorer", lambda path, device=None: rec)
    assert tcli.main(["--desync_score", "--single_video", str(video), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ref_out
    assert log.read_text().splitlines() == ref_argv and "f32le" in ref_argv[-1]
    np.testing.assert_array_equal(rec.seen[-1][1], rec.seen[-2][1])
    np.testing.assert_array_equal(rec.seen[-1][0], rec.seen[-2][0])

    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setitem(sys.modules, "av", None)  # no PyAV either, as on the card's machine
    assert jcli.main(["--desync_score", "--single_video", str(video)]) == 1
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert tcli.main(["--desync_score", "--single_video", str(video), "--device", "cpu"]) == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == ref_err


def test_pil_route_gap(capsys):
    """The JAX scorer's default PIL resize against the device resize the port takes, on the
    same frames and weights, at the real frame geometry (a 640x360 clip made in numpy, resized
    to 224; small widths): the gap in logits, printed (``-s``) for the record. The bound only
    says that the two routes score the same clip."""
    vcfg = dict(VIDEO, img_size=224, patch_size=16)
    sd = tsc.random_checkpoint(11, SynchformerConfig(**vcfg), tast.ASTConfig(**AST_SMALL),
                               tsc.SyncScorerConfig(**SCORER))
    yy, xx = np.mgrid[0:360, 0:640]
    frames = np.stack([np.stack([np.sin(xx / (17 + i)), np.cos(yy / (11 + i)),
                                 np.sin((xx + yy) / 29)], -1) * 0.5 + 0.5
                       for i in range(16)]).astype(np.float32)
    wav = _signal(0.64, seed=12)

    def logits(preprocess):
        scorer = _jax_scorer(_np(sd), preprocess)
        scorer.video_encoder = jsync.SynchformerEncoder(
            jsync.convert_state_dict(_np(sd), jsync.SynchformerConfig(**vcfg),
                                     prefix="vfeat_extractor."),
            jsync.SynchformerConfig(**vcfg), preprocess=preprocess)
        return _jax_logits(scorer, frames, wav)

    dev, pil = logits("device"), logits("pil")
    gap = float(np.linalg.norm(pil - dev) / np.linalg.norm(dev))
    u8 = jnp.asarray(np.round(frames * 255).astype(np.uint8))
    pixels = float(np.abs(np.asarray(jsync.preprocess_frames(frames, 224))
                          - np.asarray(jsync.preprocess_frames_device(u8, 224))).max())
    with capsys.disabled():
        print(f"\nPIL-route gap (JAX scorer, 16 frames 640x360 -> 224, small widths): "
              f"logits relative L2 {gap:.3e}, argmax {int(pil.argmax())} vs "
              f"{int(dev.argmax())}; preprocessed pixels max abs {pixels:.3e}")
    assert np.isfinite(gap) and gap < 0.5
