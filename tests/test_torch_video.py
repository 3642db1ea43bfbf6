"""Video ingest on the port (``foley_tpu_torch/pipeline/video.py``, ``io/png.py``,
``io/avi.py``, ``io/audio.py::merge_audio_video``) against the JAX package's, on the CPU.

- PNG frames: written by PIL here in every colour type the reader takes, odd widths, and by
  the port's own writer with every scanline filter; the port's reader must equal PIL's
  ``convert("RGB")`` bit for bit, and what it refuses must name PIL.
- Frame selection: the frames the JAX ``read_frames_dir`` returns, exactly, with and without
  ``target_fps`` and ``max_frames``.
- ffmpeg: stand-in ``ffmpeg`` / ``ffprobe`` scripts on ``PATH`` record their argv (as
  ``tests/test_video_frames.py`` stands in for ``av``): the argv and the frames must equal the
  JAX route's; without ffmpeg both raise the same message.
- The surfaces at the TINY config: a frames-directory V2A through the command line, the
  server's ``frames_path`` and ``standalone.feature_process``, with the JAX noise injected.
  Tolerances: the CLI's 5 int16 steps, audio atol 1e-4 (``tests/test_torch_nodes.py``'s),
  the fp32 encoders' features (magnitude ~50 on the seeded checkpoints) rtol and atol 1e-4.
"""

import json
import os
import struct
import sys
import zlib
from typing import Sequence

import numpy as np
import pytest
import torch
from PIL import Image

from foley_tpu.io import audio as jaudio
from foley_tpu.io import avi as javi
from foley_tpu.pipeline import standalone as jsa
from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.configs import TINY, SynchformerConfig
from foley_tpu_torch.io import audio as taudio
from foley_tpu_torch.io import avi as tavi
from foley_tpu_torch.io import png as tpng
from foley_tpu_torch.models import synchformer as tsync
from foley_tpu_torch.pipeline import generate as tgen
from foley_tpu_torch.pipeline import standalone as tsa
from foley_tpu_torch.pipeline import video as tvideo
from helpers import save_tiny_siglip2_checkpoint
from test_torch_convert import _synchformer_sd
from test_torch_nodes import SYNC_FIELDS, _inject_noise, ckpts, graphs  # noqa: F401 (fixtures)
from test_torch_serving import services  # noqa: F401 (fixture)
from torch_helpers import jax_latents, one_torch_thread, save_checkpoint_dir  # noqa: F401
from torch_helpers import jax_native_library  # noqa: F401 (autouse)

AUDIO_TOL = dict(atol=1e-4, rtol=0)
FEAT_TOL = dict(atol=1e-4, rtol=1e-4)  # features of magnitude ~50: fp32 sums, other order
PCM_TOL = 5


def encode_png(rgb: np.ndarray, filters: Sequence[int] = (0, 1, 2, 3, 4)) -> bytes:
    """``[H, W, 3]`` uint8 -> PNG bytes (8-bit RGB), row ``r`` filtered with
    ``filters[r % len(filters)]``: a stdlib writer of test frames for the port's PNG reader."""
    h, w, _ = rgb.shape
    img = rgb.astype(np.int16)
    left = np.zeros_like(img)
    left[:, 1:] = img[:, :-1]
    up = np.zeros_like(img)
    up[1:] = img[:-1]
    upleft = np.zeros_like(img)
    upleft[1:, 1:] = img[:-1, :-1]
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(img), left, up, (left + up) >> 1, paeth]
    kinds = np.asarray([filters[r % len(filters)] for r in range(h)], np.uint8)
    body = np.empty((h, 1 + w * 3), np.uint8)
    body[:, 0] = kinds
    for r in range(h):
        body[r, 1:] = ((img[r] - preds[kinds[r]][r]) & 0xFF).astype(np.uint8).reshape(-1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), 1)) + chunk(b"IEND", b""))


def _pil_frames(tmp_path, rng):
    """One PNG per colour type (and a palette with tRNS, grey with tRNS), odd sizes."""
    h, w = 9, 13
    paths = []
    for i, (mode, ch) in enumerate([("RGB", 3), ("L", 1), ("LA", 2), ("RGBA", 4), ("P", 1),
                                    ("P", 1), ("L", 1)]):
        arr = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        arr[:, : w // 2] = arr[:, :1]  # flat runs, so PIL's adaptive filters vary by row
        if mode == "P":
            im = Image.frombytes("P", (w, h), arr.tobytes())
            im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
        else:
            im = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode=mode)
        kw = {"transparency": 3} if i >= 5 else {}
        p = tmp_path / f"{i}_{mode}.png"
        im.save(p, **kw)
        paths.append(str(p))
    return paths


def test_png_reader_equals_pil(tmp_path):
    rng = np.random.default_rng(0)
    paths = _pil_frames(tmp_path, rng)
    for i, img in enumerate([rng.integers(0, 256, (17, 31, 3), dtype=np.uint8),
                             rng.integers(0, 4, (6, 5, 3), dtype=np.uint8) * 60]):
        for filters in [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 2, 1)]:
            p = tmp_path / f"own_{i}_{''.join(map(str, filters))}.png"
            p.write_bytes(encode_png(img, filters))
            paths.append(str(p))
    for p in paths:
        ref = np.asarray(Image.open(p).convert("RGB"))
        got = tpng.read_pngs([p], "cpu")[0]
        assert got.dtype == np.uint8 and np.array_equal(got, ref), p


def test_png_frames_unfilter_together(tmp_path):
    """Many frames of one geometry and mixed colour types through one wavefront."""
    rng = np.random.default_rng(1)
    paths = []
    for i in range(6):
        img = rng.integers(0, 256, (11, 7, 3), dtype=np.uint8)
        p = tmp_path / f"f{i}.png"
        if i % 2:
            Image.fromarray(img).save(p)
        else:
            p.write_bytes(encode_png(img, (i % 5, 4, 3)))
        paths.append(str(p))
    Image.fromarray(rng.integers(0, 256, (11, 7), dtype=np.uint8), mode="L").save(
        tmp_path / "grey.png")
    paths.append(str(tmp_path / "grey.png"))
    got = tpng.read_pngs(paths, "cpu")
    ref = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("chunk_frames", [3, tpng.CHUNK_FRAMES])
def test_png_frames_longer_than_one_chunk(tmp_path, monkeypatch, chunk_frames):
    """More frames than one wavefront takes: unfiltered a chunk at a time, each frame still
    equal to PIL's, in order; a frame of another size in a later chunk raises."""
    monkeypatch.setattr(tpng, "CHUNK_FRAMES", chunk_frames)
    rng = np.random.default_rng(5)
    paths = []
    for i in range(chunk_frames + 5):
        img = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
        p = tmp_path / f"f{i}.png"
        if i % 3 == 1:
            Image.fromarray(img[..., 0], mode="L").save(p)
        else:
            p.write_bytes(encode_png(img, (i % 5, 3, 4, 1)))
        paths.append(str(p))
    got = tpng.read_pngs(paths, "cpu")
    ref = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in paths])
    assert np.array_equal(got, ref)
    Image.fromarray(rng.integers(0, 256, (4, 6, 3), dtype=np.uint8)).save(tmp_path / "odd.png")
    with pytest.raises(ValueError, match="differ in size"):
        tpng.read_pngs(paths[:chunk_frames] + [str(tmp_path / "odd.png")], "cpu")


def _patch_ihdr(data: bytes, **fields) -> bytes:
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    vals = dict(depth=depth, ctype=ctype, interlace=interlace)
    vals.update(fields)
    body = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["ctype"], comp, filt,
                       vals["interlace"])
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


def test_png_refusals_name_pil(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
    cases = {}
    Image.fromarray(rng.integers(0, 65535, (5, 6), dtype=np.uint16)).save(
        tmp_path / "sixteen.png")
    cases["sixteen"] = (tmp_path / "sixteen.png").read_bytes()
    small = Image.frombytes("P", (6, 5), rng.integers(0, 4, 30, dtype=np.uint8).tobytes())
    small.putpalette(list(range(12)))
    small.save(tmp_path / "p4.png", bits=2)
    cases["palette_2bit"] = (tmp_path / "p4.png").read_bytes()
    Image.fromarray(rng.integers(0, 2, (5, 6), dtype=np.uint8) * 255).convert("1").save(
        tmp_path / "one.png")
    cases["one_bit"] = (tmp_path / "one.png").read_bytes()
    cases["interlaced"] = _patch_ihdr(encode_png(img), interlace=1)
    for name, data in cases.items():
        p = tmp_path / f"{name}_case.png"
        p.write_bytes(data)
        with pytest.raises(tpng.PNGUnsupported, match="PIL"):
            tpng.read_pngs([str(p)], "cpu")
    frames = tmp_path / "jpeg_dir"
    frames.mkdir()
    Image.fromarray(img).save(frames / "0001.png")
    Image.fromarray(img).save(frames / "0002.jpg")
    with pytest.raises(RuntimeError, match="PIL"):
        tvideo.read_frames_dir(str(frames), device="cpu")


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """19 distinct 8x10 frames under natural-sort names (frame_2 before frame_10), a stray
    non-image file."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(3)
    for i in range(19):
        img = rng.integers(0, 256, (8, 10, 3), dtype=np.uint8)
        name = root / f"frame_{i + 1}.png"
        if i % 3:
            Image.fromarray(img).save(name)
        else:
            name.write_bytes(encode_png(img, (i % 5, 3, 4)))
    (root / "notes.txt").write_text("not a frame")
    return str(root)


@pytest.mark.parametrize("kw", [{}, dict(target_fps=25.0), dict(target_fps=8.0),
                                dict(max_frames=5), dict(target_fps=25.0, max_frames=7),
                                dict(fps=12.0, target_fps=12.0)])
def test_frame_selection_matches_jax(frames_dir, kw):
    ref, ref_fps = jvideo.read_frames_dir(frames_dir, **kw)
    got, fps = tvideo.read_frames_dir(frames_dir, **kw, device="cpu")
    assert fps == ref_fps
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    names, _ = tvideo.frame_names(frames_dir, **kw)
    assert names[:3] == sorted(names[:3], key=tvideo._natural_key)


def test_read_video_frames_on_a_directory_matches_jax(frames_dir):
    ref, ref_fps = jvideo.read_video_frames(frames_dir, target_fps=25, dir_fps=16.0)
    got, fps = tvideo.read_video_frames(frames_dir, target_fps=25, dir_fps=16.0,
                                        device="cpu")
    assert fps == ref_fps == 25
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------------
# ffmpeg and the AVI
# ---------------------------------------------------------------------------------

@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    """Stand-in ``ffmpeg`` / ``ffprobe`` on ``PATH``: each call appends its argv to a log;
    ffmpeg writes a seeded clip as rgb24 (or a tone as f32le, or the mux output file)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "argv.jsonl"
    rng = np.random.default_rng(5)
    clip = rng.integers(0, 256, (6, 4, 5, 3), dtype=np.uint8)
    np.save(tmp_path / "clip.npy", clip)
    np.save(tmp_path / "tone.npy", np.sin(np.arange(16000) / 7.0).astype(np.float32))
    head = f"#!{sys.executable}\nimport json, sys\nimport numpy as np\n" \
           f"open({str(log)!r}, 'a').write(json.dumps(sys.argv) + '\\n')\n"
    (bin_dir / "ffprobe").write_text(
        head + "print(json.dumps({'streams': [{'width': 5, 'height': 4, "
        "'avg_frame_rate': '30000/1001'}]}))\n")
    (bin_dir / "ffmpeg").write_text(
        head + f"if 'rawvideo' in sys.argv:\n"
        f"    sys.stdout.buffer.write(np.load({str(tmp_path / 'clip.npy')!r}).tobytes())\n"
        f"elif 'f32le' in sys.argv:\n"
        f"    sys.stdout.buffer.write(np.load({str(tmp_path / 'tone.npy')!r}).tobytes())\n"
        "else:\n    open(sys.argv[-1], 'wb').write(b'muxed')\n")
    for name in ("ffmpeg", "ffprobe"):
        os.chmod(bin_dir / name, 0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\0" * 64)

    def calls():
        lines = log.read_text().splitlines() if log.exists() else []
        log.write_text("")
        return [json.loads(x) for x in lines]

    return str(video), clip, calls


@pytest.mark.parametrize("kw", [{}, dict(target_fps=25.0), dict(max_frames=4),
                                dict(target_fps=8.0, max_frames=2)])
def test_ffmpeg_route_matches_jax(fake_ffmpeg, kw):
    video, clip, calls = fake_ffmpeg
    ref, ref_fps = jvideo.read_video_frames(video, **kw)
    ref_argv = calls()
    got, fps = tvideo.read_video_frames(video, **kw)
    assert calls() == ref_argv and len(ref_argv) == 2
    assert fps == ref_fps
    np.testing.assert_array_equal(got, ref)
    n = min(len(clip), kw.get("max_frames") or len(clip))
    np.testing.assert_array_equal(got, clip[:n].astype(np.float32) / 255.0)


def test_merge_audio_video_matches_jax(fake_ffmpeg, tmp_path):
    video, _, calls = fake_ffmpeg
    for quality in ("high", "low"):
        out_j = jaudio.merge_audio_video(video, "a.wav", str(tmp_path / "j.mp4"), quality)
        ref = calls()
        out_t = taudio.merge_audio_video(video, "a.wav", str(tmp_path / "j.mp4"), quality)
        assert calls() == ref and out_t == out_j
    with pytest.raises(taudio.MediaProcessingError, match="PIL"):
        taudio.merge_audio_video(str(tmp_path), "a.wav", str(tmp_path / "x.mp4"))


def test_without_ffmpeg_both_raise_the_same(tmp_path, monkeypatch):
    """No ffmpeg on ``PATH`` and no PyAV (the card's machine): the JAX message, from both."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setitem(sys.modules, "av", None)  # another test file may stand one in
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\0" * 64)
    with pytest.raises(RuntimeError) as ref:
        jvideo.read_video_frames(str(video))
    with pytest.raises(RuntimeError) as got:
        tvideo.read_video_frames(str(video))
    assert str(got.value) == str(ref.value)
    with pytest.raises(jaudio.MediaProcessingError) as ref:
        jaudio.merge_audio_video(str(video), "a.wav", "o.mp4")
    with pytest.raises(taudio.MediaProcessingError) as got:
        taudio.merge_audio_video(str(video), "a.wav", "o.mp4")
    assert str(got.value) == str(ref.value)


def test_mjpeg_avi_audio_reads_and_frames_name_pil(tmp_path):
    """The JAX package's muxer writes an MJPEG + PCM AVI (PIL, here): the port reads its
    audio track as the JAX ``read_avi`` does, and refuses its JPEG frames naming PIL."""
    rng = np.random.default_rng(6)
    frames = rng.random((3, 8, 8, 3)).astype(np.float32)
    audio = (0.3 * np.sin(np.arange(4800) / 9.0)).astype(np.float32)
    path = javi.mux_frames_audio_avi(frames, 12.0, audio, 16000, str(tmp_path / "c.avi"))
    _, _, ref_audio, ref_sr = javi.read_avi(path)
    got_audio, got_sr = tavi.read_avi_audio(path)
    assert got_sr == ref_sr == 16000
    np.testing.assert_array_equal(got_audio, ref_audio)
    assert tavi.is_mjpeg_avi(path) and not tavi.is_mjpeg_avi(str(tmp_path / "none.avi"))
    with pytest.raises(RuntimeError, match="PIL"):
        tvideo.read_video_frames(path)


# ---------------------------------------------------------------------------------
# The surfaces
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v2a_dir(tmp_path_factory):
    """A checkpoint directory with a SigLIP2 beside the denoiser, DAC and CLAP, a tiny
    Synchformer file, and 24 PNG frames (16x20) of a moving pattern."""
    root = tmp_path_factory.mktemp("v2a_ckpts")
    save_checkpoint_dir(root)
    save_tiny_siglip2_checkpoint(str(root / "siglip2"), hidden=TINY.model.clip_dim, heads=2)
    from foley_tpu_torch.io.convert import save_safetensors

    save_safetensors(str(root / "sync_tiny.safetensors"),
                     _synchformer_sd(SynchformerConfig(**SYNC_FIELDS), 6))
    frames = root / "frames"
    frames.mkdir()
    yy, xx = np.mgrid[0:16, 0:20]
    for i in range(24):
        img = np.stack([(xx * 12 + i * 9) % 256, (yy * 15 + i * 5) % 256,
                        ((xx + yy) * 7 + i * 3) % 256], -1).astype(np.uint8)
        (frames / f"{i:04d}.png").write_bytes(encode_png(img, (i % 5, 1, 4)))
    return root


def test_cli_frames_dir_v2a_matches_jax(v2a_dir, monkeypatch, tmp_path, caplog):
    from test_torch_cli import RUN, _inject_noise as cli_noise, _read

    from foley_tpu import cli as jcli
    from foley_tpu_torch import cli as tcli

    argv = ["--model_path", str(v2a_dir), "--single_video", str(v2a_dir / "frames"),
            "--frames_fps", "8", "--duration", "1"] + RUN
    assert jcli.main(argv + ["--output", str(tmp_path / "jax.wav")]) == 0
    cli_noise(monkeypatch, 3)
    with caplog.at_level("INFO", logger="foley_tpu_torch"):
        assert tcli.main(argv + ["--output", str(tmp_path / "port.wav"),
                                 "--device", "cpu"]) == 0
    assert "read 24 frames @ 8.0 fps" in caplog.text
    ref, got = _read(tmp_path / "jax.wav"), _read(tmp_path / "port.wav")
    assert got.shape == ref.shape == (48000,)
    assert np.abs(got - ref).max() <= PCM_TOL


def test_server_frames_path_matches_jax(services, v2a_dir, monkeypatch):  # noqa: F811
    j_svc, t_svc = services
    body = {"prompt": "glass shattering", "negative_prompt": "noisy harsh", "duration": 1.0,
            "steps": 2, "seed": 5, "frames_path": str(v2a_dir / "frames"), "frames_fps": 8.0}
    ref = j_svc.generate(dict(body))
    _inject_noise(monkeypatch, 5, tgen)
    got = t_svc.generate(dict(body))
    np.testing.assert_allclose(got["waveform"], np.asarray(ref["waveform"]), **AUDIO_TOL)
    t_svc.frames_root = str(v2a_dir / "elsewhere")
    try:
        with pytest.raises(ValueError, match="allowlist"):
            t_svc.generate(dict(body))
        t_svc.frames_root = None
        with pytest.raises(ValueError, match="disabled"):
            t_svc.generate(dict(body))
    finally:
        t_svc.frames_root = "/"


def test_feature_process_of_a_frames_dir_matches_jax(v2a_dir, monkeypatch):
    from foley_tpu.models import synchformer as jsync

    sync_path = str(v2a_dir / "sync_tiny.safetensors")
    j_md = jsa.load_model(str(v2a_dir), config="tiny")
    t_md = tsa.load_model(str(v2a_dir), config="tiny", device="cpu", encoder_precision="fp32")

    def j_sync():
        enc = jsync.load(sync_path, jsync.SynchformerConfig(**SYNC_FIELDS))
        enc.preprocess = "device"
        return enc

    j_md.register("synchformer", j_sync)
    t_md.register("synchformer", lambda: tsync.load(
        sync_path, SynchformerConfig(**SYNC_FIELDS), device="cpu"))
    j_md.siglip2.preprocess = "device"
    frames = str(v2a_dir / "frames")
    j_vis, j_text, j_len = jsa.feature_process(frames, "rain", j_md, neg_prompt="noisy harsh")
    t_vis, t_text, t_len = tsa.feature_process(frames, "rain", t_md, neg_prompt="noisy harsh")
    assert t_len == j_len == int(24 / 16 * 25) / 25  # the 25 fps stream's length
    assert set(t_vis) == set(j_vis) == {"siglip2_feat", "syncformer_feat"}
    for k in t_vis:
        np.testing.assert_allclose(t_vis[k].numpy(), np.asarray(j_vis[k]), **FEAT_TOL)
    kw = dict(guidance_scale=4.5, num_inference_steps=2, seed=3)
    ref, _ = jsa.denoise_process(j_vis, j_text, j_len, j_md, **kw)
    monkeypatch.setattr(tgen, "prepare_latents", jax_latents(3))
    got, _ = tsa.denoise_process(t_vis, t_text, t_len, t_md, **kw)
    np.testing.assert_allclose(got, np.asarray(ref), **AUDIO_TOL)
    assert torch.is_tensor(t_vis["syncformer_feat"])
