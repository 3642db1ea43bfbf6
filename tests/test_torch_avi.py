"""The MJPEG + PCM AVI writer and reader on the port (``foley_tpu_torch/io/avi.py``, its JPEGs
from ``io/jpeg.py``) against the JAX package's ``foley_tpu/io/avi.py`` (PIL's JPEG), on the
CPU: the same frames and audio give the same bytes, and the same file reads back to the same
frames, rate and audio. No tolerance: every comparison is exact.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from foley_tpu.io import avi as javi
from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import avi as tavi
from foley_tpu_torch.io.native import wav_image
from foley_tpu_torch.pipeline import video as tvideo
from torch_helpers import jax_native_library, one_torch_thread  # noqa: F401 (autouse)


def _clip(n=6, h=18, w=26, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 9 + y * 4) % 256, (y * 11) % 256, (x * 5) % 256], -1)
    frames = np.stack([(base + 13 * i) % 256 for i in range(n)]).astype(np.float32) / 255.0
    frames += rng.normal(0, 0.05, frames.shape).astype(np.float32)
    return np.clip(frames, 0, 1)


def _audio(seconds=0.5, sr=16000, seed=1):
    t = np.arange(int(seconds * sr)) / sr
    noise = np.random.default_rng(seed).normal(0, 0.05, t.size)
    return (0.4 * np.sin(2 * np.pi * 220 * t) + noise).astype(np.float32)


@pytest.mark.parametrize("quality", ["low", "medium", "high", "other"])
def test_build_avi_bytes_matches_jax(quality):
    frames, audio = _clip(), _audio()
    ref = javi.build_avi_bytes(frames, 12.0, audio, 16000, quality=quality)
    got = tavi.build_avi_bytes(frames, 12.0, audio, 16000, quality=quality, device="cpu")
    assert got == ref


@pytest.mark.parametrize("audio_kind", ["int16", "stereo", "short"])
def test_build_avi_bytes_audio_forms_match_jax(audio_kind):
    """uint8 frames, and int16, two-channel and shorter-than-the-video audio."""
    frames = (_clip(n=5) * 255).astype(np.uint8)
    audio = _audio(seconds=0.4)
    audio = {"int16": (audio * 20000).astype(np.int16), "stereo": np.stack([audio, -audio]),
             "short": audio[:900]}[audio_kind]
    ref = javi.build_avi_bytes(frames, 25.0, audio, 16000)
    assert tavi.build_avi_bytes(frames, 25.0, audio, 16000, device="cpu") == ref


def test_mux_frames_audio_avi_writes_the_same_file(tmp_path):
    frames, audio = _clip(seed=3), _audio(seed=4)
    ref = javi.mux_frames_audio_avi(frames, 8.0, audio, 16000, str(tmp_path / "j.avi"))
    got = tavi.mux_frames_audio_avi(frames, 8.0, audio, 16000, str(tmp_path / "t.avi"),
                                    quality="low", device="cpu")
    assert got == str(tmp_path / "t.avi")
    with open(ref, "rb") as a, open(got, "rb") as b:
        assert a.read() != b.read()  # "low" against "high": other JPEGs
    got = tavi.mux_frames_audio_avi(frames, 8.0, audio, 16000, str(tmp_path / "t.avi"),
                                    device="cpu")
    with open(ref, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_merge_frames_dir_audio_matches_jax(tmp_path, ext):
    """A frames directory (JPEG or PNG frames) and a WAV muxed into the same ``.avi``."""
    frames = (_clip(n=7, seed=5) * 255).astype(np.uint8)
    d = tmp_path / "frames"
    d.mkdir()
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(d / f"f_{i + 1}.{ext}")
    wav = tmp_path / "a.wav"
    wav.write_bytes(wav_image(_audio(seconds=0.6, sr=48000)[None], 48000))
    ref = javi.merge_frames_dir_audio(str(d), str(wav), str(tmp_path / "j.mp4"), fps=10.0,
                                      quality="medium")
    os.rename(ref, tmp_path / "jax.avi")
    got = tavi.merge_frames_dir_audio(str(d), str(wav), str(tmp_path / "j.mp4"), fps=10.0,
                                      quality="medium", device="cpu")
    assert got == str(tmp_path / "j.avi")
    assert (tmp_path / "jax.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_avi_matches_jax(tmp_path, writer):
    frames, audio = _clip(n=9, h=17, w=33, seed=6), _audio(seconds=0.7, seed=7)
    build = javi.build_avi_bytes if writer == "jax" else (
        lambda *a, **k: tavi.build_avi_bytes(*a, **k, device="cpu"))
    path = tmp_path / "c.avi"
    path.write_bytes(build(frames, 12.5, audio, 16000, quality="medium"))
    ref = javi.read_avi(str(path))
    got = tavi.read_avi(str(path), device="cpu")
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] == 12.5 and got[3] == ref[3] == 16000
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("kw", [{}, {"target_fps": 5.0}, {"target_fps": 30.0, "max_frames": 7},
                                {"max_frames": 3}])
def test_read_video_frames_of_an_avi_matches_jax(tmp_path, kw):
    """The frames of an MJPEG AVI through ``read_video_frames``: the JAX package's
    nearest-index resample and ``max_frames``."""
    path = tmp_path / "c.avi"
    path.write_bytes(javi.build_avi_bytes(_clip(n=10, seed=8), 12.0, _audio(), 16000))
    ref, ref_fps = jvideo.read_video_frames(str(path), **kw)
    got, fps = tvideo.read_video_frames(str(path), **kw, device="cpu")
    assert fps == ref_fps
    np.testing.assert_array_equal(got, ref)


def test_unreadable_avis_raise_as_jax(tmp_path):
    """A non-MJPEG codec and corrupt JPEG payloads raise ``ValueError`` (the JAX messages'
    openings), which ``read_video_frames`` takes as its cue to try ffmpeg."""
    good = javi.build_avi_bytes(_clip(n=2), 12.0, _audio(), 16000)
    other = tmp_path / "xvid.avi"
    other.write_bytes(good.replace(b"MJPG", b"XVID"))
    for mod in (javi, tavi):
        kw = {"device": "cpu"} if mod is tavi else {}
        with pytest.raises(ValueError, match="is not MJPEG"):
            mod.read_avi(str(other), **kw)
    first = good.index(b"00dc") + 8
    corrupt = tmp_path / "corrupt.avi"
    corrupt.write_bytes(good[:first + 400] + bytes(200) + good[first + 600:])
    with pytest.raises(ValueError, match="undecodable MJPEG frames"):
        javi.read_avi(str(corrupt))
    with pytest.raises(ValueError, match="undecodable MJPEG frames"):
        tavi.read_avi(str(corrupt), device="cpu")


def test_frames_round_trip_through_the_port_alone(tmp_path):
    """What the port writes, the port reads back: its JPEG payloads decode to PIL's decode of
    the same bytes, the PCM to the clipped, rounded audio on both channels."""
    frames, audio = _clip(n=4, seed=9), _audio(seed=10)
    path = tmp_path / "c.avi"
    path.write_bytes(tavi.build_avi_bytes(frames, 10.0, audio, 16000, device="cpu"))
    info = tavi.read_avi_info(str(path))
    assert len(info["jpegs"]) == info["n_frames"] == 4 and info["index_entries"] == 8
    pil = np.stack([np.asarray(Image.open(io.BytesIO(j)).convert("RGB")) for j in info["jpegs"]])
    got, fps, mono, sr = tavi.read_avi(str(path), device="cpu")
    np.testing.assert_array_equal((got * 255).round().astype(np.uint8), pil)
    pcm = np.frombuffer(info["pcm"], "<i2").reshape(-1, 2)
    expect = np.round(np.clip(audio, -1, 1) * 32767.0).astype(np.int16)
    np.testing.assert_array_equal(pcm[:, 0], expect)
    np.testing.assert_array_equal(pcm[:, 1], expect)
    assert (fps, sr) == (10.0, 16000)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
def test_frames_to_uint8_matches_jax(dtype):
    """The float frames' rounding (torch's host threads) against the JAX package's numpy,
    half-way values and values past [0, 1] included."""
    rng = np.random.default_rng(12)
    if dtype == "int64":
        frames = rng.integers(0, 2, (2, 4, 6, 3))
    else:
        half = (np.arange(256) + 0.5) / 255.0
        frames = np.concatenate([np.tile(half, 3).reshape(1, 16, 16, 3),
                                 rng.uniform(-0.1, 1.1, (1, 16, 16, 3))]).astype(dtype)
    np.testing.assert_array_equal(tavi._frames_to_uint8(frames), javi._frames_to_uint8(frames))
