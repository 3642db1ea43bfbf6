"""The port's host audio IO (``io/native.py``, ``io/audio.py``) against the JAX package's
``foley_tpu.io.native`` and ``foley_tpu.io.audio``, exactly.

The JAX package takes its C++ route when the library builds (here built once for the module
into a directory of its own, ``torch_helpers.jax_native_library``), its numpy route
otherwise; the port has the numpy / ``wave`` route only, computed as the C++ code computes
it. PCM conversion and WAV bytes are the same in both JAX routes. The
resampler and the WAV decode are held bit for bit against the C++ route, and against the
numpy fallback within 1e-6 absolute (it interpolates in float32) when the library is
absent.
"""

import io
import struct
import wave

import numpy as np
import pytest

from foley_tpu.io import audio as jaudio
from foley_tpu.io import native as jnative
from foley_tpu_torch.io import audio as taudio
from foley_tpu_torch.io import native as tnative
from torch_helpers import jax_native_library, one_torch_thread  # noqa: F401 (autouse)


def _assert_same(got, ref):
    if jnative.native_available():  # the C++ route (``jax_native_library``)
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _signal(n, seed, lo=-1.2, hi=1.2):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_float_to_pcm16_and_peak_equal_jax(seed):
    x = _signal(10000, seed)
    x[:4] = [0.5 / 32767, 1.5 / 32767, -2.5 / 32767, 1.0]  # ties round to even; the rail
    np.testing.assert_array_equal(tnative.float_to_pcm16(x), jnative.float_to_pcm16(x))
    assert tnative.peak(x) == jnative.peak(x)
    assert tnative.peak(np.zeros(0, np.float32)) == 0.0


@pytest.mark.parametrize("n,sr_in,sr_out", [(1600, 16000, 48000), (48000, 48000, 16000),
                                            (44100, 44100, 48000), (1, 8000, 48000),
                                            (7, 48000, 8000), (2, 10, 3)])
def test_resample_linear_equals_jax(n, sr_in, sr_out):
    x = _signal(n, n)
    got, ref = tnative.resample_linear(x, sr_in, sr_out), jnative.resample_linear(x, sr_in,
                                                                                  sr_out)
    assert got.shape == ref.shape and got.dtype == np.float32
    _assert_same(got, ref)


@pytest.mark.parametrize("channels,n", [(1, 4800), (2, 100), (1, 0)])
def test_wav_image_bytes_equal_jax(channels, n):
    wav = _signal(channels * n, 7).reshape(channels, n)
    got = tnative.wav_image(wav, 48000)
    assert got == jnative.wav_image(wav, 48000)
    with wave.open(io.BytesIO(got)) as f:
        assert (f.getframerate(), f.getnchannels(), f.getnframes()) == (48000, channels, n)
    assert tnative.wav_image(wav[0], 48000) == jnative.wav_image(wav[0], 48000)


def test_write_wav_equals_jax(tmp_path):
    wav = _signal(2 * 480, 3).reshape(2, 480)
    taudio.write_wav(str(tmp_path / "t.wav"), wav, 48000)
    jaudio.write_wav(str(tmp_path / "j.wav"), wav, 48000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    with pytest.raises(ValueError):
        taudio.write_wav(str(tmp_path / "bad.wav"), wav[None], 48000)


def _wav_bytes(fmt_code, bits, channels, sr, payload, extensible=False, pad_chunk=False):
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt_code, channels, sr,
                      sr * channels * bits // 8, channels * bits // 8, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_code) + b"\0" * 14
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if pad_chunk:  # an odd-sized chunk before the data, padded to even
        chunks += b"LIST" + struct.pack("<I", 3) + b"abc\0"
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _payload(kind, channels, frames, seed):
    rng = np.random.default_rng(seed)
    n = channels * frames
    if kind == "f32":
        return 3, 32, rng.uniform(-1, 1, n).astype("<f4").tobytes()
    if kind == "i16":
        return 1, 16, rng.integers(-32768, 32767, n).astype("<i2").tobytes()
    if kind == "i32":
        return 1, 32, rng.integers(-2**31, 2**31 - 1, n).astype("<i4").tobytes()
    v = rng.integers(-2**23, 2**23 - 1, n).astype(np.int32)
    b = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], -1).astype(np.uint8)
    return 1, 24, b.tobytes()


@pytest.mark.parametrize("kind", ["f32", "i16", "i32", "i24"])
@pytest.mark.parametrize("channels,target_sr", [(1, None), (2, None), (3, 16000),
                                                (2, 48000)])
def test_read_wav_equals_jax(tmp_path, kind, channels, target_sr):
    code, bits, payload = _payload(kind, channels, 997, channels)
    path = tmp_path / f"{kind}_{channels}.wav"
    path.write_bytes(_wav_bytes(code, bits, channels, 44100, payload,
                                extensible=kind == "i24", pad_chunk=channels == 2))
    got, sr = taudio.read_wav(str(path), target_sr)
    ref, ref_sr = jaudio.read_wav(str(path), target_sr)
    assert sr == ref_sr == (target_sr or 44100)
    assert got.shape == ref.shape and got.dtype == np.float32
    _assert_same(got, ref)


def test_read_wav_refusals(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX" + b"\0" * 40)
    with pytest.raises(taudio.MediaProcessingError, match="RIFF"):
        taudio.read_wav(str(bad))
    alaw = tmp_path / "alaw.wav"
    alaw.write_bytes(_wav_bytes(6, 8, 1, 8000, b"\0" * 16))
    with pytest.raises(taudio.MediaProcessingError, match="unsupported"):
        taudio.read_wav(str(alaw))
    with pytest.raises(taudio.MediaProcessingError, match="PIL"):
        taudio.merge_audio_video(str(tmp_path), "a.wav", "out.mp4")  # a frames directory
