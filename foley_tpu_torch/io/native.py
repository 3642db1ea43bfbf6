"""Host audio routines of the serving path: PCM conversion, peak, linear resampling, WAV
ingest and WAV framing (``foley_tpu/io/native.py`` counterpart).

The JAX package runs these in C++ (``native/audioio.cpp`` through ctypes) when the library
is built and in numpy otherwise. The port has the numpy / ``wave`` route only, written to
give the C++ route's bits: the resampler and the WAV decode compute in float64 as the C++
code does (its numpy fallback interpolates in float32 and can differ in the last place),
and the PCM conversion and the WAV header are the same in every route.
"""

from __future__ import annotations

import io
import wave
from typing import Optional, Tuple

import numpy as np


class MediaProcessingError(RuntimeError):
    pass


def float_to_pcm16(x: np.ndarray) -> np.ndarray:
    """Clip to [-1, 1], scale by 32767 in float32 and round half to even (``lrintf``)."""
    x = np.ascontiguousarray(x, np.float32)
    return (np.clip(x, -1.0, 1.0) * np.float32(32767.0)).round().astype(np.int16)


def peak(x: np.ndarray) -> float:
    x = np.ascontiguousarray(x, np.float32)
    return float(np.abs(x).max()) if x.size else 0.0


def _resample(x64: np.ndarray, n_out: int) -> np.ndarray:
    """Linear interpolation of a float64 signal onto ``n_out`` points spanning it, in
    float64 as ``af_resample_linear`` computes it, rounded to float32 at the end."""
    n_in = x64.shape[0]
    if n_in <= 1 or n_out <= 0:
        return np.full((max(n_out, 0),), x64[0] if n_in else 0.0, np.float32)
    step = (n_in - 1) / (n_out - 1 if n_out > 1 else 1)
    pos = np.arange(n_out, dtype=np.float64) * step
    i0 = pos.astype(np.int64)
    last = i0 >= n_in - 1
    i0 = np.minimum(i0, n_in - 2)
    frac = pos - i0
    out = (1.0 - frac) * x64[i0] + frac * x64[i0 + 1]
    out[last] = x64[n_in - 1]
    return out.astype(np.float32)


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    n_out = int(round(x.shape[0] * sr_out / sr_in))
    return _resample(x.astype(np.float64), n_out)


def _chunks(raw: bytes) -> Tuple[bytes, bytes]:
    """The (last) ``fmt `` and ``data`` payloads of a RIFF/WAVE image."""
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise MediaProcessingError("not a RIFF/WAVE file")
    fmt = data = None
    pos = 12
    while pos + 8 <= len(raw):
        cid, size = raw[pos:pos + 4], int.from_bytes(raw[pos + 4:pos + 8], "little")
        payload = raw[pos + 8:pos + 8 + size]
        if len(payload) < size:
            break
        pos += 8 + size + (size & 1)
        if size == 0:  # a legal empty chunk, skipped
            continue
        if cid == b"fmt ":
            fmt = payload
        elif cid == b"data":
            data = payload
    if fmt is None or data is None:
        raise MediaProcessingError("missing fmt/data chunk")
    return fmt, data


def load_wav_mono(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """One-call WAV ingest: parse, decode (PCM 16/24/32, float32), average to mono and
    resample linearly to ``target_sr``, as ``af_load_wav_mono`` does (float64 sums over the
    channels, one float32 rounding). Returns (mono fp32 [T], sample_rate); raises
    ``MediaProcessingError`` on an unreadable or unsupported file."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        fmt, data = _chunks(raw)
    except MediaProcessingError as e:
        raise MediaProcessingError(f"{e}: {path}") from None
    audio_format = int.from_bytes(fmt[0:2], "little")
    channels = int.from_bytes(fmt[2:4], "little")
    sr = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if audio_format == 0xFFFE and len(fmt) >= 26:  # WAVE_FORMAT_EXTENSIBLE: sub-format GUID
        audio_format = int.from_bytes(fmt[24:26], "little")
    scale = {(3, 32): 1.0, (1, 16): 32768.0, (1, 32): 2147483648.0, (1, 24): 8388608.0}.get(
        (audio_format, bits))
    if channels == 0 or scale is None:
        raise MediaProcessingError(f"unsupported WAV format {audio_format}/{bits}bit: {path}")
    width = bits // 8
    frames = len(data) // (width * channels)
    body = data[:frames * width * channels]
    if bits == 24:
        b = np.frombuffer(body, np.uint8).reshape(-1, 3)
        s = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int8).astype(np.int32) << 16))
    else:
        s = np.frombuffer(body, {(3, 32): "<f4", (1, 16): "<i2", (1, 32): "<i4"}[
            (audio_format, bits)])
    acc = np.zeros(frames, np.float64)
    for c in range(channels):  # the C++ loop's order
        acc += s[c::channels].astype(np.float64)
    mono64 = acc / channels / scale if scale != 1.0 else acc / channels
    if target_sr and target_sr != sr and frames > 0:
        n_out = int(np.floor(frames * target_sr / sr + 0.5))  # llround
        return _resample(mono64.astype(np.float32).astype(np.float64), n_out), int(target_sr)
    return mono64.astype(np.float32), int(target_sr or sr)


def wav_image(waveform: np.ndarray, sample_rate: int) -> bytes:
    """[C, T] or [T] float -> complete WAV file bytes (44-byte header + 16-bit PCM)."""
    wav = np.asarray(waveform, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    channels = wav.shape[0]
    interleaved = np.ascontiguousarray(wav.T.reshape(-1), np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(float_to_pcm16(interleaved).tobytes())
    return buf.getvalue()
