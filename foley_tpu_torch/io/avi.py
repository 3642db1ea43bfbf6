"""Dependency-free AVI (MJPEG + PCM): the writer and the reader (``foley_tpu/io/avi.py``
counterpart).

``build_avi_bytes`` writes a RIFF / AVI container with an MJPEG video stream (each frame a
JPEG from ``io/jpeg.py``, equal to the JAX package's PIL encode byte for byte: the transform
on the device, the Huffman pass on the host) and a 16-bit stereo PCM stream (the mono
signal on both channels, the reference's ``pan=stereo|c0=c0|c1=c0``), interleaved a frame
at a time and indexed in ``idx1``; for the same frames and audio its bytes equal the JAX
package's. ``read_avi`` reads such a file back: the JPEG frames decoded by ``io/jpeg.py``
(as the JAX package's PIL decode), the PCM audio with ``struct`` alone
(``read_avi_audio``, which ``--desync_score`` reads on its own).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike
from foley_tpu_torch.io.jpeg import decode_jpegs, encode_jpegs

# JPEG quality per the sampler's audio-quality knob (the reference maps the same knob to AAC
# bitrates; here it shapes the MJPEG stream)
_JPEG_QUALITY = {"low": 70, "medium": 85, "high": 95}


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    pad = b"\x00" if len(data) % 2 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _list(fourcc: bytes, data: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + data)


def _frames_to_uint8(frames: np.ndarray) -> np.ndarray:
    """``[T, H, W, 3]`` uint8, or floats in [0, 1] as ``clip(round(f * 255), 0, 255)`` in
    their own precision (the JAX package's numpy, here in torch's host threads: the same
    IEEE products and half-to-even rounding; other types promote to float64, as numpy's)."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        if frames.dtype.kind != "f":
            frames = frames.astype(np.float64)
        x = torch.from_numpy(np.ascontiguousarray(frames)) * 255.0
        frames = x.round_().clamp_(0, 255).to(torch.uint8).numpy()
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected [T, H, W, 3] frames, got {frames.shape}")
    return frames


def _audio_to_stereo_i16(audio: np.ndarray) -> np.ndarray:
    """Mono float [-1, 1] (or int16) -> interleaved stereo int16, both channels the mono
    signal (the reference's pan=stereo|c0=c0|c1=c0)."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        # normalised before any channel mix: the mean of int16 channels would give
        # full-range floats that the clip below turns into a square wave
        audio = audio.astype(np.float32) / 32767.0
    if audio.ndim == 2:  # [C, T] -> mono, as read_wav mixes
        audio = audio.mean(axis=0)
    audio = np.round(np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    return np.repeat(audio[:, None], 2, axis=1).reshape(-1)  # interleaved L R L R ...


def build_avi_bytes(frames: np.ndarray, fps: float, audio: np.ndarray, sample_rate: int,
                    quality: str = "high", device: DeviceLike = None) -> bytes:
    """An AVI in memory: MJPEG video from ``frames`` (``[T, H, W, 3]`` uint8 or float in
    [0, 1]) at ``fps``, its JPEGs encoded on ``device`` (``cuda`` unless given), and 16-bit
    stereo PCM from mono ``audio`` (float in [-1, 1]). The streams interleave a video frame
    (``00dc``) then its slice of audio (``01wb``); audio past the last frame's interval rides
    the last chunk."""
    frames = _frames_to_uint8(frames)
    pcm = _audio_to_stereo_i16(audio)
    n_frames, height, width = frames.shape[0], frames.shape[1], frames.shape[2]
    jpeg_q = _JPEG_QUALITY.get(quality, _JPEG_QUALITY["high"])
    jpegs: List[bytes] = encode_jpegs(frames, jpeg_q, device) if n_frames else []

    # each frame's audio slice in samples a channel; the last takes the tail
    n_samples = len(pcm) // 2
    bounds = [min(int(round(i * sample_rate / fps)), n_samples) for i in range(n_frames + 1)]
    bounds[-1] = n_samples

    body = bytearray()
    index: List[Tuple[bytes, int, int]] = []  # (fourcc, offset from the 'movi' fourcc, size)

    def emit(fourcc: bytes, data: bytes) -> None:
        index.append((fourcc, 4 + len(body), len(data)))
        body.extend(_chunk(fourcc, data))

    for i, jb in enumerate(jpegs):
        emit(b"00dc", jb)
        seg = pcm[2 * bounds[i]: 2 * bounds[i + 1]]
        if seg.size:
            emit(b"01wb", seg.astype("<i2").tobytes())

    movi = _list(b"movi", bytes(body))
    idx1 = _chunk(b"idx1", b"".join(
        fcc + struct.pack("<III", 0x10, ofs, size) for fcc, ofs, size in index))

    block_align = 4  # stereo int16
    byte_rate = sample_rate * block_align
    duration = max(n_frames / fps, 1e-6)
    max_jpeg = max((len(j) for j in jpegs), default=0)
    avih = struct.pack(
        "<14I",
        int(round(1e6 / fps)),                              # dwMicroSecPerFrame
        int(sum(map(len, jpegs)) / duration) + byte_rate,   # dwMaxBytesPerSec
        0,                                                  # dwPaddingGranularity
        0x110,                                              # AVIF_HASINDEX | ISINTERLEAVED
        n_frames, 0, 2,                                     # total / initial frames, streams
        max_jpeg,                                           # dwSuggestedBufferSize
        width, height, 0, 0, 0, 0)
    strh_v = b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIII4h", 0, 0, 0, 0,
        1000, int(round(fps * 1000)),                       # dwScale / dwRate (fractional fps)
        0, n_frames, max_jpeg, 0xFFFFFFFF, 0,
        0, 0, width, height)                                # rcFrame
    strf_v = struct.pack(  # BITMAPINFOHEADER
        "<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG", width * height * 3, 0, 0, 0, 0)
    strh_a = b"auds" + b"\x00\x00\x00\x00" + struct.pack(
        "<IHHIIIIIIII4h", 0, 0, 0, 0,
        block_align, byte_rate,                             # dwScale / dwRate: PCM by bytes
        0, n_samples, byte_rate, 0xFFFFFFFF, block_align,
        0, 0, 0, 0)
    strf_a = struct.pack("<HHIIHH", 1, 2, sample_rate, byte_rate, block_align, 16)
    hdrl = _list(
        b"hdrl",
        _chunk(b"avih", avih)
        + _list(b"strl", _chunk(b"strh", strh_v) + _chunk(b"strf", strf_v))
        + _list(b"strl", _chunk(b"strh", strh_a) + _chunk(b"strf", strf_a)))
    payload = b"AVI " + hdrl + movi + idx1
    return b"RIFF" + struct.pack("<I", len(payload)) + payload


def mux_frames_audio_avi(frames: np.ndarray, fps: float, audio: np.ndarray, sample_rate: int,
                         output_path: str, quality: str = "high",
                         device: DeviceLike = None) -> str:
    """``build_avi_bytes`` written to ``output_path``."""
    with open(output_path, "wb") as f:
        f.write(build_avi_bytes(frames, fps, audio, sample_rate, quality=quality,
                                device=device))
    return output_path


def merge_frames_dir_audio(frames_dir: str, audio_path: str, output_path: str,
                           fps: float = 16.0, quality: str = "high",
                           device: DeviceLike = None) -> str:
    """A frames directory and a WAV muxed into an AVI, with no external tool. The output's
    extension becomes ``.avi`` (the container written): use the returned path. ``fps`` is
    the sequence's playback rate, as ``read_frames_dir`` takes it."""
    from foley_tpu_torch.io.audio import read_wav
    from foley_tpu_torch.pipeline.video import read_frames_dir

    frames, eff_fps = read_frames_dir(frames_dir, fps=fps, device=device)
    audio, sr = read_wav(audio_path)
    out = os.path.splitext(output_path)[0] + ".avi"
    return mux_frames_audio_avi(frames, eff_fps, audio, sr, out, quality=quality, device=device)


def read_avi_info(path: str) -> dict:
    """An AVI's headers and stream chunks: width / height / fps / n_frames, the video
    codec, the audio's format, channels, rate and bits, the JPEG payloads and the PCM bytes
    (the JAX package's ``read_avi_info``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"not an AVI file: {path}")
    info: dict = {"jpegs": [], "index_entries": 0}
    pcm_chunks: list = []

    def walk(buf: bytes, pos: int, end: int) -> None:
        while pos + 8 <= end:
            fourcc = buf[pos:pos + 4]
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            payload = buf[pos + 8:pos + 8 + size]
            if fourcc == b"LIST":
                walk(buf, pos + 12, pos + 8 + size)
            elif fourcc == b"avih":
                fields = struct.unpack("<14I", payload[:56])
                info["fps"] = 1e6 / fields[0]
                info["n_frames"] = fields[4]
                info["width"], info["height"] = fields[8], fields[9]
            elif fourcc == b"strh" and payload[:4] == b"vids":
                info["video_handler"] = payload[4:8]
                scale, rate = struct.unpack("<II", payload[20:28])
                info["fps"] = rate / max(scale, 1)
            elif fourcc == b"strf" and len(payload) == 40:
                info["video_compression"] = payload[16:20]
            elif fourcc == b"strf" and len(payload) == 16:
                tag, ch, sr, _, _, bits = struct.unpack("<HHIIHH", payload)
                info.update(audio_format=tag, channels=ch, sample_rate=sr, bits=bits)
            elif fourcc == b"00dc":
                info["jpegs"].append(payload)
            elif fourcc == b"01wb":
                pcm_chunks.append(payload)
            elif fourcc == b"idx1":
                info["index_entries"] = size // 16
            pos += 8 + size + (size % 2)

    try:
        walk(data, 12, len(data))
    except (struct.error, ZeroDivisionError, IndexError) as e:
        raise ValueError(f"malformed AVI {path}: {type(e).__name__}: {e}") from e
    info["pcm"] = b"".join(pcm_chunks)
    return info


def is_mjpeg_avi(path: str) -> bool:
    """RIFF / AVI magic in the first 12 bytes (the codec is checked by the readers)."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return False
    return len(head) == 12 and head[:4] == b"RIFF" and head[8:12] == b"AVI "


def _mjpeg_info(path: str) -> dict:
    """``read_avi_info``, refusing a non-MJPEG video stream or one without frames (the
    JAX ``read_avi``'s ``ValueError``: its callers then fall through to ffmpeg)."""
    info = read_avi_info(path)
    comp = info.get("video_compression", info.get("video_handler", b""))
    if comp not in (b"MJPG", b"mjpg"):
        raise ValueError(f"AVI video codec {comp!r} is not MJPEG; use ffmpeg for {path}")
    if not info["jpegs"]:
        raise ValueError(f"no video frames in {path}")
    return info


def _pcm_audio(info: dict) -> Tuple[Optional[np.ndarray], Optional[int]]:
    if not (info["pcm"] and info.get("audio_format") == 1 and info.get("bits") == 16):
        return None, None
    ch = max(int(info.get("channels", 1)), 1)
    pcm = np.frombuffer(info["pcm"], "<i2")
    pcm = pcm[: (len(pcm) // ch) * ch].reshape(-1, ch)
    return (pcm.astype(np.float32) / 32767.0).mean(axis=1), int(info["sample_rate"])


def read_avi_audio(path: str) -> Tuple[Optional[np.ndarray], Optional[int]]:
    """An MJPEG AVI's audio track -> (float32 mono in [-1, 1], sample rate), or (None, None)
    without a 16-bit PCM track: the audio half of ``read_avi``."""
    return _pcm_audio(_mjpeg_info(path))


def read_avi(path: str, device: DeviceLike = None):
    """An MJPEG (+ PCM) AVI -> (frames float32 ``[T, H, W, 3]`` in [0, 1], fps, audio float32
    mono or None, sample rate or None), the frames decoded on ``device`` (``cuda`` unless
    given). A non-MJPEG video stream, corrupt JPEG payloads or frames of differing sizes
    raise ``ValueError`` (the JAX package's ``read_avi``; its callers fall through to
    ffmpeg)."""
    info = _mjpeg_info(path)
    try:
        frames = decode_jpegs(info["jpegs"], device,
                              names=[f"frame {i}" for i in range(len(info["jpegs"]))])
    except ValueError as e:
        raise ValueError(f"undecodable MJPEG frames in {path}: {e}") from e
    audio, sr = _pcm_audio(info)
    return frames.astype(np.float32) / 255.0, float(info["fps"]), audio, sr
