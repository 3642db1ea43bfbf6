"""The PCM audio track of an MJPEG AVI (``foley_tpu/io/avi.py`` counterpart, the part that
needs no PIL).

The JAX package muxes a frames directory and its audio into an MJPEG + PCM AVI, and reads
such a file back (``read_avi``): the frames through PIL's JPEG decoder, the audio with
``struct`` alone. The card's machine has no PIL, so the port keeps only the container walk
and the audio: ``--desync_score`` scores an AVI's own audio track through it. Writing the AVI
(a JPEG encode a frame) stays with the JAX package.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


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


def read_avi_audio(path: str) -> Tuple[Optional[np.ndarray], Optional[int]]:
    """An MJPEG AVI's audio track -> (float32 mono in [-1, 1], sample rate), or (None, None)
    without a 16-bit PCM track: the audio half of the JAX package's ``read_avi``, which
    raises ``ValueError`` on a non-MJPEG video stream or one without frames (its callers
    then fall through to ffmpeg)."""
    info = read_avi_info(path)
    comp = info.get("video_compression", info.get("video_handler", b""))
    if comp not in (b"MJPG", b"mjpg"):
        raise ValueError(f"AVI video codec {comp!r} is not MJPEG; use ffmpeg for {path}")
    if not info["jpegs"]:
        raise ValueError(f"no video frames in {path}")
    if not (info["pcm"] and info.get("audio_format") == 1 and info.get("bits") == 16):
        return None, None
    ch = max(int(info.get("channels", 1)), 1)
    pcm = np.frombuffer(info["pcm"], "<i2")
    pcm = pcm[: (len(pcm) // ch) * ch].reshape(-1, ch)
    return (pcm.astype(np.float32) / 32767.0).mean(axis=1), int(info["sample_rate"])
