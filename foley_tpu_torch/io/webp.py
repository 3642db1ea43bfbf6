"""Lossless WebP frames without PIL: read as Pillow 12.1's ``Image.open(p).convert("RGB")``
reads them over libwebp (what the JAX package's ``pipeline/video.py::read_frames_dir``
calls), byte for byte.

The RIFF container is parsed here: a ``VP8L`` chunk alone, or ``VP8X`` then ``VP8L`` (the
``ICCP``, ``EXIF`` and ``XMP `` chunks skipped; the extended header's canvas must be the
bitstream's size). The VP8L bitstream (prefix codes, the colour cache, LZ77 backward
references, the meta prefix codes and the four transforms) is decoded on the host by
``csrc/webp_lossless.cpp`` (built at first use by ``ops/kernels/build.py::host_library``)
into ARGB words, whose R, G and B bytes are taken out in numpy. Every stage runs on the host:
the transforms are inverted as the pixels are decoded, so the words are final in host
memory, and no per-pixel work is left that a device pass would pay its copies for. Alpha is
dropped, as ``convert("RGB")`` drops it.

Refused, each with ``WebPUnsupported`` naming what it is: a lossy (``VP8 ``) bitstream,
with or without an ``ALPH`` chunk, and an animation (``ANIM`` / ``ANMF``). Corrupt or
truncated data raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, Sequence

import numpy as np

from foley_tpu_torch.core.device import DeviceLike
from foley_tpu_torch.io.png import check_image_size


class WebPUnsupported(ValueError):
    """A WebP this reader does not take."""


_LIB = None


def lossless_library() -> ctypes.CDLL:
    """``csrc/webp_lossless.cpp``, built at first use (a missing compiler or a failed build
    raises)."""
    global _LIB
    if _LIB is None:
        from foley_tpu_torch.ops.kernels.build import host_library

        lib = host_library("webp_lossless")
        p = ctypes.c_void_p
        lib.webp_lossless_decode.argtypes = [p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                             p, p, p, ctypes.c_int32]
        lib.webp_lossless_decode.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _chunks(data: bytes, name: str):
    """The RIFF ``WEBP`` file's chunks: (fourcc, payload)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{name}: not a WebP file")
    end = min(len(data), 8 + struct.unpack("<I", data[4:8])[0])
    pos = 12
    while pos + 8 <= end:
        fourcc, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        payload = data[pos + 8:pos + 8 + size]
        if len(payload) < size:
            raise ValueError(f"{name}: truncated WebP (chunk {fourcc!r})")
        yield fourcc, payload
        pos += 8 + size + (size & 1)


def parse_webp(data: bytes, name: str = "WebP") -> Dict:
    """One WebP file's bytes -> ``width``, ``height`` and its VP8L payload (``vp8l``)."""
    canvas, vp8l = None, None
    for fourcc, payload in _chunks(data, name):
        if fourcc in (b"VP8 ", b"ALPH"):
            raise WebPUnsupported(f"{name}: lossy WebP (VP8) is not decoded yet (lossless "
                                  "VP8L is)")
        if fourcc in (b"ANIM", b"ANMF"):
            raise WebPUnsupported(f"{name}: an animated WebP is not decoded (a still "
                                  "lossless image is)")
        if fourcc == b"VP8X":
            if len(payload) < 10:
                raise ValueError(f"{name}: truncated VP8X chunk")
            if payload[0] & 0x02:
                raise WebPUnsupported(f"{name}: an animated WebP is not decoded (a still "
                                      "lossless image is)")
            canvas = (1 + int.from_bytes(payload[4:7], "little"),
                      1 + int.from_bytes(payload[7:10], "little"))
        elif fourcc == b"VP8L":
            vp8l = payload
            break
    if vp8l is None:
        raise ValueError(f"{name}: a WebP without image data")
    if len(vp8l) < 5 or vp8l[0] != 0x2F:
        raise ValueError(f"{name}: not a VP8L bitstream")
    bits = int.from_bytes(vp8l[1:5], "little")
    width, height = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if canvas is not None and canvas != (width, height):
        raise ValueError(f"{name}: a VP8X canvas of {canvas} for a {width} x {height} image")
    check_image_size(width, height, name)
    return {"width": width, "height": height, "vp8l": vp8l}


# the VP8L transforms by their type numbers
TRANSFORMS = ("predictor", "cross_color", "subtract_green", "color_indexing")


def decode_argb(info: Dict, name: str = "WebP") -> np.ndarray:
    """A parsed WebP's pixels, ``[H, W, 4]`` uint8 in memory order (B, G, R, A), decoded on
    the host; ``info["transforms"]`` receives the names of the transforms it held."""
    out = np.empty((info["height"], info["width"]), np.uint32)
    src = np.frombuffer(info["vp8l"], np.uint8)
    seen = ctypes.c_int32(0)
    err = ctypes.create_string_buffer(256)
    rc = lossless_library().webp_lossless_decode(src.ctypes.data, src.size, info["width"],
                                                 info["height"], out.ctypes.data,
                                                 ctypes.byref(seen), err, len(err))
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    info["transforms"] = [t for i, t in enumerate(TRANSFORMS) if seen.value >> i & 1]
    return out.view(np.uint8).reshape(info["height"], info["width"], 4)


def read_webps(paths: Sequence[str], device: DeviceLike = None) -> np.ndarray:
    """Lossless WebP files of one size -> ``[T, H, W, 3]`` uint8 RGB on the host, equal to
    PIL's ``np.asarray(Image.open(p).convert("RGB"))`` for each, decoded on the host.
    ``device`` is the frame readers' common argument; no stage of this one uses it."""
    out = None
    for i, p in enumerate(paths):
        with open(p, "rb") as fh:
            info = parse_webp(fh.read(), p)
        if out is not None and out.shape[1:3] != (info["height"], info["width"]):
            raise ValueError(f"frames differ in size: "
                             f"{sorted({out.shape[1:3], (info['height'], info['width'])})}")
        if out is None:
            out = np.empty((len(paths), info["height"], info["width"], 3), np.uint8)
        out[i] = decode_argb(info, p)[..., 2::-1]  # B, G, R, A in memory -> R, G, B
    if out is None:
        raise ValueError("no WebP files given")
    return out
