"""libwebp 1.6's lossy encoder through ``ctypes`` (the library Pillow 12.1 bundles), for the
tests of ``foley_tpu_torch/io/webp.py``: it writes VP8 bitstreams with the settings Pillow's
``save`` does not expose (the simple loop filter, no filter, every sharpness, 1-4 segments,
1, 2, 4 or 8 token partitions, sharp YUV), and ``animation`` assembles an animated WebP by
hand, so that a first frame can be smaller than the canvas. Only the tests load Pillow's
libwebp; the port never does.
"""

import ctypes
import glob
import os
import struct

import numpy as np
import PIL

_LIBS = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
_WEBP = None


class WebPConfig(ctypes.Structure):
    """``src/webp/encode.h``'s ``WebPConfig`` (with room to spare after it)."""
    _fields_ = [(name, ctypes.c_float if name in ("quality", "target_PSNR") else ctypes.c_int)
                for name in ("lossless", "quality", "method", "image_hint", "target_size",
                             "target_PSNR", "segments", "sns_strength", "filter_strength",
                             "filter_sharpness", "filter_type", "autofilter",
                             "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
                             "show_compressed", "preprocessing", "partitions",
                             "partition_limit", "emulate_jpeg_size", "thread_level",
                             "low_memory", "near_lossless", "exact", "use_delta_palette",
                             "use_sharp_yuv", "qmin", "qmax")] + [("_spare", ctypes.c_int * 32)]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("_pad", ctypes.c_uint32 * 4)]


# ``WebPPicture`` on a 64-bit machine: room for it (256 bytes), and the byte offsets of the
# fields set here
PICTURE_BYTES = 1024
USE_ARGB, WIDTH, HEIGHT, WRITER, CUSTOM_PTR, ERROR_CODE = 0, 8, 12, 96, 104, 136


def library() -> ctypes.CDLL:
    global _WEBP
    if _WEBP is None:
        sharp = glob.glob(os.path.join(_LIBS, "libsharpyuv-*.so*"))[0]
        ctypes.CDLL(sharp, mode=ctypes.RTLD_GLOBAL)  # libwebp links against it
        lib = ctypes.CDLL(glob.glob(os.path.join(_LIBS, "libwebp-*.so*"))[0])
        p = ctypes.c_void_p
        lib.WebPConfigInitInternal.argtypes = [p, ctypes.c_int, ctypes.c_float, ctypes.c_int]
        lib.WebPPictureInitInternal.argtypes = [p, ctypes.c_int]
        lib.WebPPictureImportRGB.argtypes = [p, p, ctypes.c_int]
        lib.WebPPictureImportRGBA.argtypes = [p, p, ctypes.c_int]
        lib.WebPEncode.argtypes = [p, p]
        lib.WebPPictureFree.argtypes = [p]
        lib.WebPMemoryWriterInit.argtypes = [p]
        lib.WebPMemoryWriterClear.argtypes = [p]
        lib.WebPValidateConfig.argtypes = [p]
        _WEBP = lib
    return _WEBP


def encode(rgb: np.ndarray, quality: float = 75.0, **settings) -> bytes:
    """An RGB or RGBA uint8 frame ``[H, W, 3 | 4]`` -> a lossy WebP file's bytes, written by
    ``WebPEncode`` with ``WebPConfig``'s defaults for ``quality`` and the fields named in
    ``settings`` (``filter_type``, ``filter_strength``, ``filter_sharpness``, ``segments``,
    ``partitions``, ``use_sharp_yuv``, ``method``, ``exact``, ...)."""
    lib = library()
    config = WebPConfig()
    if not lib.WebPConfigInitInternal(ctypes.byref(config), 0, quality, 0x0210):
        raise RuntimeError("WebPConfigInit failed")
    for key, value in settings.items():
        setattr(config, key, value)
    if not lib.WebPValidateConfig(ctypes.byref(config)):
        raise ValueError(f"libwebp refuses the settings {settings}")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    picture = (ctypes.c_uint8 * PICTURE_BYTES)()
    if not lib.WebPPictureInitInternal(picture, 0x0210):
        raise RuntimeError("WebPPictureInit failed")
    base = ctypes.addressof(picture)
    writer = WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    # ARGB input, so that use_sharp_yuv reaches the RGB -> YUV conversion
    for offset, value in ((USE_ARGB, 1), (WIDTH, w), (HEIGHT, h)):
        ctypes.c_int.from_address(base + offset).value = value
    ctypes.c_void_p.from_address(base + WRITER).value = ctypes.cast(
        lib.WebPMemoryWrite, ctypes.c_void_p).value
    ctypes.c_void_p.from_address(base + CUSTOM_PTR).value = ctypes.addressof(writer)
    try:
        imported = (lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB)(
            picture, rgb.ctypes.data, w * c)
        if not imported or not lib.WebPEncode(ctypes.byref(config), picture):
            code = ctypes.c_int.from_address(base + ERROR_CODE).value
            raise RuntimeError(f"WebPEncode failed (error {code})")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(picture)
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def picture_chunks(data: bytes) -> bytes:
    """A still WebP file's picture chunks ([``ALPH``] + ``VP8 ``, or ``VP8L``), as they go
    into an ``ANMF`` chunk."""
    out, pos = b"", 12
    while pos + 8 <= len(data):
        fourcc, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            out += data[pos:pos + 8 + size + (size & 1)]
        pos += 8 + size + (size & 1)
    return out


def animation(canvas, frames, alpha: bool = False) -> bytes:
    """An animated WebP: ``canvas`` (width, height), ``frames`` a list of (x, y, width,
    height, still WebP bytes) placed at even offsets, each kept (no blending, no
    disposal)."""
    body = _chunk(b"VP8X", bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0])
                  + (canvas[0] - 1).to_bytes(3, "little") + (canvas[1] - 1).to_bytes(3, "little"))
    body += _chunk(b"ANIM", b"\0\0\0\0" + struct.pack("<H", 0))
    for x, y, w, h, still in frames:
        assert x % 2 == 0 and y % 2 == 0
        header = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 40))
        body += _chunk(b"ANMF", header + bytes([0x02]) + picture_chunks(still))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body
