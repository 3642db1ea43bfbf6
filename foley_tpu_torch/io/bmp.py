"""BMP frames without PIL: the header on the host, the pixels unpacked in torch on the device
the caller names (the card, unless the caller asks for the CPU). The result is Pillow 12's
``Image.open(f).convert("RGB")`` (``BmpImagePlugin``), what the JAX package's
``pipeline/video.py::read_frames_dir`` reads.

Supported: the core (12-byte) header and the info headers of 40, 52, 56, 64, 108 (V4) and
124 (V5) bytes; bottom-up and top-down rows, each padded to 4 bytes; 1-, 4- and 8-bit
palettes (short ones too: an index past the palette's end reads black), 16-bit 5-5-5,
24-bit BGR and 32-bit BGRX uncompressed; BI_BITFIELDS with Pillow's layouts (16-bit 5-6-5
and 5-5-5, 24-bit BGR, 32-bit bytes in any order, alpha dropped). A 5-bit field widens to 8
bits as ``v * 255 // 31``, a 6-bit one as ``v * 255 // 63``, as Pillow's unpackers do.

RLE8 and RLE4 (compression 1 and 2) at 1, 4 and 8 bits: the runs are read on the host by
``csrc/bmp_rle.cpp`` (built at first use by ``ops/kernels/build.py::host_library``) as
Pillow's ``BmpRleDecoder`` reads them (encoded and absolute runs, the absolute runs' word
padding, end of line, end of bitmap, the delta escape; indices never written read 0), and
the palette lookup and the row order run on the device, as for an uncompressed palette. Runs
that end before the bitmap is full raise, as Pillow's "not enough image data". A palette of
greys ``0, 1, 2, ...`` (Pillow's mode ``L``) reads every index as its grey, past the
palette's end too.

Refused with ``BMPUnsupported``, naming what it is: JPEG or PNG inside a BMP, RLE at other
bit depths, other bit depths and bitfield layouts.
"""

from __future__ import annotations

import struct
import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.io.png import check_image_size, file_bytes

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# Pillow's bitfield layouts: bits -> (r, g, b[, a]) masks
_BITFIELDS = {
    32: [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)],
    24: [(0xFF0000, 0xFF00, 0xFF)],
    16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)],
}
_COMPRESSION = {4: "JPEG", 5: "PNG"}
_RLE = {1: "RLE8", 2: "RLE4"}


class BMPUnsupported(ValueError):
    """A BMP this reader does not take."""


def rle_library() -> ctypes.CDLL:
    """``csrc/bmp_rle.cpp``, built at first use (a missing compiler or a failed build raises;
    ``host_library`` keeps the loaded library)."""
    from foley_tpu_torch.ops.kernels.build import host_library

    lib = host_library("bmp_rle")
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.bmp_rle_decode.argtypes = [ctypes.c_void_p, i64, i64, i32, i32, i32, ctypes.c_void_p]
    lib.bmp_rle_decode.restype = i64
    return lib


def _rle_indices(data: bytes, offset: int, w: int, h: int, rle4: bool, name: str) -> np.ndarray:
    """The palette indices ``[H, W]`` (file row order) of RLE pixel data from ``offset``."""
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: an RLE BMP of {w} x {h} pixels")
    out = np.zeros((h, w), np.uint8)
    src = np.frombuffer(data, np.uint8)
    n = rle_library().bmp_rle_decode(src.ctypes.data, src.size, offset, w, h, int(rle4),
                                     out.ctypes.data)
    if n < 0:
        raise ValueError(f"{name}: truncated RLE data (a delta escape without its values)")
    if n < w * h:
        raise ValueError(f"{name}: not enough image data ({n} of {w * h} RLE pixels)")
    return out


def parse_bmp(data: bytes, name: str = "BMP") -> Dict:
    """The geometry, the pixel rows (uint8 ``[H, stride]`` in file order), the bit depth,
    the channel masks (``None`` for a palette) and the palette (uint8 ``[n, 3]`` RGB) of one
    BMP file's bytes."""
    if data[:2] != b"BM" or len(data) < 18:
        raise BMPUnsupported(f"{name}: not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    if hsize not in _HEADERS:
        raise BMPUnsupported(f"{name}: a BMP header of {hsize} bytes is not read")
    head = data[18:14 + hsize]
    if len(head) != hsize - 4:
        raise ValueError(f"{name}: truncated BMP header")
    after = 14 + hsize
    if hsize == 12:
        w, h, _, bits = struct.unpack("<HHHH", head[:8])
        compression, colors, pad, top_down = 0, 0, 3, False
    else:
        w, h_raw, _, bits, compression = struct.unpack("<iIHHI", head[:16])
        colors = struct.unpack("<I", head[28:32])[0]
        pad = 4
        top_down = head[7] == 0xFF
        h = 2 ** 32 - h_raw if top_down else h_raw
    check_image_size(w, h, name)
    if compression in _COMPRESSION:
        raise BMPUnsupported(f"{name}: {_COMPRESSION[compression]}-compressed BMP is not read "
                             "(uncompressed, bitfield and RLE BMPs are)")
    if compression in _RLE and bits not in (1, 4, 8):
        raise BMPUnsupported(f"{name}: {_RLE[compression]} at {bits} bits a pixel is not read "
                             "(1, 4 and 8 are)")
    if compression not in (0, 1, 2, 3):
        raise BMPUnsupported(f"{name}: BMP compression {compression} is not read")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise BMPUnsupported(f"{name}: a {bits}-bit BMP is not read")
    masks = {16: (0x7C00, 0x3E0, 0x1F), 24: (0xFF0000, 0xFF00, 0xFF),
             32: (0xFF0000, 0xFF00, 0xFF, 0x0)}.get(bits)
    if compression == 3:
        if hsize - 4 >= 48:  # the masks are in the header (with alpha from 52 bytes on)
            n = 4 if hsize - 4 >= 52 else 3
            masks = struct.unpack(f"<{n}I", head[36:36 + 4 * n]) + ((0,) if n == 3 else ())
        else:  # a 40-byte header: three masks follow it
            masks = struct.unpack("<3I", data[after:after + 12]) + (0,)
            after += 12
        layout = masks if bits == 32 else masks[:3]
        if layout not in _BITFIELDS.get(bits, ()):
            raise BMPUnsupported(f"{name}: the BMP bitfield layout "
                                 f"{tuple(hex(m) for m in layout)} at {bits} bits is not read")
        masks = layout if any(layout) else (0xFF0000, 0xFF00, 0xFF, 0x0)  # all zero: BGRA
    palette = None
    if bits <= 8:
        colors = colors or (1 << bits)
        if not 0 < colors <= 65536:
            raise BMPUnsupported(f"{name}: a BMP palette of {colors} colours")
        raw = np.frombuffer(data[after:after + pad * colors], np.uint8)
        palette = raw[: raw.size // pad * pad].reshape(-1, pad)[:, 2::-1]  # BGR(X) -> RGB
        if offset == 14 + hsize:  # an offset that points at the palette: Pillow skips it
            offset += 4 * colors
        masks = None
        # Pillow's mode L: every colour the grey of its index, each index read as its grey
        if colors != 2 and len(palette) == colors and (
                palette == np.arange(colors)[:, None]).all():
            palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    if compression in _RLE:
        indices = _rle_indices(data, offset, w, h, compression == 2, name)
        return {"width": w, "height": h, "bits": 8, "masks": None, "palette": palette,
                "rows": indices, "top_down": top_down}
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.frombuffer(data[offset:offset + stride * h], np.uint8)
    if rows.size != stride * h:
        raise ValueError(f"{name}: truncated BMP pixel data")
    return {"width": w, "height": h, "bits": bits, "masks": masks, "palette": palette,
            "rows": rows.reshape(h, stride), "top_down": top_down}


def _field(pixel: torch.Tensor, mask: int) -> torch.Tensor:
    """One channel of packed pixels, widened to 8 bits as Pillow's unpackers do."""
    if mask == 0:
        return torch.zeros_like(pixel)
    shift = (mask & -mask).bit_length() - 1
    width = (mask >> shift).bit_length()
    v = (pixel & mask) >> shift
    return v if width == 8 else v * 255 // ((1 << width) - 1)


def decode(info: Dict, device) -> torch.Tensor:
    """A parsed BMP -> RGB ``[H, W, 3]`` uint8 on ``device``."""
    w, bits = info["width"], info["bits"]
    rows = torch.from_numpy(info["rows"].copy()).to(device)
    if not info["top_down"]:
        rows = rows.flip(0)
    if bits <= 8:
        shifts = torch.arange(8 - bits, -1, -bits, device=device, dtype=torch.int16)
        idx = ((rows.to(torch.int16)[..., None] >> shifts) & ((1 << bits) - 1)).flatten(-2)
        table = np.zeros((256, 3), np.uint8)
        table[:min(len(info["palette"]), 256)] = info["palette"][:256]
        return torch.from_numpy(table).to(device)[idx[:, :w].long()]
    nbytes = bits // 8
    px = rows[:, :w * nbytes].reshape(rows.shape[0], w, nbytes).long()
    pixel = sum(px[..., k] << (8 * k) for k in range(nbytes))
    return torch.stack([_field(pixel, m) for m in info["masks"][:3]], dim=-1).to(torch.uint8)


def read_bmps(paths: Sequence[str], device: DeviceLike = None,
              datas: Optional[Sequence[bytes]] = None) -> np.ndarray:
    """BMP files of one size -> ``[T, H, W, 3]`` uint8 RGB on the host, equal to PIL's
    ``np.asarray(Image.open(p).convert("RGB"))`` for each, unpacked on ``device`` (``cuda``
    unless given). ``datas``, where given, holds each file's bytes, already read."""
    dev = resolve_device(device)
    out = None
    for i, p in enumerate(paths):
        info = parse_bmp(file_bytes(paths, datas, i), p)
        if out is None:
            out = np.empty((len(paths), info["height"], info["width"], 3), np.uint8)
        elif out.shape[1:3] != (info["height"], info["width"]):
            sizes = sorted({out.shape[1:3], (info["height"], info["width"])})
            raise ValueError(f"frames differ in size: {sizes}")
        out[i] = decode(info, dev).cpu().numpy()
    if out is None:
        raise ValueError("no BMP files given")
    return out
