"""TIFF frames without PIL: read as Pillow 12.1's ``Image.open(p).convert("RGB")`` reads them
(what the JAX package's ``pipeline/video.py::read_frames_dir`` calls), byte for byte.

Taken: classic TIFF in either byte order and little-endian BigTIFF (Pillow does not
recognise a big-endian one), the first IFD only (what
``Image.open`` reads), strips and tiles, ``PlanarConfiguration`` 1 (chunky) and 2 (one plane a
sample); compression 1 (none), 5 (LZW, TIFF 6.0's), 8 and 32946 (Deflate) and 32773
(PackBits); predictor 2 (horizontal differencing) at 8 and 16 bits in either byte order, on
the codecs libtiff applies it to (LZW and Deflate; Pillow's uncompressed reader and libtiff's
PackBits ignore the tag); the layouts of Pillow's ``OPEN_INFO`` at 1, 2, 4, 8 and 16 bits:

- grey (photometric 1) and WhiteIsZero (0, inverted up to 8 bits; 16 bits opens as ``I;16``
  uninverted, little-endian only), grey + unassociated alpha at 8 bits;
- RGB (2) at 8 and 16 bits with the extra samples Pillow names (unassociated alpha, unknown
  extras, and associated alpha, which Pillow's ``RGBa`` raw mode un-premultiplies);
- palette (3) at 1-8 bits, with an unknown or alpha extra sample at 8.

``convert("RGB")`` then gives: grey under 8 bits scaled by 255, 85 and 17, 16-bit grey
clamped at 255 (``I;16`` -> RGB clamps, it does not scale), 16-bit RGB its high bytes, the
palette from the high byte of each 16-bit colormap entry, alpha dropped.

The IFD walk and the sequential decompression run on the host (LZW and PackBits in
``csrc/tiff_lzw.cpp``, built at first use by ``ops/kernels/build.py::host_library``; Deflate
through ``zlib``); every per-pixel step runs in integer torch ops on the device the caller
names (the card, unless the caller asks for the CPU), over every frame of one layout at
once: 16-bit samples assembled, bits under 8 unpacked, the predictor undone (a cumulative
sum along each row, modulo 2**bits), strips or tiles and planes put in place, the palette
looked up.

Refused, each with ``TIFFUnsupported`` naming what it is: JPEG-in-TIFF (6, 7), CCITT (2, 3,
4) and the other compressions, pre-6.0 LZW, floating-point and signed samples, 12- and
32-bit samples, CMYK, YCbCr, CIELab and the other photometrics, FillOrder 2, the
floating-point predictor, rotated orientations (5-8), and layouts outside Pillow's table.
Corrupt or truncated data raises ``ValueError``, and so does an image, or a strip or tile
geometry (every chunk's pixels, the padding at the edges and every plane counted), past
Pillow's pixel limit, before anything is allocated for it.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.io.png import MAX_IMAGE_PIXELS, check_image_size, file_bytes

# frames put together in one device pass, which bounds the device memory of a long clip
CHUNK_FRAMES = 128

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 13: "I", 16: "Q",
          17: "q", 18: "Q", 5: "II", 10: "ii", 11: "f", 12: "d"}
(WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER, STRIP_OFFSETS, ORIENTATION,
 SAMPLES, ROWS_PER_STRIP, STRIP_BYTES, PLANAR, PREDICTOR, COLORMAP, TILE_WIDTH, TILE_LENGTH,
 TILE_OFFSETS, TILE_BYTES, EXTRA_SAMPLES, SAMPLE_FORMAT) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324, 325,
    338, 339)
_CODECS = {1: "none", 5: "lzw", 8: "deflate", 32946: "deflate", 32773: "packbits"}
_REFUSED_CODECS = {
    2: "CCITT modified Huffman (compression 2)", 3: "CCITT Group 3 fax (compression 3)",
    4: "CCITT Group 4 fax (compression 4)", 6: "old-style JPEG-in-TIFF (compression 6)",
    7: "JPEG-in-TIFF (compression 7)", 32771: "CCITT RLE with word alignment (32771)",
    32809: "ThunderScan (32809)", 34676: "SGI LogL (34676)", 34677: "SGI LogLuv (34677)",
    34925: "LZMA (34925)", 50000: "Zstandard (50000)", 50001: "WebP-in-TIFF (50001)"}
_REFUSED_PHOTOMETRIC = {4: "a transparency mask", 5: "CMYK (separated)", 6: "YCbCr",
                        8: "CIELab", 9: "ICCLab", 10: "ITULab", 32803: "a colour filter array",
                        32844: "LogL", 32845: "LogLuv"}
# Pillow's OPEN_INFO for RGB: the extra samples it takes after R, G, B at 8 and at 16 bits
# (0 unknown, 1 associated alpha, 2 unassociated alpha, 999 Corel Draw's alpha)
_RGB_EXTRAS = [(), (0,), (0, 0), (0, 0, 0), (1,), (1, 0), (1, 0, 0), (2,), (2, 0), (2, 0, 0),
               (999,)]
_RGB_EXTRAS_16 = [(), (0,), (1,), (2,)]


class TIFFUnsupported(ValueError):
    """A TIFF this reader does not take."""


_LIB = None


def codec_library() -> ctypes.CDLL:
    """``csrc/tiff_lzw.cpp``, built at first use (a missing compiler or a failed build
    raises)."""
    global _LIB
    if _LIB is None:
        from foley_tpu_torch.ops.kernels.build import host_library

        lib = host_library("tiff_lzw")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for fn in (lib.tiff_lzw_decode, lib.tiff_packbits_decode):
            fn.argtypes = [p, i64, p, i64]
            fn.restype = i64
        _LIB = lib
    return _LIB


def _ifd(data: bytes, name: str) -> Tuple[str, Dict[int, tuple]]:
    """The byte order ('<' or '>') and the first IFD's tags (tag -> its values) of a classic
    TIFF or a BigTIFF."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or len(data) < 8:
        raise ValueError(f"{name}: not a TIFF file")
    magic = struct.unpack(order + "H", data[2:4])[0]
    if magic == 42:
        big, head, count_fmt, entry, field = False, order + "I", "H", 12, 4
        offset = struct.unpack(head, data[4:8])[0]
    elif magic == 43:
        if order == ">":  # Pillow tells BigTIFF by its third byte, 43 only little-endian
            raise TIFFUnsupported(f"{name}: a big-endian BigTIFF is not a file Pillow reads "
                                  "(little-endian BigTIFF is decoded)")
        big, count_fmt, entry, field = True, "Q", 20, 8
        if len(data) < 16:
            raise ValueError(f"{name}: truncated BigTIFF header")
        offset = struct.unpack(order + "Q", data[8:16])[0]
    else:
        raise ValueError(f"{name}: not a TIFF file (magic {magic})")
    csize = struct.calcsize(count_fmt)
    if offset + csize > len(data):
        raise ValueError(f"{name}: truncated TIFF (the IFD lies past the end)")
    n = struct.unpack(order + count_fmt, data[offset:offset + csize])[0]
    tags: Dict[int, tuple] = {}
    for i in range(n):
        at = offset + csize + i * entry
        raw = data[at:at + entry]
        if len(raw) < entry:
            raise ValueError(f"{name}: truncated TIFF IFD")
        tag, typ = struct.unpack(order + "HH", raw[:4])
        count = struct.unpack(order + ("Q" if big else "I"), raw[4:4 + (8 if big else 4)])[0]
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue  # a type Pillow also skips
        size = struct.calcsize(order + fmt) * count
        value = raw[entry - field:]
        if size > field:
            ptr = struct.unpack(order + ("Q" if big else "I"), value)[0]
            value = data[ptr:ptr + size]
            if len(value) < size:
                raise ValueError(f"{name}: truncated TIFF (tag {tag}'s values)")
        vals = struct.unpack(order + fmt * count, value[:size])
        tags[tag] = vals if len(fmt) == 1 else tuple(zip(vals[0::2], vals[1::2]))
    return order, tags


def _one(tags, tag, default=None):
    return tags[tag][0] if tag in tags else default


def _layout(order: str, tags: Dict[int, tuple], name: str) -> Dict:
    """Pillow's ``_setup``: the mode its ``OPEN_INFO`` gives the file's byte order,
    photometric, sample format, fill order, bits and extra samples, as what the port reads:
    ``kind`` (grey, grey_alpha, rgb, palette), ``bits``, ``spp`` and the flags."""
    photo = _one(tags, PHOTOMETRIC, 0)  # Pillow's default, where the tag is missing
    if photo in _REFUSED_PHOTOMETRIC:
        raise TIFFUnsupported(f"{name}: a {_REFUSED_PHOTOMETRIC[photo]} TIFF (photometric "
                              f"{photo}) is not decoded (grey, RGB and palette are)")
    if photo not in (0, 1, 2, 3):
        raise TIFFUnsupported(f"{name}: photometric interpretation {photo} is not decoded")
    fmt = tags.get(SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    if fmt != (1,):
        kind = {2: "signed integer", 3: "floating-point"}.get(fmt[0], f"format {fmt[0]}")
        raise TIFFUnsupported(f"{name}: {kind} samples are not decoded (unsigned are)")
    if _one(tags, FILL_ORDER, 1) != 1:
        raise TIFFUnsupported(f"{name}: FillOrder 2 (least significant bit first) is not "
                              "decoded")
    if _one(tags, ORIENTATION, 1) in (5, 6, 7, 8):
        raise TIFFUnsupported(f"{name}: a rotated orientation ({_one(tags, ORIENTATION)}) is "
                              "not decoded")
    bps = tags.get(BITS, (1,))
    extra = tags.get(EXTRA_SAMPLES, ())
    spp = _one(tags, SAMPLES, 1)
    if len(bps) > spp:
        bps = bps[:spp]
    elif len(bps) < spp and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp or len(set(bps)) != 1:
        raise TIFFUnsupported(f"{name}: bits per sample {bps} for {spp} samples")
    bits = bps[0]
    if bits not in (1, 2, 4, 8, 16):
        raise TIFFUnsupported(f"{name}: {bits}-bit samples are not decoded (1, 2, 4, 8 and "
                              "16 are)")
    out = {"bits": bits, "spp": spp, "invert": False, "premultiplied": False}
    if photo in (0, 1) and spp == 1 and extra == ():
        if bits == 16 and photo == 0 and order == ">":
            raise TIFFUnsupported(f"{name}: big-endian 16-bit WhiteIsZero is not a layout "
                                  "Pillow reads")
        return dict(out, kind="grey", invert=photo == 0 and bits <= 8)
    if photo == 1 and bits == 8 and spp == 2 and extra == (2,):
        return dict(out, kind="grey_alpha")
    if photo == 2 and bits in (8, 16) and len(extra) == spp - 3:
        if extra in (_RGB_EXTRAS if bits == 8 else _RGB_EXTRAS_16):
            return dict(out, kind="rgb", premultiplied=extra[:1] == (1,))
    if photo == 2 and bits in (8, 16) and spp == 4 and extra == ():
        return dict(out, kind="rgb")  # four samples without the tag: Pillow reads RGBA
    if photo == 3 and ((spp == 1 and extra == () and bits <= 8)
                       or (spp == 2 and bits == 8 and extra in ((0,), (2,)))):
        if COLORMAP not in tags or len(tags[COLORMAP]) != 3 << bits:
            raise ValueError(f"{name}: a palette TIFF without a colormap of {3 << bits} "
                             "entries")
        cmap = np.asarray(tags[COLORMAP], np.int64).reshape(3, 1 << bits)
        return dict(out, kind="palette", palette=(cmap // 256).T.astype(np.uint8))
    raise TIFFUnsupported(f"{name}: photometric {photo} with {spp} samples of {bits} bits "
                          f"and extra samples {tuple(extra)} is not a layout Pillow reads")


def _decompress(codec: str, raw: bytes, size: int, name: str) -> bytes:
    """One strip's or tile's bytes, ``size`` of them, decompressed on the host."""
    if codec == "none":
        out = raw[:size]
    elif codec == "deflate":
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f"{name}: corrupt Deflate data ({e})") from e
    else:
        if codec == "lzw" and len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
            raise TIFFUnsupported(f"{name}: old-style (pre-TIFF 6.0) LZW is not decoded")
        buf = np.empty(size, np.uint8)
        src = np.frombuffer(raw, np.uint8)
        lib = codec_library()
        fn = lib.tiff_lzw_decode if codec == "lzw" else lib.tiff_packbits_decode
        n = fn(src.ctypes.data, src.size, buf.ctypes.data, size)
        if n < 0:
            raise ValueError(f"{name}: corrupt LZW data")
        out = buf[:n].tobytes()
    if len(out) < size:
        raise ValueError(f"{name}: truncated TIFF data ({len(out)} of {size} bytes)")
    return out


def parse_tiff(data: bytes, name: str = "TIFF") -> Dict:
    """One TIFF's bytes -> its geometry, its layout (``_layout``) and ``chunks``: the
    decompressed strips or tiles, uint8 ``[n, rows, row bytes]`` (planes first, then rows
    of chunks, each left to right; the last strip's missing rows zero)."""
    order, tags = _ifd(data, name)
    if WIDTH not in tags or HEIGHT not in tags:
        raise ValueError(f"{name}: a TIFF without its dimensions")
    width, height = _one(tags, WIDTH), _one(tags, HEIGHT)
    compression = _one(tags, COMPRESSION, 1)
    if compression in _REFUSED_CODECS:
        raise TIFFUnsupported(f"{name}: {_REFUSED_CODECS[compression]} is not decoded (none, "
                              "LZW, Deflate and PackBits are)")
    if compression not in _CODECS:
        raise TIFFUnsupported(f"{name}: compression {compression} is not decoded")
    codec = _CODECS[compression]
    info = _layout(order, tags, name)
    check_image_size(width, height, name)
    predictor = _one(tags, PREDICTOR, 1)
    if codec in ("lzw", "deflate") and predictor != 1:
        if predictor == 3:
            raise TIFFUnsupported(f"{name}: the floating-point predictor is not decoded")
        if predictor != 2 or info["bits"] not in (8, 16):
            raise TIFFUnsupported(f"{name}: predictor {predictor} at {info['bits']} bits is "
                                  "not decoded (2 at 8 and 16 bits is)")
    else:
        predictor = 1
    planar = _one(tags, PLANAR, 1)
    planes = info["spp"] if planar == 2 else 1
    if TILE_WIDTH in tags:
        cw, ch = _one(tags, TILE_WIDTH), _one(tags, TILE_LENGTH, 0)
        offsets, counts = tags.get(TILE_OFFSETS, ()), tags.get(TILE_BYTES)
    else:
        cw, ch = width, min(_one(tags, ROWS_PER_STRIP, height) or height, height)
        offsets, counts = tags.get(STRIP_OFFSETS, ()), tags.get(STRIP_BYTES)
    if cw <= 0 or ch <= 0:
        raise ValueError(f"{name}: tiles or strips of {cw} x {ch} pixels")
    across, down = -(-width // cw), -(-height // ch)
    n = planes * across * down
    padded = n * cw * ch  # the pixels every chunk holds, edges and planes included
    if padded > 2 * MAX_IMAGE_PIXELS:  # refused before any chunk is allocated
        raise ValueError(f"{name}: {planes} plane(s) of {across} x {down} chunks of {cw} x "
                         f"{ch} pixels for a {width} x {height} image: {padded} pixels, past "
                         f"the limit of {2 * MAX_IMAGE_PIXELS}, could be decompression bomb "
                         "DOS attack.")
    if codec == "none" and (cw, ch) == (width, height) and planar != 2:
        offsets = offsets[-1:]  # Pillow's reader: one chunk covers the image, the last offset
        counts = counts[-1:] if counts else counts
    if len(offsets) < n or (codec != "none" and (counts is None or len(counts) < n)):
        raise ValueError(f"{name}: {len(offsets)} strip or tile offsets for {n} chunks")
    sppc = info["spp"] // planes
    row_bytes = -(-cw * sppc * info["bits"] // 8)
    chunks = np.zeros((n, ch, row_bytes), np.uint8)
    for i in range(n):
        rows = ch if TILE_WIDTH in tags else min(ch, height - (i % down) * ch)
        size = rows * row_bytes
        start = offsets[i]
        end = start + (size if codec == "none" else counts[i])
        got = _decompress(codec, data[start:end], size, name)
        chunks[i, :rows] = np.frombuffer(got, np.uint8).reshape(rows, row_bytes)
    return dict(info, width=width, height=height, order=order, predictor=predictor,
                planes=planes, chunk=(ch, cw), grid=(down, across), chunks=chunks)


def _layout_key(info: Dict) -> tuple:
    return tuple(info[k] for k in ("kind", "bits", "spp", "invert", "premultiplied", "order",
                                   "predictor", "planes", "chunk", "grid", "width", "height"))


def _unpremultiply(rgb: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Pillow's ``RGBa`` raw mode: ``x * 255 // a`` clipped to 255; alpha 0 reads black."""
    a = alpha[..., None]
    out = (rgb * 255 // a.clamp(min=1)).clamp(max=255)
    return torch.where(a == 0, torch.zeros_like(out), out)


def decode(infos: Sequence[Dict], device) -> torch.Tensor:
    """Parsed TIFFs of one layout (``_layout_key``) -> RGB ``[F, H, W, 3]`` uint8 on
    ``device``."""
    first = infos[0]
    bits, spp, planes = first["bits"], first["spp"], first["planes"]
    (ch, cw), (down, across) = first["chunk"], first["grid"]
    sppc = spp // planes
    raw = torch.from_numpy(np.stack([i["chunks"] for i in infos])).to(device)
    f, n = raw.shape[:2]
    if bits == 16:
        pair = raw.unflatten(-1, (-1, 2)).int()
        hi, lo = (pair[..., 0], pair[..., 1]) if first["order"] == ">" else \
            (pair[..., 1], pair[..., 0])
        vals = hi * 256 + lo
    elif bits == 8:
        vals = raw.int()
    else:  # most significant bits first, each row padded to a byte
        shifts = torch.arange(8 - bits, -1, -bits, device=device, dtype=torch.int32)
        vals = ((raw.int()[..., None] >> shifts) & ((1 << bits) - 1)).flatten(-2)
    vals = vals[..., :cw * sppc].unflatten(-1, (cw, sppc))  # [F, n, rows, cw, sppc]
    if first["predictor"] == 2:  # each row of each chunk accumulates from its left edge
        vals = vals.cumsum(dim=-2) & ((1 << bits) - 1)
    vals = vals.reshape(f, planes, down, across, ch, cw, sppc).permute(0, 2, 4, 3, 5, 1, 6)
    px = vals.reshape(f, down * ch, across * cw, spp)[:, :first["height"], :first["width"]]
    kind = first["kind"]
    if kind == "palette":
        table = torch.from_numpy(np.stack([i["palette"] for i in infos])).to(device)
        idx = px[..., 0].long() + (torch.arange(f, device=device) << bits).view(f, 1, 1)
        return table.reshape(-1, 3)[idx]
    if bits == 16:
        px = px.clamp(max=255) if kind == "grey" else px >> 8
    elif bits < 8:
        px = px * (255 // ((1 << bits) - 1))
    if kind == "rgb":
        rgb = px[..., :3]
        if first["premultiplied"]:
            rgb = _unpremultiply(rgb, px[..., 3])
        return rgb.to(torch.uint8)
    grey = 255 - px[..., 0] if first["invert"] else px[..., 0]
    return grey.to(torch.uint8)[..., None].expand(-1, -1, -1, 3)


def read_tiffs(paths: Sequence[str], device: DeviceLike = None,
               datas: Optional[Sequence[bytes]] = None) -> np.ndarray:
    """TIFF files of one size -> ``[T, H, W, 3]`` uint8 RGB on the host, equal to PIL's
    ``np.asarray(Image.open(p).convert("RGB"))`` for each: decompressed on the host, the
    rest on ``device`` (``cuda`` unless given), ``CHUNK_FRAMES`` frames a pass, one pass for
    each layout a group holds. ``datas``, where given, holds each file's bytes, already
    read."""
    dev = resolve_device(device)
    out = None
    for start in range(0, len(paths), CHUNK_FRAMES):
        infos = []
        for i in range(start, min(start + CHUNK_FRAMES, len(paths))):
            infos.append(parse_tiff(file_bytes(paths, datas, i), paths[i]))
        sizes = {(i["height"], i["width"]) for i in infos}
        if out is not None:
            sizes.add(out.shape[1:3])
        if len(sizes) > 1:
            raise ValueError(f"frames differ in size: {sorted(sizes)}")
        if out is None:
            (h, w), = sizes
            out = np.empty((len(paths), h, w, 3), np.uint8)
        groups: Dict[tuple, List[int]] = {}
        for j, info in enumerate(infos):
            groups.setdefault(_layout_key(info), []).append(j)
        for idx in groups.values():
            rgb = decode([infos[j] for j in idx], dev).cpu().numpy()
            for n, j in enumerate(idx):
                out[start + j] = rgb[n]
    if out is None:
        raise ValueError("no TIFF files given")
    return out
