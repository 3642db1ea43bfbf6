"""PNG frames without PIL: stdlib ``zlib``, numpy and torch (what the JAX package's
``pipeline/video.py::read_frames_dir`` reads through PIL's ``Image.open(...).convert("RGB")``).

Supported: every colour type at every bit depth PNG allows (grey at 1, 2, 4, 8 and 16 bits,
palettes at 1, 2, 4 and 8, RGB, grey + alpha and RGBA at 8 and 16), plain or Adam7
interlaced, every scanline filter (None, Sub, Up, Average, Paeth). The result is PIL's
``convert("RGB")`` on Pillow 12: grey replicated to three channels (1, 2 and 4 bits scaled
by 255, 85 and 17; 16 bits clipped to 255, not scaled), a palette looked up (an index past
the palette's end reads black), 16-bit RGB, RGBA and grey + alpha cut to their high bytes,
alpha dropped (not composited).

The chunks are parsed and inflated on the host (stdlib ``zlib``); unfiltering is vectorised
in torch on the device the caller names (the card's, unless the caller asks for the CPU).
Average and Paeth take the reconstructed byte to the left, so a scanline cannot be undone in
one step; instead every frame of one geometry is reconstructed at once along anti-diagonals
(row + column = d): a pixel needs only its left, upper and upper-left neighbours, which lie
on diagonals d - 1 and d - 2. That is ``height + width - 1`` steps (about 2,000 at
1280x720) whatever the frame count, each a few elementwise ops over every frame and row the
diagonal crosses. The filters work on bytes, so a pixel of 16-bit samples is its bytes and
samples under 8 bits are unpacked after. An interlaced image is its seven Adam7 passes,
each a sub-image with scanlines of its own, unfiltered and then scattered into place. A
long clip is unfiltered ``CHUNK_FRAMES`` frames at a time, which bounds the device memory
the skewed buffers take.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# frames unfiltered in one wavefront: its two skewed buffers take about 4.7 bytes a sample,
# so 128 frames of 1280x720 RGB hold about 1.6 GB of device memory, 1920x1080 about 3.7 GB
CHUNK_FRAMES = 128
HOST_THREADS = min(8, os.cpu_count() or 1)  # files inflated at once on the host
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: each pass's first column and row and its steps
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
# Pillow's decompression-bomb limit: ``Image.open``, which the JAX package's readers call,
# refuses an image of more than twice ``Image.MAX_IMAGE_PIXELS``
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


def file_bytes(paths: Sequence[str], datas: Optional[Sequence[bytes]], i: int) -> bytes:
    """The bytes of frame ``i`` of a reader's call: ``datas[i]`` where the caller has read them
    (``pipeline/video.py`` reads each file once, to tell its format by its first bytes), else
    the file ``paths[i]``."""
    if datas is not None:
        return datas[i]
    with open(paths[i], "rb") as fh:
        return fh.read()


def check_image_size(width: int, height: int, name: str) -> None:
    """Refuse, with Pillow's message, an image larger than Pillow opens, before any of its
    pixels is allocated (the PNG, JPEG and BMP readers)."""
    pixels = max(1, width) * max(1, height)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"{name}: Image size ({pixels} pixels) exceeds limit of "
                         f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb DOS "
                         "attack.")


class PNGUnsupported(ValueError):
    """A PNG this reader does not take (the JAX package reads it through PIL)."""


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + size]
        pos += 12 + size
        if kind == b"IEND":
            return


def parse_png(data: bytes, name: str = "PNG") -> Dict:
    """The header fields, the palette, the bytes a pixel (``bpp``, at least 1) and the
    filtered scanlines of each pass (``passes``: (x0, y0, dx, dy, rows ``[h, 1 + row
    bytes]`` uint8); one pass covering the image unless it is Adam7 interlaced) of one PNG
    file's bytes."""
    if data[:8] != SIGNATURE:
        raise PNGUnsupported(f"{name}: not a PNG file")
    info: Dict = {"palette": None}
    idat: List[bytes] = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", payload[:13])
            info.update(width=w, height=h, depth=depth, ctype=ctype, interlace=interlace)
        elif kind == b"PLTE":
            info["palette"] = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if "width" not in info:
        raise PNGUnsupported(f"{name}: no IHDR chunk")
    if info["depth"] not in _DEPTHS.get(info["ctype"], ()):
        raise PNGUnsupported(f"{name}: colour type {info['ctype']} at bit depth "
                             f"{info['depth']} is not a valid PNG")
    if info["interlace"] not in (0, 1):
        raise PNGUnsupported(f"{name}: interlace method {info['interlace']} is not PNG's")
    if info["ctype"] == 3 and info["palette"] is None:
        raise PNGUnsupported(f"{name}: a palette image without a PLTE chunk")
    check_image_size(info["width"], info["height"], name)
    ch, depth = _CHANNELS[info["ctype"]], info["depth"]
    grid = ADAM7 if info["interlace"] else ((0, 0, 1, 1),)
    shapes = []
    for x0, y0, dx, dy in grid:
        pw = -(-max(info["width"] - x0, 0) // dx)
        ph = -(-max(info["height"] - y0, 0) // dy)
        if pw and ph:  # an empty pass has no scanlines, not even their filter bytes
            shapes.append((x0, y0, dx, dy, ph, 1 + -(-pw * ch * depth // 8)))
    size = sum(ph * stride for *_, ph, stride in shapes)
    # inflate no more than the image holds
    raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat), size), np.uint8)
    if raw.size < size:
        raise PNGUnsupported(f"{name}: truncated image data")
    passes, pos = [], 0
    for x0, y0, dx, dy, ph, stride in shapes:
        passes.append((x0, y0, dx, dy, raw[pos:pos + ph * stride].reshape(ph, stride)))
        pos += ph * stride
    info.update(channels=ch, bpp=max(1, ch * depth // 8), passes=passes)
    return info


def unfilter(rows: torch.Tensor, channels: int) -> torch.Tensor:
    """Filtered scanlines ``[F, H, 1 + W * channels]`` (uint8) of F images of one geometry ->
    their pixels ``[F, H, W, channels]`` uint8, by anti-diagonal wavefront, on
    ``rows.device``. ``channels`` is the filters' bytes a pixel (16-bit samples take two,
    and a row of samples under 8 bits is a row of one-byte pixels)."""
    f, h, stride = rows.shape
    w = (stride - 1) // channels
    kinds = rows[:, :, 0].to(torch.int16)
    if int(kinds.max()) > 4:
        raise PNGUnsupported(f"unknown scanline filter type {int(kinds.max())}")
    data = rows[:, :, 1:].reshape(f, h, w, channels)
    n_diag = h + w - 1
    # skewed layouts: diagonal d of row r holds pixel (r, d - r). ``out`` has two leading
    # zero diagonals (the neighbours of diagonal 0) and a zero row above row 0; a position
    # off the image is never written, so every neighbour outside the image reads 0.
    filt = torch.zeros((n_diag, f, h, channels), dtype=torch.uint8, device=rows.device)
    for r in range(h):
        filt[r:r + w, :, r] = data[:, r].transpose(0, 1)
    out = torch.zeros((n_diag + 2, f, h + 1, channels), dtype=torch.int16, device=rows.device)
    zero = torch.zeros((), dtype=torch.int16, device=rows.device)
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1), min(h - 1, d)
        a = out[d + 1, :, lo + 1:hi + 2]   # left: (r, c - 1)
        b = out[d + 1, :, lo:hi + 1]       # up: (r - 1, c)
        c = out[d, :, lo:hi + 1]           # up-left: (r - 1, c - 1)
        ac, bc = a - c, b - c
        pa, pb, pc = bc.abs(), ac.abs(), (ac + bc).abs()
        paeth = torch.where((pa <= pb) & (pa <= pc), a, torch.where(pb <= pc, b, c))
        k = kinds[:, lo:hi + 1, None]
        pred = torch.where(k == 4, paeth, torch.where(k == 3, (a + b) >> 1, torch.where(
            k == 2, b, torch.where(k == 1, a, zero))))
        out[d + 2, :, lo + 1:hi + 2] = (filt[d, :, lo:hi + 1] + pred) & 0xFF
    pixels = torch.empty((f, h, w, channels), dtype=torch.uint8, device=rows.device)
    for r in range(h):
        pixels[:, r] = out[r + 2:r + 2 + w, :, r + 1].transpose(0, 1)
    return pixels


def samples(pixels: torch.Tensor, width: int, channels: int, depth: int) -> torch.Tensor:
    """Unfiltered bytes ``[..., n, bpp]`` of scanlines ``width`` pixels wide -> the samples
    ``[..., width, channels]``: under 8 bits unpacked, most significant first (int16); 8 bits
    as they are; 16 bits big-endian (int32)."""
    if depth == 8:
        return pixels
    if depth == 16:
        wide = pixels.int().unflatten(-1, (channels, 2))
        return wide[..., 0] * 256 + wide[..., 1]
    shifts = torch.arange(8 - depth, -1, -depth, device=pixels.device, dtype=torch.int16)
    packed = (pixels[..., 0].to(torch.int16)[..., None] >> shifts) & ((1 << depth) - 1)
    return packed.flatten(-2)[..., :width, None]  # the row's bytes unpacked, cut to its width


def to_rgb(pixels: torch.Tensor, ctype: int, palette, depth: int) -> torch.Tensor:
    """``[..., channels]`` samples of a colour type at a bit depth -> ``[..., 3]`` uint8 RGB,
    as PIL's ``convert("RGB")`` gives it (alpha dropped, grey replicated, the palette looked
    up; an index past the palette's end reads black)."""
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return torch.from_numpy(table).to(pixels.device)[pixels[..., 0].long()]
    if depth == 16:
        # RGB, RGBA and grey + alpha keep the high byte; grey alone clips to 255
        pixels = pixels.clamp(max=255) if ctype == 0 else pixels >> 8
    elif depth < 8:
        pixels = pixels * (255 // ((1 << depth) - 1))
    pixels = pixels.to(torch.uint8)
    if ctype == 2:
        return pixels
    if ctype == 6:
        return pixels[..., :3]
    return pixels[..., :1].expand(*pixels.shape[:-1], 3)


def decode(infos: Sequence[Dict], device) -> torch.Tensor:
    """Parsed PNGs of one size, colour type, bit depth and interlacing -> RGB ``[F, H, W, 3]``
    uint8 on ``device``: each pass unfiltered for every frame at once, then scattered."""
    first = infos[0]
    h, w, ch, depth = first["height"], first["width"], first["channels"], first["depth"]
    out = torch.empty((len(infos), h, w, 3), dtype=torch.uint8, device=device)
    for k, (x0, y0, dx, dy, _) in enumerate(first["passes"]):
        rows = torch.from_numpy(np.stack([i["passes"][k][4] for i in infos])).to(device)
        pw = -(-(w - x0) // dx)
        px = samples(unfilter(rows, first["bpp"]), pw, ch, depth)
        for n, info in enumerate(infos):
            out[n, y0::dy, x0::dx] = to_rgb(px[n], info["ctype"], info["palette"], depth)
    return out


def read_pngs(paths: Sequence[str], device: DeviceLike = None,
              datas: Optional[Sequence[bytes]] = None) -> np.ndarray:
    """PNG files of one size -> ``[T, H, W, 3]`` uint8 RGB on the host, equal to PIL's
    ``np.asarray(Image.open(p).convert("RGB"))`` for each. The files are inflated on the host,
    ``HOST_THREADS`` at once, and unfiltered on ``device`` (``cuda`` unless given)
    ``CHUNK_FRAMES`` at a time, one wavefront for each pass of each (colour type, bit depth,
    interlacing) a chunk holds, so the device memory is bounded whatever the clip's length.
    ``datas``, where given, holds each file's bytes, already read."""
    dev = resolve_device(device)
    out = None
    for start in range(0, len(paths), CHUNK_FRAMES):
        with ThreadPoolExecutor(HOST_THREADS) as pool:  # zlib releases the GIL
            infos = list(pool.map(lambda i: parse_png(file_bytes(paths, datas, i), paths[i]),
                                  range(start, min(start + CHUNK_FRAMES, len(paths)))))
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
            key = (info["ctype"], info["depth"], info["interlace"])
            groups.setdefault(key, []).append(j)
        for idx in groups.values():
            rgb = decode([infos[j] for j in idx], dev).cpu().numpy()
            for n, j in enumerate(idx):
                out[start + j] = rgb[n]
    if out is None:
        raise ValueError("no PNG files given")
    return out
