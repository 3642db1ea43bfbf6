"""PNG frames without PIL: stdlib ``zlib``, numpy and torch (what the JAX package's
``pipeline/video.py::read_frames_dir`` reads through PIL's ``Image.open(...).convert("RGB")``).

Supported: bit depth 8, colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6
(RGBA), not interlaced, every scanline filter (None, Sub, Up, Average, Paeth). The result is
PIL's ``convert("RGB")``: grey replicated to three channels, a palette looked up, an alpha
channel dropped (not composited). Anything else (16-bit samples, palettes or grey under 8
bits, Adam7 interlacing) raises, naming PIL.

The chunks are parsed and inflated on the host (stdlib ``zlib``); unfiltering is vectorised
in torch on the device the caller names (the card's, unless the caller asks for the CPU).
Average and Paeth take the reconstructed byte to the left, so a scanline cannot be undone in
one step; instead every frame of one geometry is reconstructed at once along anti-diagonals
(row + column = d): a pixel needs only its left, upper and upper-left neighbours, which lie
on diagonals d - 1 and d - 2. That is ``height + width - 1`` steps (about 2,000 at
1280x720) whatever the frame count, each a few elementwise ops over every frame and row the
diagonal crosses. A long clip is unfiltered ``CHUNK_FRAMES`` frames at a time, which bounds
the device memory the skewed buffers take.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# frames unfiltered in one wavefront: its two skewed buffers take about 4.7 bytes a sample,
# so 128 frames of 1280x720 RGB hold about 1.6 GB of device memory, 1920x1080 about 3.7 GB
CHUNK_FRAMES = 128
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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
    """The header fields, the palette and the filtered scanlines ``[H, 1 + W * channels]``
    (uint8) of one PNG file's bytes."""
    if data[:8] != SIGNATURE:
        raise PNGUnsupported(f"{name}: not a PNG file (needs PIL)")
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
    if info["ctype"] not in _CHANNELS or info["depth"] != 8:
        raise PNGUnsupported(
            f"{name}: colour type {info['ctype']} at bit depth {info['depth']} is not read "
            "without PIL (8-bit grey, RGB, palette, grey + alpha and RGBA are)")
    if info["interlace"]:
        raise PNGUnsupported(f"{name}: an interlaced PNG is not read without PIL")
    if info["ctype"] == 3 and info["palette"] is None:
        raise PNGUnsupported(f"{name}: a palette image without a PLTE chunk")
    ch = _CHANNELS[info["ctype"]]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 1 + info["width"] * ch
    if raw.size < info["height"] * stride:
        raise PNGUnsupported(f"{name}: truncated image data")
    info["channels"] = ch
    info["rows"] = raw[:info["height"] * stride].reshape(info["height"], stride)
    return info


def unfilter(rows: torch.Tensor, channels: int) -> torch.Tensor:
    """Filtered scanlines ``[F, H, 1 + W * channels]`` (uint8) of F images of one geometry ->
    their pixels ``[F, H, W, channels]`` uint8, by anti-diagonal wavefront, on
    ``rows.device``."""
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


def to_rgb(pixels: torch.Tensor, ctype: int, palette=None) -> torch.Tensor:
    """``[..., channels]`` samples of a colour type -> ``[..., 3]`` RGB, as PIL's
    ``convert("RGB")`` gives it (alpha dropped, grey replicated, the palette looked up; an
    index past the palette's end reads black)."""
    if ctype == 2:
        return pixels
    if ctype == 6:
        return pixels[..., :3]
    if ctype in (0, 4):
        return pixels[..., :1].expand(*pixels.shape[:-1], 3)
    table = np.zeros((256, 3), np.uint8)
    table[:len(palette)] = palette[:256]
    return torch.from_numpy(table).to(pixels.device)[pixels[..., 0].long()]


def read_pngs(paths: Sequence[str], device: DeviceLike = None) -> np.ndarray:
    """PNG files of one size -> ``[T, H, W, 3]`` uint8 RGB on the host, equal to PIL's
    ``np.asarray(Image.open(p).convert("RGB"))`` for each. The files are inflated on the host
    and unfiltered on ``device`` (``cuda`` unless given) ``CHUNK_FRAMES`` at a time, one
    wavefront for each channel count a chunk holds, so the device memory is bounded whatever
    the clip's length."""
    dev = resolve_device(device)
    out = None
    for start in range(0, len(paths), CHUNK_FRAMES):
        infos = []
        for p in paths[start:start + CHUNK_FRAMES]:
            with open(p, "rb") as fh:
                infos.append(parse_png(fh.read(), p))
        sizes = {(i["height"], i["width"]) for i in infos}
        if out is not None:
            sizes.add(out.shape[1:3])
        if len(sizes) > 1:
            raise ValueError(f"frames differ in size: {sorted(sizes)}")
        if out is None:
            (h, w), = sizes
            out = np.empty((len(paths), h, w, 3), np.uint8)
        groups: Dict[int, List[int]] = {}
        for j, info in enumerate(infos):
            groups.setdefault(info["channels"], []).append(j)
        for ch, idx in groups.items():
            rows = torch.from_numpy(np.stack([infos[j]["rows"] for j in idx])).to(dev)
            pixels = unfilter(rows, ch)
            for n, j in enumerate(idx):
                out[start + j] = to_rgb(pixels[n], infos[j]["ctype"],
                                        infos[j]["palette"]).cpu().numpy()
    if out is None:
        raise ValueError("no PNG files given")
    return out
