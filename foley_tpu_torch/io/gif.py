"""GIF frames without PIL: the first frame, read as Pillow 12.1's
``Image.open(p).convert("RGB")`` reads it (``GifImagePlugin``, ``libImaging/GifDecode.c``;
what the JAX package's ``pipeline/video.py::read_frames_dir`` calls), byte for byte.

On the host, ``csrc/gif_lzw.cpp`` (built at first use by
``ops/kernels/build.py::host_library``) walks the blocks up to the first image descriptor
(the logical screen, the global and local colour tables, the extensions: a Graphic Control
Extension's transparent index) and decodes that image's LZW data into palette indices in
decode order (LSB-first codes of 3 to 12 bits after a minimum code size of 0 to 12, clear
and end codes, a full table kept until a clear). On the device the caller names (the card,
unless the caller asks for the CPU), over every frame of one layout at once: the rows of an
interlaced frame put in place (the passes 0 / 8, 4 / 8, 2 / 4, 1 / 2), the frame placed on
its logical screen (grown to hold the frame where the frame passes its edge), the screen
outside it filled with the transparent index or else 0, as Pillow fills frame 0, and the
palette looked up: the local colour table, else (none, or one of the greys ``0, 1, 2, ...``)
the global one, of ``2 ** (n + 1)`` entries; an index past them reads black; where neither
holds other than greys (Pillow's mode ``L``), each index reads as its grey. The transparent
index keeps its colour: ``convert("RGB")`` drops transparency.

Pillow's verdicts are kept: a file without an image descriptor, a screen past Pillow's pixel
limit, a frame of no pixels, a broken LZW stream (a first code that is not a literal, a code
past the next free one), a code size past 12, and data that ends before the frame is full
(at its end, or at an end code where the file ends too) raise ``ValueError``; data after a
full frame is not read, and an end code before the frame is full is read past where the file
goes on, as Pillow reads on there.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.io.png import check_image_size, file_bytes

# frames put together in one device pass, which bounds the device memory of a long clip
CHUNK_FRAMES = 128
_INFO = ("screen_w", "screen_h", "global", "global_at", "global_n", "left", "top", "width",
         "height", "interlace", "local", "local_at", "local_n", "transparency", "bits",
         "data_at")  # ``csrc/gif_lzw.cpp::gif_parse``'s fields, in its order


def gif_library() -> ctypes.CDLL:
    """``csrc/gif_lzw.cpp``, built at first use (a missing compiler or a failed build
    raises; ``host_library`` keeps the loaded library)."""
    from foley_tpu_torch.ops.kernels.build import host_library

    lib = host_library("gif_lzw")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.gif_parse.argtypes = [p, i64, p, p, i32]
    lib.gif_parse.restype = ctypes.c_int
    lib.gif_lzw_decode.argtypes = [p, i64, i32, i32, i32, i32, p]
    lib.gif_lzw_decode.restype = i64
    return lib


def _table(data: bytes, at: int, n: int) -> Optional[np.ndarray]:
    """A colour table ``[n, 3]``, or None where it holds the greys 0, 1, 2, ... (Pillow's
    ``_is_palette_needed`` false)."""
    table = np.frombuffer(data, np.uint8, 3 * n, at).reshape(n, 3)
    return None if (table == np.arange(n)[:, None]).all() else table


def parse_gif(data: bytes, name: str = "GIF") -> Dict:
    """One GIF's bytes -> its first frame: ``width`` and ``height`` (the logical screen, grown
    to hold the frame), ``frame`` (left, top, width, height), ``interlace``, ``fill`` (the
    index outside the frame), ``palette`` (uint8 ``[256, 3]``: the table looked up) and
    ``indices`` (uint8 ``[frame height * frame width]``, decode order)."""
    lib = gif_library()
    info = np.zeros(len(_INFO), np.int64)
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.gif_parse(src.ctypes.data, src.size, info.ctypes.data, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    g = dict(zip(_INFO, (int(v) for v in info)))
    left, top, fw, fh = g["left"], g["top"], g["width"], g["height"]
    width, height = g["screen_w"], g["screen_h"]
    if left + fw > width or top + fh > height:  # Pillow grows the screen to hold the frame
        width, height = max(left + fw, width), max(top + fh, height)
    check_image_size(width, height, name)
    if fw == 0 or fh == 0:
        raise ValueError(f"{name}: a GIF frame of {fw} x {fh} pixels")
    # the local table, unless it is missing or holds the greys; then the global one, unless
    # it is missing or holds the greys (Pillow loads the global palette into a frame whose
    # local table it found to be greys)
    table = _table(data, g["local_at"], g["local_n"]) if g["local"] else None
    if table is None and g["global"]:
        table = _table(data, g["global_at"], g["global_n"])
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    if table is not None:  # mode P: the table, then black
        palette[:] = 0
        palette[:min(len(table), 256)] = table[:256]
    indices = np.empty(fw * fh, np.uint8)
    n = lib.gif_lzw_decode(src[g["data_at"]:].ctypes.data, src.size - g["data_at"], g["bits"],
                           fw, fh, g["interlace"], indices.ctypes.data)
    if n < 0:
        raise ValueError(f"{name}: " + {
            -1: "broken LZW data", -2: "image file is truncated (the LZW data ends before the "
            "frame is full)", -3: f"an LZW minimum code size of {g['bits']} (12 at most)"}[n])
    fill = g["transparency"] if g["transparency"] >= 0 else 0
    return {"width": width, "height": height, "frame": (left, top, fw, fh),
            "interlace": bool(g["interlace"]), "fill": fill, "palette": palette,
            "indices": indices}


def interlace_rows(height: int) -> torch.Tensor:
    """The image row of each decoded row of an interlaced frame: rows 0, 8, 16, ..., then 4,
    12, ..., then 2, 6, ..., then 1, 3, ... (int64 ``[height]``)."""
    rows = torch.arange(height)
    return torch.cat([rows[0::8], rows[4::8], rows[2::4], rows[1::2]])


def decode(infos: Sequence[Dict], device) -> torch.Tensor:
    """Parsed GIFs of one layout (screen, frame, interlace) -> RGB ``[F, H, W, 3]`` uint8 on
    ``device``: the rows put in place, the frame placed on the filled screen, the palette
    looked up."""
    first = infos[0]
    f, (left, top, fw, fh) = len(infos), first["frame"]
    idx = torch.from_numpy(np.stack([i["indices"] for i in infos])).to(device)
    idx = idx.view(f, fh, fw)
    if first["interlace"]:
        rows = interlace_rows(fh).to(device)
        idx = torch.empty_like(idx).index_copy_(1, rows, idx)
    fill = torch.tensor([i["fill"] for i in infos], dtype=torch.uint8, device=device)
    screen = fill.view(f, 1, 1).expand(f, first["height"], first["width"]).clone()
    screen[:, top:top + fh, left:left + fw] = idx
    table = torch.from_numpy(np.stack([i["palette"] for i in infos])).to(device)
    at = screen.long() + (torch.arange(f, device=device) << 8).view(f, 1, 1)
    return table.reshape(-1, 3)[at]


def _layout_key(info: Dict) -> tuple:
    return info["width"], info["height"], info["frame"], info["interlace"]


def read_gifs(paths: Sequence[str], device: DeviceLike = None,
              datas: Optional[Sequence[bytes]] = None) -> np.ndarray:
    """GIF files of one size -> ``[T, H, W, 3]`` uint8 RGB of each one's first frame on the
    host, equal to PIL's ``np.asarray(Image.open(p).convert("RGB"))``: decoded on the host,
    the rest on ``device`` (``cuda`` unless given), ``CHUNK_FRAMES`` frames a pass, one pass
    for each layout a group holds. ``datas``, where given, holds each file's bytes, already
    read."""
    dev = resolve_device(device)
    out = None
    for start in range(0, len(paths), CHUNK_FRAMES):
        infos = [parse_gif(file_bytes(paths, datas, i), paths[i])
                 for i in range(start, min(start + CHUNK_FRAMES, len(paths)))]
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
        raise ValueError("no GIF files given")
    return out
