"""The remaining PNG types and BMP without PIL on the port (``foley_tpu_torch/io/png.py``,
``io/bmp.py``, ``pipeline/video.py``'s frame readers) against Pillow 12.1's
``Image.open(p).convert("RGB")`` (the JAX package's ``read_frames_dir``), on the CPU.

PNG: every colour type at every bit depth PNG allows, plain and Adam7 interlaced, written
here by a numpy encoder that filters every scanline of every pass (None, Sub, Up, Average,
Paeth in turn) over the filters' bytes a pixel; Pillow's own files where it writes the type.
BMP: the core, info, V4 and V5 headers, bottom-up and top-down, 1-, 4- and 8-bit palettes
(short ones, indices past their end), 16, 24 and 32 bits plain and with Pillow's bitfield
layouts, assembled here; Pillow's own BMPs. No tolerance: every comparison is exact.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import bmp as tbmp
from foley_tpu_torch.io import png as tpng
from foley_tpu_torch.pipeline import video as tvideo
from torch_bmp_writer import bmp_bytes, rle_bmp, rle_encode
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filter_row(raw: np.ndarray, prev: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    x = raw.astype(np.int16)
    up = prev.astype(np.int16)
    left = np.concatenate([np.zeros(bpp, np.int16), x[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = [np.zeros_like(x), left, up, (left + up) >> 1, paeth][kind]
    return ((x - pred) & 0xFF).astype(np.uint8)


def _pack(samples: np.ndarray, depth: int) -> bytes:
    """One scanline's samples -> its bytes (big-endian 16-bit, MSB-first under 8 bits)."""
    flat = samples.reshape(-1)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    bits = np.unpackbits(flat.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:].reshape(-1)
    return np.packbits(bits).tobytes()


def encode_png_any(samples: np.ndarray, ctype: int, depth: int, interlace: int = 0,
                   palette=None, seed: int = 0) -> bytes:
    """``[H, W, channels]`` samples -> PNG bytes of that colour type and bit depth, Adam7
    interlaced when ``interlace``, every scanline filtered (the kinds in turn)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    grid = tpng.ADAM7 if interlace else ((0, 0, 1, 1),)
    body = bytearray()
    kind = seed
    for x0, y0, dx, dy in grid:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = None
        for row in sub:
            raw = np.frombuffer(_pack(row, depth), np.uint8)
            prev = np.zeros_like(raw) if prev is None else prev
            body += bytes([kind % 5]) + _filter_row(raw, prev, kind % 5, bpp).tobytes()
            prev, kind = raw, kind + 1

    def chunk(k: bytes, d: bytes) -> bytes:
        return struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                            0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(bytes(body))) + chunk(b"IEND", b"")


def _against_jax(tmp_path, files):
    """The port's ``read_frames_dir`` of a directory of ``files`` against the JAX
    package's."""
    d = tmp_path / "frames"
    d.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        (d / name).write_bytes(data)
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def png_case(ctype, depth, interlace, size, seed):
    rng = np.random.default_rng(seed)
    h, w = size
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (h, w, CHANNELS[ctype]))
    if depth == 16 and ctype == 0:  # grey clips at 255: keep some below it
        samples[::2] %= 300
    palette = None
    if ctype == 3:
        n = max(2, min(top + 1, 1 + int(rng.integers(0, top + 1))))  # short palettes too
        palette = rng.integers(0, 256, (n, 3))
    return encode_png_any(samples, ctype, depth, interlace, palette, seed)


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_TYPES, ids=lambda v: str(v))
def test_png_types_match_pil(tmp_path, ctype, depth, interlace):
    files = {f"{i}.png": png_case(ctype, depth, interlace, size, seed=10 * i + depth)
             for i, size in enumerate([(1, 1), (5, 3), (9, 13)])}
    for i, (name, data) in enumerate(files.items()):
        _against_jax(tmp_path / str(i), {name: data})


def test_png_frames_of_every_type_in_one_read(tmp_path):
    """One directory mixing types, depths and interlacing: one read, grouped on the device
    by (colour type, depth, interlacing), in name order."""
    files = {f"{i:02d}.png": png_case(c, d, i % 2, (7, 10), seed=i)
             for i, (c, d) in enumerate(PNG_TYPES)}
    got = _against_jax(tmp_path, files)
    assert got.shape == (len(PNG_TYPES), 7, 10, 3)


def test_adam7_at_720p_matches_pil(tmp_path):
    """A 1280 x 720 16-bit RGB Adam7 frame (the card's ``image_codecs`` phase reads one)."""
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:720, 0:1280]
    img = np.stack([x * 51, y * 91, (x + y) * 23], -1) % 65536
    img[::7, ::5] = rng.integers(0, 65536, img[::7, ::5].shape)
    _against_jax(tmp_path, {"f.png": encode_png_any(img, 2, 16, interlace=1)})


def _packbits(idx: np.ndarray, bits: int) -> bytes:
    if bits == 8:
        return idx.astype(np.uint8).tobytes()
    b = np.unpackbits(idx.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:].reshape(-1)
    return np.packbits(b).tobytes()


def bmp_case(kind, hsize, top_down, size, seed):
    rng = np.random.default_rng(seed)
    h, w = size
    if kind.startswith("pal"):
        bits = int(kind[3:])
        n = 2 if bits == 1 else int(rng.integers(2, 1 << bits))  # short palettes
        pal = rng.integers(0, 256, (n, 3 if hsize == 12 else 4)).astype(np.uint8)
        idx = rng.integers(0, 1 << bits, (h, w))  # indices past the palette's end too
        return bmp_bytes(w, h, bits, [_packbits(r, bits) for r in idx], pal.tobytes(),
                         colors=0 if hsize == 12 else n, hsize=hsize, top_down=top_down)
    bits, masks = {"rgb16": (16, None), "rgb24": (24, None), "rgb32": (32, None),
                   "bf565": (16, (0xF800, 0x7E0, 0x1F, 0)),
                   "bf555": (16, (0x7C00, 0x3E0, 0x1F, 0)),
                   "bf32_bgrx": (32, (0xFF0000, 0xFF00, 0xFF, 0)),
                   "bf32_rgba": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                   "bf32_bgar": (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000))}[kind]
    px = rng.integers(0, 1 << bits, (h, w), dtype=np.uint64)
    dtype = {16: "<u2", 32: "<u4"}.get(bits)
    rows = ([r.astype(dtype).tobytes() for r in px] if dtype
            else [rng.integers(0, 256, 3 * w).astype(np.uint8).tobytes() for _ in range(h)])
    packed = b""
    if masks:
        packed = struct.pack("<3I", *masks[:3]) if hsize == 40 else struct.pack("<4I", *masks)
    return bmp_bytes(w, h, bits, rows, compression=3 if masks else 0, masks=packed,
                     hsize=hsize, top_down=top_down)


BMP_KINDS = ["pal1", "pal4", "pal8", "rgb16", "rgb24", "rgb32", "bf565", "bf555", "bf32_bgrx",
             "bf32_rgba", "bf32_bgar"]


# a 40-byte header carries three masks, no alpha: the alpha layouts take V4 and V5
BMP_CASES = [(k, h) for k in BMP_KINDS for h in (40, 108, 124)
             if not (h == 40 and k in ("bf32_rgba", "bf32_bgar"))]


@pytest.mark.parametrize("kind,hsize", BMP_CASES, ids=lambda v: str(v))
def test_bmp_variants_match_pil(tmp_path, kind, hsize):
    files = {}
    for i, (size, top_down) in enumerate([((1, 1), False), ((5, 7), True), ((9, 13), False)]):
        files[f"{i}.bmp"] = bmp_case(kind, hsize, top_down, size, seed=i + 3 * len(kind))
    for i, (name, data) in enumerate(files.items()):
        _against_jax(tmp_path / str(i), {name: data})


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pillow_written_bmps_and_the_core_header(tmp_path, mode):
    rng = np.random.default_rng(ord(mode[0]))
    img = Image.fromarray(rng.integers(0, 256, (6, 11, 3), dtype=np.uint8)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="BMP")
    files = {"a.bmp": buf.getvalue(), "b.bmp": bmp_case("pal8", 12, False, (6, 11), seed=1)}
    _against_jax(tmp_path, files)


def test_rle_bmp_and_other_formats_raise(tmp_path):
    """RLE8 and RLE4 read back as Pillow reads them (they were refused before the port
    decoded them); a bitfield layout Pillow does not take and a file of another format under
    a frame's name raise."""
    pal = np.arange(256 * 4, dtype=np.uint32).astype(np.uint8).reshape(256, 4)
    idx = np.array([[1, 1, 1, 7], [200, 3, 4, 5]])
    rle = rle_bmp(4, 2, rle_encode(idx[::-1], False), False, pal)
    _against_jax(tmp_path / "rle8", {"a.bmp": rle})
    rle4 = rle_bmp(4, 2, rle_encode(idx[::-1] % 16, True), True, pal[:16])
    _against_jax(tmp_path / "rle4", {"a.bmp": rle4})
    odd = bmp_bytes(2, 1, 32, [bytes(8)], compression=3, hsize=108,
                    masks=struct.pack("<4I", 0xF00, 0xF0, 0xF, 0))
    with pytest.raises(tbmp.BMPUnsupported, match="bitfield"):
        tbmp.parse_bmp(odd)
    for ext, fmt in ((".webp", "WebP"), (".tif", "TIFF")):  # read now: not one of them
        d = tmp_path / ext[1:]
        d.mkdir()
        (d / f"0{ext}").write_bytes(b"\0" * 16)
        with pytest.raises(ValueError, match=f"not a {fmt} file"):
            tvideo.read_frames_dir(str(d), device="cpu")

def _rle_random(rng, w, h, rle4) -> bytes:
    """A stream of random escapes: encoded runs (some past the row's end), absolute runs
    (odd RLE4 ones among them), end of line, deltas, and an end of bitmap after enough."""
    out = bytearray()
    for _ in range(4 * h + 8):
        kind = rng.choice(["run", "run", "abs", "eol", "delta"], p=[0.35, 0.2, 0.3, 0.1, 0.05])
        if kind == "run":
            out += bytes([int(rng.integers(1, w + 3)), int(rng.integers(0, 256))])
        elif kind == "abs":
            n = int(rng.integers(3, w + 2))
            payload = rng.integers(0, 256, (n + 1) // 2 if rle4 else n, dtype=np.uint8).tobytes()
            out += bytes([0, n]) + payload + b"\0" * (len(payload) & 1)
        elif kind == "eol":
            out += b"\0\0"
        else:
            out += bytes([0, 2, 0, 0, int(rng.integers(0, 3)), int(rng.integers(0, 2))])
    return bytes(out) + b"\0\0" * h


def _pil_or_error(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), None
    except Exception as e:  # noqa: BLE001 (Pillow raises several types)
        return None, e


def _same_as_pil(data: bytes):
    ref, err = _pil_or_error(data)
    if err is not None:
        with pytest.raises(ValueError):
            tbmp.read_bmps(["f.bmp"], "cpu", [data])
        return None
    got = tbmp.read_bmps(["f.bmp"], "cpu", [data])[0]
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
@pytest.mark.parametrize("top_down", [False, True])
def test_rle_bmp_against_jax(tmp_path, rle4, top_down):
    """An image with runs and noise, RLE-encoded as an encoder writes it, read by the JAX
    package (Pillow) and the port alike, in either row order."""
    rng = np.random.default_rng(20 + rle4)
    h, w = 23, 37
    idx = np.repeat(rng.integers(0, 16 if rle4 else 256, (h, w // 3 + 1)), 3, axis=1)[:, :w]
    noisy = rng.random((h, w)) < 0.25
    idx[noisy] = rng.integers(0, 16 if rle4 else 256, noisy.sum())
    palette = rng.integers(0, 256, (16 if rle4 else 256, 4)).astype(np.uint8)
    stream = rle_encode(idx if top_down else idx[::-1], rle4)
    got = _against_jax(tmp_path, {"a.bmp": rle_bmp(w, h, stream, rle4, palette, top_down)})
    np.testing.assert_array_equal(np.round(got[0] * 255).astype(np.uint8),
                                  palette[idx][..., 2::-1])


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
@pytest.mark.parametrize("seed", range(8))
def test_rle_escapes_read_as_pillow_reads_them(rle4, seed):
    """Random streams of every escape: runs cut at the row's end, absolute runs across it
    and (RLE4) of odd length, deltas (Pillow reads two bytes, then right and up), lines ended
    early (their rest index 0), a data offset of either parity; where the runs stop short of
    the bitmap Pillow raises, and so does the port."""
    rng = np.random.default_rng(100 * rle4 + seed)
    w, h = int(rng.integers(3, 30)), int(rng.integers(1, 12))
    palette = rng.integers(0, 256, (int(rng.integers(2, 17 if rle4 else 257)), 4)).astype(np.uint8)
    for gap in (b"", b"\x00"):
        _same_as_pil(rle_bmp(w, h, _rle_random(rng, w, h, rle4), rle4, palette, gap=gap))


@pytest.mark.parametrize("case", ["end_of_bitmap_early", "cut_in_a_run", "cut_in_absolute",
                                  "cut_in_delta", "delta_without_values", "no_end_of_line",
                                  "grey_palette", "rle8_at_4_bits", "rle4_at_8_bits"])
def test_rle_ends_and_odd_files(case):
    """How a stream that ends early reads (Pillow raises "not enough image data"), a delta
    cut short, rows without an end of line (Pillow's column never returns to 0, so every run
    after the first row's writes nothing: too little data), a palette of greys (Pillow's
    mode L: each index its own grey, past the palette too), RLE8 at 4 bits and RLE4 at 8."""
    rng = np.random.default_rng(7)
    h, w = 6, 10
    idx = rng.integers(0, 16, (h, w))
    palette = rng.integers(0, 256, (16, 4)).astype(np.uint8)
    rle4 = case == "rle4_at_8_bits"
    stream = rle_encode(idx, rle4)
    if case == "end_of_bitmap_early":
        stream = rle_encode(idx[:3], rle4)
    elif case == "cut_in_a_run":
        stream = stream[:len(stream) // 2 | 1]
    elif case == "cut_in_absolute":
        stream = bytes([0, 8, 1, 2, 3])
    elif case == "cut_in_delta":
        stream = stream[:-2 * h - 2] + bytes([0, 2, 1])
    elif case == "delta_without_values":
        stream = bytes([0, 2, 5, 5, 1])
    elif case == "no_end_of_line":
        stream = b"".join(bytes([w, v]) for v in range(h))
    elif case == "grey_palette":
        palette = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 4, axis=1)
        stream = rle_encode(rng.integers(0, 256, (h, w)), False)
    data = rle_bmp(w, h, stream, rle4, palette)
    if case in ("rle8_at_4_bits", "rle4_at_8_bits"):  # the header's bits a pixel swapped
        data = data[:28] + struct.pack("<H", 4 if case == "rle8_at_4_bits" else 8) + data[30:]
    got = _same_as_pil(data)
    if case in ("end_of_bitmap_early", "cut_in_a_run", "cut_in_absolute", "cut_in_delta",
                "delta_without_values", "no_end_of_line"):
        assert got is None  # Pillow raised, and so did the port
    else:
        assert got is not None


def _past_pils_limit(kind: str) -> bytes:
    """A small file that declares more pixels than Pillow opens: a 65535 x 65535 PNG, a
    20000 x 20000 BMP (Pillow refuses BMPs past 2**31 pixels with another message)."""
    if kind == "png":
        data = encode_png_any(np.zeros((2, 2, 3), np.uint8), 2, 8)
        ihdr = b"IHDR" + struct.pack(">IIBBBBB", 65535, 65535, 8, 2, 0, 0, 0)
        return data[:12] + ihdr + struct.pack(">I", zlib.crc32(ihdr)) + data[33:]
    buf = io.BytesIO()
    Image.fromarray(np.zeros((2, 2, 3), np.uint8)).save(buf, format="BMP")
    data = buf.getvalue()
    return data[:18] + struct.pack("<ii", 20000, 20000) + data[26:]


@pytest.mark.parametrize("kind", ["png", "bmp"])
def test_a_frame_past_pils_pixel_limit_raises_as_pil_does(tmp_path, kind):
    """The JAX package's reader (Pillow) refuses the file as a decompression bomb, and the
    port refuses it with Pillow's message before it inflates or allocates the pixels."""
    d = tmp_path / "frames"
    d.mkdir()
    (d / f"0.{kind}").write_bytes(_past_pils_limit(kind))
    with pytest.raises(Image.DecompressionBombError) as ref:
        jvideo.read_frames_dir(str(d))
    with pytest.raises(ValueError) as got:
        tvideo.read_frames_dir(str(d), device="cpu")
    assert str(ref.value) in str(got.value)


def test_mixed_frame_types_in_one_directory(tmp_path):
    """PNG, JPEG and BMP frames of one size in one directory, read in name order."""
    rng = np.random.default_rng(9)
    files = {}
    for i, ext in enumerate(["png", "jpg", "bmp", "jpeg", "png"]):
        img = Image.fromarray(rng.integers(0, 256, (12, 20, 3), dtype=np.uint8))
        buf = io.BytesIO()
        img.save(buf, format={"jpg": "JPEG", "jpeg": "JPEG"}.get(ext, ext.upper()))
        files[f"frame_{i + 1}.{ext}"] = buf.getvalue()
    got = _against_jax(tmp_path, files)
    assert got.shape == (5, 12, 20, 3)


def test_grey_palette_reads_each_index_as_its_grey(tmp_path):
    """An uncompressed 8-bit BMP whose 16 colours are the greys 0-15 opens in Pillow's mode L:
    every index reads as its own grey, past the palette's end too (it read black before)."""
    pal = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 4, axis=1)
    idx = np.random.default_rng(9).integers(0, 256, (5, 9))
    data = bmp_bytes(9, 5, 8, [r.astype(np.uint8).tobytes() for r in idx], pal.tobytes(),
                     colors=16)
    assert Image.open(io.BytesIO(data)).mode == "L"
    got = _against_jax(tmp_path, {"a.bmp": data})
    np.testing.assert_array_equal(np.round(got[0, ..., 0] * 255), idx)
