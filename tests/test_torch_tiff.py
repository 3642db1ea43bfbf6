"""TIFF frames without PIL on the port (``foley_tpu_torch/io/tiff.py`` and its host LZW and
PackBits decoders, ``csrc/tiff_lzw.cpp``) against the JAX package's
``pipeline/video.py::read_frames_dir`` (Pillow 12.1 over libtiff 4.7, ``convert("RGB")``),
on the CPU.

Pillow's own files where it writes the layout (LZW with and without predictor 2, Deflate,
PackBits, none; RGB, grey, 1-bit, palette, RGBA, LA, ``I;16``), and files this test
assembles for what Pillow does not write: either byte order, BigTIFF, strips of several
heights, tiles, planar configuration 2, 1- to 16-bit grey and WhiteIsZero, 16-bit RGB and
its extra samples, associated alpha, 1- to 8-bit palettes, predictor 2 at 8 and 16 bits,
each compression. Every refused kind raises, naming itself. No tolerance: every comparison
is exact.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import tiff as ttiff
from foley_tpu_torch.pipeline import video as tvideo
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)


def samples(h, w, spp, bits, seed):
    """Seeded samples: a ramp under noise, every value of the depth reached."""
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    y, x = np.mgrid[0:h, 0:w]
    ramp = (x * 37 + y * 11)[..., None] * (np.arange(spp) + 1)
    noise = rng.integers(0, top + 1, (h, w, spp))
    return np.where(rng.random((h, w, spp)) < 0.3, noise, ramp % (top + 1)).astype(np.int64)


def lzw_encode(data: bytes) -> bytes:
    """TIFF 6.0 LZW: 9- to 12-bit codes, MSB first, a clear first and when the table fills,
    the code width growing one code early, as libtiff's encoder writes it."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, n):
        nonlocal acc, nacc
        acc, nacc = (acc << n) | code, nacc + n
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    def fresh():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, nbits = fresh()
    put(256, 9)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], nbits)
        table[wc], nxt = nxt, nxt + 1
        if nxt == 4094:
            put(256, nbits)
            table, nxt, nbits = fresh()
        elif nxt == 1 << nbits:
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w], nbits)
        nxt += 1
        if nxt == 1 << nbits:
            nbits += 1
    put(257, nbits)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _pack_row(row: np.ndarray, bits: int, order: str) -> bytes:
    if bits == 16:
        return row.astype(order + "u2").tobytes()
    if bits == 8:
        return row.astype(np.uint8).tobytes()
    b = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:].reshape(-1)
    return np.packbits(b).tobytes()


def tiff_bytes(px, photometric, bits, order="<", big=False, compression=1, predictor=1,
               planar=1, tile=None, rows=None, extra=None, colormap=None, tags=None):
    """``px`` [H, W, spp] samples -> a TIFF: strips of ``rows`` rows (all in one when None)
    or ``tile`` = (height, width) tiles, planar configuration ``planar``, the samples
    differenced along each row for predictor 2, compressed, with the given tags and any
    ``tags`` = {tag: (type, values)} added or replacing them."""
    h, w, spp = px.shape
    planes = spp if planar == 2 else 1
    ch, cw = tile if tile else ((rows or h), w)
    across, down = -(-w // cw), -(-h // ch)
    chunks = []
    for p in range(planes):
        for cy in range(down):
            for cx in range(across):
                part = np.zeros((ch, cw, spp // planes), np.int64)
                src = px[cy * ch:(cy + 1) * ch, cx * cw:(cx + 1) * cw,
                         p if planar == 2 else slice(None)]
                src = src.reshape(src.shape[0], src.shape[1], -1)
                part[:src.shape[0], :src.shape[1]] = src
                if not tile:
                    part = part[:min(ch, h - cy * ch)]
                if predictor == 2:
                    part = np.concatenate([part[:, :1], np.diff(part, axis=1)], 1) % (1 << bits)
                raw = b"".join(_pack_row(r.reshape(-1), bits, order) for r in part)
                raw = {1: lambda d: d, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
                       32773: packbits_encode}[compression](raw)
                chunks.append(raw)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra is not None:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    if tile:
        entries.update({322: (3, [cw]), 323: (3, [ch]), 324: (4, [0] * len(chunks)),
                        325: (4, [len(c) for c in chunks])})
    else:
        entries.update({278: (4, [ch]), 273: (4, [0] * len(chunks)),
                        279: (4, [len(c) for c in chunks])})
    entries.update(tags or {})
    head = 16 if big else 8
    data_at = head
    offsets = []
    for c in chunks:
        offsets.append(data_at)
        data_at += len(c) + (len(c) & 1)
    entries[324 if tile else 273] = (16 if big else 4, offsets)
    fmt = {1: "B", 3: "H", 4: "I", 16: "Q"}
    n_entry, field = (20, 8) if big else (12, 4)
    ifd_at = data_at
    blob_at = ifd_at + (8 if big else 2) + n_entry * len(entries) + (8 if big else 4)
    ifd, blobs = bytearray(), bytearray()
    ifd += struct.pack(order + ("Q" if big else "H"), len(entries))
    for tag in sorted(entries):
        typ, vals = entries[tag]
        if typ == 16 and not big:
            typ = 4
        raw = struct.pack(order + fmt[typ] * len(vals), *vals)
        count = struct.pack(order + ("Q" if big else "I"), len(vals))
        if len(raw) <= field:
            value = raw.ljust(field, b"\0")
        else:
            value = struct.pack(order + ("Q" if big else "I"), blob_at + len(blobs))
            blobs += raw + b"\0" * (len(raw) & 1)
        ifd += struct.pack(order + "HH", tag, typ) + count + value
    ifd += b"\0" * (8 if big else 4)
    magic = 43 if big else 42
    header = (order.replace("<", "II").replace(">", "MM").encode()
              + struct.pack(order + "H", magic)
              + (struct.pack(order + "HHQ", 8, 0, ifd_at) if big
                 else struct.pack(order + "I", ifd_at)))
    body = b"".join(c + b"\0" * (len(c) & 1) for c in chunks)
    return header + body + bytes(ifd) + bytes(blobs)


def _against_jax(tmp_path, data: bytes, name="f.tif"):
    d = tmp_path / "frames"
    d.mkdir(exist_ok=True)
    (d / name).write_bytes(data)
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def _pil(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="TIFF", **kw)
    return buf.getvalue()


PIL_COMPRESSIONS = {"none": {"compression": "raw"}, "lzw": {"compression": "tiff_lzw"},
                    "lzw_predictor": {"compression": "tiff_lzw", "tiffinfo": {317: 2}},
                    "deflate": {"compression": "tiff_deflate"},
                    "adobe_deflate_predictor": {"compression": "tiff_adobe_deflate",
                                                "tiffinfo": {317: 2}},
                    "packbits": {"compression": "packbits"}}


@pytest.mark.parametrize("mode,compression", [
    (m, c) for m in ["RGB", "L", "1", "P", "RGBA", "LA", "I;16"] for c in PIL_COMPRESSIONS
    if not (m == "1" and "predictor" in c)])  # libtiff's predictor takes 8 and 16 bits only
def test_pillows_own_tiffs(tmp_path, mode, compression):
    rgb = samples(29, 37, 3, 8, seed=1).astype(np.uint8)
    if mode == "I;16":
        img = Image.fromarray((rgb[..., 0].astype(np.uint16) * 257 // 3).astype(np.uint16))
    elif mode == "RGBA":
        img = Image.fromarray(np.dstack([rgb, rgb[..., 1]]), "RGBA")
    else:
        img = Image.fromarray(rgb).convert(mode)
    _against_jax(tmp_path, _pil(img, **PIL_COMPRESSIONS[compression]))


COMPRESSIONS = [1, 5, 8, 32773]


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("photometric,bits", [(1, 1), (1, 2), (1, 4), (1, 8), (1, 16), (0, 1),
                                              (0, 2), (0, 4), (0, 8)])
def test_grey_depths(tmp_path, photometric, bits, order, compression):
    """Grey and WhiteIsZero at every depth: under 8 bits scaled, WhiteIsZero inverted, 16
    bits clamped at 255 (``I;16``)."""
    px = samples(13, 21, 1, bits, seed=bits)
    _against_jax(tmp_path, tiff_bytes(px, photometric, bits, order, compression=compression,
                                      rows=5))


def test_whiteiszero_16_bit_is_not_inverted(tmp_path):
    px = samples(9, 11, 1, 16, seed=3)
    _against_jax(tmp_path, tiff_bytes(px, 0, 16, "<", compression=8))


@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("compression", [5, 8, 32946])
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("bits", [8, 16])
def test_rgb_predictor(tmp_path, bits, order, compression, predictor):
    """RGB at 8 and 16 bits (the high bytes), predictor 2 undone per row modulo 2**bits in
    the file's byte order."""
    px = samples(17, 23, 3, bits, seed=bits + predictor)
    _against_jax(tmp_path, tiff_bytes(px, 2, bits, order, compression=compression,
                                      predictor=predictor, rows=4))


@pytest.mark.parametrize("compression", [1, 32773])
def test_predictor_is_ignored_where_libtiff_and_pillow_ignore_it(tmp_path, compression):
    """Pillow's uncompressed reader and libtiff's PackBits do not apply the predictor: the
    differenced bytes are read as they are."""
    px = samples(7, 9, 3, 8, seed=4)
    _against_jax(tmp_path, tiff_bytes(px, 2, 8, compression=compression, predictor=2))


@pytest.mark.parametrize("bits,extra", [
    (8, e) for e in [(0,), (1,), (2,), (0, 0), (1, 0), (2, 0, 0), (999,), None]]
    + [(16, e) for e in [(0,), (1,), (2,), None]])
def test_rgb_extra_samples(tmp_path, bits, extra):
    """Alpha and unknown extras dropped; associated alpha (1) un-premultiplied as Pillow's
    ``RGBa`` raw mode; four samples without the tag read as RGBA."""
    spp = 3 + (len(extra) if extra else 1)
    px = samples(11, 13, spp, bits, seed=spp)
    if extra and extra[0] == 1:  # premultiplied: colour at most alpha, some alpha 0
        px[..., :3] = np.minimum(px[..., :3], px[..., 3:4])
        px[0, :3, 3] = 0
    _against_jax(tmp_path, tiff_bytes(px, 2, bits, compression=8, extra=extra))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("bits,extra", [(1, None), (2, None), (4, None), (8, None), (8, (0,)),
                                        (8, (2,))])
def test_palette(tmp_path, bits, extra, order):
    """The colormap's 16-bit entries cut to their high bytes; PX and PA read the index."""
    spp = 1 + (len(extra) if extra else 0)
    px = samples(15, 19, spp, bits, seed=bits)
    cmap = np.random.default_rng(bits).integers(0, 65536, 3 << bits)
    _against_jax(tmp_path, tiff_bytes(px, 3, bits, order, compression=5, extra=extra,
                                      colormap=cmap))


def test_grey_with_alpha(tmp_path):
    _against_jax(tmp_path, tiff_bytes(samples(9, 10, 2, 8, seed=5), 1, 8, extra=(2,)))


@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("layout", ["tiles16", "tiles16x32", "strips1", "strips7"])
def test_tiles_strips_and_planes(tmp_path, layout, compression, planar):
    """Tiles past the image's edges, strips of several heights, one plane a sample."""
    px = samples(29, 37, 3, 8, seed=6)
    kw = {"tiles16": {"tile": (16, 16)}, "tiles16x32": {"tile": (16, 32)},
          "strips1": {"rows": 1}, "strips7": {"rows": 7}}[layout]
    _against_jax(tmp_path, tiff_bytes(px, 2, 8, ">" if planar == 2 else "<",
                                      compression=compression, planar=planar,
                                      predictor=2 if compression in (5, 8) else 1, **kw))


@pytest.mark.parametrize("case", ["grey16_tiles_planar", "palette4_tiles", "rgb16_planar"])
def test_other_layouts_in_tiles_and_planes(tmp_path, case):
    if case == "grey16_tiles_planar":
        data = tiff_bytes(samples(20, 33, 1, 16, seed=7), 1, 16, ">", compression=5,
                          predictor=2, tile=(16, 16), planar=2)
    elif case == "palette4_tiles":
        data = tiff_bytes(samples(20, 33, 1, 4, seed=8), 3, 4, compression=8, tile=(16, 16),
                          colormap=np.arange(48) * 1000)
    else:
        data = tiff_bytes(samples(12, 17, 3, 16, seed=9), 2, 16, "<", compression=8,
                          planar=2, predictor=2)
    _against_jax(tmp_path, data)


def test_bigtiff(tmp_path):
    px = samples(21, 18, 3, 8, seed=10)
    data = tiff_bytes(px, 2, 8, "<", big=True, compression=5, predictor=2, rows=8)
    assert data[:4] == b"II\x2b\x00"
    _against_jax(tmp_path, data)


def test_big_endian_bigtiff_is_refused_as_pillow_does(tmp_path):
    """Pillow tells BigTIFF by the header's third byte, 43 only in little-endian files: a
    big-endian BigTIFF does not open."""
    data = tiff_bytes(samples(5, 6, 3, 8, seed=10), 2, 8, ">", big=True)
    with pytest.raises(Image.UnidentifiedImageError):
        Image.open(io.BytesIO(data))
    with pytest.raises(ttiff.TIFFUnsupported, match="big-endian BigTIFF"):
        ttiff.parse_tiff(data)


def test_many_frames_of_mixed_layouts_in_chunks(tmp_path, monkeypatch):
    """Frames of several layouts in one directory, read a few at a time."""
    monkeypatch.setattr(ttiff, "CHUNK_FRAMES", 2)
    d = tmp_path / "frames"
    d.mkdir()
    rgb = samples(10, 12, 3, 8, seed=11)
    files = [tiff_bytes(rgb, 2, 8, compression=5), tiff_bytes(rgb[..., :1], 1, 8),
             tiff_bytes(rgb, 2, 8, ">", compression=8, tile=(16, 16)),
             _pil(Image.fromarray(rgb.astype(np.uint8)), compression="packbits"),
             tiff_bytes(rgb[..., :1] * 200, 1, 16, compression=32773)]
    for i, data in enumerate(files):
        (d / f"f{i}.tif").write_bytes(data)
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    np.testing.assert_array_equal(got, ref)


def _tags(**kw):
    return {int(k[1:]): v for k, v in kw.items()}


REFUSED = {
    "ccitt_g3": ({"tags": _tags(t259=(3, [3]))}, "CCITT Group 3"),
    "ccitt_g4": ({"tags": _tags(t259=(3, [4]))}, "CCITT Group 4"),
    "ccitt_rle": ({"tags": _tags(t259=(3, [2]))}, "CCITT modified Huffman"),
    "jpeg_old": ({"tags": _tags(t259=(3, [6]))}, "old-style JPEG-in-TIFF"),
    "jpeg": ({"tags": _tags(t259=(3, [7]))}, "JPEG-in-TIFF"),
    "cmyk": ({"photometric": 5, "spp": 4}, "CMYK"),
    "ycbcr": ({"photometric": 6}, "YCbCr"),
    "cielab": ({"photometric": 8}, "CIELab"),
    "float": ({"tags": _tags(t339=(3, [3, 3, 3]))}, "floating-point samples"),
    "signed": ({"tags": _tags(t339=(3, [2, 2, 2]))}, "signed integer samples"),
    "12bit": ({"tags": _tags(t258=(3, [12, 12, 12]))}, "12-bit"),
    "32bit": ({"tags": _tags(t258=(3, [32, 32, 32]))}, "32-bit"),
    "fill_order": ({"tags": _tags(t266=(3, [2]))}, "FillOrder 2"),
    "float_predictor": ({"compression": 8, "tags": _tags(t317=(3, [3]))},
                        "floating-point predictor"),
    "rotated": ({"tags": _tags(t274=(3, [6]))}, "rotated orientation"),
    "layout": ({"extra": (1,), "spp": 2, "photometric": 1}, "not a layout Pillow reads"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_name_what_they_are(tmp_path, case):
    kw, message = REFUSED[case]
    kw = dict(kw)
    spp, photometric = kw.pop("spp", 3), kw.pop("photometric", 2)
    data = tiff_bytes(samples(8, 8, spp, 8, seed=12), photometric, 8, **kw)
    with pytest.raises(ttiff.TIFFUnsupported, match=message):
        ttiff.parse_tiff(data)


def test_old_style_lzw_is_refused(tmp_path):
    data = bytearray(tiff_bytes(samples(8, 8, 3, 8, seed=13), 2, 8, compression=5))
    data[8:10] = b"\x00\x01"  # the first strip's first bytes: pre-6.0 LZW's signature
    with pytest.raises(ttiff.TIFFUnsupported, match="old-style"):
        ttiff.parse_tiff(bytes(data))


@pytest.mark.parametrize("cut", [40, 200])
def test_truncated_tiff_raises(cut):
    data = tiff_bytes(samples(16, 16, 3, 8, seed=14), 2, 8, compression=5)
    with pytest.raises(ValueError):
        ttiff.parse_tiff(data[:cut])


def test_a_frame_past_pils_pixel_limit_raises_as_pil_does(tmp_path):
    data = tiff_bytes(samples(2, 2, 3, 8, seed=15), 2, 8,
                      tags={256: (4, [65535]), 257: (4, [65535])})
    d = tmp_path / "frames"
    d.mkdir()
    (d / "0.tif").write_bytes(data)
    with pytest.raises(Image.DecompressionBombError) as ref:
        jvideo.read_frames_dir(str(d))
    with pytest.raises(ValueError) as got:
        tvideo.read_frames_dir(str(d), device="cpu")
    assert str(ref.value) in str(got.value)


@pytest.mark.parametrize("tile", [(65535, 65535), (1, 1 << 30)])
def test_oversized_tiles_are_refused_before_they_are_allocated(tile):
    """A 1 x 1 image whose tile tags declare a tile past Pillow's pixel limit: refused by its
    geometry before the tile's bytes are allocated or inflated (a short Deflate stream could
    otherwise fill gigabytes a tile)."""
    data = tiff_bytes(samples(1, 1, 3, 8, seed=16), 2, 8, compression=8, tile=(16, 16),
                      tags={322: (4, [tile[1]]), 323: (4, [tile[0]])})
    with pytest.raises(ValueError, match="chunks of .* past the limit"):
        ttiff.parse_tiff(data)
