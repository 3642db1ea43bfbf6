"""TIFF frames without PIL on the port (``foley_tpu_torch/io/tiff.py`` and its host LZW and
PackBits decoders, ``csrc/tiff_lzw.cpp``) against the JAX package's
``pipeline/video.py::read_frames_dir`` (Pillow 12.1 over libtiff 4.7, ``convert("RGB")``),
on the CPU.

Pillow's own files where it writes the layout (LZW with and without predictor 2, Deflate,
PackBits, none, JPEG; RGB, grey, 1-bit, palette, RGBA, LA, ``I;16``, CMYK, YCbCr), and files
assembled here (``torch_tiff_writer.py``) for what Pillow does not write: either byte order,
BigTIFF, strips of several heights, tiles, planar configuration 2, 1- to 16-bit grey and
WhiteIsZero, 16-bit RGB and its extra samples, associated alpha, 1- to 8-bit palettes,
predictor 2 at 8 and 16 bits, each compression, every orientation, CMYK's layouts, YCbCr at
every subsampling libtiff converts with its coefficient and reference tags, JPEG-in-TIFF in
strips and tiles at 4:4:4, 4:2:2 and 4:2:0. Every refused kind raises, naming itself. No
tolerance: every comparison is exact.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import tiff as ttiff
from foley_tpu_torch.pipeline import video as tvideo
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_tiff_writer import jpeg_tiff, tiff_bytes, ycbcr_chunks, ycbcr_tiff


def samples(h, w, spp, bits, seed):
    """Seeded samples: a ramp under noise, every value of the depth reached."""
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    y, x = np.mgrid[0:h, 0:w]
    ramp = (x * 37 + y * 11)[..., None] * (np.arange(spp) + 1)
    noise = rng.integers(0, top + 1, (h, w, spp))
    return np.where(rng.random((h, w, spp)) < 0.3, noise, ramp % (top + 1)).astype(np.int64)


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
    "ycbcr": ({"photometric": 6}, "uncompressed YCbCr"),  # Pillow: "image file is truncated"
    "cielab": ({"photometric": 8}, "CIELab"),
    "float": ({"tags": _tags(t339=(3, [3, 3, 3]))}, "floating-point samples"),
    "signed": ({"tags": _tags(t339=(3, [2, 2, 2]))}, "signed integer samples"),
    "12bit": ({"tags": _tags(t258=(3, [12, 12, 12]))}, "12-bit"),
    "32bit": ({"tags": _tags(t258=(3, [32, 32, 32]))}, "32-bit"),
    "fill_order": ({"tags": _tags(t266=(3, [2]))}, "FillOrder 2"),
    "float_predictor": ({"compression": 8, "tags": _tags(t317=(3, [3]))},
                        "floating-point predictor"),
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


# ---------------------------------------------------------------------------------------
# orientations, CMYK, YCbCr and JPEG-in-TIFF
# ---------------------------------------------------------------------------------------

def _same_verdict(tmp_path, data: bytes):
    """Pillow and the port both raise, or both read the same bytes (through each
    package's ``read_frames_dir``)."""
    try:
        Image.open(io.BytesIO(data)).convert("RGB")
    except Exception:  # noqa: BLE001 (Pillow raises several types)
        with pytest.raises(ValueError):
            ttiff.read_tiffs(["f.tif"], "cpu", [data])
        return False
    _against_jax(tmp_path, data)
    return True


def _orientation_case(case: str):
    rgb = samples(13, 22, 3, 8, seed=30)
    if case == "rgb_lzw":
        return dict(px=rgb, photometric=2, bits=8, compression=5, rows=4)
    if case == "palette_none":
        return dict(px=samples(13, 22, 1, 4, seed=31), photometric=3, bits=4,
                    colormap=np.arange(48) * 1300)
    if case == "grey16_tiles":
        return dict(px=samples(13, 22, 1, 16, seed=32), photometric=1, bits=16,
                    compression=8, tile=(16, 16))
    raise KeyError(case)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("case", ["rgb_lzw", "palette_none", "grey16_tiles", "ycbcr22",
                                  "jpeg_ycbcr", "cmyk"])
def test_orientations(tmp_path, orientation, case):
    """Every orientation (Pillow's ``exif_transpose`` after the decode: 2-4 flipped, 5-8
    turned, their width and height swapped), over every route of the reader."""
    tag = {274: (3, [orientation])}
    if case == "ycbcr22":
        data = ycbcr_tiff(samples(13, 22, 3, 8, seed=33), (2, 2), rows=4, tags=tag)
    elif case == "jpeg_ycbcr":
        data = jpeg_tiff(samples(24, 40, 3, 8, seed=34), rows=16, tags=tag)
    elif case == "cmyk":
        data = tiff_bytes(samples(13, 22, 4, 8, seed=35), 5, 8, compression=8, tags=tag)
    else:
        kw = _orientation_case(case)
        data = tiff_bytes(kw.pop("px"), kw.pop("photometric"), kw.pop("bits"), tags=tag, **kw)
    got = _against_jax(tmp_path, data)
    assert got.shape[1:3] == ((22, 13) if orientation >= 5 and case != "jpeg_ycbcr"
                              else (40, 24) if orientation >= 5 else got.shape[1:3])


@pytest.mark.parametrize("second", ["upright_same", "turned_same", "turned_other"])
def test_rotated_frames_agree_in_size_after_turning(tmp_path, second):
    """A 256 x 144 frame at orientation 6 opens at 144 x 256: beside a 144 x 256 frame at
    orientation 1, or a 256 x 144 one at orientation 8, it reads; beside a 144 x 256 one at
    orientation 6 (opening at 256 x 144) the sizes differ, and both packages raise."""
    d = tmp_path / "frames"
    d.mkdir()
    (d / "0.tif").write_bytes(tiff_bytes(samples(144, 256, 3, 8, seed=36), 2, 8,
                                         compression=5, tags={274: (3, [6])}))
    size, orientation = {"upright_same": ((256, 144), 1), "turned_same": ((144, 256), 8),
                         "turned_other": ((256, 144), 6)}[second]
    (d / "1.tif").write_bytes(tiff_bytes(samples(*size, 3, 8, seed=37), 2, 8, compression=8,
                                         tags={274: (3, [orientation])}))
    if second != "turned_other":
        ref, _ = jvideo.read_frames_dir(str(d))
        got, _ = tvideo.read_frames_dir(str(d), device="cpu")
        assert got.shape == (2, 256, 144, 3)
        np.testing.assert_array_equal(got, ref)
    else:
        with pytest.raises(ValueError):
            jvideo.read_frames_dir(str(d))
        with pytest.raises(ValueError, match="frames differ in size"):
            tvideo.read_frames_dir(str(d), device="cpu")


@pytest.mark.parametrize("compression", ["none", "lzw", "deflate", "packbits", "jpeg"])
def test_pillows_own_cmyk(tmp_path, compression):
    img = Image.fromarray(samples(19, 27, 3, 8, seed=38).astype(np.uint8)).convert("CMYK")
    kw = {"none": {"compression": "raw"}, "jpeg": {"compression": "jpeg", "quality": 90}}.get(
        compression, PIL_COMPRESSIONS.get(compression))
    _against_jax(tmp_path, _pil(img, **kw))


@pytest.mark.parametrize("layout", ["8", "8_x", "8_xx", "16_le", "16_be", "8_planar",
                                    "8_predictor", "16_predictor_be"])
def test_cmyk_layouts(tmp_path, layout):
    """Every CMYK row of Pillow's ``OPEN_INFO`` (8 bits with 0-2 extra samples, 16 bits in
    either byte order: the high bytes), in planes and under predictor 2: raw mode ``CMYK``
    (not inverted), then ``cmyk2rgb``."""
    bits = 16 if layout.startswith("16") else 8
    extra = {"8_x": (0,), "8_xx": (0, 0)}.get(layout)
    px = samples(15, 21, 4 + len(extra or ()), bits, seed=39)
    kw = dict(order=">" if layout.endswith("be") else "<", extra=extra,
              planar=2 if layout == "8_planar" else 1,
              predictor=2 if "predictor" in layout else 1, compression=5, rows=6)
    _against_jax(tmp_path, tiff_bytes(px, 5, bits, **kw))


def test_cmyk_every_ink_against_black():
    """All 256 x 256 pairs of an ink and black through the port's conversion against
    Pillow's, on one CMYK TIFF."""
    ink, black = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([ink, 255 - ink, ink // 2, black], -1)
    data = tiff_bytes(px, 5, 8, compression=8, rows=64)
    np.testing.assert_array_equal(ttiff.read_tiffs(["f"], "cpu", [data])[0],
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("compression", ["lzw", "deflate", "packbits", "none"])
def test_pillows_own_ycbcr(tmp_path, compression):
    """Pillow writes YCbCr at 1 x 1; it reads it through libtiff's RGBA interface
    (``TIFFYCbCrToRGB``) when compressed, and raises uncompressed (raw mode RGBX wants 4
    bytes a pixel): so does the port."""
    rgb = samples(21, 34, 3, 8, seed=40).astype(np.uint8)
    data = _pil(Image.fromarray(rgb).convert("YCbCr"), **PIL_COMPRESSIONS[compression])
    if compression == "none":
        with pytest.raises(OSError, match="truncated"):
            Image.open(io.BytesIO(data)).convert("RGB")
        with pytest.raises(ttiff.TIFFUnsupported, match="uncompressed YCbCr"):
            ttiff.parse_tiff(data)
        return
    got = _against_jax(tmp_path, data)
    assert np.abs(np.round(got[0] * 255) - rgb).max() <= 3


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)])
@pytest.mark.parametrize("layout", ["strips4", "strips_odd", "one_strip", "tiles16"])
@pytest.mark.parametrize("compression", [5, 8, 32773])
def test_ycbcr_subsampling(tmp_path, sub, layout, compression):
    """Every subsampling libtiff's RGBA interface converts, in strips (of a height that is
    not a multiple of the block's, and the last one short), one strip, and tiles; each
    block's chroma replicated over it, never interpolated."""
    rows = {"strips4": 4, "strips_odd": 5 if sub[1] == 1 else 6, "one_strip": None}.get(layout)
    tile = (16, 16) if layout == "tiles16" else None
    data = ycbcr_tiff(samples(19, 29, 3, 8, seed=41), sub, compression, rows=rows, tile=tile)
    _against_jax(tmp_path, data)


@pytest.mark.parametrize("case", ["bt709_studio", "odd_reference", "no_subsampling_tag",
                                  "predictor_11", "planar_11", "big_endian"])
def test_ycbcr_tables_and_layouts(tmp_path, case):
    """libtiff's tables from ``YCbCrCoefficients`` and ``ReferenceBlackWhite`` (its float
    steps), the default subsampling 2 x 2 where the tag is missing, predictor 2 and planes at
    1 x 1, big-endian."""
    ycc = samples(17, 26, 3, 8, seed=42)
    tags = {}
    if case == "bt709_studio":
        tags = {529: (5, [(2126, 10000), (7152, 10000), (722, 10000)]),
                532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])}
    elif case == "odd_reference":
        tags = {532: (5, [(31, 2), (473, 2), (121, 1), (250, 1), (503, 4), (245, 1)])}
    if case == "no_subsampling_tag":
        data = ycbcr_tiff(ycc, (2, 2), rows=6, subsampling_tag=False)
    elif case == "predictor_11":
        data = tiff_bytes(ycc, 6, 8, compression=5, predictor=2, rows=5,
                          tags={530: (3, [1, 1])})
    elif case == "planar_11":
        data = tiff_bytes(ycc, 6, 8, compression=8, planar=2, tags={530: (3, [1, 1])})
    else:
        data = ycbcr_tiff(ycc, (2, 1), rows=6, tags=tags, order=">" if case == "big_endian"
                          else "<")
    _against_jax(tmp_path, data)


@pytest.mark.parametrize("case", ["sub_1_4", "sub_2_4", "subsampled_predictor",
                                  "one_sample_lzw", "one_sample_none", "truncated_block"])
def test_ycbcr_that_pillow_refuses_or_reads_oddly(tmp_path, case):
    """Subsamplings libtiff does not convert raise; a one-sample YCbCr file reads as grey
    uncompressed (Pillow's mode L) and raises compressed (libtiff refuses it); a subsampled
    file with a predictor, which the port does not decode, is refused by name; a strip short
    of its blocks raises (libtiff's RGBA interface reads on past it, and Pillow returns what
    it left: not read as Pillow reads it)."""
    ycc = samples(12, 16, 3, 8, seed=43)
    if case in ("sub_1_4", "sub_2_4"):
        data = ycbcr_tiff(ycc, (1, 4) if case == "sub_1_4" else (2, 4), rows=4)
    elif case == "subsampled_predictor":
        data = ycbcr_tiff(ycc, (2, 2), rows=4, predictor=1, tags={317: (3, [2])})
        with pytest.raises(ttiff.TIFFUnsupported, match="predictor"):
            ttiff.parse_tiff(data)
        return
    elif case.startswith("one_sample"):
        data = tiff_bytes(ycc[..., :1], 6, 8, compression=5 if case.endswith("lzw") else 1)
    else:  # libtiff's RGBA interface reads on past the strip's error; the port refuses it
        chunks = ycbcr_chunks(ycc, (2, 2), rows=4)
        chunks[1] = chunks[1][:-7]
        data = tiff_bytes(ycc, 6, 8, compression=5, rows=4, tags={530: (3, [2, 2])},
                          raw_chunks=chunks)
        with pytest.raises(ValueError, match="truncated TIFF data"):
            ttiff.parse_tiff(data)
        return
    assert _same_verdict(tmp_path, data) == (case == "one_sample_none")


@pytest.mark.parametrize("mode", ["RGB", "L", "YCbCr"])
@pytest.mark.parametrize("quality", [50, 95])
def test_pillows_own_jpeg_in_tiff(tmp_path, mode, quality):
    """Pillow's JPEG-in-TIFF (libtiff's encoder, tables in ``JPEGTables``): RGB as
    photometric 2 (no colour transform), grey, and YCbCr (photometric 6, decoded to RGB by
    libjpeg as libtiff's ``JPEGCOLORMODE_RGB`` asks)."""
    img = Image.fromarray(samples(40, 52, 3, 8, seed=44).astype(np.uint8)).convert(mode)
    _against_jax(tmp_path, _pil(img, compression="jpeg", quality=quality))


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("layout", ["strips16", "one_strip", "tiles32", "own_tables",
                                    "no_subsampling_tag"])
def test_jpeg_in_tiff_ycbcr(tmp_path, subsampling, layout):
    """YCbCr JPEG-in-TIFF at 4:4:4, 4:2:2 and 4:2:0 in strips (the last one short), one
    strip and tiles past the image's edges, its tables shared or in each stream, the
    subsampling tag missing (libtiff takes the stream's); the chroma upsampled as libjpeg's
    fancy upsampler does it, each strip on its own."""
    rgb = samples(40, 52, 3, 8, seed=45)
    kw = {"strips16": dict(rows=16), "one_strip": {}, "tiles32": dict(tile=(32, 32)),
          "own_tables": dict(rows=16, shared_tables=False),
          "no_subsampling_tag": dict(rows=24, subsampling_tag=False)}[layout]
    _against_jax(tmp_path, jpeg_tiff(rgb, subsampling=subsampling, **kw))


@pytest.mark.parametrize("case", ["rgb_components", "improper_sampling", "rgb_subsampled",
                                  "strip_too_big", "truncated_stream", "missing_tables"])
def test_jpeg_in_tiff_odd_files(tmp_path, case):
    """Photometric 2 whose streams hold R, G, B: read without a transform; a subsampling
    tag that disagrees with the stream, subsampled RGB, a stream larger than its strip and
    missing tables raise, as libtiff fails them; a corrupt stream, which libjpeg decodes
    with a warning, raises in the port (not read as Pillow reads it)."""
    rgb = samples(32, 40, 3, 8, seed=46)
    if case == "rgb_components":
        data = jpeg_tiff(rgb, photometric=2, subsampling=0, rows=16)
    elif case == "improper_sampling":
        data = jpeg_tiff(rgb, subsampling=2, rows=16, tags={530: (3, [1, 1])})
    elif case == "rgb_subsampled":
        data = jpeg_tiff(rgb, photometric=2, subsampling=2, rows=16)
    elif case == "strip_too_big":
        data = jpeg_tiff(rgb, subsampling=2, rows=16, tags={278: (4, [8])})
    elif case == "truncated_stream":  # libjpeg reads on with a warning; the port refuses it
        data = bytearray(jpeg_tiff(rgb, subsampling=2, rows=32))
        data[200:400] = bytes(200)
        with pytest.raises(ValueError, match="corrupt or truncated"):
            ttiff.parse_tiff(bytes(data))
        return
    else:
        data = jpeg_tiff(rgb, subsampling=2, rows=16)
        i = data.rindex(struct.pack("<HH", 347, 7))
        data = data[:i] + struct.pack("<HH", 65000, 7) + data[i + 4:]
    assert _same_verdict(tmp_path, data) == (case == "rgb_components")
