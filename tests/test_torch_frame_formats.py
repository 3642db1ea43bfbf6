"""The frame formats together on the port (``foley_tpu_torch/pipeline/video.py``'s readers)
against the JAX package's ``pipeline/video.py`` (PIL), on the CPU: the committed fixtures of
``tests/data/torch_frame_formats/`` (``tests/torch_frame_fixtures.py``) against the digests
recorded beside them, which ``chip_smoke.py``'s ``frame_formats`` phase holds the card to,
and directories mixing progressive JPEG, TIFF (turned, JPEG, YCbCr, CMYK), lossless, lossy
and animated WebP, GIF named ``.png``, PNG and BMP (RLE too) frames of one size read through
``read_frames_dir`` and ``read_video_frames``; the fixtures Pillow raises on raising; the 720p
lossy WebP, GIF and arithmetic-coded progressive JPEG of
``tests/data/torch_frame_formats_720p/`` against their digests. No tolerance: every
comparison is exact.
"""

import hashlib
import io
import json
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

import torch_frame_fixtures as fx
from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import gif as tgif
from foley_tpu_torch.io import jpeg as tjpeg
from foley_tpu_torch.io import tiff as ttiff
from foley_tpu_torch.io import webp as twebp
from foley_tpu_torch.pipeline import video as tvideo
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

with open(os.path.join(fx.DIR, "digests.json")) as _f:
    RECORD = json.load(_f)
DIGESTS = RECORD["sha256_of_pil_rgb"]


def _data(name: str) -> bytes:
    with open(os.path.join(fx.DIR, name), "rb") as f:
        return f.read()


def test_fixtures_are_small_and_listed():
    names = sorted(n for n in os.listdir(fx.DIR) if n != "digests.json")
    assert names == sorted([*DIGESTS, *RECORD["pil_raises"]]) and len(names) == 38
    assert sum(os.path.getsize(os.path.join(fx.DIR, n)) for n in names) < 1 << 20
    assert tuple(RECORD["hw"]) == fx.HW and tuple(RECORD["pil_raises"]) == fx.REFUSED


@pytest.mark.parametrize("name", ["clip_q80.webp", "clip.gif", "clip_arith_prog.jpg"])
def test_720p_frames_are_pillows_and_the_ports(tmp_path, name):
    """The 720p frame as a lossy WebP, as Pillow's GIF and as an arithmetic-coded progressive
    JPEG: each file Pillow's digest, and the port's decode the same."""
    with open(os.path.join(fx.DIR_720P, "digests.json")) as f:
        record = json.load(f)
    digest = record["sha256_of_pil_rgb"][name]
    path = os.path.join(fx.DIR_720P, name)
    with open(path, "rb") as f:
        data = f.read()
    assert tuple(record["hw"]) == (720, 1280) and sorted(record["sha256_of_pil_rgb"]) == [
        "clip.gif", "clip_arith_prog.jpg", "clip_q80.webp"]
    kind, head, limit = {".webp": ("webp", data[12:16], 1 << 17),
                         ".gif": ("gif", data[:4], 1 << 18),
                         ".jpg": ("jpeg", data[:2], tjpeg.PIL_READ_BLOCK)}[name[name.index("."):]]
    assert head == {"webp": b"VP8 ", "gif": b"GIF8", "jpeg": b"\xff\xd8"}[kind]
    assert os.path.getsize(path) < limit
    assert fx.pil_digest(data) == digest
    read = {"webp": twebp.read_webps, "gif": tgif.read_gifs, "jpeg": tjpeg.read_jpegs}[kind]
    rgb = read([path], "cpu")[0]
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == digest


REFUSED_BECAUSE = {"alpha_vp8l_corrupt.webp": "corrupt VP8L alpha plane",
                   "sampling_3x2.jpg": "fractional upsampling"}


@pytest.mark.parametrize("name", fx.REFUSED)
def test_refused_fixtures_raise_in_pillow_and_the_port(tmp_path, name):
    """A fixture Pillow raises on (a sound VP8 frame beside a corrupt VP8L alpha plane, a
    JPEG whose sampling asks a 3 / 2 ratio) raises in the port, naming the reason."""
    data = _data(name)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).convert("RGB")
    shutil.copy(os.path.join(fx.DIR, name), tmp_path / name)
    with pytest.raises(ValueError, match=REFUSED_BECAUSE[name]):
        tvideo.read_frames_dir(str(tmp_path), device="cpu")


def test_new_kinds_in_one_directory_match_jax(tmp_path):
    """A GIF named ``.png``, turned TIFFs, JPEG-in-TIFF, YCbCr and CMYK TIFFs, RLE BMPs and the
    JPEG kinds of ROADMAP 13p-13r (other samplings, a cut progressive file, arithmetic
    coding) in one directory, through the JAX package's ``read_frames_dir`` and the port's."""
    kinds = ["gif_interlaced.png", "gif_pillow.png", "orient6.tif", "orient8.tif",
             "jpeg_rgb.tif", "jpeg_ycbcr_420.tif", "lzw_ycbcr22.tif", "cmyk8.tif", "rle8.bmp",
             "rle4.bmp", "alpha_vp8l_trailing.webp", "sampling_411.jpg",
             "luma_below_chroma.jpg", "prog_cut.jpg", "arith_restart.jpg", "arith_prog.jpg",
             "arith_prog_cut.jpg", "jpeg_ycbcr_44.tif"]
    for i, name in enumerate(kinds):
        shutil.copy(os.path.join(fx.DIR, name), tmp_path / f"f{i:02d}_{name}")
    ref, _ = jvideo.read_frames_dir(str(tmp_path))
    got, _ = tvideo.read_frames_dir(str(tmp_path), device="cpu")
    assert got.shape == (len(kinds), *fx.HW, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digest_is_pillows_and_the_ports(tmp_path, name):
    data = _data(name)
    assert fx.pil_digest(data) == DIGESTS[name]
    shutil.copy(os.path.join(fx.DIR, name), tmp_path / name)
    frames, _ = tvideo.read_frames_dir(str(tmp_path), device="cpu")
    rgb = np.round(frames[0] * 255.0).astype(np.uint8)
    assert rgb.shape == (*fx.HW, 3)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == DIGESTS[name]


def test_fixtures_hold_the_kinds_they_are_named_for():
    for name in DIGESTS:
        data = _data(name)
        if name.startswith("prog"):
            assert b"\xff\xc2" in data
        if name == "prog_restart.jpg":
            assert b"\xff\xdd" in data and b"\xff\xd0" in data
        if name == "cmyk.jpg":
            assert tjpeg.parse_jpeg(data)["color"] == "cmyk"
        if name.startswith("arith"):
            assert (b"\xff\xca" if "prog" in name else b"\xff\xc9") in data
        if name in ("prog_cut.jpg", "arith_prog_cut.jpg"):
            assert tjpeg.parse_jpeg(data)["smooth"].any()  # decoded with block smoothing
    samplings = {n: tjpeg.parse_jpeg(_data(n))["sampling"] for n in
                 ("sampling_411.jpg", "luma_below_chroma.jpg")}
    assert samplings == {"sampling_411.jpg": ((4, 1), (1, 1), (1, 1)),
                         "luma_below_chroma.jpg": ((1, 1), (2, 2), (2, 2))}
    assert b"\xff\xdd" in _data("arith_restart.jpg")
    tiffs = {n: ttiff.parse_tiff(_data(n)) for n in DIGESTS if n.endswith(".tif")}
    assert tiffs["lzw_predictor.tif"]["predictor"] == 2
    assert tiffs["palette.tif"]["kind"] == "palette"
    assert (tiffs["grey16.tif"]["kind"], tiffs["grey16.tif"]["bits"]) == ("grey", 16)
    assert [tiffs[f"orient{k}.tif"]["orientation"] for k in (6, 8)] == [6, 8]
    assert tiffs["orient6.tif"]["height"] == fx.HW[1]  # stored turned
    assert (tiffs["jpeg_rgb.tif"]["codec"], tiffs["jpeg_rgb.tif"]["jpeg_color"]) == (
        "jpeg", "rgb")
    ycc = tiffs["jpeg_ycbcr_420.tif"]
    assert ycc["jpeg_color"] == "ycc" and {j["sampling"] for j in ycc["jpeg"]} == {
        ((2, 2), (1, 1), (1, 1))} and len(ycc["jpeg"]) == 9
    assert (tiffs["lzw_ycbcr22.tif"]["kind"], tiffs["lzw_ycbcr22.tif"]["subsampling"]) == (
        "ycbcr", (2, 2))
    assert tiffs["cmyk8.tif"]["kind"] == "cmyk"
    assert {j["sampling"] for j in tiffs["jpeg_ycbcr_44.tif"]["jpeg"]} == {
        ((4, 4), (1, 1), (1, 1))}
    for name, compression in (("rle8.bmp", 1), ("rle4.bmp", 2)):
        assert struct.unpack("<I", _data(name)[30:34])[0] == compression
    gifs = {n: tgif.parse_gif(_data(n)) for n in DIGESTS if n.startswith("gif")}
    assert gifs["gif_interlaced.png"]["interlace"] and gifs["gif_interlaced.png"]["fill"] == 5
    assert gifs["gif_interlaced.png"]["frame"] == (16, 16, 224, 112)
    assert _data("gif_interlaced.png")[10] & 0x80  # a global table beside the local one
    trailing = _data("alpha_vp8l_trailing.webp")
    assert trailing.index(b"ALPH") and twebp.parse_webp(trailing)["alpha"]
    for name, want in (("color_indexing.webp", ["color_indexing"]),
                       ("all_transforms.webp", ["predictor", "cross_color", "subtract_green"])):
        info = twebp.parse_webp(_data(name))
        twebp.decode_argb(info)
        assert info["transforms"] == want
    lossy = {n: twebp.parse_webp(_data(n)) for n in DIGESTS if n.startswith(("lossy", "anim"))}
    assert all(info["kind"] == "lossy" for info in lossy.values())
    assert lossy["lossy_alpha.webp"]["alpha"] and lossy["animated_offset.webp"]["alpha"]
    assert lossy["animated.webp"]["frames"] == 3
    assert lossy["animated_offset.webp"]["offset"] == (48, 32)
    twebp.decode_yuv(lossy["lossy_simple_8parts.webp"])
    assert {"filter_simple", "partitions_8"} <= set(lossy["lossy_simple_8parts.webp"]["features"])


def _mixed_dir(tmp_path, n=14):
    """``n`` frames cycling through every fixture, a PNG and a BMP of the fixtures' size."""
    d = tmp_path / "mixed"
    d.mkdir()
    base = Image.fromarray(fx.base_frame())
    extra = {}
    for fmt, ext in (("PNG", ".png"), ("BMP", ".bmp")):
        buf = io.BytesIO()
        base.save(buf, format=fmt)
        extra["base" + ext] = buf.getvalue()
    sources = [(n, _data(n)) for n in sorted(DIGESTS)] + sorted(extra.items())
    for i in range(n):
        name, data = sources[i % len(sources)]
        (d / f"frame_{i + 1}{os.path.splitext(name)[1]}").write_bytes(data)
    return str(d)


@pytest.mark.parametrize("select", [{}, {"target_fps": 5.0}, {"max_frames": 6}],
                         ids=["all", "resampled", "cut"])
def test_mixed_directory_matches_jax(tmp_path, select):
    d = _mixed_dir(tmp_path)
    ref, ref_fps = jvideo.read_frames_dir(d, fps=8.0, **select)
    got, fps = tvideo.read_frames_dir(d, fps=8.0, device="cpu", **select)
    assert fps == ref_fps and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_mixed_directory_through_read_video_frames(tmp_path):
    d = _mixed_dir(tmp_path, n=9)
    ref, ref_fps = jvideo.read_video_frames(d, target_fps=4.0, dir_fps=8.0)
    got, fps = tvideo.read_video_frames(d, target_fps=4.0, dir_fps=8.0, device="cpu")
    assert fps == ref_fps
    np.testing.assert_array_equal(got, ref)


def _png_bytes() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(fx.base_frame()).save(buf, format="PNG")
    return buf.getvalue()


# a frame of each format under another format's name: (the name, where its bytes come from)
MISNAMED = {"png_as.jpg": "png", "jpeg_as.png": "prog_420.jpg",
            "webp_as.jpg": "lossy_q80.webp", "tiff_as.bmp": "lzw_predictor.tif"}


def _misnamed_bytes(source: str) -> bytes:
    return _png_bytes() if source == "png" else _data(source)


@pytest.mark.parametrize("name", sorted(MISNAMED))
def test_misnamed_frame_reads_as_its_bytes_say(tmp_path, name):
    """The reader is chosen by the file's first bytes, as PIL chooses it, not by its name."""
    (tmp_path / name).write_bytes(_misnamed_bytes(MISNAMED[name]))
    ref, _ = jvideo.read_frames_dir(str(tmp_path))
    got, _ = tvideo.read_frames_dir(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(got, ref)


def test_misnamed_frames_mixed_with_named_ones_match_jax(tmp_path):
    """Every misnamed kind beside the mixed directory's frames, resampled: equal to JAX."""
    d = _mixed_dir(tmp_path, n=10)
    for i, (name, source) in enumerate(sorted(MISNAMED.items())):
        with open(os.path.join(d, f"frame_{11 + i}_{name}"), "wb") as f:
            f.write(_misnamed_bytes(source))
    ref, ref_fps = jvideo.read_frames_dir(d, fps=8.0, target_fps=6.0)
    got, fps = tvideo.read_frames_dir(d, fps=8.0, target_fps=6.0, device="cpu")
    assert fps == ref_fps
    np.testing.assert_array_equal(got, ref)


def test_gif_named_png_reads_as_jax(tmp_path):
    """A GIF named ``.png`` (refused before the port read GIF) reads by its bytes, as PIL
    reads it, beside a PNG."""
    buf = io.BytesIO()
    Image.fromarray(fx.base_frame()).save(buf, format="GIF")
    (tmp_path / "a.png").write_bytes(_png_bytes())
    (tmp_path / "b.png").write_bytes(buf.getvalue())
    ref, _ = jvideo.read_frames_dir(str(tmp_path))
    got, _ = tvideo.read_frames_dir(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fmt,ext", [("SGI", ".png"), ("PPM", ".jpg"), ("QOI", ".bmp")])
def test_other_formats_raise_naming_them(tmp_path, fmt, ext):
    """A format PIL opens and the port does not decode raises, naming it, before any frame
    is decoded; the JAX package reads it through PIL."""
    buf = io.BytesIO()
    Image.fromarray(fx.base_frame()).save(buf, format=fmt)
    (tmp_path / f"a{ext}").write_bytes(_png_bytes())
    (tmp_path / f"b{ext}").write_bytes(buf.getvalue())
    assert jvideo.read_frames_dir(str(tmp_path))[0].shape == (2, *fx.HW, 3)
    with pytest.raises(ValueError, match=f"a {fmt} file; the port decodes PNG, JPEG, BMP, "
                                         f"GIF, TIFF and WebP frames, not {fmt}"):
        tvideo.read_frames_dir(str(tmp_path), device="cpu")


def test_unidentified_bytes_raise(tmp_path):
    (tmp_path / "a.png").write_bytes(b"not an image at all")
    with pytest.raises(ValueError, match="cannot identify image file"):
        tvideo.read_frames_dir(str(tmp_path), device="cpu")


def test_each_file_is_read_once(tmp_path, monkeypatch):
    """``read_frames_dir`` opens each selected frame once and hands its bytes to the reader."""
    for i, (name, source) in enumerate(sorted(MISNAMED.items())):
        (tmp_path / f"f{i}_{name}").write_bytes(_misnamed_bytes(source))
    opened = []
    real_open = open

    def counting_open(path, *args, **kwargs):
        opened.append(os.path.basename(str(path)))
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr("builtins.open", counting_open)
    tvideo.read_frames_dir(str(tmp_path), device="cpu")
    frames = [n for n in opened if n.startswith("f")]
    assert sorted(frames) == sorted(f"f{i}_{n}" for i, n in enumerate(sorted(MISNAMED)))
