"""Baseline JPEG without PIL on the port (``foley_tpu_torch/io/jpeg.py``, its host entropy
coder ``csrc/jpeg_entropy.cpp`` and the host route of ``ops/kernels/build.py``) against
Pillow 12.1 over libjpeg-turbo, on the CPU.

Decoding (baseline here; progressive, RGB, CMYK and YCCK in
``tests/test_torch_jpeg_progressive.py``) is held bit for bit against the JAX package's ``pipeline/video.py::read_frames_dir``
(PIL's ``convert("RGB")``) over sizes from 1 x 1 to 37 x 29, qualities 1 to 100, 4:4:4,
4:2:2, 4:2:0 and grey, Pillow's restart intervals (``restart_marker_blocks``,
``restart_marker_rows``), and files this test assembles from seeded coefficient blocks:
4:4:0 (which Pillow does not write) and every sampling at coefficients that drive the
inverse DCT towards its range limit. Encoding is held byte for byte against Pillow's
``save(format="JPEG", quality=q)``. No tolerance: every comparison is exact.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import jpeg as tjpeg
from foley_tpu_torch.ops.kernels import build
from foley_tpu_torch.pipeline import video as tvideo
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

SIZES = [(1, 1), (8, 8), (16, 16), (29, 37), (17, 33)]  # (height, width)
QUALITIES = [1, 50, 70, 85, 95, 100]
SAMPLINGS = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "grey": None}


def frame(h, w, seed):
    """A seeded RGB frame: smooth colour waves under noise, so every coefficient band and
    both ends of the sample range occur."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    waves = np.stack([128 + 110 * np.sin(x / 3.0 + c) * np.cos(y / 4.0 - c) for c in range(3)],
                     -1)
    return np.clip(waves + rng.normal(0, 30, waves.shape), 0, 255).astype(np.uint8)


def pil_jpeg(img, **kw) -> bytes:
    mode = kw.pop("mode", "RGB")
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _against_jax(tmp_path, data: bytes, name="f.jpg"):
    """The port's ``read_frames_dir`` of a one-file directory against the JAX package's."""
    d = tmp_path / "frames"
    d.mkdir(exist_ok=True)
    (d / name).write_bytes(data)
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_matches_pil(tmp_path, size, quality, sampling):
    img = frame(*size, seed=size[0] * 100 + quality)
    kw = {"mode": "L"} if SAMPLINGS[sampling] is None else {"subsampling": SAMPLINGS[sampling]}
    _against_jax(tmp_path, pil_jpeg(img, quality=quality, **kw))


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4", "grey"])
@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}], ids=["blocks3", "rows1"])
def test_decode_with_restart_markers(tmp_path, restart, sampling):
    img = frame(37, 45, seed=5)
    kw = {"mode": "L"} if SAMPLINGS[sampling] is None else {"subsampling": SAMPLINGS[sampling]}
    data = pil_jpeg(img, quality=80, **restart, **kw)
    assert b"\xff\xdd" in data and b"\xff\xd1" in data  # DRI and more than one RSTn
    _against_jax(tmp_path, data)


@pytest.mark.parametrize("settings", [
    {"optimize": True, "quality": 80}, {"optimize": True, "quality": 90, "subsampling": 1},
    {"qtables": [[300] * 64, [400] * 64]}, {"qtables": [[1] * 64, [2] * 64]}],
    ids=["optimized", "optimized_422", "16bit_tables_sof1", "unit_tables"])
def test_decode_other_encoder_settings(tmp_path, settings):
    """Optimised Huffman tables, and tables past 255 (16-bit DQT in an extended-sequential
    SOF1 frame) or of ones."""
    data = pil_jpeg(frame(23, 41, seed=3), **settings)
    if "qtables" in settings and settings["qtables"][0][0] > 255:
        assert b"\xff\xc1" in data
    _against_jax(tmp_path, data)


def synthetic_jpeg(h, w, luma_hv, seed, scale=5):
    """A baseline JPEG assembled from seeded quantised blocks (standard Huffman tables,
    quality 50 tables) with the luma sampled ``luma_hv`` = (h, v) and the chroma 1 x 1, or
    grey for ``None``: encoded by the port's host coder, decoded by both sides."""
    rng = np.random.default_rng(seed)
    hh, vv = luma_hv or (1, 1)
    mx, my = -(-w // (8 * hh)), -(-h // (8 * vv))
    n_luma = hh * vv
    per_mcu = n_luma + (2 if luma_hv else 0)
    blocks = np.zeros((mx * my * per_mcu, 64), np.int16)
    blocks[:, 0] = rng.integers(-60, 60, len(blocks))
    ac = np.rint(rng.laplace(0, scale, (len(blocks), 63)) * (rng.random((len(blocks), 63)) < 0.3))
    blocks[:, 1:] = np.clip(ac, -60, 60)
    bits, vals = tjpeg._table_arrays(tjpeg._STD_TABLES)
    comp = np.array([0] * n_luma + ([1, 2] if luma_hv else []), np.int32)
    tables = np.array([0, 1, 1], np.int32)
    out = np.empty(len(blocks) * 420 + 64, np.uint8)
    n = tjpeg.entropy_library().fj_encode_scan(
        blocks.ctypes.data, len(blocks), per_mcu, comp.ctypes.data, tables.ctypes.data,
        tables.ctypes.data, bits.ctypes.data, vals.ctypes.data, out.ctypes.data, out.size)
    assert n > 0
    header = tjpeg.jpeg_header(w, h, 50)
    if luma_hv is None:  # one component: one table, one scan component
        sof = header.index(b"\xff\xc0")
        header = (header[:sof] + tjpeg._segment(0xC0, bytes([8, h >> 8, h & 255, w >> 8, w & 255,
                                                             1, 1, 0x11, 0]))
                  + b"".join(tjpeg._segment(0xC4, bytes([c]) + t[0] + t[1])
                             for c, t in ((0x00, tjpeg.STD_DC_LUMA), (0x10, tjpeg.STD_AC_LUMA)))
                  + tjpeg._segment(0xDA, bytes([1, 1, 0, 0, 63, 0])))
    else:
        header = header.replace(b"\x03\x01\x22\x00", bytes([3, 1, hh * 16 + vv, 0]))
    return header + out[:n].tobytes() + b"\xff\xd9"


@pytest.mark.parametrize("luma_hv", [(1, 2), (2, 2), (2, 1), (1, 1), None],
                         ids=["4:4:0", "4:2:0", "4:2:2", "4:4:4", "grey"])
@pytest.mark.parametrize("size", [(1, 1), (13, 3), (29, 37)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_assembled_files(tmp_path, size, luma_hv):
    """Sampling Pillow does not write (4:4:0) and coefficients far larger than an encoder of
    natural images gives (the inverse DCT's clamp at both ends)."""
    data = synthetic_jpeg(*size, luma_hv, seed=size[1])
    got = _against_jax(tmp_path, data)
    if size[0] > 1:
        assert (got == 0).any() and (got == 1).any()  # clamped at both ends


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES + [(40, 24), (3, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_matches_pil(size, quality):
    img = frame(*size, seed=7 + quality)
    got = tjpeg.encode_jpegs(img[None], quality, "cpu")[0]
    assert got == pil_jpeg(img, quality=quality)


def test_encode_a_batch_in_chunks(monkeypatch):
    """Frames encoded several to a device pass and one at a time give Pillow's bytes."""
    frames = np.stack([frame(20, 30, seed=s) for s in range(5)])
    monkeypatch.setattr(tjpeg, "CHUNK_BLOCKS", 2 * 6 * 2 * 2)  # two frames a pass
    got = tjpeg.encode_jpegs(frames, 85, "cpu")
    assert got == [pil_jpeg(f, quality=85) for f in frames]
    monkeypatch.setattr(tjpeg, "CHUNK_BLOCKS", 1)
    assert tjpeg.decode_jpegs(got, "cpu").tolist() == [
        np.asarray(Image.open(io.BytesIO(b)).convert("RGB")).tolist() for b in got]


def test_refusals_name_the_format(tmp_path):
    """What stays refused, each by name: lossless and hierarchical frames (their arithmetic
    kinds, SOF11 and SOF13-15, too), 12-bit samples, two components. (Progressive, CMYK,
    YCCK, RGB, arithmetic-coded files and every sampling libjpeg takes decode:
    ``tests/test_torch_jpeg_progressive.py``, ``test_torch_jpeg_arith.py``,
    ``test_torch_jpeg_sampling.py``.)"""
    img = frame(16, 16, seed=1)
    base = pil_jpeg(img, quality=90)
    sof = base.index(b"\xff\xc0")
    for marker, name in ((b"\xff\xc3", "lossless"), (b"\xff\xc5", "hierarchical"),
                         (b"\xff\xcb", "lossless arithmetic"),
                         (b"\xff\xcd", "hierarchical arithmetic")):
        with pytest.raises(tjpeg.JPEGUnsupported, match=name):
            tjpeg.decode_jpegs([base.replace(b"\xff\xc0", marker, 1)], "cpu")
    twelve = base[:sof + 4] + bytes([12]) + base[sof + 5:]
    with pytest.raises(tjpeg.JPEGUnsupported, match="12-bit"):
        tjpeg.decode_jpegs([twelve], "cpu")
    two = base[:sof + 9] + bytes([2]) + base[sof + 10:]  # the component count
    with pytest.raises(tjpeg.JPEGUnsupported, match="2-component"):
        tjpeg.decode_jpegs([two], "cpu")
    d = tmp_path / "frames"
    d.mkdir()
    (d / "0.jpg").write_bytes(base.replace(b"\xff\xc0", b"\xff\xcb", 1))
    with pytest.raises(tjpeg.JPEGUnsupported, match="arithmetic"):
        tvideo.read_frames_dir(str(d), device="cpu")


@pytest.mark.parametrize("cut", ["eoi", "scan", "header"])
def test_truncated_data_raises_where_pil_does(cut):
    data = pil_jpeg(frame(64, 64, seed=2), quality=90)
    bad = {"eoi": data[:-2], "scan": data[:-200], "header": data[:300]}[cut]
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bad)).convert("RGB")
    with pytest.raises(ValueError):
        tjpeg.decode_jpegs([bad], "cpu")


@pytest.mark.parametrize("selector", [0xFF, 0x40, 0x04], ids=["ff", "dc4", "ac4"])
def test_scan_table_selectors_past_3_raise_where_pil_does(selector):
    """An SOS that names a Huffman table past 3 (baseline has 0-3) is corrupt: Pillow raises,
    and so does the port, before the entropy decoder sees the selector."""
    data = pil_jpeg(frame(16, 16, seed=3), quality=90)
    sos = data.index(b"\xff\xda")
    bad = data[:sos + 6] + bytes([selector]) + data[sos + 7:]  # the first component's tables
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bad)).convert("RGB")
    with pytest.raises(ValueError, match="Huffman tables"):
        tjpeg.decode_jpegs([bad], "cpu")


def test_entropy_decoder_refuses_table_selectors_past_3():
    """The C entry checks the selectors itself: a call that names DC table 4 or AC table 7
    returns an error, it does not index past its four tables."""
    import ctypes

    lib = tjpeg.entropy_library()
    bits, vals = tjpeg._table_arrays(tjpeg._STD_TABLES)
    out = np.zeros((1, 1, 64), np.int16)
    ptrs = (ctypes.c_void_p * 1)(out.ctypes.data)
    one = np.ones(1, np.int32)
    data = np.zeros(16, np.uint8)
    for dc, ac in ((4, 0), (0, 7), (-1, 0)):
        dc, ac = np.array([dc], np.int32), np.array([ac], np.int32)  # alive over the call
        err = ctypes.create_string_buffer(256)
        rc = lib.fj_decode_scan(data.ctypes.data, data.size, 1, one.ctypes.data,
                                one.ctypes.data, dc.ctypes.data, ac.ctypes.data, bits.ctypes.data,
                                vals.ctypes.data, 1, 1, one.ctypes.data, ptrs, 0, 0, 0, 63, 0, 0,
                                ctypes.byref(ctypes.c_int64()), err, len(err))
        assert rc != 0 and b"Huffman table" in err.value


def test_a_frame_past_pils_pixel_limit_raises_as_pil_does(tmp_path):
    """A few hundred bytes that declare a 65535 x 65535 frame: the JAX package's reader
    (Pillow) refuses it as a decompression bomb, and the port refuses it with Pillow's
    message before it allocates a block."""
    data = pil_jpeg(frame(16, 16, seed=4), quality=90)
    sof = data.index(b"\xff\xc0")
    big = data[:sof + 5] + bytes.fromhex("ffffffff") + data[sof + 9:]
    d = tmp_path / "frames"
    d.mkdir()
    (d / "0.jpg").write_bytes(big)
    with pytest.raises(Image.DecompressionBombError) as ref:
        jvideo.read_frames_dir(str(d))
    with pytest.raises(ValueError) as got:
        tvideo.read_frames_dir(str(d), device="cpu")
    assert str(ref.value) in str(got.value)


def test_frames_of_other_sizes_raise():
    a, b = pil_jpeg(frame(8, 8, 1)), pil_jpeg(frame(8, 16, 1))
    with pytest.raises(ValueError, match="differ in size"):
        tjpeg.decode_jpegs([a, b], "cpu")


# ---------------------------------------------------------------------------------
# the host build route
# ---------------------------------------------------------------------------------

@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "h.cpp").write_text('extern "C" int h_answer() { return 42; }\n')
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    return src


def test_host_library_builds_once_under_its_hash(csrc, monkeypatch):
    path = build.host_library_path("h")
    assert build.host_library("h").h_answer() == 42
    assert path.exists() and path.parent.parent == build.BUILD_ROOT
    assert not list(path.parent.glob("*.tmp"))  # written under a temporary name, renamed
    (csrc / "h.cpp").write_text('extern "C" int h_answer() { return 43; }\n')
    assert build.host_library_path("h") != path
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("-g",))
    assert build.host_library_path("h").parent != path.parent


def test_host_build_failure_and_missing_compiler_raise(csrc, monkeypatch):
    (csrc / "h.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed on h.cpp"):
        build.host_library("h")
    assert not build.host_library_path("h").exists()
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="c\\+\\+ not found"):
        build.host_library("h")


def test_entropy_library_is_built_into_the_ignored_tree():
    lib = tjpeg.entropy_library()
    path = build.host_library_path("jpeg_entropy")
    assert os.path.exists(path) and "build" in path.parts and lib is tjpeg.entropy_library()
