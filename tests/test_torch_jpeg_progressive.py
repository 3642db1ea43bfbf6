"""Progressive JPEG and the RGB, CMYK and YCCK colour spaces on the port
(``foley_tpu_torch/io/jpeg.py`` and the progressive scans of ``csrc/jpeg_entropy.cpp``)
against the JAX package's PIL readers, on the CPU: ``pipeline/video.py::read_frames_dir``
(Pillow 12.1 over libjpeg-turbo 3.1, ``convert("RGB")``) and ``io/avi.py::read_avi``.

Progressive files from Pillow at sizes 1 x 1 to 37 x 29, qualities 1 to 100, 4:4:4, 4:2:2,
4:2:0 and grey, with optimised tables and restart intervals; CMYK from Pillow with and
without its Adobe marker, progressive too; RGB from Pillow's ``keep_rgb`` and with its
Adobe marker taken out (the ids R, G, B); YCCK assembled here from seeded blocks in
libjpeg's default sampling (Y and K 2 x 2). A progressive file whose scans stop before its
first coefficients are complete decodes with libjpeg's block smoothing. No tolerance: every
comparison is exact.
"""

import io

import numpy as np
import pytest
from PIL import Image

from foley_tpu.io import avi as javi
from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import avi as tavi
from foley_tpu_torch.io import jpeg as tjpeg
from foley_tpu_torch.pipeline import video as tvideo
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

SIZES = [(1, 1), (8, 8), (29, 37), (37, 29)]  # (height, width)
QUALITIES = [1, 50, 90, 100]
SAMPLINGS = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "grey": None}


def frame(h, w, seed):
    """A seeded RGB frame: smooth colour waves under noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    waves = np.stack([128 + 110 * np.sin(x / 3.0 + c) * np.cos(y / 4.0 - c) for c in range(3)],
                     -1)
    return np.clip(waves + rng.normal(0, 30, waves.shape), 0, 255).astype(np.uint8)


def pil_jpeg(img, mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _against_jax(tmp_path, data: bytes, name="f.jpg"):
    d = tmp_path / "frames"
    d.mkdir(exist_ok=True)
    (d / name).write_bytes(data)
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def _sampling_kw(sampling):
    return {"mode": "L"} if SAMPLINGS[sampling] is None else {"subsampling": SAMPLINGS[sampling]}


def _scans(data: bytes) -> int:
    return data.count(b"\xff\xda")


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_matches_pil(tmp_path, size, quality, sampling):
    data = pil_jpeg(frame(*size, seed=size[0] * 100 + quality), quality=quality,
                    progressive=True, **_sampling_kw(sampling))
    assert b"\xff\xc2" in data and _scans(data) > 2
    _against_jax(tmp_path, data)


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("settings", [
    {"optimize": True, "quality": 80}, {"restart_marker_blocks": 3, "quality": 85},
    {"restart_marker_rows": 1, "quality": 70, "optimize": True}],
    ids=["optimize", "restart_blocks3", "restart_rows1_optimize"])
def test_progressive_optimized_and_restarts(tmp_path, settings, sampling):
    """Optimised Huffman tables (one DHT a scan) and restart markers, which reset the DC
    predictors and the EOB run inside every scan."""
    data = pil_jpeg(frame(37, 45, seed=6), progressive=True, **settings,
                    **_sampling_kw(sampling))
    if "restart_marker_blocks" in settings or "restart_marker_rows" in settings:
        assert b"\xff\xdd" in data and b"\xff\xd1" in data
    _against_jax(tmp_path, data)


def _without_segment(data: bytes, marker: bytes) -> bytes:
    at = data.index(marker)
    length = int.from_bytes(data[at + 2:at + 4], "big")
    return data[:at] + data[at + 2 + length:]


@pytest.mark.parametrize("variant", ["baseline", "progressive", "no_adobe"])
@pytest.mark.parametrize("size", [(1, 1), (29, 37)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_cmyk_matches_pil(tmp_path, size, variant):
    """Pillow reads every CMYK JPEG inverted (its ``CMYK;I`` raw mode, whatever the markers
    say), then converts to RGB."""
    data = pil_jpeg(frame(*size, seed=9), mode="CMYK", quality=90,
                    progressive=variant == "progressive")
    assert b"\xff\xee" in data  # libjpeg's Adobe marker (transform 0) on CMYK
    if variant == "no_adobe":
        data = _without_segment(data, b"\xff\xee")
    _against_jax(tmp_path, data)


def test_cmyk_conversion_equals_pils_everywhere():
    """``cmyk_to_rgb`` on every pair of ink and black against Pillow's ``CMYK;I`` unpack and
    ``convert("RGB")``."""
    import torch

    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    samples = np.stack([c, 255 - c, (c * 7) % 256, k], -1)  # as decoded from the file
    pil = Image.frombytes("CMYK", (256, 256), (255 - samples).astype(np.uint8).tobytes())
    got = tjpeg.cmyk_to_rgb(torch.from_numpy(samples)).numpy()
    np.testing.assert_array_equal(got, np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("variant", ["adobe0", "ids_rgb", "progressive"])
def test_rgb_jpeg_matches_pil(tmp_path, variant):
    """Three components without a colour transform: Pillow's ``keep_rgb`` writes the Adobe
    marker's transform 0 and the component ids R, G, B; without the marker the ids decide."""
    data = pil_jpeg(frame(29, 37, seed=10), quality=92, keep_rgb=True, subsampling=0,
                    progressive=variant == "progressive")
    assert b"\xff\xee" in data and b"\xff\xe0" not in data
    if variant == "ids_rgb":
        data = _without_segment(data, b"\xff\xee")
    _against_jax(tmp_path, data)


def _segment(marker: int, payload: bytes) -> bytes:
    return tjpeg._segment(marker, payload)


def assembled_jpeg(h, w, comps, adobe, seed, jfif=False):
    """A baseline JPEG of ``comps`` = [(id, h, v, table), ...] assembled from seeded
    quantised blocks (quality 50 tables, the standard Huffman tables), with an Adobe marker
    of transform ``adobe`` (None: no marker)."""
    rng = np.random.default_rng(seed)
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comp_of_block = [i for i, c in enumerate(comps) for _ in range(c[1] * c[2])]
    blocks = np.zeros((mx * my * len(comp_of_block), 64), np.int16)
    blocks[:, 0] = rng.integers(-40, 40, len(blocks))
    ac = np.rint(rng.laplace(0, 4, (len(blocks), 63)) * (rng.random((len(blocks), 63)) < 0.3))
    blocks[:, 1:] = np.clip(ac, -40, 40)
    bits, vals = tjpeg._table_arrays(tjpeg._STD_TABLES)
    tables = np.array([c[3] for c in comps], np.int32)
    block_comp = np.array(comp_of_block, np.int32)
    out = np.empty(len(blocks) * 420 + 64, np.uint8)
    n = tjpeg.entropy_library().fj_encode_scan(
        blocks.ctypes.data, len(blocks), len(comp_of_block), block_comp.ctypes.data,
        tables.ctypes.data, tables.ctypes.data, bits.ctypes.data, vals.ctypes.data,
        out.ctypes.data, out.size)
    assert n > 0
    luma, chroma = tjpeg.quality_tables(50)
    head = [b"\xff\xd8"]
    if jfif:
        head.append(_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    if adobe is not None:
        head.append(_segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe])))
    for tq, table in enumerate((luma, chroma)):
        head.append(_segment(0xDB, bytes([tq]) + bytes(table[tjpeg.ZIGZAG].astype(np.uint8))))
    head.append(_segment(0xC0, bytes([8, h >> 8, h & 255, w >> 8, w & 255, len(comps)])
                         + b"".join(bytes([i, hh * 16 + vv, t]) for i, hh, vv, t in comps)))
    for cls_id, (b, v) in ((0x00, tjpeg.STD_DC_LUMA), (0x10, tjpeg.STD_AC_LUMA),
                           (0x01, tjpeg.STD_DC_CHROMA), (0x11, tjpeg.STD_AC_CHROMA)):
        head.append(_segment(0xC4, bytes([cls_id]) + b + v))
    head.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([i, t * 17]) for i, _, _, t in comps) + bytes([0, 63, 0])))
    return b"".join(head) + out[:n].tobytes() + b"\xff\xd9"


YCCK_LAYOUTS = {"2x2_1_1_2x2": [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 2, 2, 0)],
                "1x1": [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 1, 1, 0)],
                "2x1_1_1_2x1": [(1, 2, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 2, 1, 0)]}


@pytest.mark.parametrize("layout", list(YCCK_LAYOUTS))
@pytest.mark.parametrize("size", [(1, 1), (13, 3), (29, 37)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_ycck_matches_pil(tmp_path, size, layout):
    """Adobe transform 2: libjpeg's YCC -> RGB, C, M and Y the complements, K kept, then
    Pillow's inversion and CMYK -> RGB."""
    _against_jax(tmp_path, assembled_jpeg(*size, YCCK_LAYOUTS[layout], adobe=2, seed=size[1]))


@pytest.mark.parametrize("case", ["pillow_cmyk_as_ycck", "adobe1_ycc", "jfif_over_rgb_ids",
                                  "cmyk_other_transform"])
def test_colour_space_markers_as_libjpeg_reads_them(tmp_path, case):
    """The markers decide the colour space as ``jdapimin.c`` decides it: a CMYK file's
    Adobe transform 2 makes it YCCK (any transform but 0 on four components does), Adobe
    transform 1 on three is YCbCr, and a JFIF marker makes three components YCbCr whatever
    their ids."""
    if case == "pillow_cmyk_as_ycck":
        data = pil_jpeg(frame(20, 24, seed=11), mode="CMYK", quality=90)
        at = data.index(b"\xff\xee")
        data = data[:at + 15] + b"\x02" + data[at + 16:]  # the transform byte
    elif case == "cmyk_other_transform":
        data = assembled_jpeg(16, 16, YCCK_LAYOUTS["1x1"], adobe=7, seed=12)
    elif case == "adobe1_ycc":
        data = assembled_jpeg(17, 19, [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)], adobe=1,
                              seed=13)
    else:
        data = assembled_jpeg(17, 19, [(82, 1, 1, 0), (71, 1, 1, 1), (66, 1, 1, 1)],
                              adobe=None, seed=14, jfif=True)
    _against_jax(tmp_path, data)


def _first_scans(data: bytes, n: int) -> bytes:
    """The file cut before its (n + 1)-th scan, closed with EOI."""
    at = -1
    for _ in range(n + 1):
        at = data.index(b"\xff\xda", at + 1)
    return data[:at] + b"\xff\xd9"


def test_incomplete_progressive_file_is_refused_by_name(tmp_path):
    """Cut after its DC scans and the first AC scans, a progressive file leaves its first
    coefficients short: Pillow's libjpeg smooths the blocks, and the port, which once refused
    such a file by name, now decodes it as Pillow does (``io/jpeg.py::smooth_blocks``; every
    cut of the default scripts in ``tests/test_torch_jpeg_smoothing.py``)."""
    data = pil_jpeg(frame(32, 40, seed=15), quality=85, progressive=True, subsampling=2)
    partial = _first_scans(data, 3)
    assert tjpeg.parse_jpeg(partial)["smooth"].any()
    got = _against_jax(tmp_path, partial)
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(partial)).convert("RGB"))[None] / np.float32(255))


def test_bad_progression_raises():
    """A refinement scan whose Al is not its Ah - 1 is corrupt (JERR_BAD_PROGRESSION)."""
    data = pil_jpeg(frame(16, 16, seed=16), quality=85, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    for at in sos:
        ns = data[at + 4]
        ahal = at + 5 + 2 * ns + 2
        if data[ahal] >> 4:  # a refinement scan
            bad = data[:ahal] + bytes([data[ahal] | 0x0F]) + data[ahal + 1:]
            with pytest.raises(ValueError, match="progressive"):
                tjpeg.decode_jpegs([bad], "cpu")
            return
    raise AssertionError("no refinement scan")


def test_progressive_avi_matches_jax_read_avi(tmp_path, monkeypatch):
    """An MJPEG AVI whose frames are progressive JPEGs: the JAX writer with Pillow's save
    made progressive, read back by the JAX reader (PIL) and by the port's."""
    save = Image.Image.save

    def progressive_save(self, fp, format=None, **kw):
        return save(self, fp, format, progressive=True, **kw)

    rng = np.random.default_rng(17)
    frames = np.stack([frame(18, 26, seed=s) for s in range(4)])
    audio = rng.normal(0, 0.1, 8000).astype(np.float32)
    monkeypatch.setattr(Image.Image, "save", progressive_save)
    data = javi.build_avi_bytes(frames, 8.0, audio, 16000)
    monkeypatch.setattr(Image.Image, "save", save)
    path = tmp_path / "p.avi"
    path.write_bytes(data)
    info = tavi.read_avi_info(str(path))
    assert all(b"\xff\xc2" in j for j in info["jpegs"])
    ref = javi.read_avi(str(path))
    got = tavi.read_avi(str(path), "cpu")
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]
