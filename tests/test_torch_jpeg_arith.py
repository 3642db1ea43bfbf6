"""Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive) on the port
(``foley_tpu_torch/csrc/jpeg_entropy.cpp::fj_decode_scan_arith``, ``jdarith.c``'s decoder, and
``io/jpeg.py``'s DAC parse) against Pillow 12.1 (libjpeg-turbo 3.1) and the JAX package's
readers, on the CPU.

The files come from ``tests/torch_jpeg_writer.py`` (libjpeg's arithmetic encoder, which
Pillow's ``save`` does not expose): 1, 3 and 4 components, several samplings and
qualities, restart intervals in MCUs and in MCU rows, DAC conditioning other than the
defaults (and none at all), table selectors past 3, progressive files cut short (then
smoothed), an MJPEG AVI of arithmetic-coded frames. Pillow hands libjpeg a file 64 KiB at a
time and the arithmetic decoder cannot wait for more inside a scan: where a scan needs
bytes past the block it began in, Pillow raises, and the port raises too. A coefficient
overflow in corrupt data makes libjpeg warn and leave the rest of the scan undecoded, which
Pillow reads on from; the port raises. No tolerance: every comparison is exact.
"""

import ctypes
import glob
import io
import os
import struct

import numpy as np
import PIL
import pytest
from PIL import Image

from foley_tpu.io import avi as javi
import torch_jpeg_writer as writer
from foley_tpu_torch.io import avi as tavi
from foley_tpu_torch.io import jpeg as tjpeg
from torch_helpers import one_torch_thread, read_frame_as_jax_does  # noqa: F401 (autouse)


def frame(h, w, seed, channels=3):
    """A seeded frame: smooth waves under noise, each channel apart."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    waves = np.stack([128 + 100 * np.sin(x / 5.0 + c) * np.cos(y / 7.0 - c)
                      for c in range(channels)], -1)
    return np.clip(waves + rng.normal(0, 15, waves.shape), 0, 255).astype(np.uint8)


LAYOUTS = {
    "grey": ("grey", 1, [(1, 1)]),
    "420": ("ycc", 3, [(2, 2), (1, 1), (1, 1)]),
    "444": ("ycc", 3, [(1, 1), (1, 1), (1, 1)]),
    "411": ("ycc", 3, [(4, 1), (1, 1), (1, 1)]),
    "cmyk": ("cmyk", 4, [(1, 1), (1, 1), (1, 1), (1, 1)]),
    "ycck": ("ycck", 4, [(2, 2), (1, 1), (1, 1), (2, 2)]),
}


def _pixels(channels, h=37, w=45, seed=1):
    px = frame(h, w, seed, channels)
    return px[..., 0] if channels == 1 else px


def _write(layout, **kw):
    space, channels, sampling = LAYOUTS[layout]
    return writer.compress(_pixels(channels), sampling, space, **kw)


@pytest.mark.parametrize("quality", [10, 75, 100])
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_arithmetic_matches_pil(tmp_path, layout, progressive, quality):
    data = _write(layout, quality=quality, arith=True, progressive=progressive)
    assert (b"\xff\xca" if progressive else b"\xff\xc9") in data and b"\xff\xcc" in data
    read_frame_as_jax_does(tmp_path, data)


@pytest.mark.parametrize("restart", [(1, 0), (3, 0), (0, 1)], ids=["mcu1", "mcu3", "row1"])
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("layout", ["grey", "420", "ycck"])
def test_restarts_reset_the_statistics(tmp_path, layout, progressive, restart):
    """At each RSTn the statistics bins, the DC predictions and contexts, and the decoder's
    registers start again."""
    data = _write(layout, quality=85, arith=True, progressive=progressive,
                  restart=restart[0], restart_rows=restart[1])
    assert b"\xff\xdd" in data and b"\xff\xd1" in data
    read_frame_as_jax_does(tmp_path, data)


DACS = {
    "dc_narrow_ac_low": {("dc", 0): (0, 0), ("dc", 1): (1, 2), ("ac", 0): 1, ("ac", 1): 2},
    "dc_wide_ac_high": {("dc", 0): (3, 9), ("dc", 1): (15, 15), ("ac", 0): 40, ("ac", 1): 63},
    "ac_zero": {("ac", 0): 0, ("ac", 1): 0},
}


@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("dac", list(DACS))
def test_dac_conditioning(tmp_path, dac, progressive):
    """The DC bounds L and U pick the difference's context, Kx the AC magnitude bins."""
    data = _write("420", quality=90, arith=True, progressive=progressive, dac=DACS[dac])
    read_frame_as_jax_does(tmp_path, data)


def _without(data: bytes, marker: int) -> bytes:
    """The file without its ``marker`` segments."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xD9:
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] == 0xDA:  # the scan's data, to the next marker but RSTn
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, 0xFF)
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        if data[pos + 1] != marker:
            out += data[pos:end]
        pos = end
    return bytes(out + data[pos:])


@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
def test_no_dac_segment_means_the_defaults(tmp_path, progressive):
    data = _write("420", quality=80, arith=True, progressive=progressive)
    bare = _without(data, 0xCC)
    assert b"\xff\xcc" not in bare
    np.testing.assert_array_equal(read_frame_as_jax_does(tmp_path, bare),
                                  read_frame_as_jax_does(tmp_path, data))


def test_dac_segments_libjpeg_refuses_raise():
    """L above U, or a table index past 31 (JERR_DAC_VALUE, JERR_DAC_INDEX): Pillow raises,
    and so does the port."""
    data = _write("grey", quality=80, arith=True)
    at = data.index(b"\xff\xcc") + 4
    for index, value in ((0, 0x12), (40, 5)):
        bad = data[:at] + bytes([index, value]) + data[at + 2:]
        with pytest.raises(OSError):
            Image.open(io.BytesIO(bad)).convert("RGB")
        with pytest.raises(ValueError, match="DAC"):
            tjpeg.decode_jpegs([bad], "cpu")


@pytest.mark.parametrize("layout", ["420", "411", "cmyk"])
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
def test_coefficients_equal_the_huffman_files(layout, progressive):
    """A Huffman file transcoded to arithmetic coding holds the same coefficients: the two
    entropy decoders agree block for block, every scan kind included."""
    huff = _write(layout, quality=85, progressive=progressive)
    arith = writer.transcode(huff, progressive=progressive, arith=True, restart=2)
    a, b = tjpeg.parse_jpeg(huff), tjpeg.parse_jpeg(arith)
    for x, y in zip(a["coefs"], b["coefs"]):
        np.testing.assert_array_equal(x, y)


def test_table_selectors_past_3():
    """An arithmetic scan may name tables 0-15: Cb and Cr moved together from table 1 to 5
    (the default conditioning, fresh bins) decode as before."""
    data = _write("420", quality=85, arith=True)
    sos = data.index(b"\xff\xda")
    moved = bytearray(data)
    for i in (1, 2):
        moved[sos + 6 + 2 * i] = 0x55
    moved = bytes(moved)
    np.testing.assert_array_equal(tjpeg.decode_jpegs([moved], "cpu"),
                                  tjpeg.decode_jpegs([data], "cpu"))
    np.testing.assert_array_equal(tjpeg.decode_jpegs([moved], "cpu")[0],
                                  np.asarray(Image.open(io.BytesIO(moved)).convert("RGB")))


@pytest.mark.parametrize("layout", ["420", "grey"])
def test_progressive_arithmetic_cut_short_is_smoothed(tmp_path, layout):
    data = _write(layout, quality=85, arith=True, progressive=True, restart=4)
    for cut in range(1, writer.n_scans(data)):
        read_frame_as_jax_does(tmp_path, writer.cut_after(data, cut))


def test_qe_table_is_libjpegs():
    """Table D.2 as the decoder holds it, against the ``jpeg_aritab`` of the libjpeg-turbo
    Pillow bundles (Qe, then the next index after an LPS with the MPS swap bit, after an
    MPS)."""
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libjpeg-*.so*"))[0])
    aritab = np.array((ctypes.c_long * 114).in_dll(lib, "jpeg_aritab")[:], np.int64)
    ours = np.zeros((114, 4), np.int32)
    tjpeg.entropy_library().fj_arith_qe_table(ours.ctypes.data)
    np.testing.assert_array_equal(ours[:, 0], aritab >> 16)
    np.testing.assert_array_equal(ours[:, 1], aritab & 0x7F)
    np.testing.assert_array_equal(ours[:, 2], (aritab >> 8) & 0xFF)
    np.testing.assert_array_equal(ours[:, 3], (aritab >> 7) & 1)


def _noisy(h, w, seed):
    rng = np.random.default_rng(seed)
    return np.clip(frame(h, w, seed).astype(int) + rng.normal(0, 40, (h, w, 3)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
def test_scans_past_pils_64_kib_blocks_raise_where_pil_does(progressive):
    """The same file behind comment segments of growing length, so that Pillow's first
    64 KiB block ends before, inside and after each scan: the port raises exactly where
    Pillow does, and otherwise decodes as Pillow does."""
    data = writer.compress(_noisy(200, 230, 13), [(2, 2), (1, 1), (1, 1)], quality=85,
                           progressive=progressive, arith=True, restart=3)
    base = len(data)
    outcomes = set()
    for length in range(65536 - base - 4, 65536 - base + 40, 3):
        shifted = data[:2] + b"\xff\xfe" + struct.pack(">H", length) + bytes(length - 2) \
            + data[2:]
        try:
            ref = np.asarray(Image.open(io.BytesIO(shifted)).convert("RGB"))
        except OSError:
            with pytest.raises(ValueError, match="64 KiB|65536 bytes"):
                tjpeg.decode_jpegs([shifted], "cpu")
            outcomes.add("raises")
            continue
        np.testing.assert_array_equal(tjpeg.decode_jpegs([shifted], "cpu")[0], ref)
        outcomes.add("reads")
    assert outcomes == {"raises", "reads"}


def test_a_large_arithmetic_file_raises_where_pil_does(tmp_path):
    data = writer.compress(_noisy(300, 400, 14), [(2, 2), (1, 1), (1, 1)], quality=95,
                           arith=True)
    assert len(data) > tjpeg.PIL_READ_BLOCK
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(ValueError, match="arithmetic-coded scan"):
        tjpeg.decode_jpegs([data], "cpu")


def test_coefficient_overflow_raises_where_libjpeg_warns():
    """Seeded bytes in place of a scan's data that drive a value's magnitude past 15 bits:
    libjpeg warns (JWRN_ARITH_BAD_CODE) and leaves the scan's rest undecoded, and Pillow
    reads the picture; the port raises."""
    data = writer.compress(frame(37, 45, 12), [(2, 2), (1, 1), (1, 1)], quality=90,
                           arith=True)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    body = np.random.default_rng(248).integers(0, 255, len(data) - start - 2,
                                               dtype=np.uint8).tobytes()
    bad = data[:start] + body + b"\xff\xd9"
    Image.open(io.BytesIO(bad)).convert("RGB")
    with pytest.raises(ValueError, match="corrupt"):
        tjpeg.decode_jpegs([bad], "cpu")


def test_arithmetic_avi_matches_jax_read_avi(tmp_path, monkeypatch):
    """An MJPEG AVI whose frames are arithmetic-coded (the JAX writer with Pillow's JPEGs
    transcoded), read back by the JAX reader (PIL) and by the port's."""
    save = Image.Image.save

    def arithmetic_save(self, fp, format=None, **kw):
        buf = io.BytesIO()
        save(self, buf, format, **kw)
        fp.write(writer.transcode(buf.getvalue(), arith=True, progressive=True))

    rng = np.random.default_rng(17)
    frames = np.stack([frame(18, 26, seed=s) for s in range(4)])
    audio = rng.normal(0, 0.1, 8000).astype(np.float32)
    monkeypatch.setattr(Image.Image, "save", arithmetic_save)
    data = javi.build_avi_bytes(frames, 8.0, audio, 16000)
    monkeypatch.setattr(Image.Image, "save", save)
    path = tmp_path / "a.avi"
    path.write_bytes(data)
    assert all(b"\xff\xca" in j for j in tavi.read_avi_info(str(path))["jpegs"])
    ref = javi.read_avi(str(path))
    got = tavi.read_avi(str(path), "cpu")
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]
