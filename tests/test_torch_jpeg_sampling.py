"""Every sampling libjpeg decodes, on the port (``foley_tpu_torch/io/jpeg.py``: the frame check,
``upsample`` as ``jdsample.c::jinit_upsampler`` chooses per component, ``reconstruct``)
against Pillow 12.1 (libjpeg-turbo 3.1) and the JAX package's ``read_frames_dir``, on the CPU.

The files come from ``tests/torch_jpeg_writer.py`` (libjpeg's own encoder, which Pillow's
``save`` does not expose for these layouts): grey, YCbCr and CMYK / YCCK at 4:1:1, 4:1:0, 3 x
1, luma below its chroma, chroma sampled above 1, 4 x 4 luma over 2 x 2 chroma (in one scan a
component, since its interleaved MCU would hold 24 blocks), at sizes on the largest MCU grid
(96 x 96) and off it. The layouts libjpeg refuses (a factor outside 1-4, a fractional ratio,
more than 10 blocks in an interleaved MCU) raise where Pillow raises. JPEG-in-TIFF strips at
libtiff's ``YCbCrSubsampling`` of 4 x 1, 4 x 2 and 4 x 4 read as Pillow reads them. No
tolerance: every comparison is exact.
"""

import io

import numpy as np
import pytest
from PIL import Image

from foley_tpu.pipeline import video as jvideo
import torch_jpeg_writer as writer
from foley_tpu_torch.io import jpeg as tjpeg
from foley_tpu_torch.io import tiff as ttiff
from torch_helpers import one_torch_thread, read_frame_as_jax_does  # noqa: F401 (autouse)
from torch_tiff_writer import jpeg_tiff

SIZES = [(96, 96), (37, 45), (7, 70)]  # (height, width): on every MCU grid, off it


def frame(h, w, seed, channels=3):
    """A seeded frame: smooth waves under noise, each channel apart."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    waves = np.stack([128 + 100 * np.sin(x / 5.0 + c) * np.cos(y / 7.0 - c)
                      for c in range(channels)], -1)
    return np.clip(waves + rng.normal(0, 15, waves.shape), 0, 255).astype(np.uint8)


def one_scan_a_component(n):
    return [((c,), 0, 63, 0, 0) for c in range(n)]


# (h, v) of each component; those marked "apart" exceed 10 blocks an interleaved MCU, so
# each component has a scan of its own
LEGAL = {
    "411": [(4, 1), (1, 1), (1, 1)],
    "410": [(4, 2), (1, 1), (1, 1)],
    "3x1": [(3, 1), (1, 1), (1, 1)],
    "1x3": [(1, 3), (1, 1), (1, 1)],
    "3x3": [(3, 3), (1, 1), (1, 1)],
    "1x4": [(1, 4), (1, 1), (1, 1)],
    "2x3": [(2, 3), (1, 1), (1, 1)],
    "luma_below_chroma": [(1, 1), (2, 2), (2, 2)],
    "luma_below_chroma_2x1": [(1, 1), (2, 1), (2, 1)],
    "chroma_2x1_1x2": [(2, 2), (2, 1), (1, 2)],
    "luma_2x1_cb_1x2": [(2, 1), (1, 2), (1, 1)],
    "3x2_3x1": [(3, 2), (3, 1), (1, 1)],
    "2x4_1x2": [(2, 4), (1, 2), (1, 1)],
    "4x4_2x2_apart": [(4, 4), (2, 2), (2, 2)],
    "4x2_2x1_2x1_apart": [(4, 2), (2, 1), (2, 1)],
}
GREY = {"grey_2x2": [(2, 2)], "grey_3x1": [(3, 1)], "grey_4x4": [(4, 4)]}
FOUR = {  # CMYK / YCCK: the K need not follow the first component
    "cmyk_2x2_k1x1": ("cmyk", [(2, 2), (1, 1), (1, 1), (1, 1)]),
    "cmyk_411": ("cmyk", [(4, 1), (1, 1), (1, 1), (4, 1)]),
    "ycck_k2x2": ("ycck", [(1, 1), (1, 1), (1, 1), (2, 2)]),
    "ycck_luma_below": ("ycck", [(1, 1), (2, 2), (2, 2), (1, 1)]),
    "ycck_3x1_mixed": ("ycck", [(3, 1), (1, 1), (3, 1), (1, 1)]),
}


def _write(px, sampling, space="ycc", **kw):
    scans = one_scan_a_component(len(sampling)) if sum(h * v for h, v in sampling) > 10 \
        else None
    return writer.compress(px, sampling, space, quality=85, scans=scans, **kw)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", list(LEGAL))
def test_ycbcr_samplings_match_pil(tmp_path, layout, size):
    data = _write(frame(*size, seed=size[1]), LEGAL[layout])
    assert tjpeg.parse_jpeg(data)["sampling"] == tuple(LEGAL[layout])
    read_frame_as_jax_does(tmp_path, data)


@pytest.mark.parametrize("size", SIZES[1:], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", list(GREY))
def test_grey_sampling_factors_are_read_and_ignored(tmp_path, layout, size):
    """One component: libjpeg takes its declared factors (1-4) and upsamples nothing."""
    read_frame_as_jax_does(tmp_path, _write(frame(*size, seed=3)[..., 0], GREY[layout],
                                            space="grey"))


@pytest.mark.parametrize("size", SIZES[1:], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", list(FOUR))
def test_four_component_samplings_match_pil(tmp_path, layout, size):
    space, sampling = FOUR[layout]
    read_frame_as_jax_does(tmp_path, _write(frame(*size, seed=4, channels=4), sampling,
                                            space=space))


@pytest.mark.parametrize("layout", ["411", "luma_below_chroma", "4x4_2x2_apart"])
def test_progressive_and_restarts_at_new_samplings(tmp_path, layout):
    """The same layouts progressive (libjpeg's default script) and with restart markers."""
    px = frame(37, 45, seed=5)
    read_frame_as_jax_does(tmp_path, _write(px, LEGAL[layout], progressive=True))
    read_frame_as_jax_does(tmp_path, _write(px, LEGAL[layout], restart=2), name="r.jpg")


def test_upsampler_choice_by_ratio():
    """``upsample`` as ``jinit_upsampler``: 1 x 2 fancy at any width, 2 x 1 and 2 x 2 a box
    at widths of 2 or less, every other ratio plain replication."""
    import torch

    x = torch.tensor([[[10, 50, 90], [30, 70, 250]]], dtype=torch.int32)
    np.testing.assert_array_equal(tjpeg.upsample(x, 3, 2)[0].numpy(),
                                  np.repeat(np.repeat(x[0].numpy(), 3, 1), 2, 0))
    narrow = x[..., :2]
    np.testing.assert_array_equal(tjpeg.upsample(narrow, 2, 1)[0].numpy(),
                                  np.repeat(narrow[0].numpy(), 2, 1))
    assert not torch.equal(tjpeg.upsample(x, 2, 1), x.repeat_interleave(2, -1))  # fancy


def _patched_sof(data: bytes, factors) -> bytes:
    sof = data.index(b"\xff\xc0")
    out = bytearray(data)
    for i, (h, v) in enumerate(factors):
        out[sof + 11 + 3 * i] = h * 16 + v
    return bytes(out)


ILLEGAL = {
    "factor_5": ([(5, 1), (1, 1), (1, 1)], "bogus sampling"),
    "factor_0": ([(2, 2), (0, 1), (1, 1)], "bogus sampling"),
    "ratio_3_over_2": ([(3, 2), (2, 1), (1, 1)], "fractional"),
    "ratio_2_and_3": ([(2, 1), (3, 1), (1, 1)], "fractional"),
    "mcu_of_11_blocks": ([(4, 2), (2, 1), (1, 1)], "too large for an interleaved scan"),
}


@pytest.mark.parametrize("case", list(ILLEGAL))
def test_samplings_libjpeg_refuses_raise_where_pil_does(tmp_path, case):
    """A 4:2:0 file's frame header given factors libjpeg refuses (JERR_BAD_SAMPLING,
    JERR_FRACT_SAMPLE_NOT_IMPL, JERR_BAD_MCU_SIZE): Pillow raises, and so does the port,
    naming the reason."""
    factors, reason = ILLEGAL[case]
    bad = _patched_sof(_write(frame(37, 45, seed=6), [(2, 2), (1, 1), (1, 1)]), factors)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bad)).convert("RGB")
    with pytest.raises(ValueError, match=reason):
        tjpeg.decode_jpegs([bad], "cpu")
    d = tmp_path / "frames"
    d.mkdir()
    (d / "0.jpg").write_bytes(bad)
    with pytest.raises(OSError):
        jvideo.read_frames_dir(str(d))


@pytest.mark.parametrize("height", [64, 70])
@pytest.mark.parametrize("sub", [(4, 1), (4, 2), (4, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_in_tiff_at_libtiffs_largest_subsampling(tmp_path, sub, height):
    """libtiff's ``YCbCrSubsampling`` may be 4 each way and its JPEG codec leaves the
    upsampling to libjpeg: Pillow reads such strips (4 x 4 in one scan a component), and
    so does the port."""
    rgb = frame(height, 64, seed=7)
    data = jpeg_tiff(rgb, subsampling=sub, rows=32,
                     encode=lambda part: _write(part, [sub, (1, 1), (1, 1)]))
    got = read_frame_as_jax_does(tmp_path, data, name="f.tif")
    np.testing.assert_array_equal(ttiff.read_tiffs(["f.tif"], "cpu", datas=[data])[0], got)
