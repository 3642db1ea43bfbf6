"""libjpeg-turbo's block smoothing of progressive files whose scans leave coefficients
unfinished, on the port (``foley_tpu_torch/io/jpeg.py::smooth_blocks`` and the ``coef_bits``
latch of ``parse_jpeg``) against Pillow 12.1 (libjpeg-turbo 3.1, ``jdcoefct.c``'s
``decompress_smooth_data``) and the JAX package's ``read_frames_dir``, on the CPU.

A progressive file cut after any of its scans (and closed with EOI) is what a truncated
download leaves; Pillow decodes it, estimating the first nine AC coefficients (and, before
any AC data, the DC) from the 5 x 5 DC values around each block. The cases: a cut after
every scan of libjpeg's default progressive scripts (Pillow's ``progressive=True``, and
``jpeg_simple_progression`` through ``tests/torch_jpeg_writer.py``) at 4:2:0, 4:4:4, grey
and CMYK, at sizes off the MCU grid; vertical sampling 1-4, whose iMCU rows decide which
block rows libjpeg reads past the image's edge; a DC-only file; a DC never refined to Al 0;
AC bands sent at Al > 0 (the estimates clamped below ``1 << Al``) and refined; a table with
a zero at a smoothed position (no smoothing). No tolerance: every comparison is exact.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import torch_jpeg_writer as writer
from foley_tpu_torch.io import jpeg as tjpeg
from torch_helpers import one_torch_thread, read_frame_as_jax_does  # noqa: F401 (autouse)


def frame(h, w, seed, channels=3):
    """A seeded frame: smooth waves under noise, each channel apart."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    waves = np.stack([128 + 100 * np.sin(x / 5.0 + c) * np.cos(y / 7.0 - c)
                      for c in range(channels)], -1)
    return np.clip(waves + rng.normal(0, 15, waves.shape), 0, 255).astype(np.uint8)


def pil_progressive(img, mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="JPEG", progressive=True, **kw)
    return buf.getvalue()


SCRIPTS = {  # libjpeg's default scripts: 10 scans for YCbCr, 6 for grey, 14 for CMYK
    "pillow_420": lambda px: pil_progressive(px, quality=85, subsampling=2),
    "pillow_444": lambda px: pil_progressive(px, quality=75, subsampling=0),
    "pillow_grey": lambda px: pil_progressive(px, "L", quality=90),
    "libjpeg_cmyk": lambda px: writer.compress(np.dstack([px, px[..., :1]]),
                                               [(2, 2), (1, 1), (1, 1), (2, 2)], "cmyk",
                                               quality=80, progressive=True),
}
SIZES = [(37, 45), (29, 70)]


def _cuts(name):
    n = writer.n_scans(SCRIPTS[name](frame(16, 16, seed=0)))
    return [(name, k) for k in range(1, n)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("script,cut", [c for name in SCRIPTS for c in _cuts(name)],
                         ids=lambda c: str(c))
def test_cut_after_every_scan_of_the_default_scripts(tmp_path, script, cut, size):
    data = writer.cut_after(SCRIPTS[script](frame(*size, seed=cut + size[0])), cut)
    parsed = tjpeg.parse_jpeg(data)
    assert (parsed["smooth"] != 0).any()  # every cut leaves a first coefficient unfinished
    read_frame_as_jax_does(tmp_path, data)


@pytest.mark.parametrize("v", [1, 2, 3, 4])
@pytest.mark.parametrize("height", [20, 37, 40, 53, 90])
def test_vertical_sampling_decides_the_rows_read(tmp_path, height, v):
    """A single component declared 1 x v: its iMCU rows of v block rows decide which rows
    past the image's bottom (the last iMCU row's dummy rows) and which above libjpeg-turbo
    reads; the DC-only cut makes every one of the 25 DC values count."""
    data = writer.compress(frame(height, 24, seed=height)[..., 0], [(1, v)], "grey",
                           quality=80, progressive=True)
    for cut in (1, 3):
        read_frame_as_jax_does(tmp_path, writer.cut_after(data, cut))


@pytest.mark.parametrize("sampling", [[(2, 3), (1, 1), (1, 1)], [(1, 1), (1, 4), (1, 2)],
                                      [(3, 2), (1, 2), (1, 1)]], ids=str)
def test_mixed_samplings_cut_short(tmp_path, sampling):
    data = writer.compress(frame(45, 53, seed=8), sampling, quality=85, progressive=True)
    for cut in (1, 2, 5):
        read_frame_as_jax_does(tmp_path, writer.cut_after(data, cut))


DC = ((0, 1, 2), 0, 0, 0, 0)
SCRIPTED = {
    "dc_only": [DC],
    "dc_never_refined_ac_complete": [((0, 1, 2), 0, 0, 0, 2), ((0,), 1, 63, 0, 0),
                                     ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
    "dc_never_refined_ac_short": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 0),
                                  ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
    "ac_at_al2_clamped": [DC, ((0,), 1, 9, 0, 2), ((1,), 1, 63, 0, 1), ((2,), 1, 63, 0, 0)],
    "ac_refined_to_al1": [DC, ((0,), 1, 9, 0, 2), ((1,), 1, 63, 0, 1), ((2,), 1, 63, 0, 0),
                          ((0,), 1, 9, 2, 1)],
    "late_bands_only": [DC, ((0,), 6, 63, 0, 0), ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
}


@pytest.mark.parametrize("script", list(SCRIPTED))
def test_custom_scripts(tmp_path, script):
    data = writer.compress(frame(37, 45, seed=9), [(2, 2), (1, 1), (1, 1)], quality=75,
                           scans=SCRIPTED[script])
    parsed = tjpeg.parse_jpeg(data)
    # smoothed unless every first coefficient is complete (a DC short of Al 0 is no reason)
    assert (parsed["smooth"] != 0).any() == (script != "dc_never_refined_ac_complete")
    read_frame_as_jax_does(tmp_path, data)


def test_zero_in_a_table_turns_smoothing_off(tmp_path):
    """``smoothing_ok`` wants every table nonzero at the DC and the first nine AC
    positions: a zero at Q11 (written by transcoding) turns the smoothing off."""
    data = writer.cut_after(pil_progressive(frame(37, 45, seed=10), quality=85), 2)
    luma = tjpeg.parse_jpeg(data)["quant"][0].copy()
    luma[9] = 0
    zeroed = writer.transcode(data, progressive=True, quant={0: luma})
    zeroed = writer.cut_after(zeroed, 2)
    assert not tjpeg.parse_jpeg(zeroed)["smooth"].any()
    read_frame_as_jax_does(tmp_path, zeroed)
    both = tjpeg.decode_jpegs([zeroed, data], "cpu")  # beside a smoothed frame, one pass
    for got, one in zip(both, (zeroed, data)):
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(one)).convert("RGB")))


def test_smoothing_leaves_frames_it_does_not_smooth_alone():
    """Frames of one geometry go through ``reconstruct`` together: a complete file beside a
    cut one keeps its own blocks (its latch is zero), and decodes as it does alone."""
    px = frame(37, 45, seed=11)
    whole = pil_progressive(px, quality=85, subsampling=2)
    cut = writer.cut_after(whole, 3)
    both = tjpeg.decode_jpegs([whole, cut, whole], "cpu")
    np.testing.assert_array_equal(both[0], tjpeg.decode_jpegs([whole], "cpu")[0])
    np.testing.assert_array_equal(both[1],
                                  np.asarray(Image.open(io.BytesIO(cut)).convert("RGB")))
    np.testing.assert_array_equal(both[2], both[0])
    blocks = torch.zeros((1, 2, 2, 64), dtype=torch.int16)
    assert tjpeg.smooth_blocks(blocks, torch.ones((1, 64)), torch.zeros((1, 10)), 2, 2, 1,
                               2) is blocks
