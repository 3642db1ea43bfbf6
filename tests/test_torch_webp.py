"""Lossless WebP frames without PIL on the port (``foley_tpu_torch/io/webp.py`` and its host
VP8L decoder, ``csrc/webp_lossless.cpp``) against the JAX package's
``pipeline/video.py::read_frames_dir`` (Pillow 12.1 over libwebp 1.6, ``convert("RGB")``),
on the CPU.

Pillow's lossless files at every method (0-6) and several qualities, with and without
alpha, of smooth, noisy and few-coloured frames (so every transform, colour indexing with
its pixel bundling at 2, 4 and 16 colours, the colour cache and backward references occur;
the test checks that each transform was met), sizes 1 x 1 to 64 x 80, in the simple and
the extended (``VP8X``, with an ICC profile and EXIF) container. Lossy and animated files,
once refused by name, are read too (``tests/test_torch_webp_lossy.py`` holds them in full).
No tolerance: every comparison is exact.
"""

import io

import numpy as np
import pytest
from PIL import Image

from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import webp as twebp
from foley_tpu_torch.pipeline import video as tvideo
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

SIZES = [(1, 1), (7, 13), (29, 37), (64, 80)]  # (height, width)
KINDS = ["smooth", "noisy", "colors2", "colors4", "colors16", "alpha"]
SEEN = set()  # the transforms the files of this module held


def frame(h, w, kind, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([128 + 100 * np.sin(x / 5 + c) * np.cos(y / 7 - c) for c in range(3)], -1)
    if kind in ("noisy", "alpha"):
        rgb = rgb + rng.normal(0, 25, rgb.shape)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if kind.startswith("colors"):
        return Image.fromarray(rgb).quantize(int(kind[6:])).convert("RGB")
    if kind == "alpha":
        return Image.fromarray(np.dstack([rgb, rng.integers(0, 256, (h, w), np.uint8)]), "RGBA")
    return Image.fromarray(rgb)


def webp(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _against_jax(tmp_path, data: bytes, name="f.webp"):
    d = tmp_path / "frames"
    d.mkdir(exist_ok=True)
    (d / name).write_bytes(data)
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    info = twebp.parse_webp(data)
    if info["kind"] == "lossless":
        twebp.decode_argb(info)
        SEEN.update(info["transforms"])


@pytest.mark.parametrize("method", range(7))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossless_matches_pil(tmp_path, size, kind, method):
    quality = (0, 50, 100)[(method + size[0]) % 3]
    data = webp(frame(*size, kind, seed=method + size[1]), lossless=True, method=method,
                quality=quality)
    assert b"VP8L" in data
    _against_jax(tmp_path, data)


@pytest.mark.parametrize("quality", [0, 25, 75, 100])
def test_exact_alpha_and_every_quality(tmp_path, quality):
    """``exact`` keeps the colour under transparent pixels, which ``convert("RGB")`` shows."""
    img = frame(29, 37, "alpha", seed=quality)
    _against_jax(tmp_path, webp(img, lossless=True, quality=quality, method=3, exact=True))


def test_extended_container_with_icc_and_exif(tmp_path):
    img = frame(20, 30, "smooth", seed=1)
    exif = Image.Exif()
    exif[0x010E] = "a frame"
    data = webp(img, lossless=True, icc_profile=b"\0" * 128, exif=exif.tobytes())
    assert b"VP8X" in data and b"ICCP" in data and b"EXIF" in data
    _against_jax(tmp_path, data)


def test_every_transform_was_met():
    """Runs after the cases above (file order): the files held all four transforms."""
    assert SEEN == set(twebp.TRANSFORMS), SEEN


def test_lossy_and_animated_webp_are_refused_by_name(tmp_path):
    """The files this test once saw refused by name (``WebPUnsupported``: a lossy ``VP8 ``
    bitstream, with and without ``ALPH``, and an animation) are read now, equal to the JAX
    package's reading, alone and in one directory."""
    img = frame(16, 16, "smooth", seed=2)
    rgba = frame(16, 16, "alpha", seed=3)
    lossy, with_alpha = webp(img, quality=80), webp(rgba, quality=80)  # VP8; VP8X, ALPH, VP8
    anim = webp(img, lossless=True, save_all=True,
                append_images=[frame(16, 16, "noisy", seed=4)], duration=40)
    for name, data in (("lossy", lossy), ("alpha", with_alpha), ("anim", anim)):
        (tmp_path / name).mkdir()
        _against_jax(tmp_path / name, data)
    assert twebp.parse_webp(lossy)["kind"] == "lossy"
    assert twebp.parse_webp(with_alpha)["alpha"]
    assert twebp.parse_webp(anim)["frames"] == 2
    d = tmp_path / "frames"
    d.mkdir()
    for i, data in enumerate((lossy, with_alpha, anim)):
        (d / f"{i}.webp").write_bytes(data)
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cut", [20, 60, 400])
def test_truncated_webp_raises_where_pil_does(cut):
    data = webp(frame(29, 37, "noisy", seed=5), lossless=True)
    bad = data[:cut]
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bad)).convert("RGB")
    with pytest.raises(ValueError):
        info = twebp.parse_webp(bad)
        twebp.decode_argb(info)


def test_frames_of_one_size_and_of_other_sizes(tmp_path):
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(5):
        (d / f"f{i}.webp").write_bytes(webp(frame(9, 11, KINDS[i], seed=i), lossless=True))
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    np.testing.assert_array_equal(got, ref)
    (d / "f9.webp").write_bytes(webp(frame(9, 12, "smooth", seed=9), lossless=True))
    with pytest.raises(ValueError, match="differ in size"):
        tvideo.read_frames_dir(str(d), device="cpu")
