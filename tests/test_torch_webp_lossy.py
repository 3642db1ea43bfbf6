"""Lossy and animated WebP frames without PIL on the port (``foley_tpu_torch/io/webp.py``, its
host VP8 decoder ``csrc/webp_vp8.cpp`` and the upsampling and colour conversion in torch)
against the JAX package's ``pipeline/video.py::read_frames_dir`` (Pillow 12.1 over libwebp
1.6, ``convert("RGB")``), on the CPU. No tolerance: every comparison is exact.

The files: Pillow's lossy files at qualities 0, 5, 50, 80 and 100 and methods 0, 4 and 6, of
smooth, noisy, flat (skipped macroblocks) and sharp-edged (4x4 modes) frames, sizes 1 x 1 to
64 x 80 (sizes that are not multiples of 16, odd chroma); with alpha, ``exact`` on and off;
files from libwebp's encoder through ``ctypes`` (``torch_webp_encoder.py``) with the simple
and the normal loop filter, no filter and the strongest, sharpness 0 and 7, 1 and 4
segments, 1, 2, 4 and 8 token partitions, sharp YUV; animations from Pillow's ``save_all``
and assembled by hand with a first frame smaller than the canvas. A last test asserts from
the decoder's feature mask that the files held every filter type, segments and a segment
map, each partition count, a skipped macroblock, each 16x16 and 4x4 mode and a coefficient
probability update. Truncated and corrupt files raise where Pillow raises, and read as
Pillow reads them where it does not; a frame past Pillow's pixel limit raises; the decoder's
constant tables are held against a digest and found, each, in Pillow's libwebp binary.

A VP8L-compressed ``ALPH`` plane is decoded where libwebp decodes it (a still with the
alpha flag, an animation's first frame): a corrupt or cut one beside a sound VP8 frame
raises, as Pillow raises; bytes after a sound one, and any filter or pre-processing bits
libwebp takes, read as Pillow reads them.

Not held against Pillow: the VP8 loop-filter deltas (no encoder here writes them; they are
decoded as libwebp decodes them).
"""

import glob
import hashlib
import io
import os
import random
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import torch_webp_encoder as enc
from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import webp as twebp
from foley_tpu_torch.pipeline import video as tvideo
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

SIZES = [(1, 1), (15, 17), (16, 16), (33, 47), (64, 80)]  # (height, width)
KINDS = ["smooth", "noisy", "flat", "sharp"]
SEEN = set()  # the VP8 features the files of this module held


def frame(h, w, kind, seed, alpha=False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([128 + 100 * np.sin(x / 5 + c) * np.cos(y / 7 - c) for c in range(3)], -1)
    if kind == "noisy":
        rgb = rgb + rng.normal(0, 40, rgb.shape)
    elif kind == "flat":  # two bands of one colour: macroblocks predicted exactly, skipped
        rgb = np.where((y < 32)[..., None], (90.0, 140.0, 60.0), (170.0, 40.0, 200.0)) + 0 * rgb
    elif kind == "sharp":  # thin edges and diagonals: the 4x4 modes
        rgb = np.where(((x // 3 + y // 5) % 2)[..., None] == 1, 230.0, 20.0) + 0 * rgb
        rgb[(x + 2 * y) % 9 == 0] = (250, 30, 90)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if alpha:  # transparent bands and a disc; graded elsewhere
        a = np.clip(x * 255 // max(w, 1), 1, 255).astype(np.uint8)
        a[(y // 3) % 3 == 1] = 0
        a[(x - w // 2) ** 2 + (y - h // 2) ** 2 < (min(h, w) // 3) ** 2] = 0
        return np.dstack([rgb, a])
    return rgb


def pil_webp(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA" if arr.shape[-1] == 4 else "RGB").save(buf, format="WEBP",
                                                                         **kw)
    return buf.getvalue()


def _note(data: bytes) -> None:
    info = twebp.parse_webp(data)
    if info["kind"] == "lossy":
        twebp.decode_yuv(info)
        SEEN.update(info["features"])


def _against_jax(tmp_path, data: bytes, name="f.webp") -> np.ndarray:
    d = tmp_path / "frames"
    d.mkdir(exist_ok=True)
    (d / name).write_bytes(data)
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    _note(data)
    return np.round(ref[0] * 255).astype(np.uint8)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [0, 5, 50, 80, 100])
def test_pillow_lossy_matches_jax(tmp_path, quality, method, kind):
    h, w = SIZES[(quality // 5 + method + KINDS.index(kind)) % len(SIZES)]
    data = pil_webp(frame(h, w, kind, seed=quality + method), quality=quality, method=method)
    assert data[12:16] == b"VP8 "
    _against_jax(tmp_path, data)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_size_at_pillows_default(tmp_path, size, kind):
    _against_jax(tmp_path, pil_webp(frame(*size, kind, seed=size[1])))  # quality 80


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("quality", [0, 50, 100])
@pytest.mark.parametrize("size", [(15, 17), (33, 47)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_alpha_matches_jax(tmp_path, size, quality, exact):
    data = pil_webp(frame(*size, "noisy", seed=quality, alpha=True), quality=quality,
                    exact=exact)
    assert b"VP8X" in data and b"ALPH" in data and b"VP8 " in data
    _against_jax(tmp_path, data)


def _strip_alpha(data: bytes) -> bytes:
    """The same VP8 bitstream as a simple-layout file, without ``VP8X`` and ``ALPH``."""
    at = data.index(b"VP8 ")
    size = struct.unpack("<I", data[at + 4:at + 8])[0]
    chunk = data[at:at + 8 + size + (size & 1)]
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def test_rgb_is_independent_of_alpha(tmp_path):
    """Under alpha 0 the RGB is kept (``exact``) and read; with its ``ALPH`` chunk taken
    away, the same bitstream reads the same RGB in Pillow and in the port."""
    rgba = frame(33, 47, "smooth", seed=7, alpha=True)
    data = pil_webp(rgba, quality=90, exact=True)
    with_alpha = _against_jax(tmp_path, data, "a.webp")
    assert (rgba[..., 3] == 0).any() and with_alpha[rgba[..., 3] == 0].any()
    plain = _strip_alpha(data)
    assert b"ALPH" not in plain
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(plain)).convert("RGB")),
                                  with_alpha)
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "b.webp").write_bytes(plain)
    np.testing.assert_array_equal(
        np.round(tvideo.read_frames_dir(str(tmp_path / "b"), device="cpu")[0][0] * 255),
        with_alpha)


ENCODER_SETTINGS = {
    "simple_filter": dict(filter_type=0),
    "normal_filter": dict(filter_type=1),
    "no_filter": dict(filter_strength=0),
    "strongest_filter": dict(filter_strength=100),
    "sharpness_0": dict(filter_sharpness=0, filter_strength=80),
    "sharpness_7": dict(filter_sharpness=7, filter_strength=80),
    "simple_sharpness_7": dict(filter_type=0, filter_sharpness=7, filter_strength=80),
    "segments_1": dict(segments=1),
    "segments_4": dict(segments=4, sns_strength=100),
    "partitions_1": dict(partitions=0, method=0),
    "partitions_2": dict(partitions=1, method=0),
    "partitions_4": dict(partitions=2, method=1),
    "partitions_8": dict(partitions=3, method=2),
    "sharp_yuv": dict(use_sharp_yuv=1),
}


@pytest.mark.parametrize("size", [(33, 47), (64, 80)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("setting", sorted(ENCODER_SETTINGS))
def test_encoder_settings_match_jax(tmp_path, setting, size):
    kw = ENCODER_SETTINGS[setting]
    data = enc.encode(frame(*size, "noisy", seed=len(setting)), 60, **kw)
    info = twebp.parse_webp(data)
    twebp.decode_yuv(info)
    feats = set(info["features"])
    want = {"simple_filter": "filter_simple", "normal_filter": "filter_normal",
            "no_filter": "filter_none", "sharpness_7": "sharpness",
            "partitions_2": "partitions_2", "partitions_4": "partitions_4",
            "partitions_8": "partitions_8"}.get(setting)
    assert want is None or want in feats, (setting, feats)
    _against_jax(tmp_path, data)


def test_pillow_animations_read_their_first_frame(tmp_path):
    frames = [frame(33, 47, k, seed=i) for i, k in enumerate(KINDS[:3])]
    rgba = [frame(33, 47, "smooth", seed=9, alpha=True), frame(33, 47, "noisy", seed=3,
                                                               alpha=True)]
    for imgs, kw in ((frames, {}), (frames, {"lossless": True}), (rgba, {"quality": 60})):
        buf = io.BytesIO()
        pil = [Image.fromarray(f, "RGBA" if f.shape[-1] == 4 else "RGB") for f in imgs]
        pil[0].save(buf, format="WEBP", save_all=True, append_images=pil[1:], duration=40,
                    **kw)
        data = buf.getvalue()
        info = twebp.parse_webp(data)
        assert info["frames"] == len(imgs) and info["canvas"] == (47, 33)
        _against_jax(tmp_path, data, f"anim_{len(kw)}_{imgs[0].shape[-1]}.webp")
        assert Image.open(io.BytesIO(data)).n_frames == len(imgs)


@pytest.mark.parametrize("first", ["lossy", "lossy_alpha", "lossless"])
def test_first_frame_smaller_than_the_canvas(tmp_path, first):
    """Outside the first frame's rectangle the canvas reads 0, in Pillow and in the port."""
    small = frame(20, 30, "noisy", seed=4, alpha=first == "lossy_alpha")
    still = (pil_webp(small, lossless=True) if first == "lossless"
             else enc.encode(small, 70, exact=1))
    data = enc.animation((64, 48), [(10, 14, 30, 20, still),
                                    (0, 0, 64, 48, pil_webp(frame(48, 64, "smooth", 5)))],
                         alpha=first == "lossy_alpha")
    assert twebp.parse_webp(data)["offset"] == (10, 14)
    rgb = _against_jax(tmp_path, data)
    assert not rgb[:14].any() and not rgb[34:].any()
    assert not rgb[:, :10].any() and not rgb[:, 40:].any()
    assert rgb[14:34, 10:40].any()


def test_lossy_lossless_and_animated_in_one_directory(tmp_path):
    d = tmp_path / "mixed"
    d.mkdir()
    shapes = []
    for i in range(6):
        arr = frame(24, 40, KINDS[i % 4], seed=i)
        if i % 3 == 0:
            data = pil_webp(arr, quality=20 * i)
        elif i % 3 == 1:
            data = pil_webp(arr, lossless=True)
        else:
            data = enc.animation((40, 24), [(4, 2, 30, 20, enc.encode(arr[:20, :30], 50))])
        (d / f"frame_{i}.webp").write_bytes(data)
        shapes.append(data[12:16])
    assert {b"VP8 ", b"VP8L", b"VP8X"} <= set(shapes)
    ref, _ = jvideo.read_frames_dir(str(d), fps=8.0, target_fps=4.0)
    got, _ = tvideo.read_frames_dir(str(d), fps=8.0, target_fps=4.0, device="cpu")
    np.testing.assert_array_equal(got, ref)
    (d / "frame_9.webp").write_bytes(pil_webp(frame(24, 41, "smooth", 1)))
    with pytest.raises(ValueError, match="differ in size"):
        tvideo.read_frames_dir(str(d), device="cpu")


def test_the_card_is_never_replaced_by_the_cpu(tmp_path):
    (tmp_path / "f.webp").write_bytes(pil_webp(frame(16, 16, "smooth", 1)))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda route runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twebp.read_webps([str(tmp_path / "f.webp")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twebp.read_webps([str(tmp_path / "f.webp")], "cuda")


def _pil_raises(data: bytes) -> bool:
    try:
        Image.open(io.BytesIO(data)).convert("RGB")
    except Exception:  # noqa: BLE001 (Pillow's errors vary: OSError, SyntaxError, ...)
        return True
    return False


def _port(data: bytes) -> np.ndarray:
    info = twebp.parse_webp(data)
    if info["kind"] == "lossless":
        rgb = twebp.decode_argb(info)[..., 2::-1]
    else:
        y, u, v = (torch.from_numpy(p)[None] for p in twebp.decode_yuv(info))
        rgb = twebp.yuv_to_rgb(y, u, v, info["width"], info["height"])[0].numpy()
    canvas = np.zeros((info["canvas"][1], info["canvas"][0], 3), np.uint8)
    x, y0 = info["offset"]
    canvas[y0:y0 + info["height"], x:x + info["width"]] = rgb
    return canvas


def _same_verdict(data: bytes) -> None:
    """Where Pillow raises, the port raises ``ValueError``; elsewhere both read the same."""
    if _pil_raises(data):
        with pytest.raises(ValueError):
            _port(data)
    else:
        np.testing.assert_array_equal(_port(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("cut", [13, 30, 40, 300, -200, -1])
def test_truncated_files_raise_where_pillow_does(cut):
    still = pil_webp(frame(33, 47, "noisy", seed=1, alpha=True), quality=70)
    anim = enc.animation((47, 33), [(0, 0, 47, 33, still)], alpha=True)
    for data in (still, anim):
        bad = data[:cut]
        assert _pil_raises(bad)
        with pytest.raises(ValueError):
            _port(bad)


def _vp8_at(data: bytes) -> int:
    return data.index(b"VP8 ") + 8


@pytest.mark.parametrize("where", ["tag_inter", "tag_profile", "tag_hidden", "start_code",
                                   "zero_width", "partition0_length", "partition_sizes",
                                   "tokens", "partition0_body", "alph_header",
                                   "chunk_size", "vp8x_canvas", "tokens_cut_short",
                                   "tokens_cut_long", "odd_chunk_padded", "odd_chunk_unpadded",
                                   "odd_chunk_padded_ff"])
def test_corrupt_files_raise_where_pillow_does(where):
    data = bytearray(pil_webp(frame(33, 47, "noisy", seed=2, alpha=True), quality=70))
    at = _vp8_at(bytes(data))
    first = (data[at] | data[at + 1] << 8 | data[at + 2] << 16) >> 5
    if where == "tag_inter":
        data[at] |= 1
    elif where == "tag_profile":
        data[at] |= 7 << 1
    elif where == "tag_hidden":
        data[at] &= ~0x10 & 0xFF
    elif where == "start_code":
        data[at + 4] ^= 0xFF
    elif where == "zero_width":
        data[at + 6:at + 8] = b"\0\0"
    elif where == "partition0_length":
        data[at + 2] = 0x7F
    elif where == "partition_sizes":  # the first partition's bits, then a token byte
        data[at + 10 + first - 1] ^= 0xFF
    elif where == "tokens":
        for k in range(at + 10 + first + 5, len(data) - 4, 97):
            data[k] ^= 0x5A
    elif where == "partition0_body":
        for k in range(at + 20, at + 10 + first, 7):
            data[k] ^= 0xA5
    elif where == "alph_header":
        data[data.index(b"ALPH") + 8] |= 0xC0
    elif where == "chunk_size":
        data[at - 4:at] = struct.pack("<I", len(data))
    elif where == "vp8x_canvas":
        data[data.index(b"VP8X") + 12] ^= 1
    elif where.startswith("tokens_cut"):  # a whole container around a cut token partition
        keep = first + 10 + (12 if where.endswith("short") else 300)
        chunk = b"VP8 " + struct.pack("<I", keep) + bytes(data[at:at + keep])
        data = bytearray(b"RIFF" + struct.pack("<I", 4 + len(chunk) + (keep & 1)) + b"WEBP"
                         + chunk + b"\0" * (keep & 1))
    elif where.startswith("odd_chunk"):  # an odd payload: its padding byte, or none
        size = struct.unpack("<I", data[at - 4:at])[0]
        payload = bytes(data[at:at + size]) + b"\0"  # one byte more in the last partition
        pad = {"odd_chunk_padded": b"\0", "odd_chunk_unpadded": b"",
               "odd_chunk_padded_ff": b"\xff"}[where]
        chunk = b"VP8 " + struct.pack("<I", len(payload)) + payload + pad
        data = bytearray(b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk)
    _same_verdict(bytes(data))


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def _riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _parts():
    """A lossy still with alpha taken apart: its ``VP8X``, ``ALPH`` and ``VP8 `` chunks, an
    ``ALPH`` with reserved bits set, a lossless picture's ``VP8L`` chunk and an ``EXIF``."""
    rgba = frame(33, 47, "noisy", seed=1, alpha=True)
    still = pil_webp(rgba, quality=70)
    ai, vi = still.index(b"ALPH"), still.index(b"VP8 ")
    size = struct.unpack("<I", still[vi + 4:vi + 8])[0]
    lossless = pil_webp(rgba, lossless=True)
    li = lossless.index(b"VP8L")
    lsize = struct.unpack("<I", lossless[li + 4:li + 8])[0]
    alph = still[ai:vi]
    return {"VP8X": still[12:ai], "ALPH": alph, "VP8": still[vi:vi + 8 + size + (size & 1)],
            "badALPH": alph[:8] + bytes([alph[8] | 0xC0]) + alph[9:],
            "VP8L": lossless[li:li + 8 + lsize + (lsize & 1)], "EXIF": _chunk(b"EXIF", b"abc")}


LAYOUTS = ["ALPH VP8", "badALPH VP8", "VP8 ALPH", "VP8 badALPH", "VP8 EXIF ALPH",
           "ALPH ALPH VP8", "ALPH EXIF VP8", "VP8 VP8", "VP8 EXIF VP8", "VP8 EXIF", "EXIF VP8",
           "VP8", "ALPH VP8L", "VP8L ALPH", "VP8 ALPH VP8L", "VP8L", "ALPH"]


@pytest.mark.parametrize("container, layout", [
    (container, layout) for container in ("vp8x_alpha_flag", "vp8x_no_flag", "simple")
    for layout in LAYOUTS  # a simple WebP's first chunk is its bitstream
    if container != "simple" or layout.startswith("VP8")])
def test_chunk_layouts_are_judged_as_pillow_judges_them(container, layout):
    """libwebp's demuxer takes one ``ALPH`` and one bitstream in a row and refuses picture
    chunks after them; a still without ``VP8X``'s alpha flag drops its ``ALPH`` unread.
    Where Pillow raises the port raises; elsewhere both read the same."""
    parts = _parts()
    body = b"".join(parts[name] for name in layout.split())
    if container == "simple":
        _same_verdict(_riff(body))
        return
    vp8x = parts["VP8X"]
    if container == "vp8x_no_flag":
        vp8x = vp8x[:8] + bytes([vp8x[8] & ~0x10 & 0xFF]) + vp8x[9:]
    _same_verdict(_riff(vp8x + body))


@pytest.mark.parametrize("flag", [True, False], ids=["alpha_flag", "no_flag"])
def test_only_the_first_frames_alpha_is_checked(flag):
    parts = _parts()
    good = _riff(parts["VP8X"] + parts["ALPH"] + parts["VP8"])
    bad = _riff(parts["VP8X"] + parts["badALPH"] + parts["VP8"])
    for frames in ((bad, good), (good, bad), (good, good)):
        _same_verdict(enc.animation((47, 33), [(0, 0, 47, 33, f) for f in frames], alpha=flag))


def test_corrupt_coefficients_wrap_as_libwebps_sse2_transform():
    """Five bytes changed in a file's tokens: the coefficients they make overflow 16 bits
    inside the inverse DCT, where libwebp's x86 transform wraps (the C version, in 32 bits,
    reads 0 for 255 at four pixels). Pillow reads the file, and the port the same bytes."""
    data = bytearray(enc.encode(frame(33, 47, "noisy", seed=249), 90, method=1))
    at = _vp8_at(bytes(data))
    for offset, op, value in ((430, "xor", 64), (179, "xor", 64), (249, "set", 238),
                              (1338, "xor", 8), (477, "xor", 64)):
        data[at + offset] = data[at + offset] ^ value if op == "xor" else value
    assert not _pil_raises(bytes(data))
    _same_verdict(bytes(data))


@pytest.mark.parametrize("seed", range(6))
def test_random_corruptions_read_as_pillow_reads(seed):
    """Ten files a seed, lossy from Pillow and from the encoder helper, with one to five
    bytes of the VP8 chunk flipped or set at random (seeded): each raises where Pillow
    raises and reads Pillow's bytes where it reads, the first partition's garbage modes,
    segments, filter levels and quantisers, and the tokens' garbage coefficients included."""
    rng = random.Random(seed)
    for i in range(10):
        n = 10 * seed + i
        arr = frame(*SIZES[1 + n % 4], KINDS[n % 4], seed=n, alpha=n % 5 == 0)
        if n % 3 == 0:
            data = bytearray(enc.encode(arr, rng.choice([5, 50, 90]), method=rng.choice([0, 1, 2]),
                                        partitions=rng.choice([0, 1, 2, 3]),
                                        filter_type=rng.choice([0, 1])))
        else:
            data = bytearray(pil_webp(arr, quality=rng.choice([0, 30, 80, 100]),
                                      method=rng.choice([0, 4, 6])))
        at = _vp8_at(bytes(data))
        for _ in range(rng.choice([1, 1, 2, 5])):
            k = rng.randrange(at, len(data))
            flip = rng.random() < 0.5
            data[k] = data[k] ^ (1 << rng.randrange(8)) if flip else rng.randrange(256)
        _same_verdict(bytes(data))


def test_unsupported_vp8_frames_are_named():
    data = bytearray(pil_webp(frame(16, 16, "smooth", seed=3)))
    data[_vp8_at(bytes(data))] |= 1
    with pytest.raises(twebp.WebPUnsupported, match="inter frame"):
        twebp.parse_webp(bytes(data))


def test_pixel_limit(tmp_path):
    """A VP8 header of 16383 x 16383 (past twice Pillow's ``MAX_IMAGE_PIXELS``) raises
    before any pixel is allocated, with Pillow's message."""
    data = bytearray(pil_webp(frame(16, 16, "smooth", seed=1)))
    at = _vp8_at(bytes(data))
    data[at + 6:at + 10] = struct.pack("<HH", 0x3FFF, 0x3FFF)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(bytes(data)))
    with pytest.raises(ValueError, match="could be decompression bomb"):
        twebp.parse_webp(bytes(data))


# SHA-256 of ``webp_vp8_tables``'s bytes: kDcTable, kAcTable, the bands, the zigzag order,
# the kCat3-6 probabilities, CoeffsProba0, CoeffsUpdateProba and kBModesProba
TABLES_SHA256 = "6ba3b674e2bb22c2b455571f48a6422a8d1b5206b8e0cc8a55da9a8902ba3dfc"
TABLE_SIZES = (("kDcTable", 128), ("kAcTable", 256), ("kBands", 17), ("kZigzag", 16),
               ("kCat3", 4), ("kCat4", 5), ("kCat5", 6), ("kCat6", 12),
               ("CoeffsProba0", 1056), ("CoeffsUpdateProba", 1056), ("kBModesProba", 900))


def test_constant_tables():
    """The decoder's tables against their digest, and each found as it is in the libwebp
    Pillow bundles (its decoder's copy: the same bytes, in libwebp's own layout)."""
    lib = twebp.vp8_library()
    n = lib.webp_vp8_tables(None)
    buf = np.empty(n, np.uint8)
    lib.webp_vp8_tables(buf.ctypes.data)
    assert n == sum(size for _, size in TABLE_SIZES)
    assert hashlib.sha256(buf.tobytes()).hexdigest() == TABLES_SHA256
    with open(glob.glob(os.path.join(enc._LIBS, "libwebp-*.so*"))[0], "rb") as f:
        binary = f.read()
    at = 0
    for name, size in TABLE_SIZES:
        assert buf[at:at + size].tobytes() in binary, name
        at += size


def test_every_feature_was_met():
    """Runs after the cases above (file order): the files held every loop filter, segments
    and a segment map, 2, 4 and 8 partitions, a skipped macroblock, every 16x16 and 4x4
    mode and a coefficient probability update."""
    assert set(twebp.VP8_FEATURES) <= SEEN, sorted(set(twebp.VP8_FEATURES) - SEEN)


def _alpha_parts(seed: int, size=(48, 61)):
    """A lossy still with a VP8L-compressed alpha plane (Pillow's default): its ``VP8X``
    payload chunk, the ``ALPH`` payload and the ``VP8 `` chunk."""
    rgba = frame(*size, "noisy", seed=seed, alpha=True)
    rgba[..., 3] = (rgba[..., 3].astype(int) * 7 + np.arange(size[1])[None] * 3) % 256
    still = pil_webp(rgba, quality=60, method=4, exact=True)
    ai, vi = still.index(b"ALPH"), still.index(b"VP8 ")
    alph = still[ai + 8:ai + 8 + struct.unpack("<I", still[ai + 4:ai + 8])[0]]
    assert alph[0] & 3 == 1  # VP8L-compressed
    return still[12:ai], alph, still[vi:]


@pytest.mark.parametrize("case", ["sound", "trailing_bytes", "filter_0", "filter_2",
                                  "filter_3", "preprocessing_1", "preprocessing_2",
                                  "cut_header", "cut_half", "cut_last_byte", "flipped",
                                  "uncompressed", "uncompressed_short", "no_alpha_flag",
                                  "animation_first", "animation_second"])
def test_vp8l_alpha_is_decoded_where_libwebp_decodes_it(case):
    """A sound VP8 frame beside its ``ALPH`` chunk: the VP8L-compressed plane decoded on the
    host (``webp_alpha_decode``) where libwebp decodes it, so a corrupt or cut one raises as
    Pillow raises, and bytes after a sound one are ignored; the filter bits (2-3) never
    fail, pre-processing past 1 does; a still without the alpha flag, and an animation's
    second frame, leave theirs unread."""
    vp8x, alph, vp8 = _alpha_parts(11)
    head = alph[0]
    if case == "trailing_bytes":
        alph += b"\x5a\xa5\x00\xff"
    elif case.startswith("filter"):
        alph = bytes([head & ~0x0C | int(case[-1]) << 2]) + alph[1:]
    elif case.startswith("preprocessing"):
        alph = bytes([head & ~0x30 | int(case[-1]) << 4]) + alph[1:]
    elif case == "cut_header":
        alph = alph[:3]
    elif case == "cut_half":
        alph = alph[:len(alph) // 2]
    elif case == "cut_last_byte":
        alph = alph[:-1]
    elif case == "flipped":
        alph = alph[:20] + bytes([alph[20] ^ 0xFF]) + alph[21:]
    elif case.startswith("uncompressed"):
        plane = np.arange(48 * 61, dtype=np.uint8).tobytes()
        alph = bytes([head & ~0x03]) + plane[:None if case == "uncompressed" else -1]
    if case == "no_alpha_flag":
        vp8x = vp8x[:8] + bytes([vp8x[8] & ~0x10 & 0xFF]) + vp8x[9:]
        alph = alph[:len(alph) // 2]  # corrupt, and not read
    body = vp8x + _chunk(b"ALPH", alph) + vp8
    if case.startswith("animation"):
        bad = _riff(vp8x + _chunk(b"ALPH", alph[:len(alph) // 2]) + vp8)
        good = _riff(body)
        frames = (bad, good) if case == "animation_first" else (good, bad)
        data = enc.animation((61, 48), [(0, 0, 61, 48, f) for f in frames], alpha=True)
    else:
        data = _riff(body)
    raises = case in ("preprocessing_2", "cut_header", "cut_half", "cut_last_byte",
                      "uncompressed_short", "animation_first") or (
        case == "flipped" and _pil_raises(data))
    assert _pil_raises(data) == raises
    _same_verdict(data)


@pytest.mark.parametrize("seed", range(3))
def test_random_alpha_corruptions_read_as_pillow_reads(seed):
    """Sixty VP8L alpha planes a seed with one to four bytes set or flipped, or cut short,
    at random (seeded): each raises where Pillow raises and reads Pillow's bytes where it
    reads."""
    rng = random.Random(seed)
    vp8x, alph, vp8 = _alpha_parts(seed, size=[(33, 47), (64, 80), (17, 90)][seed])
    for _ in range(60):
        a = bytearray(alph)
        for _ in range(rng.choice([1, 2, 4])):
            k = rng.randrange(1, len(a))
            a[k] = rng.randrange(256) if rng.random() < 0.5 else a[k] ^ (1 << rng.randrange(8))
        if rng.random() < 0.2:
            a = a[:rng.randrange(1, len(a))]
        _same_verdict(_riff(vp8x + _chunk(b"ALPH", bytes(a)) + vp8))
