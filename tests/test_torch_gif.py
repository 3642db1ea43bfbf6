"""GIF frames without PIL on the port (``foley_tpu_torch/io/gif.py`` and its host block walk
and LZW decoder, ``csrc/gif_lzw.cpp``) against the JAX package's
``pipeline/video.py::read_frames_dir`` (Pillow 12.1's ``GifImagePlugin`` and ``GifDecode.c``,
``convert("RGB")``), on the CPU. No tolerance: every comparison is exact.

Pillow's own GIFs (palettes of 2 to 256 colours, greys, interlaced or not, with a
transparent index), and files this test assembles (``torch_gif_writer.py``) for what Pillow
does not write: every LZW minimum code size from 0 to 12, a table kept full without a clear
(a deferred clear) and clears at any point, frames smaller than the screen and past its
edge, with and without a transparent index, local tables, tables of greys, no table, tables
shorter than the indices, interlaced frames of 1 to 17 rows, extensions Pillow walks oddly;
truncated and corrupt files, which raise where Pillow raises and read as it reads elsewhere.
"""

import io
import random

import numpy as np
import pytest
from PIL import Image

from foley_tpu.pipeline import video as jvideo
from foley_tpu_torch.io import gif as tgif
from foley_tpu_torch.pipeline import video as tvideo
from torch_gif_writer import gif_bytes, interlace_order, lzw_encode, sub_blocks
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)


def _image(h, w, seed) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    waves = np.stack([128 + 100 * np.sin(x / 5 + c) * np.cos(y / 4 - c) for c in range(3)], -1)
    noise = np.random.default_rng(seed).normal(0, 25, (h, w, 3))
    return np.clip(waves + noise, 0, 255).astype(np.uint8)


def _against_jax(tmp_path, data: bytes, name="f.png"):
    """The port's ``read_frames_dir`` of a directory holding ``data`` (named ``.png``: the
    JAX package lists no ``.gif``) against the JAX package's."""
    d = tmp_path / "frames"
    d.mkdir(exist_ok=True)
    (d / name).write_bytes(data)
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def _pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), None
    except Exception as e:  # noqa: BLE001 (Pillow raises several types here)
        return None, e


def _same_verdict(data: bytes) -> bool:
    """Pillow and the port both raise, or both read the same bytes; returns whether they
    read."""
    ref, err = _pil(data)
    if err is not None:
        with pytest.raises(ValueError):
            tgif.read_gifs(["f.gif"], "cpu", [data])
        return False
    np.testing.assert_array_equal(tgif.read_gifs(["f.gif"], "cpu", [data])[0], ref)
    return True


def _pil_gif(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="GIF", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("colors", [2, 4, 16, 100, 256])
@pytest.mark.parametrize("interlace", [False, True])
def test_pillows_own_gifs(tmp_path, colors, interlace):
    img = Image.fromarray(_image(37, 53, colors)).quantize(colors)
    _against_jax(tmp_path, _pil_gif(img, interlace=interlace, optimize=False))


@pytest.mark.parametrize("mode", ["L", "RGB", "1"])
def test_pillows_grey_and_rgb_gifs(tmp_path, mode):
    """Pillow's writer quantises RGB itself and writes greys as a table of greys, which its
    reader takes as mode L."""
    _against_jax(tmp_path, _pil_gif(Image.fromarray(_image(21, 30, 3)).convert(mode)))


def test_pillows_transparent_gif(tmp_path):
    img = Image.fromarray(_image(24, 31, 4)).quantize(16)
    _against_jax(tmp_path, _pil_gif(img, transparency=5))


@pytest.mark.parametrize("bits", range(13))
def test_every_lzw_code_size(bits):
    """Minimum code sizes 0 to 12 (literals below ``2 ** bits``; 0 has the literal 0 only;
    past 8 the codes start at 10 to 13 bits and the table never grows)."""
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 if bits == 0 else min(1 << bits, 256), (13, 19))
    table = rng.integers(0, 256, (256, 3))
    data = gif_bytes(idx, global_table=table, bits=bits)
    if _same_verdict(data) and bits <= 8:
        np.testing.assert_array_equal(tgif.read_gifs(["f"], "cpu", [data])[0], table[idx])


@pytest.mark.parametrize("bits", [2, 3, 5, 8])
@pytest.mark.parametrize("clears", ["deferred", "when_full", "every_300"])
def test_full_tables_and_clears(bits, clears):
    """Long frames that fill the 4096-code table: kept full (a deferred clear: 12-bit codes
    with no new entry), cleared when full, or cleared every 300 codes."""
    rng = np.random.default_rng(bits)
    base = rng.integers(0, 1 << bits, (160, 190))
    idx = np.where(rng.random(base.shape) < 0.7, base[:, :1] * 0 + base[0], base) % (1 << bits)
    kw = {"deferred": {"clear_when_full": False}, "when_full": {},
          "every_300": {"clear_every": 300}}[clears]
    table = rng.integers(0, 256, (1 << bits, 3))
    data = gif_bytes(idx, global_table=table, bits=bits, **kw)
    assert _same_verdict(data)
    np.testing.assert_array_equal(tgif.read_gifs(["f"], "cpu", [data])[0], table[idx])


@pytest.mark.parametrize("case", ["small", "small_transparent", "past_edge", "past_both",
                                  "local_table", "local_greys", "global_greys", "no_table",
                                  "short_global", "short_local", "background"])
def test_frames_screens_and_tables(tmp_path, case):
    """A frame smaller than its screen (the rest index 0, or the transparent index: not the
    background), a frame past the screen's edge (the screen grows), local tables over global
    ones, tables of greys and none (each index its grey), tables shorter than the indices
    (black past them)."""
    rng = np.random.default_rng(len(case))
    idx = rng.integers(0, 16, (11, 17))
    table = rng.integers(0, 256, (16, 3))
    greys = np.repeat(np.arange(32)[:, None], 3, axis=1)
    kw = {"small": dict(screen=(30, 20), at=(6, 5), global_table=table),
          "small_transparent": dict(screen=(30, 20), at=(6, 5), global_table=table,
                                    transparency=9),
          "past_edge": dict(screen=(20, 9), at=(7, 0), global_table=table),
          "past_both": dict(screen=(5, 5), at=(3, 2), global_table=table, transparency=2),
          "local_table": dict(global_table=table, local_table=rng.integers(0, 256, (16, 3))),
          "local_greys": dict(global_table=table, local_table=greys),
          "global_greys": dict(global_table=greys, screen=(25, 15), at=(2, 2), transparency=7),
          "no_table": dict(bits=4, screen=(20, 12), at=(1, 1)),
          "short_global": dict(global_table=table[:4], bits=4),
          "short_local": dict(local_table=table[:2], bits=4),
          "background": dict(screen=(30, 20), at=(6, 5), global_table=table, background=11)}
    _against_jax(tmp_path, gif_bytes(idx, **kw[case]))


@pytest.mark.parametrize("height", [1, 2, 3, 4, 5, 8, 9, 12, 17])
def test_interlaced_rows(tmp_path, height):
    """An interlaced frame's rows come in the passes 0 / 8, 4 / 8, 2 / 4, 1 / 2; the port
    puts them in place on the device."""
    rng = np.random.default_rng(height)
    idx = rng.integers(0, 16, (height, 7))
    table = rng.integers(0, 256, (16, 3))
    got = _against_jax(tmp_path, gif_bytes(idx, global_table=table, interlace=True))
    np.testing.assert_array_equal(np.round(got[0] * 255).astype(np.uint8), table[idx])
    assert sorted(interlace_order(height)) == list(range(height))
    np.testing.assert_array_equal(tgif.interlace_rows(height).numpy(), interlace_order(height))


COMMENT = b"!\xfe\x05hello\x03abc\x00"
NETSCAPE = b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
OTHER_APP = b"!\xff\x0bXMP DataXMP\x02ab\x00"
EMPTY_EXT = b"!\x01\x00"  # a plain-text label and no sub-block: Pillow reads on past it


@pytest.mark.parametrize("before", ["comment", "netscape", "other_app", "junk", "two_gce",
                                    "empty_extension", "gce_short", "gce_no_index",
                                    "gce_after_comment"])
def test_extensions_are_walked_as_pillow_walks_them(before):
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 16, (6, 9))
    table = rng.integers(0, 256, (16, 3))
    blocks = {"comment": COMMENT, "netscape": NETSCAPE + COMMENT, "other_app": OTHER_APP,
              "junk": b"\x00\x17\xaa" + COMMENT,
              "two_gce": b"!\xf9\x04\x01\x00\x00\x03\x00",  # the second one's index counts
              "empty_extension": EMPTY_EXT,
              "gce_short": b"!\xf9\x02\x01\x00\x00",
              "gce_no_index": b"!\xf9\x03\x00\x00\x00\x00",
              "gce_after_comment": COMMENT + b"!\xf9\x04\x01\x00\x00\x05\x00"}[before]
    data = gif_bytes(idx, global_table=table, screen=(12, 8), at=(2, 1), transparency=6,
                     before=blocks)
    _same_verdict(data)


@pytest.mark.parametrize("case", ["no_image", "trailer_first", "zero_width", "code_size_13",
                                  "first_code_not_literal", "code_past_next",
                                  "end_code_early", "end_code_early_long_file",
                                  "extra_after_frame", "clear_after_clear"])
def test_corrupt_streams(case):
    """Pillow's verdicts: no image descriptor, a frame of no pixels, a code size past 12, a
    broken stream (the first code after a clear not a literal, a code past the next free
    one) raise; an end code before the frame is full raises where the file ends after it
    and is read past where 64 KiB more follow (Pillow reads on); data after a full frame,
    and a clear right after a clear, are read as Pillow reads them."""
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 4, (8, 10))
    table = rng.integers(0, 256, (4, 3))
    clear = 4
    if case == "no_image":
        data = gif_bytes(idx, global_table=table)
        data = data[:data.index(b",")] + b";"
    elif case == "trailer_first":
        data = gif_bytes(idx, global_table=table, before=b";")
    elif case == "zero_width":
        data = gif_bytes(np.zeros((3, 0), np.int64), global_table=table, screen=(4, 4))
    elif case == "code_size_13":
        data = gif_bytes(idx, global_table=table, bits=13, lzw=b"\x00" * 8)
    elif case == "first_code_not_literal":  # clear, then code 6 (3 bits each)
        data = gif_bytes(idx, global_table=table, bits=2, lzw=bytes([clear | 6 << 3, 0]))
    elif case == "code_past_next":  # clear, 1, then 7 (the next free code is 6)
        data = gif_bytes(idx, global_table=table, bits=2,
                         lzw=bytes([clear | 1 << 3 | (7 & 3) << 6, 7 >> 2]))
    elif case.startswith("end_code_early"):
        lzw = lzw_encode(idx.reshape(-1)[:30], 2)  # 30 pixels, then the end code
        tail = b"" if case == "end_code_early" else lzw_encode(idx.reshape(-1), 2) * 4000
        data = gif_bytes(idx, global_table=table, bits=2, lzw=lzw + tail)
    elif case == "extra_after_frame":
        data = gif_bytes(idx, global_table=table, bits=2,
                         lzw=lzw_encode(idx.reshape(-1), 2) + bytes(range(40)))
    else:
        data = gif_bytes(idx, global_table=table, bits=2, extra_clears=2)
    read = _same_verdict(data)
    if case != "end_code_early_long_file":  # there, what follows the end code decides
        assert read == (case in ("extra_after_frame", "clear_after_clear"))


@pytest.mark.parametrize("interlace", [False, True])
def test_truncated_files_raise_where_pillow_does(interlace):
    """Every cut of a small file: Pillow raises until the frame's last pixel is in, and reads
    from there on (the trailer and the block terminator are not needed)."""
    rng = np.random.default_rng(7 + interlace)
    data = gif_bytes(rng.integers(0, 16, (9, 13)), global_table=rng.integers(0, 256, (16, 3)),
                     interlace=interlace, transparency=3)
    read = [_same_verdict(data[:cut]) for cut in range(0, len(data) + 1)]
    assert read[-1] and not read[0] and not read[len(data) // 2]


@pytest.mark.parametrize("seed", range(4))
def test_random_corruptions_read_as_pillow_reads(seed):
    """Forty files a seed, Pillow's and assembled ones, with one to four bytes flipped or set
    at random (seeded) anywhere after the header: each raises where Pillow raises and reads
    Pillow's bytes where it reads."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    for i in range(40):
        h, w = nprng.integers(1, 20), nprng.integers(1, 20)
        if i % 2:
            data = bytearray(_pil_gif(Image.fromarray(_image(h, w, i)).quantize(
                int(nprng.integers(2, 64))), interlace=bool(i % 4 == 1)))
        else:
            bits = int(nprng.integers(1, 9))
            data = bytearray(gif_bytes(nprng.integers(0, 1 << bits, (h, w)), bits=bits,
                                       global_table=nprng.integers(0, 256, (1 << bits, 3)),
                                       transparency=1 if i % 3 else None,
                                       interlace=bool(i % 5 == 0)))
        for _ in range(rng.choice([1, 1, 2, 4])):
            k = rng.randrange(13, len(data))
            data[k] = data[k] ^ (1 << rng.randrange(8)) if rng.random() < 0.5 \
                else rng.randrange(256)
        _same_verdict(bytes(data))


def test_pixel_limit(tmp_path):
    """A screen past Pillow's limit raises, with Pillow's message."""
    data = bytearray(gif_bytes(np.zeros((2, 2), np.int64), global_table=np.zeros((4, 3))))
    data[6:10] = b"\xff\xff\xff\xff"
    d = tmp_path / "frames"
    d.mkdir()
    (d / "0.png").write_bytes(bytes(data))
    with pytest.raises(Image.DecompressionBombError) as ref:
        jvideo.read_frames_dir(str(d))
    with pytest.raises(ValueError) as got:
        tvideo.read_frames_dir(str(d), device="cpu")
    assert str(ref.value) in str(got.value)


def test_many_frames_of_mixed_layouts_in_chunks(tmp_path, monkeypatch):
    """GIFs of several layouts (interlaced, offset, transparent, Pillow's) among PNGs in one
    directory, read a few at a time."""
    monkeypatch.setattr(tgif, "CHUNK_FRAMES", 2)
    rng = np.random.default_rng(8)
    d = tmp_path / "frames"
    d.mkdir()
    table = rng.integers(0, 256, (16, 3))
    files = [gif_bytes(rng.integers(0, 16, (10, 12)), global_table=table),
             gif_bytes(rng.integers(0, 16, (10, 12)), global_table=table, interlace=True),
             gif_bytes(rng.integers(0, 16, (6, 5)), global_table=table, screen=(12, 10),
                       at=(3, 2), transparency=4),
             _pil_gif(Image.fromarray(_image(10, 12, 1)).quantize(8)),
             gif_bytes(rng.integers(0, 16, (10, 12)), global_table=table)]
    for i, data in enumerate(files):
        (d / f"f{i}.png").write_bytes(data)
    buf = io.BytesIO()
    Image.fromarray(_image(10, 12, 2)).save(buf, format="PNG")
    (d / "f5.png").write_bytes(buf.getvalue())
    ref, _ = jvideo.read_frames_dir(str(d))
    got, _ = tvideo.read_frames_dir(str(d), device="cpu")
    np.testing.assert_array_equal(got, ref)


def test_sub_blocks_of_any_size(tmp_path):
    """LZW data cut into sub-blocks of 1, 7 and 255 bytes reads the same."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 8, (20, 25))
    table = rng.integers(0, 256, (8, 3))
    lzw = lzw_encode(idx.reshape(-1), 3)
    head = gif_bytes(idx, global_table=table, bits=3, lzw=b"")
    head = head[:head.rindex(b",") + 10 + 1]  # up to and including the code size byte
    for size in (1, 7, 255):
        data = head + sub_blocks(lzw, size) + b";"
        assert _same_verdict(data)
        np.testing.assert_array_equal(tgif.read_gifs(["f"], "cpu", [data])[0], table[idx])
