"""The frame-format fixtures of ``tests/data/torch_frame_formats/``: small files written by
Pillow 12.1 (libjpeg-turbo 3.1, libtiff 4.7, libwebp 1.6), or assembled by the test writers
(``torch_gif_writer``, ``torch_tiff_writer``, ``torch_bmp_writer``, ``torch_jpeg_writer``)
where Pillow does not write the kind, in the formats the port reads without PIL, all of one
size after decoding (the turned TIFFs are stored turned), with the SHA-256 of Pillow's
``convert("RGB")`` bytes of each in ``digests.json``; the files Pillow raises on
(``REFUSED``: a corrupt VP8L alpha plane, a JPEG of a fractional sampling ratio) are listed
there under ``pil_raises``. GIFs are named ``.png``: the JAX package lists frames by its
seven extensions, and reads a GIF by its bytes. In ``tests/data/torch_frame_formats_720p/``,
the 720p frame the main path ingests (``chip_smoke.make_clip``'s first frame) as a lossy
WebP at Pillow's default quality 80, as Pillow's GIF and as an arithmetic-coded progressive
JPEG at quality 90, with their digests. ``chip_smoke.py``'s ``frame_formats`` phase decodes
them on the card (which has no PIL to make them) and holds each against its digest;
``tests/test_torch_frame_formats.py`` holds the digests against Pillow and the port.

Rewrite them with ``python tests/torch_frame_fixtures.py`` (the files change only when
Pillow's encoders do).
"""

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

import torch_jpeg_writer
import torch_webp_encoder
from torch_bmp_writer import rle_bmp, rle_encode
from torch_gif_writer import gif_bytes
from torch_tiff_writer import jpeg_tiff, ycbcr_tiff

TESTS = os.path.dirname(os.path.abspath(__file__))
DIR = os.path.join(TESTS, "data", "torch_frame_formats")
DIR_720P = os.path.join(TESTS, "data", "torch_frame_formats_720p")
HW = (144, 256)


def base_frame() -> np.ndarray:
    """Smooth colour waves, the three channels apart (so libwebp's method 1 takes every
    transform but colour indexing)."""
    y, x = np.mgrid[0:HW[0], 0:HW[1]]
    waves = np.stack([128 + 100 * np.sin(x / 9 + c) * np.cos(y / 13 - c) for c in range(3)], -1)
    return np.clip(waves, 0, 255).astype(np.uint8)


def _save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _rgba() -> np.ndarray:
    """The base frame with an alpha plane that is 0 over a band and a disc (the colour under
    it kept: ``exact``), graded elsewhere."""
    y, x = np.mgrid[0:HW[0], 0:HW[1]]
    alpha = np.clip(x * 255 // HW[1], 1, 255).astype(np.uint8)
    alpha[(y // 12) % 4 == 1] = 0
    alpha[(x - 180) ** 2 + (y - 70) ** 2 < 40 ** 2] = 0
    return np.dstack([base_frame(), alpha])


def _animated() -> bytes:
    """Three frames through Pillow's ``save_all`` (libwebp's animation encoder, lossy)."""
    frames = [Image.fromarray(np.roll(base_frame(), 24 * i, axis=1)) for i in range(3)]
    return _save(frames[0], "WEBP", save_all=True, append_images=frames[1:], duration=40,
                 quality=80)


def _animated_offset() -> bytes:
    """An animation whose first frame (lossy with alpha, 96 x 160) lies at (48, 32) on the
    canvas, the rest of which reads as 0; a lossless second frame covers the canvas."""
    first = torch_webp_encoder.encode(_rgba()[16:112, 40:200], 80, exact=1)
    second = _save(Image.fromarray(base_frame()), "WEBP", lossless=True)
    return torch_webp_encoder.animation((HW[1], HW[0]), [(48, 32, 160, 96, first),
                                                         (0, 0, HW[1], HW[0], second)],
                                        alpha=True)


def _gif_interlaced() -> bytes:
    """An interlaced GIF frame of 224 x 112 at (16, 16) on a 256 x 144 screen, with a
    global and a local colour table (the local one read) and a transparent index (the
    screen outside the frame filled with it; its colour kept)."""
    q = Image.fromarray(base_frame()[16:128, 16:240]).quantize(64)
    local = np.asarray(q.getpalette()[:3 * 64], np.uint8).reshape(64, 3)
    return gif_bytes(np.asarray(q), screen=(HW[1], HW[0]), at=(16, 16), interlace=True,
                     global_table=local[::-1].copy(), local_table=local, transparency=5)


def _rle_bmp(colors: int) -> bytes:
    """The base frame quantised to 256 (RLE8) or 16 (RLE4) colours, RLE-encoded."""
    q = Image.fromarray(base_frame()).quantize(colors)
    pal = np.asarray(q.getpalette()[:3 * colors], np.uint8).reshape(colors, 3)
    bgrx = np.concatenate([pal[:, ::-1], np.zeros((colors, 1), np.uint8)], 1)
    idx = np.asarray(q)
    return rle_bmp(HW[1], HW[0], rle_encode(idx[::-1], colors == 16), colors == 16, bgrx)


def _alpha_pair() -> tuple:
    """``lossy_alpha.webp``'s picture with bytes after its sound VP8L alpha stream (libwebp
    ignores them), and with that stream cut in half (libwebp, and Pillow, refuse it)."""
    still = _save(Image.fromarray(_rgba(), "RGBA"), "WEBP", quality=80, exact=True)
    ai = still.index(b"ALPH")
    size = struct.unpack("<I", still[ai + 4:ai + 8])[0]
    alph = still[ai + 8:ai + 8 + size]

    def with_alpha(a: bytes) -> bytes:
        chunk = b"ALPH" + struct.pack("<I", len(a)) + a + b"\0" * (len(a) & 1)
        body = still[12:ai] + chunk + still[ai + 8 + size + (size & 1):]
        return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body

    return with_alpha(alph + b"\x5a\xa5\x00\xff"), with_alpha(alph[:len(alph) // 2])


def _jpeg_fixtures(rgb: Image.Image) -> dict:
    """The JPEG kinds Pillow reads and does not write (libjpeg's encoder through
    ``torch_jpeg_writer``): 4:1:1, luma sampled below its chroma, a progressive file cut
    after its third scan (smoothed), SOF9 with restart markers, SOF10 and SOF10 cut after its
    second scan; a JPEG-in-TIFF at ``YCbCrSubsampling`` 4 x 4 (its luma alone in a scan);
    and a 4:2:0 file whose frame header asks a 3 / 2 upsampling ratio (Pillow raises)."""
    px = base_frame()
    write = torch_jpeg_writer.compress
    prog = _save(rgb, "JPEG", quality=90, progressive=True, subsampling=2)
    apart = [((c,), 0, 63, 0, 0) for c in range(3)]
    fractional = bytearray(write(px, [(2, 2), (1, 1), (1, 1)], quality=85))
    sof = fractional.index(b"\xff\xc0")
    fractional[sof + 11], fractional[sof + 14] = 0x32, 0x21  # Y 3 x 2, Cb 2 x 1
    return {
        "sampling_411.jpg": write(px, [(4, 1), (1, 1), (1, 1)], quality=85),
        "luma_below_chroma.jpg": write(px, [(1, 1), (2, 2), (2, 2)], quality=85),
        "prog_cut.jpg": torch_jpeg_writer.cut_after(prog, 3),
        "arith_restart.jpg": write(px, [(2, 2), (1, 1), (1, 1)], quality=85, arith=True,
                                   restart=7),
        "arith_prog.jpg": write(px, [(2, 2), (1, 1), (1, 1)], quality=90, arith=True,
                                progressive=True),
        "arith_prog_cut.jpg": torch_jpeg_writer.cut_after(
            write(px, [(2, 2), (1, 1), (1, 1)], quality=90, arith=True, progressive=True), 2),
        "jpeg_ycbcr_44.tif": jpeg_tiff(px, subsampling=(4, 4), rows=32, encode=lambda part:
                                       write(part, [(4, 4), (1, 1), (1, 1)], quality=85,
                                             scans=apart)),
        "sampling_3x2.jpg": bytes(fractional),
    }


def fixtures() -> dict:
    """name -> file bytes (the files Pillow reads; ``REFUSED`` lists those it raises on)."""
    rgb = Image.fromarray(base_frame())
    grey = rgb.convert("L")
    turned = {k: Image.fromarray(np.ascontiguousarray(np.rot90(base_frame(), k)))
              for k in (1, -1)}
    sound_alpha, corrupt_alpha = _alpha_pair()
    return {
        "prog_420.jpg": _save(rgb, "JPEG", quality=90, progressive=True, subsampling=2),
        "prog_444_optimize.jpg": _save(rgb, "JPEG", quality=75, progressive=True,
                                       subsampling=0, optimize=True),
        "prog_grey.jpg": _save(grey, "JPEG", quality=85, progressive=True),
        "prog_restart.jpg": _save(rgb, "JPEG", quality=80, progressive=True, subsampling=2,
                                  restart_marker_blocks=5),
        "cmyk.jpg": _save(rgb.convert("CMYK"), "JPEG", quality=90),
        "lzw_predictor.tif": _save(rgb, "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
        "deflate.tif": _save(rgb, "TIFF", compression="tiff_adobe_deflate"),
        "packbits.tif": _save(rgb, "TIFF", compression="packbits"),
        "palette.tif": _save(rgb.quantize(64), "TIFF", compression="tiff_lzw"),
        "grey16.tif": _save(Image.fromarray((np.asarray(grey, np.uint16) * 3)), "TIFF",
                            compression="tiff_adobe_deflate"),
        "orient6.tif": _save(turned[1], "TIFF", compression="tiff_lzw",
                             tiffinfo={274: 6, 317: 2}),
        "orient8.tif": _save(turned[-1], "TIFF", compression="tiff_adobe_deflate",
                             tiffinfo={274: 8, 317: 2}),
        "jpeg_rgb.tif": _save(rgb, "TIFF", compression="jpeg", quality=90),
        "jpeg_ycbcr_420.tif": jpeg_tiff(base_frame(), subsampling=2, rows=16, quality=85),
        "lzw_ycbcr22.tif": ycbcr_tiff(np.asarray(rgb.convert("YCbCr")), (2, 2), rows=16),
        "cmyk8.tif": _save(rgb.convert("CMYK"), "TIFF", compression="tiff_lzw",
                           tiffinfo={317: 2}),
        "gif_interlaced.png": _gif_interlaced(),
        "gif_pillow.png": _save(rgb, "GIF"),
        "rle8.bmp": _rle_bmp(256),
        "rle4.bmp": _rle_bmp(16),
        "color_indexing.webp": _save(rgb.quantize(16).convert("RGB"), "WEBP", lossless=True,
                                     method=4),
        "all_transforms.webp": _save(rgb, "WEBP", lossless=True, method=1, quality=0),
        "lossy_q80.webp": _save(rgb, "WEBP", quality=80),
        "lossy_q5_m6.webp": _save(rgb, "WEBP", quality=5, method=6),
        "lossy_alpha.webp": _save(Image.fromarray(_rgba(), "RGBA"), "WEBP", quality=80,
                                  exact=True),
        "alpha_vp8l_trailing.webp": sound_alpha,
        "alpha_vp8l_corrupt.webp": corrupt_alpha,
        "lossy_simple_8parts.webp": torch_webp_encoder.encode(base_frame(), 80, filter_type=0,
                                                              partitions=3, method=0),
        "animated.webp": _animated(),
        "animated_offset.webp": _animated_offset(),
        **_jpeg_fixtures(rgb),
    }


# the fixtures Pillow raises on: decoding them must raise on every device
REFUSED = ("alpha_vp8l_corrupt.webp", "sampling_3x2.jpg")


def clip_frame_720p() -> np.ndarray:
    """``chip_smoke.make_clip``'s first frame at ``CLIP_HW`` (720 x 1280), as its
    ``frame_formats`` phase draws it."""
    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke

    return chip_smoke.make_clip(np, 1, 1.0 / chip_smoke.CLIP_FPS, chip_smoke.CLIP_HW)[0]


def fixtures_720p() -> dict:
    """name -> file bytes: the 720p frame as a lossy WebP at Pillow's default quality, as
    Pillow's GIF (its own 256-colour quantisation: a screen capture's format), and as an
    arithmetic-coded progressive JPEG at quality 90 (under the 64 KiB that Pillow's reader
    hands libjpeg at once, which an arithmetic scan cannot outrun)."""
    px = clip_frame_720p()
    frame = Image.fromarray(px)
    return {"clip_q80.webp": _save(frame, "WEBP", quality=80), "clip.gif": _save(frame, "GIF"),
            "clip_arith_prog.jpg": torch_jpeg_writer.compress(
                px, [(2, 2), (1, 1), (1, 1)], quality=90, arith=True, progressive=True)}


def pil_digest(data: bytes) -> str:
    return hashlib.sha256(np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                                     np.uint8).tobytes()).hexdigest()


def write() -> None:
    for directory, files, hw in ((DIR, fixtures(), HW),
                                 (DIR_720P, fixtures_720p(), clip_frame_720p().shape[:2])):
        os.makedirs(directory, exist_ok=True)
        digests = {}
        for name, data in files.items():
            with open(os.path.join(directory, name), "wb") as f:
                f.write(data)
            if name not in REFUSED:
                digests[name] = pil_digest(data)
        record = {"hw": list(hw), "sha256_of_pil_rgb": digests}
        if directory == DIR:
            record["pil_raises"] = list(REFUSED)
        with open(os.path.join(directory, "digests.json"), "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    write()
