"""The frame-format fixtures of ``tests/data/torch_frame_formats/``: small files written by
Pillow 12.1 (libjpeg-turbo 3.1, libtiff 4.7, libwebp 1.6) in the formats the port reads
without PIL, all of one size, with the SHA-256 of Pillow's ``convert("RGB")`` bytes of each
in ``digests.json``. ``chip_smoke.py``'s ``frame_formats`` phase decodes them on the card
(which has no PIL to make them) and holds each against its digest;
``tests/test_torch_frame_formats.py`` holds the digests against Pillow and the port.

Rewrite them with ``python tests/torch_frame_fixtures.py`` (the files change only when
Pillow's encoders do).
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_frame_formats")
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


def fixtures() -> dict:
    """name -> file bytes."""
    rgb = Image.fromarray(base_frame())
    grey = rgb.convert("L")
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
        "color_indexing.webp": _save(rgb.quantize(16).convert("RGB"), "WEBP", lossless=True,
                                     method=4),
        "all_transforms.webp": _save(rgb, "WEBP", lossless=True, method=1, quality=0),
    }


def pil_digest(data: bytes) -> str:
    return hashlib.sha256(np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                                     np.uint8).tobytes()).hexdigest()


def write() -> None:
    os.makedirs(DIR, exist_ok=True)
    digests = {}
    for name, data in fixtures().items():
        with open(os.path.join(DIR, name), "wb") as f:
            f.write(data)
        digests[name] = pil_digest(data)
    with open(os.path.join(DIR, "digests.json"), "w") as f:
        json.dump({"hw": list(HW), "sha256_of_pil_rgb": digests}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    write()
