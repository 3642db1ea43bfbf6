"""Video frame reading on the host (``foley_tpu/pipeline/video.py`` counterpart).

Two routes, as in the JAX package:

- a directory of image frames, natural-sorted by name, declared to play at ``fps``
  (``read_frames_dir``): the frames are selected by name (``target_fps`` through the port's
  ``ops/interp.py::linspace_resample_indices``, then ``max_frames``) before any is decoded,
  each file's format is told by its first bytes as PIL tells it (a PNG named ``.jpg`` reads
  as a PNG, a GIF named ``.png`` as a GIF; the other formats PIL opens raise, naming the
  format), and PNG, JPEG (baseline and progressive; grey, YCbCr, RGB, CMYK, YCCK), BMP
  (uncompressed, bitfields, RLE8 and RLE4), GIF (the first frame), TIFF (every
  orientation; LZW, Deflate, PackBits, JPEG; grey, RGB, palette, CMYK, YCbCr) and WebP
  (lossless, lossy with or without alpha, and an animation's first frame) frames are decoded
  without PIL (``io/png.py``, ``io/jpeg.py``, ``io/bmp.py``, ``io/gif.py``, ``io/tiff.py``,
  ``io/webp.py``, each equal to PIL's ``convert("RGB")``), on ``device`` (the card unless
  the caller asks for the CPU); each kind a reader refuses raises, naming it (its module
  says which);
- a video file (``read_video_frames``): an MJPEG AVI (the JAX package's own container,
  ``io/avi.py``) is decoded in-process, its frames resampled to ``target_fps`` by nearest
  index, as in the JAX package; any other file, or an AVI that is not MJPEG or does not
  decode, goes through an ffmpeg rawvideo pipe with ``ffprobe`` for the geometry and rate:
  the same subprocess argv as the JAX package. Without ffmpeg on ``PATH`` it raises the JAX
  package's message.

Still refused, naming what is missing on the card's machine: the JAX package's PyAV route
(no ``av`` package there).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import subprocess
from typing import List, Optional, Tuple

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike
from foley_tpu_torch.io.avi import is_mjpeg_avi, read_avi
from foley_tpu_torch.io.bmp import read_bmps
from foley_tpu_torch.io.gif import read_gifs
from foley_tpu_torch.io.jpeg import read_jpegs
from foley_tpu_torch.io.png import read_pngs
from foley_tpu_torch.io.tiff import read_tiffs
from foley_tpu_torch.io.webp import read_webps
from foley_tpu_torch.ops.interp import linspace_resample_indices

# the names a frames directory's frames are selected by: the JAX package's extensions, in its
# order; each file's reader is then chosen from its first bytes (``frame_format``)
_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff")
_READERS = {"PNG": read_pngs, "JPEG": read_jpegs, "BMP": read_bmps, "GIF": read_gifs,
            "TIFF": read_tiffs, "WEBP": read_webps}
# the first bytes by which Pillow 12.1's plugins accept a file (their ``_accept``), of the
# formats the port decodes; TIFF's include the two byte orders' odd variants Pillow takes
_TIFF_PREFIXES = (b"MM\x00*", b"II*\x00", b"MM*\x00", b"II\x00*", b"MM\x00+", b"II+\x00")
# and of formats Pillow opens that the port does not decode, to name them when it refuses
_OTHER_FORMATS = (
    ((b"\x00\x00\x01\x00",), "ICO"),
    ((b"\x00\x00\x02\x00",), "CUR"), ((b"qoif",), "QOI"), ((b"8BPS",), "PSD"),
    ((b"icns",), "ICNS"), ((b"DDS ",), "DDS"),
    ((b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \r\n\x87\n"), "JPEG 2000"),
    ((b"%!PS", b"\xc5\xd0\xd3\xc6"), "EPS"), ((b"BLP1", b"BLP2"), "BLP"),
    ((b"\x01\xda",), "SGI"), ((b"\x59\xa6\x6a\x95",), "SUN"), ((b"/* XPM */",), "XPM"),
    ((b"SIMPLE",), "FITS"), ((b"DanM", b"LinS"), "MSP"))
_NAMED = {".png": "PNG", ".jpg": "JPEG", ".jpeg": "JPEG", ".bmp": "BMP", ".webp": "WebP",
          ".tif": "TIFF", ".tiff": "TIFF"}  # the format a frame's extension names
CHUNK_FRAMES = 128  # files read at a time: the host holds one chunk's bytes (PNG's and TIFF's)

NO_DECODER = ("no video decoder: install ffmpeg or the 'av' (PyAV) package, or pass a "
              "directory of image frames")


def _probe(path: str) -> Tuple[int, int, float]:
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        raise RuntimeError("ffprobe not found; install ffmpeg to read videos")
    out = subprocess.run(
        [ffprobe, "-v", "quiet", "-print_format", "json", "-show_streams",
         "-select_streams", "v:0", path],
        capture_output=True, text=True, check=True,
    ).stdout
    info = json.loads(out)["streams"][0]
    num, den = (int(x) for x in info.get("avg_frame_rate", "25/1").split("/"))
    return int(info["width"]), int(info["height"]), num / max(den, 1)


def _natural_key(name: str):
    """Sort key treating digit runs numerically, so frame_2 < frame_10."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name.lower())]


def frame_names(path: str, fps: float = 16.0, target_fps: Optional[float] = None,
                max_frames: Optional[int] = None) -> Tuple[List[str], float]:
    """The frame files ``read_frames_dir`` decodes, in order, and the effective fps: the
    JAX package's selection by name, before any decoding."""
    names = sorted((n for n in os.listdir(path) if n.lower().endswith(_IMAGE_EXTS)),
                   key=_natural_key)
    if not names:
        raise RuntimeError(f"no image frames ({'/'.join(_IMAGE_EXTS)}) under {path}")
    if target_fps and target_fps != fps:
        n_out = max(int(round(len(names) * target_fps / fps)), 1)
        names = [names[i] for i in linspace_resample_indices(len(names), n_out)]
        fps = target_fps
    if max_frames:
        names = names[:max_frames]
    return names, float(fps)


def frame_format(data: bytes, name: str) -> str:
    """The format of a frame file's bytes, told as Pillow's ``Image.open`` tells it (its
    plugins' ``_accept`` on the first bytes), whatever the file's name says: ``"PNG"``,
    ``"JPEG"``, ``"BMP"``, ``"GIF"``, ``"TIFF"`` or ``"WEBP"``. Any other format raises,
    naming it where Pillow would open it (ICO, PPM, QOI, ...): the port does not decode it."""
    if data.startswith(b"\x89PNG\r\n\x1a\n"):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data.startswith(b"BM"):
        return "BMP"
    if data.startswith((b"GIF87a", b"GIF89a")):
        return "GIF"
    if data[:4] in _TIFF_PREFIXES:
        return "TIFF"
    if data.startswith(b"RIFF") and data[8:12] == b"WEBP" and data[12:16] in (
            b"VP8 ", b"VP8L", b"VP8X"):
        return "WEBP"
    found = next((fmt for prefixes, fmt in _OTHER_FORMATS if data.startswith(prefixes)), None)
    if found is None and len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy":
        found = "PPM"
    if found is not None:
        raise ValueError(f"{name}: a {found} file; the port decodes PNG, JPEG, BMP, GIF, TIFF "
                         f"and WebP frames, not {found}")
    named = _NAMED.get(os.path.splitext(name)[1].lower(), "PNG, JPEG, BMP, GIF, TIFF or WebP")
    raise ValueError(f"{name}: cannot identify image file (not a {named} file, nor any other "
                     f"format the port decodes: its first bytes are {data[:12]!r})")


def read_frames_dir(path: str, fps: float = 16.0, target_fps: Optional[float] = None,
                    max_frames: Optional[int] = None,
                    device: DeviceLike = None) -> Tuple[np.ndarray, float]:
    """A directory of PNG, JPEG, BMP, GIF, TIFF or WebP frames -> ([T, H, W, 3] float32 in
    [0, 1] on the host, effective fps), decoded on ``device`` (``cuda`` unless given). The
    frames are selected by name (``frame_names``), and each file's reader is chosen by its
    bytes (``frame_format``), as PIL chooses it: a PNG named ``.jpg`` reads as a PNG, a GIF
    named ``.png`` as a GIF (the JAX package lists no ``.gif`` name, so neither does the
    port). Each
    file is read once, ``CHUNK_FRAMES`` at a time. Every frame must share one size; a frame
    of another format, or of a kind its reader refuses (an arithmetic-coded JPEG, a CCITT
    TIFF, ...) raises, naming it."""
    names, fps = frame_names(path, fps, target_fps, max_frames)
    frames = None
    for start in range(0, len(names), CHUNK_FRAMES):
        paths = [os.path.join(path, n) for n in names[start:start + CHUNK_FRAMES]]
        datas = []
        for p in paths:
            with open(p, "rb") as fh:
                datas.append(fh.read())
        groups = {}
        for i, (p, data) in enumerate(zip(paths, datas)):
            groups.setdefault(frame_format(data, p), []).append(i)
        for fmt, idx in groups.items():
            got = _READERS[fmt]([paths[i] for i in idx], device, [datas[i] for i in idx])
            if frames is None:
                frames = np.empty((len(names), *got.shape[1:]), np.uint8)
            elif frames.shape[1:] != got.shape[1:]:
                sizes = sorted({frames.shape[1:3], got.shape[1:3]})
                raise ValueError(f"frames differ in size: {sizes}")
            frames[[start + i for i in idx]] = got
    # / 255 in float32 on torch's host threads: numpy's correctly rounded quotients, faster
    return torch.from_numpy(frames).float().div_(255.0).numpy(), fps


def read_video_frames(path: str, target_fps: Optional[float] = None,
                      max_frames: Optional[int] = None, dir_fps: float = 16.0,
                      device: DeviceLike = None) -> Tuple[np.ndarray, float]:
    """A video file (an MJPEG AVI in-process, anything else through ffmpeg) or a directory of
    image frames (declared to play at ``dir_fps``), decoded on ``device`` (``cuda`` unless
    given) -> ([T, H, W, 3] float32 in [0, 1], effective fps)."""
    if os.path.isdir(path):
        return read_frames_dir(path, fps=dir_fps, target_fps=target_fps,
                               max_frames=max_frames, device=device)
    if is_mjpeg_avi(path):
        # the JAX package's own container decodes in-process; an AVI that is not MJPEG, or
        # does not decode, falls through to ffmpeg
        try:
            frames, src_fps, _, _ = read_avi(path, device)
        except ValueError:
            pass
        else:
            if target_fps and abs(target_fps - src_fps) > 1e-6:
                n_out = max(1, int(round(len(frames) * target_fps / src_fps)))
                idx = np.clip(np.round(np.arange(n_out) * src_fps / target_fps).astype(int),
                              0, len(frames) - 1)
                frames, src_fps = frames[idx], target_fps
            if max_frames:
                frames = frames[:max_frames]
            return frames, float(src_fps)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        if importlib.util.find_spec("av") is not None:
            raise RuntimeError(f"{path}: the JAX package's PyAV route is not ported; "
                               "install ffmpeg")
        raise RuntimeError(NO_DECODER)
    w, h, src_fps = _probe(path)
    fps = target_fps or src_fps
    cmd = [ffmpeg, "-v", "quiet", "-i", path]
    if target_fps:
        cmd += ["-vf", f"fps={target_fps}"]
    cmd += ["-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:1"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    n = len(raw) // (w * h * 3)
    if max_frames:
        n = min(n, max_frames)
    frames = np.frombuffer(raw[: n * w * h * 3], np.uint8).reshape(n, h, w, 3)
    return frames.astype(np.float32) / 255.0, fps
