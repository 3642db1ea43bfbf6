"""Video frame reading on the host (``foley_tpu/pipeline/video.py`` counterpart).

Two routes, as in the JAX package:

- a directory of image frames, natural-sorted by name, declared to play at ``fps``
  (``read_frames_dir``): the frames are selected by name (``target_fps`` through the port's
  ``ops/interp.py::linspace_resample_indices``, then ``max_frames``) before any is decoded,
  and PNG frames are decoded without PIL (``io/png.py``, equal to PIL's
  ``convert("RGB")``), unfiltered on ``device`` (the card unless the caller asks for the
  CPU); JPEG and the other image types raise, naming PIL;
- a video file through an ffmpeg rawvideo pipe (``read_video_frames``), with ``ffprobe`` for
  the geometry and rate: the same subprocess argv as the JAX package. Without ffmpeg on
  ``PATH`` it raises the JAX package's message.

Still refused, each naming what is missing on the card's machine: the JAX package's PyAV
route (no ``av`` package there) and the frames of an MJPEG AVI (JPEG needs PIL; the AVI's
PCM audio is read by ``io/avi.py`` without it).
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

from foley_tpu_torch.core.device import DeviceLike
from foley_tpu_torch.io.avi import is_mjpeg_avi, read_avi_info
from foley_tpu_torch.io.png import read_pngs
from foley_tpu_torch.ops.interp import linspace_resample_indices

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff")

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


def read_frames_dir(path: str, fps: float = 16.0, target_fps: Optional[float] = None,
                    max_frames: Optional[int] = None,
                    device: DeviceLike = None) -> Tuple[np.ndarray, float]:
    """A directory of PNG frames -> ([T, H, W, 3] float32 in [0, 1] on the host, effective
    fps), unfiltered on ``device`` (``cuda`` unless given). Every frame must share one size;
    a frame of another image type raises, naming PIL."""
    names, fps = frame_names(path, fps, target_fps, max_frames)
    other = [n for n in names if not n.lower().endswith(".png")]
    if other:
        raise RuntimeError(
            f"{path}: {other[0]} is not a PNG; the port decodes PNG frames without PIL, and "
            "JPEG and the other image types need PIL, which the card's machine has not")
    frames = read_pngs([os.path.join(path, n) for n in names], device)
    return frames.astype(np.float32) / 255.0, fps


def read_video_frames(path: str, target_fps: Optional[float] = None,
                      max_frames: Optional[int] = None, dir_fps: float = 16.0,
                      device: DeviceLike = None) -> Tuple[np.ndarray, float]:
    """A video file (through ffmpeg) or a directory of PNG frames (declared to play at
    ``dir_fps``, unfiltered on ``device``, ``cuda`` unless given) -> ([T, H, W, 3] float32
    in [0, 1], effective fps)."""
    if os.path.isdir(path):
        return read_frames_dir(path, fps=dir_fps, target_fps=target_fps,
                               max_frames=max_frames, device=device)
    if is_mjpeg_avi(path):
        try:
            info = read_avi_info(path)
        except ValueError:
            info = {}
        if info.get("video_compression", info.get("video_handler")) in (b"MJPG", b"mjpg"):
            raise RuntimeError(
                f"{path}: the frames of an MJPEG AVI are JPEG, which needs PIL; the card's "
                "machine has no PIL (its PCM audio reads without it)")
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
