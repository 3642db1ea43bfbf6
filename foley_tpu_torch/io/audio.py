"""Audio IO: WAV writing and reading (``foley_tpu/io/audio.py`` counterpart).

Waveforms are 48 kHz AUDIO dicts, written as 16-bit PCM WAV through ``io/native.py``.
``merge_audio_video`` muxes audio onto a video file with the JAX package's ffmpeg command,
and onto a frames directory without ffmpeg: an MJPEG + PCM AVI (``io/avi.py``, its JPEGs
encoded on the device).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from foley_tpu_torch.core.device import DeviceLike
from foley_tpu_torch.io.native import MediaProcessingError, load_wav_mono, wav_image

__all__ = ["MediaProcessingError", "merge_audio_video", "read_wav", "write_wav"]

AUDIO_QUALITY_SETTINGS = {"high": ["-b:a", "192k"], "medium": ["-b:a", "128k"],
                          "low": ["-b:a", "96k"]}


def write_wav(path: str, waveform: np.ndarray, sample_rate: int = 48000) -> None:
    """Write a [C, T] or [T] float waveform in [-1, 1] as a 16-bit PCM WAV file."""
    wav = np.asarray(waveform, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    if wav.ndim != 2:
        raise ValueError(f"expected [C, T], got {wav.shape}")
    with open(path, "wb") as f:
        f.write(wav_image(wav, sample_rate))


def read_wav(path: str, target_sr: Optional[int] = None) -> "tuple[np.ndarray, int]":
    """A WAV file -> (mono fp32 [T] in [-1, 1], sample rate): PCM 16/24/32-bit and IEEE
    float32, channels averaged, resampled linearly to ``target_sr`` when given."""
    return load_wav_mono(path, target_sr)


def merge_audio_video(video_path: str, audio_path: str, output_path: str,
                      quality: str = "high", ffmpeg_bin: Optional[str] = None,
                      frames_fps: float = 16.0, device: DeviceLike = None) -> str:
    """Mux audio onto a video file with ffmpeg: the video stream copied, the mono audio
    panned to AAC stereo (the JAX package's command). Returns ``output_path``. A frames
    directory needs no ffmpeg: its frames (at ``frames_fps``, the rate they were conditioned
    at) and the audio are muxed into an MJPEG + PCM AVI, its JPEGs encoded on ``device``
    (``cuda`` unless given), and the ``.avi`` path written is returned."""
    if os.path.isdir(video_path):
        from foley_tpu_torch.io.avi import merge_frames_dir_audio

        return merge_frames_dir_audio(video_path, audio_path, output_path, fps=frames_fps,
                                      quality=quality, device=device)
    ffmpeg = ffmpeg_bin or shutil.which("ffmpeg")
    if ffmpeg is None:
        raise MediaProcessingError(
            "ffmpeg not found (required to mux onto a video FILE; a frames directory "
            "input muxes without it). Install ffmpeg: https://ffmpeg.org/download.html")
    cmd = [ffmpeg, "-y", "-i", video_path, "-i", audio_path, "-c:v", "copy", "-c:a", "aac",
           "-ac", "2", "-af", "pan=stereo|c0=c0|c1=c0",
           *AUDIO_QUALITY_SETTINGS.get(quality, AUDIO_QUALITY_SETTINGS["high"]),
           "-map", "0:v:0", "-map", "1:a:0", "-shortest", output_path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise MediaProcessingError(f"ffmpeg failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return output_path
