"""Audio IO: WAV writing and reading (``foley_tpu/io/audio.py`` counterpart).

Waveforms are 48 kHz AUDIO dicts, written as 16-bit PCM WAV through ``io/native.py``. Muxing
audio onto video needs ffmpeg, which the card's machine lacks, and the JAX package's
no-ffmpeg fallback (an MJPEG AVI writer) needs PIL: both wait for ROADMAP item 13, and
``merge_audio_video`` raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from foley_tpu_torch.io.native import MediaProcessingError, load_wav_mono, wav_image

__all__ = ["MediaProcessingError", "merge_audio_video", "read_wav", "write_wav"]


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
                      frames_fps: float = 16.0) -> str:
    """Muxing audio onto a video is not ported: it needs ffmpeg or PIL (ROADMAP item 13)."""
    raise MediaProcessingError(
        "merge_audio_video is not ported: muxing needs ffmpeg (a video file) or PIL (a "
        "frames directory's AVI), which wait for ROADMAP item 13")
