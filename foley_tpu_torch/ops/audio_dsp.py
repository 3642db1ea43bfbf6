"""Synchformer's audio preprocessing: STFT, HTK mel spectrogram and the 16 kHz segments
(``foley_tpu/ops/audio_dsp.py`` counterpart, the parts the desync scorer reaches).

torchaudio's ``MelSpectrogram(sr=16000, win_length=400, hop_length=160, n_fft=1024,
n_mels=128)`` (reference ``synchformer.py:349-355``): a periodic Hann window zero-padded to
``n_fft``, a centred reflect-padded STFT in fp32 (``torch.fft.rfft``; cuFFT on the card, so
the bins differ from XLA's FFT in the last places), the power spectrum, an HTK triangular
filterbank without normalisation (built in float64 numpy, as in the JAX package), then
``log(mel + 1e-6)``, padded or cut to 66 frames, and AST's normalisation. The Slaney
filterbank and ``resample_poly`` serve the DAC's training losses and are not here.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from foley_tpu_torch.ops.nn import divide, true_fp32

SYNC_MEAN, SYNC_STD = -4.2677393, 4.5689974  # AST's normalisation (synchformer.py:294-317)


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(periodic=True)``), in fp32 arithmetic."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / win_length))


def stft_power(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
               win_length: int = 400, center: bool = True) -> torch.Tensor:
    """|STFT|^2 of ``x [..., T]`` -> ``[..., n_fft // 2 + 1, 1 + T // hop]`` fp32."""
    left = (n_fft - win_length) // 2
    window = F.pad(hann_window(win_length, x.device), (left, n_fft - win_length - left))
    lead = x.shape[:-1]
    x = x.float().reshape(-1, 1, x.shape[-1])
    if center:
        x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    frames = x[:, 0].unfold(-1, n_fft, hop_length) * window  # [N, frames, n_fft]
    power = torch.fft.rfft(frames, n=n_fft, dim=-1).abs() ** 2
    return power.transpose(-1, -2).reshape(*lead, n_fft // 2 + 1, -1)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int = 513, n_mels: int = 128, sample_rate: int = 16000,
                   f_min: float = 0.0, f_max: Optional[float] = None) -> np.ndarray:
    """``[n_freqs, n_mels]`` HTK triangular filterbank without normalisation (torchaudio's
    defaults), float64 arithmetic rounded to fp32. Read-only: the cache shares it."""
    f_max = f_max or sample_rate / 2.0
    freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    f_pts = _mel_to_hz_htk(np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max),
                                       n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up)).astype(np.float32)
    fb.flags.writeable = False
    return fb


def mel_spectrogram(x: torch.Tensor, sample_rate: int = 16000, n_fft: int = 1024,
                    hop_length: int = 160, win_length: int = 400,
                    n_mels: int = 128) -> torch.Tensor:
    """``x [..., T]`` waveform -> ``[..., n_mels, frames]`` power mel spectrogram (the
    filterbank product in true fp32)."""
    power = stft_power(x, n_fft, hop_length, win_length)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate).copy())
    with true_fp32():
        return torch.einsum("...ft,fm->...mt", power, fb.to(power.device))


def sync_audio_spectrogram(x: torch.Tensor, max_spec_t: int = 66) -> torch.Tensor:
    """Synchformer's audio input (reference ``synchformer.py:294-317``): mel, log(x + 1e-6),
    time padded with zeros or cut to ``max_spec_t``, then ``(x - mean) / (2 std)``.
    ``x [..., T]`` 16 kHz -> ``[..., 128, max_spec_t]``."""
    logmel = torch.log(mel_spectrogram(x) + 1e-6)
    t = logmel.shape[-1]
    if t < max_spec_t:
        logmel = F.pad(logmel, (0, max_spec_t - t))
    else:
        logmel = logmel[..., :max_spec_t]
    return divide(logmel - SYNC_MEAN, 2 * SYNC_STD)


def segment_audio(x: torch.Tensor, segment_size: int = 10240,
                  step_size: int = 5120) -> torch.Tensor:
    """``[B, T]`` 16 kHz -> ``[B, S, segment_size]`` windows at ``step_size`` (reference
    ``synchformer.py:299-306``). A waveform shorter than a segment gives one window whose
    indices past its end read its last sample, as the JAX gather clamps them."""
    t = x.shape[-1]
    num = max((t - segment_size) // step_size + 1, 1)
    idx = (torch.arange(num, device=x.device)[:, None] * step_size
           + torch.arange(segment_size, device=x.device)[None, :]).clamp_(max=t - 1)
    return x[..., idx]
