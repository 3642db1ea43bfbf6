"""Synchformer's audio preprocessing: STFT, HTK mel spectrogram and the 16 kHz segments
(``foley_tpu/ops/audio_dsp.py`` counterpart, the parts the desync scorer reaches).

torchaudio's ``MelSpectrogram(sr=16000, win_length=400, hop_length=160, n_fft=1024,
n_mels=128)`` (reference ``synchformer.py:349-355``): a periodic Hann window zero-padded to
``n_fft``, a centred reflect-padded STFT in fp32 (``torch.fft.rfft``; cuFFT on the card, so
the bins differ from XLA's FFT in the last places), the power spectrum, an HTK triangular
filterbank without normalisation (built in float64 numpy, as in the JAX package), then
``log(mel + 1e-6)``, padded or cut to 66 frames, and AST's normalisation.

The DAC's training uses the rest: the Slaney-scale, Slaney-normalised mel basis of its mel
loss (librosa's defaults, built in float64 numpy as in the JAX package) and julius's
polyphase sinc resampler behind the multi-scale discriminator's ``rate > 1``.
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


def _hz_to_mel_slaney(f):
    """librosa's ``hz_to_mel(htk=False)``: linear below 1 kHz, log-spaced above."""
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-12) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def mel_filterbank_slaney_np(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                             f_max: Optional[float] = None) -> np.ndarray:
    """``[n_freqs, n_mels]`` Slaney-scale, Slaney-normalised filterbank (``librosa.filters.mel``
    with ``htk=False, norm="slaney"``, which audiotools' mel spectrogram builds): float64
    arithmetic rounded to fp32."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    fftfreqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_f = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max),
                                          n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights = weights * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_filterbank_slaney(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                          f_max: Optional[float] = None) -> np.ndarray:
    """``mel_filterbank_slaney_np``, cached. Read-only: the cache shares it."""
    fb = mel_filterbank_slaney_np(n_freqs, n_mels, sample_rate, f_min, f_max)
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


def _sinc_resample_kernel(old_sr: int, new_sr: int, zeros: int, rolloff: float):
    """julius ``ResampleFrac``'s polyphase bank: one FIR of length ``2 * width + old_sr`` a
    output phase, a Hann^2 (cos^2) windowed sinc at cutoff ``min(old, new) * rolloff``,
    scaled by cutoff / old_sr; float64 on the host. Returns (kernel [new_sr, K] fp32, width)."""
    sr = min(new_sr, old_sr) * rolloff
    width = math.ceil(zeros * old_sr / sr)
    idx = np.arange(-width, width + old_sr, dtype=np.float64)
    kernels = []
    for i in range(new_sr):
        t = np.clip((-i / new_sr + idx / old_sr) * sr, -zeros, zeros) * np.pi
        window = np.cos(t / zeros / 2) ** 2
        kernels.append(np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window)
    return np.stack(kernels).astype(np.float32) * np.float32(sr / old_sr), width


def resample_poly(x: torch.Tensor, orig_sr: int, target_sr: int, zeros: int = 24,
                  rolloff: float = 0.945) -> torch.Tensor:
    """Polyphase sinc resampling of ``x [..., T]`` from ``orig_sr`` to ``target_sr`` (julius
    ``resample_frac``, behind audiotools' ``AudioSignal.resample`` in the multi-scale
    discriminator): zero-pad ``(width, width + old_sr)``, one ``F.conv1d`` of stride
    ``old_sr`` carrying every phase, the phases interleaved in time, cut to
    ``int(new_sr * T / old_sr)`` samples (the rates reduced by their gcd). fp32 in true fp32."""
    g = math.gcd(int(orig_sr), int(target_sr))
    old_sr, new_sr = int(orig_sr) // g, int(target_sr) // g
    if old_sr == new_sr:
        return x
    length = x.shape[-1]
    kernel, width = _sinc_resample_kernel(old_sr, new_sr, zeros, rolloff)
    xp = F.pad(x.reshape(-1, 1, length).float(), (width, width + old_sr))
    with true_fp32():
        ys = F.conv1d(xp, torch.from_numpy(kernel).to(x.device)[:, None, :], stride=old_sr)
    y = ys.transpose(1, 2).reshape(ys.shape[0], -1)  # [B, T' * new_sr], phases interleaved
    return y[:, :int(new_sr * length / old_sr)].reshape(*x.shape[:-1], -1).to(x.dtype)
