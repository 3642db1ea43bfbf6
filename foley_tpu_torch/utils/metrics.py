"""Audio parity metrics (``foley_tpu/utils/metrics.py`` counterpart, the same float64
numpy on the host).

The parity criterion is at least 99% spectral correlation against the reference's output
for matched inputs: the Pearson correlation of two waveforms' magnitude STFTs; and the SNR
of an estimate against a reference in dB.
"""

from __future__ import annotations

import numpy as np


def _mag_stft(x: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    pad = n_fft // 2
    xp = np.pad(np.asarray(x, np.float64).reshape(-1), (pad, pad), mode="reflect")
    frames = 1 + (len(xp) - n_fft) // hop
    out = np.empty((n_fft // 2 + 1, frames))
    for t in range(frames):
        out[:, t] = np.abs(np.fft.rfft(xp[t * hop : t * hop + n_fft] * window))
    return out


def spectral_correlation(x: np.ndarray, y: np.ndarray, n_fft: int = 1024, hop: int = 256) -> float:
    """Pearson correlation between magnitude spectrograms of two waveforms in [0, 1]."""
    n = min(np.asarray(x).reshape(-1).shape[0], np.asarray(y).reshape(-1).shape[0])
    mx = _mag_stft(np.asarray(x).reshape(-1)[:n], n_fft, hop).reshape(-1)
    my = _mag_stft(np.asarray(y).reshape(-1)[:n], n_fft, hop).reshape(-1)
    mx = mx - mx.mean()
    my = my - my.mean()
    denom = np.sqrt((mx * mx).sum() * (my * my).sum()) + 1e-12
    return float((mx * my).sum() / denom)


def snr_db(estimate: np.ndarray, reference: np.ndarray) -> float:
    e = np.asarray(estimate, np.float64).reshape(-1)
    r = np.asarray(reference, np.float64).reshape(-1)
    n = min(len(e), len(r))
    e, r = e[:n], r[:n]
    noise = e - r
    return float(10 * np.log10((r ** 2).sum() / ((noise ** 2).sum() + 1e-20)))
