"""The DAC's training losses (``foley_tpu/models/dac_losses.py`` counterpart).

Reference ``dac_vae/nn/loss.py``: the L1 waveform loss, SI-SDR, the multi-scale STFT loss
(L1 of log10 magnitude and of magnitude over window sizes), the mel-spectrogram loss (a
Slaney basis on the magnitude STFT) and the LSGAN adversarial and feature-matching losses.
Waveforms are ``[..., T]``. The STFTs are centred and reflect-padded with a periodic Hann
window (``torch.fft.rfft`` in fp32; cuFFT on the card, whose bins differ from XLA's in the
last places); the mel products run in true fp32. The feature maps may lie in any layout:
every loss is a mean.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from foley_tpu_torch.ops.audio_dsp import hann_window, mel_filterbank_slaney
from foley_tpu_torch.ops.nn import true_fp32


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def sisdr_loss(x: torch.Tensor, y: torch.Tensor, zero_mean: bool = True,
               clip_min: Optional[float] = None, eps: float = 1e-8) -> torch.Tensor:
    """Negative scale-invariant SDR in dB (reference ``loss.py:51-140``), x the estimate,
    y the reference; lower is better."""
    if zero_mean:
        x = x - x.mean(dim=-1, keepdim=True)
        y = y - y.mean(dim=-1, keepdim=True)
    dot = (x * y).sum(dim=-1, keepdim=True)
    s_ref_energy = (y * y).sum(dim=-1, keepdim=True) + eps
    proj = dot * y / s_ref_energy
    noise = x - proj
    ratio = ((proj * proj).sum(dim=-1) + eps) / ((noise * noise).sum(dim=-1) + eps)
    sdr = 10.0 * torch.log10(ratio)
    if clip_min is not None:
        sdr = torch.clamp_min(sdr, clip_min)
    return -sdr.mean()


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``jnp.pad(mode="reflect")`` on the last axis of ``x [..., T]`` (``F.pad`` reflects
    only 2-D / 3-D inputs, so the leading axes fold into one)."""
    lead = x.shape[:-1]
    return F.pad(x.reshape(-1, 1, x.shape[-1]), (left, right), mode="reflect").reshape(
        *lead, -1)


def frames(x: torch.Tensor, window_length: int, hop: int) -> torch.Tensor:
    """Hann-windowed frames of ``x [..., T]`` at ``hop``: ``[..., n_frames, window_length]``."""
    return x.unfold(-1, window_length, hop) * hann_window(window_length, x.device)


def stft_mag(x: torch.Tensor, window_length: int, hop: int) -> torch.Tensor:
    """Magnitude STFT ``[..., freq, frames]`` (Hann window, centred, reflect-padded)."""
    pad = window_length // 2
    spec = torch.fft.rfft(frames(reflect_pad(x.float(), pad, pad), window_length, hop), dim=-1)
    return spec.abs().transpose(-1, -2)


def multiscale_stft_loss(x: torch.Tensor, y: torch.Tensor,
                         window_lengths: Sequence[int] = (2048, 512), clamp_eps: float = 1e-5,
                         mag_weight: float = 1.0, log_weight: float = 1.0,
                         pow: float = 2.0) -> torch.Tensor:
    """Reference ``loss.py:142-228``: for each window, L1 on log10(mag ** pow) plus L1 on the
    magnitude, hop = window / 4."""
    loss = x.new_zeros(())
    for w in window_lengths:
        mx, my = stft_mag(x, w, w // 4), stft_mag(y, w, w // 4)
        loss = loss + log_weight * l1_loss(torch.log10(torch.clamp_min(mx, clamp_eps) ** pow),
                                           torch.log10(torch.clamp_min(my, clamp_eps) ** pow))
        loss = loss + mag_weight * l1_loss(mx, my)
    return loss


def mel_spectrogram_loss(x: torch.Tensor, y: torch.Tensor, sample_rate: int = 48000,
                         n_mels: Sequence[int] = (150, 80),
                         window_lengths: Sequence[int] = (2048, 512), clamp_eps: float = 1e-5,
                         mag_weight: float = 1.0, log_weight: float = 1.0,
                         pow: float = 2.0) -> torch.Tensor:
    """Reference ``loss.py:231-368``: audiotools' mel spectrogram applies a Slaney basis to
    the magnitude STFT (not the power), then L1 on ``log10(max(mel, eps) ** pow)`` plus L1
    on the mel magnitudes."""
    loss = x.new_zeros(())
    for mels, w in zip(n_mels, window_lengths):
        mx, my = stft_mag(x, w, w // 4), stft_mag(y, w, w // 4)
        fb = torch.from_numpy(mel_filterbank_slaney(w // 2 + 1, mels, sample_rate).copy())
        fb = fb.to(mx.device)
        with true_fp32():
            mel_x = torch.einsum("...ft,fm->...mt", mx, fb)
            mel_y = torch.einsum("...ft,fm->...mt", my, fb)
        loss = loss + log_weight * l1_loss(
            torch.log10(torch.clamp_min(mel_x, clamp_eps) ** pow),
            torch.log10(torch.clamp_min(mel_y, clamp_eps) ** pow))
        loss = loss + mag_weight * l1_loss(mel_x, mel_y)
    return loss


# ---------------------------------------------------------------------------------
# GAN losses (HiFi-GAN style, reference GANLoss in loss.py)
# ---------------------------------------------------------------------------------

FeatureMaps = List[List[torch.Tensor]]


def discriminator_loss(real_fmaps: FeatureMaps, fake_fmaps: FeatureMaps) -> torch.Tensor:
    """LSGAN discriminator loss over each sub-discriminator's final logits."""
    loss = real_fmaps[0][-1].new_zeros(())
    for real, fake in zip(real_fmaps, fake_fmaps):
        loss = loss + (1.0 - real[-1]).square().mean() + fake[-1].square().mean()
    return loss


def generator_adv_loss(fake_fmaps: FeatureMaps) -> torch.Tensor:
    loss = fake_fmaps[0][-1].new_zeros(())
    for fake in fake_fmaps:
        loss = loss + (1.0 - fake[-1]).square().mean()
    return loss


def feature_matching_loss(real_fmaps: FeatureMaps, fake_fmaps: FeatureMaps) -> torch.Tensor:
    """L1 between the fake and the (detached) real intermediate maps, all but the logits."""
    loss = real_fmaps[0][-1].new_zeros(())
    for real, fake in zip(real_fmaps, fake_fmaps):
        for r, f in zip(real[:-1], fake[:-1]):
            loss = loss + l1_loss(f, r.detach())
    return loss
