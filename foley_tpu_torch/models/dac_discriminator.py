"""The DAC's GAN discriminators (``foley_tpu/models/dac_discriminator.py`` counterpart).

Reference ``dac_vae/model/discriminator.py``: multi-period (MPD, periods 2, 3, 5, 7, 11),
multi-scale (MSD) and multi-resolution complex-STFT (MRD, FFT sizes 2048, 1024, 512, five
frequency bands) discriminators, each returning its pyramid of feature maps for feature
matching. LeakyReLU(0.1) follows every conv but the posts; the input is DC-removed and
peak-normalised to 0.8.

The maps run channels-first, cuDNN's layout, so no transpose sits between the convs (the
JAX package runs them channel-last): MPD ``[B, C, T/p, p]``, MSD ``[B, C, T']``, MRD
``[B, C, frames, freq]`` with the bands concatenated along frequency. A map of the JAX
package is the port's with its channel axis moved last. Weights are ``F.conv2d`` /
``F.conv1d``'s ``[out, in/groups, K...]`` (``io/from_jax.py`` converts the JAX HWIO ones).
fp32 in true fp32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.models.dac_losses import frames, reflect_pad
from foley_tpu_torch.ops.audio_dsp import resample_poly
from foley_tpu_torch.ops.nn import Conv1d, Conv2d, init_parameters, true_fp32

BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
_MPD_CHANNELS = ((1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024))
_MSD_SPECS = (  # (cin, cout, k, stride, groups, pad)
    (1, 16, 15, 1, 1, 7),
    (16, 64, 41, 4, 4, 20),
    (64, 256, 41, 4, 16, 20),
    (256, 1024, 41, 4, 64, 20),
    (1024, 1024, 41, 4, 256, 20),
    (1024, 1024, 5, 1, 1, 2),
)
_MRD_CH = 32


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    rates: Tuple[int, ...] = ()
    fft_sizes: Tuple[int, ...] = (2048, 1024, 512)
    sample_rate: int = 48000


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class MPD(nn.Module):
    def __init__(self, dtype, device):
        super().__init__()
        self.convs = nn.ModuleList(Conv2d(cin, cout, (5, 1), dtype=dtype, device=device)
                                   for cin, cout in _MPD_CHANNELS)
        self.post = Conv2d(1024, 1, (3, 1), dtype=dtype, device=device)


class MSD(nn.Module):
    def __init__(self, dtype, device):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(cin // groups, cout, k, dtype=dtype, device=device)
                                   for cin, cout, k, _, groups, _ in _MSD_SPECS)
        self.post = Conv1d(1024, 1, 3, dtype=dtype, device=device)


class MRD(nn.Module):
    def __init__(self, dtype, device, n_bands: int = len(BANDS)):
        super().__init__()
        ch = _MRD_CH

        def band():
            return nn.ModuleList([Conv2d(2, ch, (3, 9), dtype=dtype, device=device)]
                                 + [Conv2d(ch, ch, (3, 9), dtype=dtype, device=device)
                                    for _ in range(3)]
                                 + [Conv2d(ch, ch, (3, 3), dtype=dtype, device=device)])

        self.band_convs = nn.ModuleList(band() for _ in range(n_bands))
        self.post = Conv2d(ch, 1, (3, 3), dtype=dtype, device=device)


class Discriminator(nn.Module):
    """``mpd.<i>``, ``msd.<i>``, ``mrd.<i>``: one sub-discriminator per period, rate and FFT
    size of ``cfg`` (the JAX tree's names)."""

    def __init__(self, cfg: DiscriminatorConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.mpd = nn.ModuleList(MPD(dtype, device) for _ in cfg.periods)
        self.msd = nn.ModuleList(MSD(dtype, device) for _ in cfg.rates)
        self.mrd = nn.ModuleList(MRD(dtype, device) for _ in cfg.fft_sizes)


def init(cfg: DiscriminatorConfig, generator: torch.Generator, device: DeviceLike = None,
         dtype=torch.float32) -> Discriminator:
    """Random discriminators on ``device`` (``cuda`` unless given): every weight and bias
    uniform in +-1/sqrt(fan_in), as the JAX ``init`` draws."""
    model = Discriminator(cfg, dtype=dtype, device=resolve_device(device))
    init_parameters(model, generator)
    return model


def apply_mpd(m: MPD, x: torch.Tensor, period: int) -> List[torch.Tensor]:
    """x [B, 1, T] -> maps [B, C, T/p, p]: the period reshape, then (5, 1) convs of stride
    (3, 1) along the length axis (reference ``discriminator.py:27-62``)."""
    t = x.shape[-1]
    x = reflect_pad(x, 0, period - t % period)
    x = x.reshape(x.shape[0], 1, -1, period)
    fmap = []
    for i, conv in enumerate(m.convs):
        x = _leaky(F.conv2d(x, conv.weight, conv.bias, stride=(3, 1) if i < 4 else (1, 1),
                            padding=(2, 0)))
        fmap.append(x)
    fmap.append(F.conv2d(x, m.post.weight, m.post.bias, padding=(1, 0)))
    return fmap


def apply_msd(m: MSD, x: torch.Tensor, rate: int = 1) -> List[torch.Tensor]:
    """x [B, 1, T] -> maps [B, C, T']; ``rate > 1`` first resamples by 1/rate with julius's
    polyphase filter (reference ``discriminator.py:95-118``)."""
    if rate > 1:
        x = resample_poly(x[:, 0], rate, 1)[:, None]
    fmap = []
    for conv, (_, _, _, stride, groups, pad) in zip(m.convs, _MSD_SPECS):
        x = _leaky(F.conv1d(x, conv.weight, conv.bias, stride=stride, padding=pad,
                            groups=groups))
        fmap.append(x)
    fmap.append(F.conv1d(x, m.post.weight, m.post.bias, padding=1))
    return fmap


def mrd_band_indices(window_length: int, bands: Sequence = BANDS):
    n_fft_bins = window_length // 2 + 1
    return [(int(b0 * n_fft_bins), int(b1 * n_fft_bins)) for b0, b1 in bands]


def complex_spectrogram(x: torch.Tensor, window_length: int) -> torch.Tensor:
    """[B, T] -> [B, 2, frames, freq] (real and imaginary channels), hop = window / 4.

    audiotools' STFT with ``match_stride=True`` (reference ``discriminator.py:126-131,
    149-156``): reflect-pad by ``((w - h) // 2, (w - h) // 2 + ceil(T / h) * h - T)``, then
    a centred STFT, a second reflect pad of w / 2 on the padded signal (two stages, not one
    fused pad), then the first and last two frames dropped so ``ceil(T / h)`` remain."""
    w = window_length
    hop = w // 4
    t = x.shape[-1]
    right_pad = -(-t // hop) * hop - t
    p1 = (w - hop) // 2
    xp = reflect_pad(reflect_pad(x.float(), p1, p1 + right_pad), w // 2, w // 2)
    spec = torch.fft.rfft(frames(xp, w, hop), dim=-1)[:, 2:-2]  # [B, frames, freq]
    return torch.stack([spec.real, spec.imag], dim=1)


def apply_mrd(m: MRD, x: torch.Tensor, window_length: int,
              bands: Sequence = BANDS) -> List[torch.Tensor]:
    """x [B, 1, T] -> maps over five frequency bands, then the post conv over the bands
    concatenated along frequency (reference ``discriminator.py:101-172``)."""
    spec = complex_spectrogram(x[:, 0], window_length)
    fmap, outs = [], []
    for (b0, b1), convs in zip(mrd_band_indices(window_length, bands), m.band_convs):
        band = spec[..., b0:b1]
        for i, conv in enumerate(convs):
            if i == 0:
                band = F.conv2d(band, conv.weight, conv.bias, padding=(1, 4))
            elif i < 4:
                band = F.conv2d(band, conv.weight, conv.bias, stride=(1, 2), padding=(1, 4))
            else:
                band = F.conv2d(band, conv.weight, conv.bias, padding=(1, 1))
            band = _leaky(band)
            fmap.append(band)
        outs.append(band)
    fmap.append(F.conv2d(torch.cat(outs, dim=3), m.post.weight, m.post.bias, padding=(1, 1)))
    return fmap


def preprocess(y: torch.Tensor) -> torch.Tensor:
    """DC removal and 0.8 peak normalisation over time (reference ``discriminator.py:
    207-212``), y [B, T, 1]."""
    y = y - y.mean(dim=1, keepdim=True)
    peak = y.abs().amax(dim=1, keepdim=True)
    return 0.8 * y / (peak + 1e-9)


def apply(model: Discriminator, x: torch.Tensor) -> List[List[torch.Tensor]]:
    """Waveform [B, T, 1] -> the feature-map pyramid of every sub-discriminator, MPDs, then
    MSDs, then MRDs."""
    cfg = model.cfg
    with true_fp32():
        x = preprocess(x.float()).transpose(1, 2)  # [B, 1, T]
        fmaps = [apply_mpd(m, x, p) for m, p in zip(model.mpd, cfg.periods)]
        fmaps += [apply_msd(m, x, r) for m, r in zip(model.msd, cfg.rates)]
        fmaps += [apply_mrd(m, x, w) for m, w in zip(model.mrd, cfg.fft_sizes)]
    return fmaps
