"""Continuous DAC-VAE codec (``foley_tpu/models/dac_vae.py`` counterpart).

Decode: post_quant_conv -> WNConv1d k7 -> 5x DecoderBlock (Snake -> ConvTranspose1d k=2s
-> 3 dilated ResidualUnits) -> Snake -> WNConv1d k7 -> tanh; total upsample x960 => 48 kHz.
Encode: WNConv1d k7 -> 5x EncoderBlock (3 dilated ResidualUnits -> Snake -> strided
WNConv1d k=2s) -> Snake -> WNConv1d k3 -> quant_conv k1 -> a diagonal Gaussian posterior
over the latents (``GaussianPosterior``); continuation and SDEdit take its ``mode()``.
Weight norm is already folded into plain conv weights (as in the JAX tree).

The public functions take channel-last tensors ([B, T, C] latents, [B, T, 1] audio), as in
the JAX package; inside, both halves run channels-first, which is cuDNN's layout, so no
transpose sits between their convolutions. Both are fp32 with TF32 off (``true_fp32``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from foley_tpu_torch.configs import DACConfig
from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.ops.activations import snake
from foley_tpu_torch.ops.nn import init_parameters, true_fp32


class _Conv(nn.Module):
    """Plain conv weights, [out, in, K] (or [in, out, K] when ``transpose``), with the JAX
    package's fan-in-scaled init: trunc_normal(±2 std), std = sqrt(2 / (in * K)), zero bias.
    (The reference's trunc_normal(0.02) would attenuate random-weight smoke runs to
    silence; checkpoint loads overwrite this.)"""

    def __init__(self, in_dim, out_dim, k, dtype, device, transpose=False):
        super().__init__()
        shape = (in_dim, out_dim, k) if transpose else (out_dim, in_dim, k)
        self.fan_in = in_dim * k
        self.weight = nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=dtype, device=device),
                                 requires_grad=False)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        std = (2.0 / self.fan_in) ** 0.5
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
        self.bias.zero_()


def _alpha(dim, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(dim, dtype=dtype, device=device), requires_grad=False)


class ResidualUnit(nn.Module):
    """Snake -> conv k7 dilated -> Snake -> conv k1, residual add (length-preserving)."""

    def __init__(self, dim, dilation, dtype, device):
        super().__init__()
        self.dilation = dilation
        self.alpha1 = _alpha(dim, dtype, device)
        self.conv1 = _Conv(dim, dim, 7, dtype, device)
        self.alpha2 = _alpha(dim, dtype, device)
        self.conv2 = _Conv(dim, dim, 1, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        y = snake(x, self.alpha1[:, None])
        y = F.conv1d(y, self.conv1.weight, self.conv1.bias, padding=3 * self.dilation,
                     dilation=self.dilation)
        y = snake(y, self.alpha2[:, None])
        return x + F.conv1d(y, self.conv2.weight, self.conv2.bias)


class DecoderBlock(nn.Module):
    def __init__(self, in_dim, out_dim, stride, dtype, device):
        super().__init__()
        self.stride = stride
        self.alpha = _alpha(in_dim, dtype, device)
        self.conv_t = _Conv(in_dim, out_dim, 2 * stride, dtype, device, transpose=True)
        self.res = nn.ModuleList(ResidualUnit(out_dim, d, dtype, device) for d in (1, 3, 9))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        s = self.stride
        x = F.conv_transpose1d(snake(x, self.alpha[:, None]), self.conv_t.weight,
                               self.conv_t.bias, stride=s, padding=math.ceil(s / 2),
                               output_padding=s % 2)
        for unit in self.res:
            x = unit(x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: DACConfig, dtype, device):
        super().__init__()
        d = cfg.decoder_dim
        self.conv_in = _Conv(cfg.latent_dim, d, 7, dtype, device)
        self.blocks = nn.ModuleList(
            DecoderBlock(d // 2 ** i, d // 2 ** (i + 1), s, dtype, device)
            for i, s in enumerate(cfg.decoder_rates))
        out_dim = d // 2 ** len(cfg.decoder_rates)
        self.alpha_out = _alpha(out_dim, dtype, device)
        self.conv_out = _Conv(out_dim, 1, 7, dtype, device)


class EncoderBlock(nn.Module):
    def __init__(self, out_dim, stride, dtype, device):
        super().__init__()
        self.stride = stride
        self.res = nn.ModuleList(ResidualUnit(out_dim // 2, d, dtype, device) for d in (1, 3, 9))
        self.alpha = _alpha(out_dim // 2, dtype, device)
        self.conv_d = _Conv(out_dim // 2, out_dim, 2 * stride, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        for unit in self.res:
            x = unit(x)
        return F.conv1d(snake(x, self.alpha[:, None]), self.conv_d.weight, self.conv_d.bias,
                        stride=self.stride, padding=math.ceil(self.stride / 2))


class Encoder(nn.Module):
    def __init__(self, cfg: DACConfig, dtype, device):
        super().__init__()
        e = cfg.encoder_dim
        self.conv_in = _Conv(1, e, 7, dtype, device)
        self.blocks = nn.ModuleList(EncoderBlock(e * 2 ** (i + 1), s, dtype, device)
                                    for i, s in enumerate(cfg.encoder_rates))
        out_dim = e * 2 ** len(cfg.encoder_rates)
        self.alpha_out = _alpha(out_dim, dtype, device)
        self.conv_out = _Conv(out_dim, cfg.latent_dim, 3, dtype, device)


class DAC(nn.Module):
    """The continuous DAC-VAE, encoder and decoder (names follow the JAX tree)."""

    def __init__(self, cfg: DACConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg, dtype, device)
        self.post_quant_conv = _Conv(cfg.latent_dim, cfg.latent_dim, 1, dtype, device)
        # registered after the decoder, so a seed draws the decoder it drew before
        self.encoder = Encoder(cfg, dtype, device)
        self.quant_conv = _Conv(cfg.latent_dim, 2 * cfg.latent_dim, 1, dtype, device)


def init(cfg: DACConfig, generator: torch.Generator, device: DeviceLike = None,
         dtype=torch.float32) -> DAC:
    """A randomly initialized codec, encoder and decoder, on ``device`` (``cuda`` unless
    given); the generator must live on that device."""
    model = DAC(cfg, dtype=dtype, device=resolve_device(device))
    init_parameters(model, generator)
    return model


@torch.no_grad()
def decode(model: DAC, z: torch.Tensor) -> torch.Tensor:
    """Latents [B, T, latent_dim] -> waveform [B, T*hop, 1], fp32 with TF32 off."""
    dec = model.decoder
    with true_fp32():
        x = z.float().transpose(1, 2)  # [B, C, T]
        x = F.conv1d(x, model.post_quant_conv.weight, model.post_quant_conv.bias)
        x = F.conv1d(x, dec.conv_in.weight, dec.conv_in.bias, padding=3)
        for block in dec.blocks:
            x = block(x)
        x = snake(x, dec.alpha_out[:, None])
        x = F.conv1d(x, dec.conv_out.weight, dec.conv_out.bias, padding=3)
        return torch.tanh(x).transpose(1, 2)


# Decoder receptive field in latent frames is about +-12; 32 frames of overlap on each side
# of a window is a 2.6x margin.
_DECODE_OVERLAP = 32


@torch.no_grad()
def decode_chunked(model: DAC, z: torch.Tensor, chunk_frames: int,
                   overlap_frames: int = _DECODE_OVERLAP) -> torch.Tensor:
    """``decode`` in time windows: the same output with about ``chunk/T`` of the decode's
    temporaries. Every kept sample sees >= ``overlap_frames`` latent frames of true context
    on each interior side; head and tail windows start/end at the true sequence edges, so
    their zero padding matches the full decode's. Exact, not an approximation."""
    b, t, _ = z.shape
    ov = overlap_frames
    n = max(1, -(-t // chunk_frames))
    if n >= 2 and t - (n - 1) * chunk_frames < ov:
        n -= 1  # merge a too-short tail into the last window
    if n == 1 or t <= chunk_frames + ov:
        return decode(model, z)
    hop = model.cfg.hop_length
    tail_frames = t - (n - 1) * chunk_frames
    parts = [decode(model, z[:, : chunk_frames + ov])[:, : chunk_frames * hop]]
    for i in range(1, n - 1):
        start = i * chunk_frames - ov
        y = decode(model, z[:, start: start + chunk_frames + 2 * ov])
        parts.append(y[:, ov * hop: ov * hop + chunk_frames * hop])
    parts.append(decode(model, z[:, t - (tail_frames + ov):])[:, ov * hop:])
    return torch.cat(parts, dim=1)


class GaussianPosterior(NamedTuple):
    """Diagonal Gaussian over latents [B, T, latent_dim] (reference ``nn/vae_utils.py``)."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                            dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to the standard normal, summed over time and channels -> [B]."""
        return 0.5 * torch.sum(self.mean.square() + torch.exp(self.logvar) - 1.0 - self.logvar,
                               dim=(1, 2))


@torch.no_grad()
def encode(model: DAC, audio: torch.Tensor) -> GaussianPosterior:
    """Waveform [B, T, 1] (T a hop multiple, see ``preprocess``) -> the posterior over
    latents [B, T/hop, latent_dim], fp32 with TF32 off."""
    enc = model.encoder
    with true_fp32():
        x = audio.float().transpose(1, 2)  # [B, 1, T]
        x = F.conv1d(x, enc.conv_in.weight, enc.conv_in.bias, padding=3)
        for block in enc.blocks:
            x = block(x)
        x = snake(x, enc.alpha_out[:, None])
        x = F.conv1d(x, enc.conv_out.weight, enc.conv_out.bias, padding=1)
        moments = F.conv1d(x, model.quant_conv.weight, model.quant_conv.bias).transpose(1, 2)
    mean, logvar = moments.chunk(2, dim=-1)
    return GaussianPosterior(mean, torch.clamp(logvar, -30.0, 20.0))


def preprocess(audio: torch.Tensor, cfg: DACConfig) -> torch.Tensor:
    """Right-pad [B, T, 1] audio with zeros to a hop multiple (reference ``dac.py:225-234``)."""
    right = math.ceil(audio.shape[1] / cfg.hop_length) * cfg.hop_length - audio.shape[1]
    return F.pad(audio, (0, 0, 0, right)) if right else audio
