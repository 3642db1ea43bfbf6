"""The DAC-VAE decoder (``dac_vae``'s ``DAC.decode``) in plain fp32 PyTorch, read from a
checkpoint-layout state dict: weight norm as published (w = g v / ||v||, the norm over
every axis but the first), post_quant_conv, conv k7, one block a rate (Snake, transposed
conv of kernel 2s, stride s, padding ceil(s/2), output padding s % 2, three residual units
of dilation 1, 3, 9), Snake, conv k7, tanh. Snake is x + sin(alpha x)^2 / (alpha + 1e-9).
Channels-first [B, C, T] inside; the public function takes latents [B, T, C] and returns
audio [B, T * hop]. It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def weight(W, name):
    """A convolution's weight: folded from its weight-norm pair, or as stored."""
    if name + ".weight_v" in W:
        v, g = W[name + ".weight_v"], W[name + ".weight_g"]
        norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
        return g * v / norm
    return W[name + ".weight"]


def _snake(W, name, x):
    a = W[name + ".alpha"]
    return x + torch.sin(a * x).pow(2) / (a + 1e-9)


def _conv(W, name, x, **kw):
    return F.conv1d(x, weight(W, name), W[name + ".bias"], **kw)


def _residual(W, p, x, dilation):
    y = _snake(W, p + ".block.0", x)
    y = _conv(W, p + ".block.1", y, padding=3 * dilation, dilation=dilation)
    y = _conv(W, p + ".block.3", _snake(W, p + ".block.2", y))
    return x + y


def decode(W, d, z):
    """Latents [B, T, latent_dim] -> audio [B, T * hop] in [-1, 1]. ``d``: the configuration's
    ``dac`` group."""
    x = _conv(W, "post_quant_conv", z.transpose(1, 2))
    x = _conv(W, "decoder.model.0", x, padding=3)
    rates = d["decoder_rates"]
    for i, s in enumerate(rates):
        b = f"decoder.model.{i + 1}.block"
        x = F.conv_transpose1d(_snake(W, b + ".0", x), weight(W, b + ".1"), W[b + ".1.bias"],
                               stride=s, padding=math.ceil(s / 2), output_padding=s % 2)
        for j, dil in zip((2, 3, 4), (1, 3, 9)):
            x = _residual(W, f"{b}.{j}", x, dil)
    x = _snake(W, f"decoder.model.{len(rates) + 1}", x)
    x = _conv(W, f"decoder.model.{len(rates) + 2}", x, padding=3)
    return torch.tanh(x)[:, 0]


def to_pcm16(audio):
    """The 16-bit PCM a WAV holds: clip to [-1, 1], times 32767, round half to even."""
    return torch.round(torch.clamp(audio, -1.0, 1.0) * 32767.0)
