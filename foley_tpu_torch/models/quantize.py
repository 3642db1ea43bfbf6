"""Residual vector quantization, the DAC codec's discrete branch
(``foley_tpu/models/quantize.py`` counterpart).

ViT-VQGAN-style factorized codebooks (reference ``dac_vae/nn/quantize.py``): each stage
projects the residual to ``codebook_dim``, picks the nearest L2-normalised code, and
projects back; 9 stages of 1024 x 8 by default. Latents are channel-last ``[B, T, D]``, as
in the JAX package. The straight-through estimator is ``z_e + (z_q - z_e).detach()``, so
the quantizer is differentiable under autograd; ties in the nearest code take the first
index, as ``jnp.argmin`` does. fp32 in true fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.ops.nn import dense, empty_parameter, init_parameters, true_fp32


@dataclasses.dataclass(frozen=True)
class RVQConfig:
    input_dim: int = 128
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8


class RVQOutput(NamedTuple):
    z_q: torch.Tensor              # [B, T, D] quantized continuous representation
    codes: torch.Tensor            # [B, N, T] codebook indices
    latents: torch.Tensor          # [B, T, N*dim] projected pre-quantization latents
    commitment_loss: torch.Tensor  # scalar
    codebook_loss: torch.Tensor    # scalar


class _Proj(nn.Module):
    """A folded 1x1 weight-normed conv as a dense [out, in], zero bias at init."""

    def __init__(self, in_dim: int, out_dim: int, dtype, device):
        super().__init__()
        self.weight = empty_parameter(out_dim, in_dim, dtype=dtype, device=device)
        self.bias = empty_parameter(out_dim, dtype=dtype, device=device)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        limit = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-limit, limit, generator=g)
        self.bias.zero_()


class VectorQuantizer(nn.Module):
    def __init__(self, cfg: RVQConfig, dtype, device):
        super().__init__()
        self.in_proj = _Proj(cfg.input_dim, cfg.codebook_dim, dtype, device)
        self.out_proj = _Proj(cfg.codebook_dim, cfg.input_dim, dtype, device)
        self.codebook = empty_parameter(cfg.codebook_size, cfg.codebook_dim, dtype=dtype,
                                        device=device)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.codebook.normal_(generator=g)


class RVQ(nn.Module):
    """The stages, ``quantizers.<i>`` (the JAX tree's names)."""

    def __init__(self, cfg: RVQConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.quantizers = nn.ModuleList(VectorQuantizer(cfg, dtype, device)
                                        for _ in range(cfg.n_codebooks))


def init(cfg: RVQConfig, generator: torch.Generator, device: DeviceLike = None,
         dtype=torch.float32) -> RVQ:
    """A random quantizer on ``device`` (``cuda`` unless given): projections uniform in
    +-1/sqrt(in) with zero biases, codebooks standard normal, as the JAX ``init`` draws."""
    model = RVQ(cfg, dtype=dtype, device=resolve_device(device))
    init_parameters(model, generator)
    return model


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(x.square().sum(dim=-1, keepdim=True).sqrt(), eps)


def _nearest(enc: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin of the squared distance from normalised ``enc [B, T, d]`` to the normalised
    codes, the JAX package's expansion ``|e|^2 - 2 e.c + |c|^2`` -> [B, T]."""
    cb = _l2n(codebook)
    dist = (enc.square().sum(dim=-1, keepdim=True) - 2.0 * torch.einsum("btd,nd->btn", enc, cb)
            + cb.square().sum(dim=-1)[None, None, :])
    return dist.argmin(dim=-1)


def vector_quantize(q: VectorQuantizer, z: torch.Tensor):
    """One factorized stage (reference ``quantize.py:34-94``). z: [B, T, D] -> (z_q [B, T, D],
    commitment [B], codebook [B], indices [B, T], z_e [B, T, dim])."""
    z_e = dense(z, q.in_proj.weight, q.in_proj.bias)
    indices = _nearest(_l2n(z_e), q.codebook)
    z_q = q.codebook[indices]
    commitment = (z_e - z_q.detach()).square().mean(dim=(1, 2))
    codebook = (z_q - z_e.detach()).square().mean(dim=(1, 2))
    z_q = z_e + (z_q - z_e).detach()  # straight-through
    return dense(z_q, q.out_proj.weight, q.out_proj.bias), commitment, codebook, indices, z_e


def apply(model: RVQ, z: torch.Tensor, n_quantizers: Optional[int] = None) -> RVQOutput:
    """Residual quantization (reference ``quantize.py:127-198``, the eval path), z [B, T, D]."""
    n = n_quantizers if n_quantizers is not None else model.cfg.n_codebooks
    with true_fp32():
        z_q = torch.zeros_like(z)
        residual = z
        commitment = codebook = torch.zeros((), dtype=torch.float32, device=z.device)
        codes, latents = [], []
        for q in list(model.quantizers)[:n]:
            z_q_i, c_i, cb_i, idx_i, z_e_i = vector_quantize(q, residual)
            z_q = z_q + z_q_i
            residual = residual - z_q_i
            commitment = commitment + c_i.mean()
            codebook = codebook + cb_i.mean()
            codes.append(idx_i)
            latents.append(z_e_i)
    return RVQOutput(z_q, torch.stack(codes, dim=1), torch.cat(latents, dim=-1), commitment,
                     codebook)


def from_codes(model: RVQ, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, N, T] -> z_q [B, T, D] (reference ``quantize.py:200-220``)."""
    z_q = None
    with true_fp32():
        for i in range(codes.shape[1]):
            q = model.quantizers[i]
            z_q_i = dense(q.codebook[codes[:, i].long()], q.out_proj.weight, q.out_proj.bias)
            z_q = z_q_i if z_q is None else z_q + z_q_i
    return z_q


def from_latents(model: RVQ, latents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """latents [B, T, N*dim] -> (z_q [B, T, D], codes [B, N, T]) (reference
    ``quantize.py:222-255``)."""
    cfg = model.cfg
    dims = np.cumsum([0] + [cfg.codebook_dim] * cfg.n_codebooks)
    n = int(np.max(np.where(dims <= latents.shape[-1])[0]))
    z_q, codes = None, []
    with true_fp32():
        for i in range(n):
            q = model.quantizers[i]
            idx = _nearest(_l2n(latents[..., dims[i]:dims[i + 1]]), q.codebook)
            codes.append(idx)
            z_q_i = dense(q.codebook[idx], q.out_proj.weight, q.out_proj.bias)
            z_q = z_q_i if z_q is None else z_q + z_q_i
    return z_q, torch.stack(codes, dim=1)
