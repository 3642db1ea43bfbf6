"""SigLIP2 vision tower (google/siglip2-base-patch16-512) as ``nn.Module``s
(``foley_tpu/models/siglip2.py`` counterpart).

Role in the pipeline: 768-d per-frame visual semantics at 8 fps from 512x512 frames (the
reference's ``get_image_features``: vision tower -> post-LN -> attention-pooling MAP head ->
pooled [768]). Pre-LN ViT (patch 16), no class token, learned position embeddings, MAP
pooling head (a probe token cross-attends every patch token, then LN + residual MLP).

The encoder's self-attention always goes through ``flash_attention``: the Hopper kernel for
CUDA tensors, its plain version for CPU tensors, at any token count. The MAP head's
one-query attention stays plain, as in the JAX package. Frames take the JAX package's
``preprocess="device"`` route only (uint8 upload, antialiased bicubic resize on the card);
the PIL route, checkpoint conversion and the naflex patch embedding are not ported.

Parameter names follow the JAX tree (``w``/``b`` become ``weight``/``bias``), so
``io/from_jax.py`` maps one onto the other by name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.io.images import box_downsample_u8, frames_to_u8
from foley_tpu_torch.ops.activations import gelu_tanh
from foley_tpu_torch.ops.attention import sdpa
from foley_tpu_torch.ops.kernels.flash_attention import flash_attention
from foley_tpu_torch.ops.nn import Dense, LayerNorm, empty_parameter, init_parameters


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 512
    patch_size: int = 16
    num_channels: int = 3
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def tiny(cls) -> "SiglipVisionConfig":
        return cls(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=2, image_size=32, patch_size=8)


# ---------------------------------------------------------------------------------
# Modules (the JAX ``init`` layout)
# ---------------------------------------------------------------------------------

def _dense(cin: int, cout: int, dtype, device) -> Dense:
    return Dense(cin, cout, scheme="normal02_zero_bias", dtype=dtype, device=device)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype, device):
        super().__init__()
        h, inter, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.ln1 = LayerNorm(h, eps, dtype, device)
        self.q, self.k, self.v, self.out = (_dense(h, h, dtype, device) for _ in range(4))
        self.ln2 = LayerNorm(h, eps, dtype, device)
        self.fc1 = _dense(h, inter, dtype, device)
        self.fc2 = _dense(inter, h, dtype, device)


class MAPHead(nn.Module):
    """Attention pooling: a learned probe token [1, 1, h] attends every patch token."""

    def __init__(self, cfg: SiglipVisionConfig, dtype, device):
        super().__init__()
        h, inter = cfg.hidden_size, cfg.intermediate_size
        self.probe = empty_parameter(1, 1, h, dtype=dtype, device=device)
        self.q, self.k, self.v, self.out = (_dense(h, h, dtype, device) for _ in range(4))
        self.ln = LayerNorm(h, cfg.layer_norm_eps, dtype, device)
        self.fc1 = _dense(h, inter, dtype, device)
        self.fc2 = _dense(inter, h, dtype, device)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.probe.normal_(0.0, 0.02, generator=g)


class Siglip2(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.patch_embedding = _dense(cfg.num_channels * cfg.patch_size ** 2, h, dtype, device)
        self.position_embedding = empty_parameter(cfg.grid ** 2, h, dtype=dtype,
                                                  device=device)
        self.post_layernorm = LayerNorm(h, cfg.layer_norm_eps, dtype, device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.head = MAPHead(cfg, dtype, device)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.position_embedding.normal_(0.0, 0.02, generator=g)


def init(cfg: SiglipVisionConfig, generator: torch.Generator, device: DeviceLike = None,
         dtype=torch.float32) -> Siglip2:
    """A randomly initialized tower, drawn from ``generator`` directly on the device (``cuda``
    unless given; the generator must live there), in the JAX ``init``'s schemes:
    normal(0.02) dense weights, position embeddings and probe, zero biases, unit LN."""
    model = Siglip2(cfg, dtype=dtype, device=resolve_device(device))
    init_parameters(model, generator)
    return model


def init_random(seed: int, feat_dim: int = 768, device: DeviceLike = None,
                dtype=torch.float32) -> "Siglip2Encoder":
    """Random-weight encoder for checkpoint-free runs, computing in ``dtype``.

    ``feat_dim`` must match the MMDiT's ``clip_dim``; 768 selects the real base-model
    geometry, anything else a tiny 2-layer stand-in with the same code paths."""
    cfg = SiglipVisionConfig() if feat_dim == 768 else SiglipVisionConfig(
        hidden_size=feat_dim, intermediate_size=2 * feat_dim, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=8,
    )
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return Siglip2Encoder(init(cfg, gen, device=dev, dtype=dtype), compute_dtype=dtype)


# ---------------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------------

def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    b, length, h = x.shape
    return x.view(b, length, nh, h // nh)


def _patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/P)*(W/P), C*P*P] with (C, Ph, Pw) feature order (torch conv)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * patch * patch)


def _resize_pos_embed(pos: torch.Tensor, target_grid: int) -> torch.Tensor:
    """Bilinear-resize square positional embeddings [G*G, D] -> [g*g, D], with the antialias
    ``jax.image.resize`` applies when it shrinks (fp32 arithmetic, cast back)."""
    n, d = pos.shape
    g = int(round(n ** 0.5))
    if g == target_grid:
        return pos
    grid = pos.float().reshape(g, g, d).permute(2, 0, 1)[None]
    out = F.interpolate(grid, size=(target_grid, target_grid), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).reshape(target_grid * target_grid, d).to(pos.dtype)


def apply(model: Siglip2, images: torch.Tensor, pooled: bool = True) -> torch.Tensor:
    """images: [B, H, W, C] normalized ((x-0.5)/0.5). Returns pooled [B, h]
    (``get_image_features``) or the token sequence [B, N, h]. Positional embeddings are
    resized when the input grid differs from the tower's."""
    cfg = model.cfg
    x = model.patch_embedding(_patchify(images, cfg.patch_size))
    pos = _resize_pos_embed(model.position_embedding, images.shape[1] // cfg.patch_size)
    x = x + pos[None].to(x.dtype)
    nh = cfg.num_attention_heads
    for layer in model.layers:
        xn = layer.ln1(x)
        attn = flash_attention(_heads(layer.q(xn), nh), _heads(layer.k(xn), nh),
                               _heads(layer.v(xn), nh))
        x = x + layer.out(attn.flatten(2))
        x = x + layer.fc2(gelu_tanh(layer.fc1(layer.ln2(x))))
    x = model.post_layernorm(x)
    if not pooled:
        return x
    head = model.head
    probe = head.probe.to(x.dtype).expand(x.shape[0], *head.probe.shape[1:])
    attn = sdpa(_heads(head.q(probe), nh), _heads(head.k(x), nh), _heads(head.v(x), nh))
    attn = head.out(attn.flatten(2))
    out = attn + head.fc2(gelu_tanh(head.fc1(head.ln(attn))))
    return out[:, 0]


# ---------------------------------------------------------------------------------
# Frame preprocessing + encode (the device route)
# ---------------------------------------------------------------------------------

def preprocess_frames_device(frames: torch.Tensor, size: int = 512) -> torch.Tensor:
    """[T, H, W, C] uint8 (or float [0, 1]) frames on any device -> [T, size, size, C] fp32,
    normalized (x-0.5)/0.5: one antialiased bicubic resize of the whole batch, which agrees
    with ``jax.image.resize(method="bicubic")`` to float rounding."""
    if frames.dtype == torch.uint8:
        frames = frames.float() / 255.0
    x = F.interpolate(frames.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                      align_corners=False, antialias=True)
    return (x.permute(0, 2, 3, 1).clamp(0.0, 1.0) - 0.5) / 0.5


class Siglip2Encoder:
    def __init__(self, model: Siglip2, compute_dtype=torch.float32):
        self.model = model
        self.cfg = model.cfg
        # activation dtype of the ViT; features come back in fp32 either way
        self.compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return self.model.position_embedding.device

    @torch.no_grad()
    def encode(self, frames: np.ndarray) -> torch.Tensor:
        """[T, H, W, C] frames (float [0, 1] or uint8) -> [1, T, hidden] fp32 pooled features.

        Sources more than twice the encoder's resolution are box-downsampled on the host
        first, so only pixels the resize can use are uploaded, as uint8."""
        u8 = box_downsample_u8(frames_to_u8(np.asarray(frames)), self.cfg.image_size)
        pixels = preprocess_frames_device(torch.from_numpy(u8).to(self.device),
                                          self.cfg.image_size)
        feats = apply(self.model, pixels.to(self.compute_dtype), pooled=True)  # [T, h]
        return feats[None].float()
