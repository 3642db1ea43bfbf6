"""SigLIP2 vision tower (google/siglip2-base-patch16-512) as ``nn.Module``s
(``foley_tpu/models/siglip2.py`` counterpart).

Role in the pipeline: 768-d per-frame visual semantics at 8 fps from 512x512 frames (the
reference's ``get_image_features``: vision tower -> post-LN -> attention-pooling MAP head ->
pooled [768]). Pre-LN ViT (patch 16), no class token, learned position embeddings, MAP
pooling head (a probe token cross-attends every patch token, then LN + residual MLP).

The encoder's self-attention always goes through ``flash_attention``: the Hopper kernel for
CUDA tensors, its plain version for CPU tensors, at any token count. The MAP head's
one-query attention stays plain, as in the JAX package. Frames take either of the JAX
package's routes, by the encoder's ``preprocess``: ``"device"`` (the default: uint8 upload,
antialiased bicubic resize on the card) or ``"pil"`` (PIL's BICUBIC resize of every frame,
the reference's, through ``ops/pil_resize.py``: the same bytes, on the card, without PIL).
``load`` reads a Hugging Face checkpoint (``vision_model.*``
keys) with either patch embedding: the fixed-resolution conv ``[h, C, P, P]`` or naflex's
linear ``[h, P*P*C]``, both mapped onto the port's linear one over (C, Ph, Pw).

Parameter names follow the JAX tree (``w``/``b`` become ``weight``/``bias``), so
``io/from_jax.py`` maps one onto the other by name.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.io.images import box_downsample_u8, frames_to_u8
from foley_tpu_torch.ops.activations import gelu_tanh
from foley_tpu_torch.ops.attention import sdpa
from foley_tpu_torch.ops.kernels.flash_attention import flash_attention
from foley_tpu_torch.ops import pil_resize
from foley_tpu_torch.ops.nn import (Dense, LayerNorm, divide, empty_parameter, exact_fp32,
                                    init_parameters)


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
# Frame preprocessing + encode
# ---------------------------------------------------------------------------------

def preprocess_frames(frames: np.ndarray, size: int = 512,
                      device: DeviceLike = None) -> torch.Tensor:
    """The PIL route (the JAX ``preprocess_frames``): [T, H, W, C] float [0, 1] (or uint8)
    -> [T, size, size, C] fp32 on ``device``, (x-0.5)/0.5 of PIL's BICUBIC resize of each
    frame quantised by ``io/images.py::frames_to_u8``, equal to the JAX function bit for bit
    (``ops/pil_resize.py``)."""
    u8 = torch.from_numpy(frames_to_u8(np.asarray(frames)))
    x = pil_resize.resize(u8.to(resolve_device(device)), (size, size), pil_resize.BICUBIC)
    return divide(divide(x.float(), 255.0) - 0.5, 0.5)


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
    def __init__(self, model: Siglip2, compute_dtype=torch.float32, preprocess: str = "device"):
        self.model = model
        self.cfg = model.cfg
        # activation dtype of the ViT; features come back in fp32 either way
        self.compute_dtype = compute_dtype
        self.preprocess = preprocess  # "device" (the resize on the card) | "pil" (PIL's bytes)

    @property
    def device(self) -> torch.device:
        return self.model.position_embedding.device

    @torch.no_grad()
    def encode(self, frames: np.ndarray) -> torch.Tensor:
        """[T, H, W, C] frames (float [0, 1] or uint8) -> [1, T, hidden] fp32 pooled features.

        The device route box-downsamples sources more than twice the encoder's resolution on
        the host first, so only pixels the resize can use are uploaded, as uint8; the PIL
        route uploads each frame whole and resizes it as PIL does."""
        if self.preprocess == "pil":
            pixels = preprocess_frames(np.asarray(frames), self.cfg.image_size, self.device)
        elif self.preprocess == "device":
            u8 = box_downsample_u8(frames_to_u8(np.asarray(frames)), self.cfg.image_size)
            pixels = preprocess_frames_device(torch.from_numpy(u8).to(self.device),
                                              self.cfg.image_size)
        else:
            raise ValueError(f"preprocess {self.preprocess!r}: expected 'device' or 'pil'")
        with exact_fp32(self.compute_dtype):
            feats = apply(self.model, pixels.to(self.compute_dtype), pooled=True)  # [T, h]
        return feats[None].float()


# ---------------------------------------------------------------------------------
# Checkpoint conversion and loading
# ---------------------------------------------------------------------------------

def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: SiglipVisionConfig,
                          prefix: str = "vision_model.") -> Dict[str, torch.Tensor]:
    """A Hugging Face SigLIP / SigLIP2 vision tower's state dict -> the port's ``Siglip2``
    state dict. The MAP head's packed ``in_proj`` [3h, h] splits into q, k and v."""
    out: Dict[str, torch.Tensor] = {}

    def lin(src, dst):
        out[dst + ".weight"] = sd[prefix + src + ".weight"]
        out[dst + ".bias"] = sd[prefix + src + ".bias"]

    pe = sd[prefix + "embeddings.patch_embedding.weight"]
    h = pe.shape[0]
    if pe.ndim == 4:  # conv2d [h, C, P, P]: flattened in (C, Ph, Pw) order
        out["patch_embedding.weight"] = pe.reshape(h, -1)
    else:
        # naflex linear [h, Ph*Pw*C]: HF's processor orders patch features (ph, pw, c)
        p = cfg.patch_size
        c = pe.shape[1] // (p * p)
        out["patch_embedding.weight"] = pe.reshape(h, p, p, c).permute(0, 3, 1, 2).reshape(h, -1)
    out["patch_embedding.bias"] = sd[prefix + "embeddings.patch_embedding.bias"]
    out["position_embedding"] = sd[prefix + "embeddings.position_embedding.weight"]
    lin("post_layernorm", "post_layernorm")
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}."
        for src, dst in (("layer_norm1", "ln1"), ("self_attn.q_proj", "q"),
                         ("self_attn.k_proj", "k"), ("self_attn.v_proj", "v"),
                         ("self_attn.out_proj", "out"), ("layer_norm2", "ln2"),
                         ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            lin(b + src, f"layers.{i}.{dst}")
    if prefix + "head.probe" in sd:
        out["head.probe"] = sd[prefix + "head.probe"]
        in_w = sd[prefix + "head.attention.in_proj_weight"]
        in_b = sd[prefix + "head.attention.in_proj_bias"]
        for j, name in enumerate(("q", "k", "v")):
            out[f"head.{name}.weight"] = in_w[j * h:(j + 1) * h]
            out[f"head.{name}.bias"] = in_b[j * h:(j + 1) * h]
        for src, dst in (("head.attention.out_proj", "head.out"), ("head.layernorm", "head.ln"),
                         ("head.mlp.fc1", "head.fc1"), ("head.mlp.fc2", "head.fc2")):
            lin(src, dst)
    return out


def _infer_config(sd: Dict[str, torch.Tensor], prefix: str,
                  model_path: str) -> SiglipVisionConfig:
    """The tower's config from the checkpoint's shapes and a colocated ``config.json``: the
    head count is not in the shapes (``config.json`` wins, else head dim 64)."""
    pe = sd[prefix + "embeddings.patch_embedding.weight"]
    hidden = pe.shape[0]
    if pe.ndim == 4:  # conv2d [h, C, P, P]
        channels, patch = pe.shape[1], pe.shape[2]
    else:  # naflex linear [h, P*P*C]
        channels, patch = 3, int(math.isqrt(pe.shape[1] // 3))
    n_pos = sd[prefix + "embeddings.position_embedding.weight"].shape[0]
    inter = sd[prefix + "encoder.layers.0.mlp.fc1.weight"].shape[0]
    n_layers = 1 + max(int(k[len(prefix + "encoder.layers."):].split(".")[0])
                       for k in sd if k.startswith(prefix + "encoder.layers."))
    heads, eps = max(1, hidden // 64), 1e-6
    cfg_json = os.path.join(model_path, "config.json") if os.path.isdir(model_path) else None
    if cfg_json and os.path.exists(cfg_json):
        with open(cfg_json) as f:
            raw = json.load(f)
        raw = raw.get("vision_config", raw)
        heads = int(raw.get("num_attention_heads", heads))
        eps = float(raw.get("layer_norm_eps", eps))
    return SiglipVisionConfig(
        hidden_size=int(hidden), intermediate_size=int(inter), num_hidden_layers=int(n_layers),
        num_attention_heads=heads, image_size=int(math.isqrt(n_pos)) * int(patch),
        patch_size=int(patch), num_channels=int(channels), layer_norm_eps=eps)


def load(model_path: str, cfg: Optional[SiglipVisionConfig] = None, device: DeviceLike = None,
         dtype=torch.float32) -> Siglip2Encoder:
    """A Hugging Face checkpoint (directory or file) -> an encoder on ``device`` (``cuda``
    unless given) whose weights and activations are ``dtype``."""
    from foley_tpu_torch.io.convert import load_torch_state_dict, module_from_state_dict

    sd = load_torch_state_dict(model_path)
    prefix = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    cfg = cfg or _infer_config(sd, prefix, model_path)
    model = module_from_state_dict(Siglip2, convert_hf_state_dict(sd, cfg, prefix), cfg,
                                   device, dtype)
    return Siglip2Encoder(model, compute_dtype=dtype)
