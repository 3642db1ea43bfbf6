"""Synchformer video feature extractor (MotionFormer divided space-time ViT) as
``nn.Module``s (``foley_tpu/models/synchformer.py`` counterpart).

Role in the pipeline: audio-visual sync features at 25 fps. Input: 16-frame 224x224 segments
with stride 8; output (8, 768) per segment, flattened to [1, S*8, 768]. Only the video half
runs at inference.

Architecture (config ``divided_224_16x4``: ViT-B/16, depth 12, heads 12, temporal patch 2):
- Conv3d patch embedding (2, 16, 16) -> 8 x 14 x 14 tokens per segment + CLS;
- spatial positional embeddings (196 + CLS) tiled over time plus temporal ones (8) repeated
  over space;
- 12 divided space-time blocks: time attention (norm3) -> space attention (norm1) -> MLP
  (norm2). CLS attends globally; patch tokens attend within their time or space group with
  the CLS key/value prepended;
- drop CLS, final LayerNorm, then a pre-LN transformer encoder layer with a CLS probe pools
  each frame -> (8, 768).

The JAX package computes all of this attention outside any Pallas kernel, so it stays plain
here (matmul and softmax). Frames take the ``preprocess="device"`` route only: the unique
25 fps frames are uploaded once as uint8 and windowed into segments on the card.
The PIL route is not ported. ``load`` reads the reference's ``synchformer_state_dict``
(``vfeat_extractor.*`` keys; the audio branch's keys are ignored).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from foley_tpu_torch.configs import SynchformerConfig
from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.io.images import box_downsample_u8, frames_to_u8
from foley_tpu_torch.ops.activations import gelu
from foley_tpu_torch.ops.nn import Dense, LayerNorm, empty_parameter, exact_fp32, init_parameters

EPS = 1e-6


# ---------------------------------------------------------------------------------
# Modules (the JAX ``init`` layout)
# ---------------------------------------------------------------------------------

def _dense(cin: int, cout: int, dtype, device) -> Dense:
    return Dense(cin, cout, scheme="normal02_zero_bias", dtype=dtype, device=device)


class Block(nn.Module):
    """DividedSpaceTimeBlock weights: space attention (norm1, attn_*), time attention
    (norm3, time_*) and the MLP (norm2, fc1, fc2)."""

    def __init__(self, cfg: SynchformerConfig, dtype, device):
        super().__init__()
        d, hidden = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
        self.norm1 = LayerNorm(d, EPS, dtype, device)
        self.attn_qkv = _dense(d, 3 * d, dtype, device)
        self.attn_proj = _dense(d, d, dtype, device)
        self.norm3 = LayerNorm(d, EPS, dtype, device)
        self.time_qkv = _dense(d, 3 * d, dtype, device)
        self.time_proj = _dense(d, d, dtype, device)
        self.norm2 = LayerNorm(d, EPS, dtype, device)
        self.fc1 = _dense(d, hidden, dtype, device)
        self.fc2 = _dense(hidden, d, dtype, device)


class SpatialAgg(nn.Module):
    """SpatialTransformerEncoderLayer: a CLS probe and a pre-LN torch encoder layer."""

    def __init__(self, cfg: SynchformerConfig, dtype, device):
        super().__init__()
        d, hidden = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
        self.cls_token = empty_parameter(1, 1, d, dtype=dtype, device=device)
        self.q, self.k, self.v, self.out = (_dense(d, d, dtype, device) for _ in range(4))
        self.linear1 = _dense(d, hidden, dtype, device)
        self.linear2 = _dense(hidden, d, dtype, device)
        self.norm1 = LayerNorm(d, EPS, dtype, device)
        self.norm2 = LayerNorm(d, EPS, dtype, device)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.cls_token.normal_(0.0, 0.02, generator=g)


class Synchformer(nn.Module):
    def __init__(self, cfg: SynchformerConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        patch_in = 3 * cfg.temporal_patch_size * cfg.patch_size * cfg.patch_size
        self.patch_embed = _dense(patch_in, d, dtype, device)
        self.cls_token = empty_parameter(1, 1, d, dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        self.pos_embed = empty_parameter(1, cfg.patches_per_frame + 1, d, **kw)
        self.temp_embed = empty_parameter(1, cfg.temporal_resolution, d, **kw)
        self.norm = LayerNorm(d, EPS, dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, dtype, device) for _ in range(cfg.depth))
        self.spatial_agg = SpatialAgg(cfg, dtype, device)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.cls_token.normal_(0.0, 0.02, generator=g)
        self.pos_embed.normal_(0.0, 0.02, generator=g)
        self.temp_embed.zero_()


def init(cfg: SynchformerConfig, generator: torch.Generator, device: DeviceLike = None,
         dtype=torch.float32) -> Synchformer:
    """A randomly initialized extractor, drawn from ``generator`` directly on the device
    (``cuda`` unless given; the generator must live there), in the JAX ``init``'s schemes:
    normal(0.02) dense weights and CLS/position embeddings, zero biases and temporal
    embeddings, unit LN."""
    model = Synchformer(cfg, dtype=dtype, device=resolve_device(device))
    init_parameters(model, generator)
    return model


def init_random(seed: int, feat_dim: int = 768, device: DeviceLike = None,
                dtype=torch.float32) -> "SynchformerEncoder":
    """Random-weight encoder for checkpoint-free runs, computing in ``dtype``.

    ``feat_dim`` must match the MMDiT's ``sync_feat_dim``; 768 selects the real
    divided_224_16x4 geometry, anything else a tiny 2-layer stand-in. ``num_frames`` stays
    16 either way: the segmentation and the MMDiT's 8-token sync grouping depend on it."""
    cfg = SynchformerConfig() if feat_dim == 768 else SynchformerConfig(
        img_size=32, patch_size=8, temporal_patch_size=2, num_frames=16,
        embed_dim=feat_dim, depth=2, num_heads=2, mlp_ratio=2.0,
    )
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return SynchformerEncoder(init(cfg, gen, device=dev, dtype=dtype), compute_dtype=dtype)


# ---------------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------------

def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nh: int,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, L, D] heads-folded attention: fp32 logits q.k / sqrt(hd) (bf16 products are
    exact in fp32), ``bias`` [B, 1, 1, Lk] added, fp32 softmax, p cast to ``v.dtype``."""
    b, lq, dm = q.shape
    hd = dm // nh

    def heads(t):
        return t.reshape(b, t.shape[1], nh, hd).transpose(1, 2)  # [B, nh, L, hd]

    logits = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2)) / (hd ** 0.5)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, heads(v)).transpose(1, 2).reshape(b, lq, dm)


def _divided_attention(p_qkv: Dense, p_proj: Dense, x: torch.Tensor, group: str, f: int,
                       n: int, nh: int) -> torch.Tensor:
    """DividedAttention. x: [B, 1+f*n, D]. ``group`` 'time' attends across frames within each
    spatial position, 'space' across positions within each frame. CLS attends globally;
    each group also attends to the CLS key/value."""
    b, _, dm = x.shape
    q, k, v = p_qkv(x).chunk(3, dim=-1)
    cls_out = _sdpa(q[:, :1], k, v, nh)  # [B, 1, D]

    def regroup(t):
        t = t.reshape(b, f, n, dm)
        if group == "time":
            return t.transpose(1, 2).reshape(b * n, f, dm)  # (b n) f d
        return t.reshape(b * f, n, dm)                       # (b f) n d

    qg, kg, vg = regroup(q[:, 1:]), regroup(k[:, 1:]), regroup(v[:, 1:])
    r = qg.shape[0] // b
    out = _sdpa(qg, torch.cat([k[:, :1].repeat_interleave(r, dim=0), kg], dim=1),
                torch.cat([v[:, :1].repeat_interleave(r, dim=0), vg], dim=1), nh)
    if group == "time":
        out = out.reshape(b, n, f, dm).transpose(1, 2).reshape(b, f * n, dm)
    else:
        out = out.reshape(b, f * n, dm)
    return p_proj(torch.cat([cls_out, out], dim=1))


def _block(p: Block, x: torch.Tensor, f: int, n: int, nh: int) -> torch.Tensor:
    """DividedSpaceTimeBlock: time -> space -> MLP."""
    x = x + _divided_attention(p.time_qkv, p.time_proj, p.norm3(x), "time", f, n, nh)
    x = x + _divided_attention(p.attn_qkv, p.attn_proj, p.norm1(x), "space", f, n, nh)
    return x + p.fc2(gelu(p.fc1(p.norm2(x))))


def _spatial_agg(p: SpatialAgg, x: torch.Tensor, nh: int,
                 key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prepend CLS, run the pre-LN encoder layer, return CLS: [B', N, D] -> [B', D].
    ``key_mask`` [B', N] (True = keep) masks attention keys; the CLS key is always kept."""
    b = x.shape[0]
    x = torch.cat([p.cls_token.to(x.dtype).expand(b, 1, x.shape[-1]), x], dim=1)
    bias = None
    if key_mask is not None:
        keep = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=x.device),
                          key_mask.to(torch.bool)], dim=1)
        bias = torch.where(keep[:, None, None, :], 0.0, torch.finfo(torch.float32).min)
    xn = p.norm1(x)
    x = x + p.out(_sdpa(p.q(xn), p.k(xn), p.v(xn), nh, bias=bias))
    x = x + p.linear2(gelu(p.linear1(p.norm2(x))))
    return x[:, 0]


def _patchify_3d(x: torch.Tensor, pt: int, ps: int) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, (T/pt)*(H/ps)*(W/ps), C*pt*ps*ps] in torch Conv3d flatten order
    (features ordered (C, kt, kh, kw); tokens ordered (t, h, w))."""
    b, t, h, w, c = x.shape
    gt, gh, gw = t // pt, h // ps, w // ps
    x = x.reshape(b, gt, pt, gh, ps, gw, ps, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, gt * gh * gw, c * pt * ps * ps)


def apply(model: Synchformer, segments: torch.Tensor) -> torch.Tensor:
    """segments: [B, S, T=16, H, W, C] normalized frames -> features [B, S, 8, D]."""
    cfg = model.cfg
    b, s, t, h, w, c = segments.shape
    nh, f, n = cfg.num_heads, cfg.temporal_resolution, cfg.patches_per_frame

    x = segments.reshape(b * s, t, h, w, c)
    x = model.patch_embed(_patchify_3d(x, cfg.temporal_patch_size, cfg.patch_size))
    x = torch.cat([model.cls_token.to(x.dtype).expand(b * s, 1, x.shape[-1]), x], dim=1)

    pos = model.pos_embed.to(x.dtype)
    tile_pos = pos[:, 1:].repeat(1, f, 1)
    tile_temp = model.temp_embed.to(x.dtype).repeat_interleave(n, dim=1)
    x = x + torch.cat([pos[:, :1], tile_pos + tile_temp], dim=1)

    for blk in model.blocks:
        x = _block(blk, x, f, n, nh)

    x = model.norm(x[:, 1:])  # drop CLS
    x = _spatial_agg(model.spatial_agg, x.reshape(b * s * f, n, x.shape[-1]), nh)
    return x.reshape(b, s, f, x.shape[-1])


# ---------------------------------------------------------------------------------
# Preprocessing + encode (the device route)
# ---------------------------------------------------------------------------------

def preprocess_frames_device(frames: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[T, H, W, C] uint8 (or float [0, 1]) frames -> [T, size, size, C] fp32, (x-0.5)/0.5:
    short side to ``size`` by an antialiased bicubic resize (long side by Python ``round``),
    then a center crop, on whatever device the frames lie."""
    if frames.dtype == torch.uint8:
        frames = frames.float() / 255.0
    _, h, w, _ = frames.shape
    scale = size / min(w, h)
    nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
    x = F.interpolate(frames.permute(0, 3, 1, 2), size=(nh, nw), mode="bicubic",
                      align_corners=False, antialias=True)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, :, top:top + size, left:left + size].permute(0, 2, 3, 1)
    return (x.clamp(0.0, 1.0) - 0.5) / 0.5


def upload_frames_async(frames: np.ndarray, target_short_side: int,
                        device: torch.device) -> torch.Tensor:
    """Start the uint8 host->device frame copy without waiting for it: a pinned host buffer
    and a ``non_blocking`` copy on the current stream (a plain copy for a CPU device).
    Frames more than twice ``target_short_side`` are box-downsampled on the host first."""
    u8 = torch.from_numpy(box_downsample_u8(frames_to_u8(np.asarray(frames)),
                                            target_short_side))
    if device.type == "cuda":
        return u8.pin_memory().to(device, non_blocking=True)
    return u8.to(device)


def encode_frames_device(encoder: "SynchformerEncoder",
                         frames_25fps: np.ndarray) -> torch.Tensor:
    """25 fps frames [T, H, W, C] -> [1, S*8, D]: each unique frame is uploaded once as
    uint8, resized on the device, then windowed into overlapping segments of
    ``cfg.num_frames`` (16) at ``cfg.segment_stride`` (8) by a gather (short inputs repeat
    the last frame, as ``pipeline/features.py::sync_segments`` does)."""
    segment_size, stride = encoder.cfg.num_frames, encoder.cfg.segment_stride
    t = frames_25fps.shape[0]
    num = max((t - segment_size) // stride + 1, 1)
    u8 = upload_frames_async(frames_25fps, encoder.cfg.img_size, encoder.device)
    dev = preprocess_frames_device(u8, encoder.cfg.img_size)
    idx = np.minimum(np.arange(num)[:, None] * stride + np.arange(segment_size)[None, :], t - 1)
    segs = dev.index_select(0, torch.from_numpy(idx.reshape(-1)).to(dev.device))
    return encoder.encode(segs.reshape(num, segment_size, *dev.shape[1:]))


class SynchformerEncoder:
    def __init__(self, model: Synchformer, compute_dtype=torch.float32):
        self.model = model
        self.cfg = model.cfg
        # activation dtype of the ViT; features come back in fp32 either way
        self.compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return self.model.pos_embed.device

    @torch.no_grad()
    def encode(self, segments) -> torch.Tensor:
        """[S, 16, H, W, C] preprocessed segments (tensor or array) -> [1, S*8, D] fp32."""
        x = torch.as_tensor(segments).to(self.device)[None].to(self.compute_dtype)
        with exact_fp32(self.compute_dtype):
            feats = apply(self.model, x)  # [1, S, 8, D]
        return feats.reshape(1, -1, feats.shape[-1]).float()


# ---------------------------------------------------------------------------------
# Checkpoint conversion and loading
# ---------------------------------------------------------------------------------

def convert_state_dict(sd: Dict[str, torch.Tensor], cfg: SynchformerConfig,
                       prefix: str = "vfeat_extractor.") -> Dict[str, torch.Tensor]:
    """A Synchformer checkpoint's video half -> the port's ``Synchformer`` state dict. The
    Conv3d patch embedding [D, C, kt, kh, kw] flattens (in torch's order) to a dense
    [D, C*kt*kh*kw]."""
    out: Dict[str, torch.Tensor] = {}

    def lin(src, dst):
        out[dst + ".weight"] = sd[prefix + src + ".weight"]
        out[dst + ".bias"] = sd[prefix + src + ".bias"]

    w3 = sd[prefix + "patch_embed_3d.proj.weight"]
    out["patch_embed.weight"] = w3.reshape(w3.shape[0], -1)
    out["patch_embed.bias"] = sd[prefix + "patch_embed_3d.proj.bias"]
    for name in ("cls_token", "pos_embed", "temp_embed"):
        out[name] = sd[prefix + name]
    lin("norm", "norm")
    for i in range(cfg.depth):
        for src, dst in (("norm1", "norm1"), ("attn.qkv", "attn_qkv"),
                         ("attn.proj", "attn_proj"), ("norm3", "norm3"),
                         ("timeattn.qkv", "time_qkv"), ("timeattn.proj", "time_proj"),
                         ("norm2", "norm2"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            lin(f"blocks.{i}.{src}", f"blocks.{i}.{dst}")
    agg = convert_torch_encoder_layer(sd, prefix + "spatial_attn_agg.", cfg.embed_dim)
    out.update({"spatial_agg." + k: v for k, v in agg.items()})
    return out


def convert_torch_encoder_layer(sd: Dict[str, torch.Tensor], prefix: str,
                                dim: int) -> Dict[str, torch.Tensor]:
    """A torch ``nn.TransformerEncoderLayer`` with a CLS probe -> ``SpatialAgg``'s state
    dict: the packed ``in_proj`` [3d, d] splits into q, k and v."""
    in_w, in_b = sd[prefix + "self_attn.in_proj_weight"], sd[prefix + "self_attn.in_proj_bias"]
    out = {"cls_token": sd[prefix + "cls_token"]}
    for j, name in enumerate(("q", "k", "v")):
        out[name + ".weight"] = in_w[j * dim:(j + 1) * dim]
        out[name + ".bias"] = in_b[j * dim:(j + 1) * dim]
    for src, dst in (("self_attn.out_proj", "out"), ("linear1", "linear1"),
                     ("linear2", "linear2"), ("norm1", "norm1"), ("norm2", "norm2")):
        out[dst + ".weight"] = sd[prefix + src + ".weight"]
        out[dst + ".bias"] = sd[prefix + src + ".bias"]
    return out


def load(model_path: str, cfg: Optional[SynchformerConfig] = None, device: DeviceLike = None,
         dtype=torch.float32) -> "SynchformerEncoder":
    """The reference's checkpoint -> an encoder on ``device`` (``cuda`` unless given) whose
    weights and activations are ``dtype``."""
    from foley_tpu_torch.io.convert import load_torch_state_dict, module_from_state_dict

    sd = load_torch_state_dict(model_path)
    cfg = cfg or SynchformerConfig()
    prefix = "vfeat_extractor." if any(k.startswith("vfeat_extractor.") for k in sd) else ""
    model = module_from_state_dict(Synchformer, convert_state_dict(sd, cfg, prefix), cfg,
                                   device, dtype)
    return SynchformerEncoder(model, compute_dtype=dtype)
