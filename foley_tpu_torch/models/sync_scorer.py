"""The AV desync scorer: Synchformer's GlobalTransformer head and the scoring pipeline
(``foley_tpu/models/sync_scorer.py`` counterpart).

Video features (the MotionFormer, ``models/synchformer.py``) and audio features (AST,
``models/ast.py``) are projected to one 768-d space and concatenated as
``[OFF, v..., MOD, a...]`` with a learned 198-position embedding; a 3-layer GPT-style
transformer reads a 21-class offset (desync) prediction off the OFF token, on a +/-2 s grid
(reference ``synchformer.py:54-68, 115-256``, ``compute_desync_score.py``).

The scorer's frames take its video encoder's route (``synchformer.encode_segments``): the
device resize by default, where the JAX scorer's encoder defaults to the PIL resize
(``preprocess="pil"``, which the port's encoder also takes, byte for byte, through
``ops/pil_resize.py``); the port is held against the JAX scorer on the device route. Every attention is the plain ``ops/attention.py::sdpa``;
the whole score runs in true fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from foley_tpu_torch.configs import SynchformerConfig
from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.models import ast as ast_mod
from foley_tpu_torch.models import synchformer
from foley_tpu_torch.ops.activations import gelu
from foley_tpu_torch.ops.attention import sdpa
from foley_tpu_torch.ops.audio_dsp import segment_audio, sync_audio_spectrogram
from foley_tpu_torch.ops.nn import Dense, LayerNorm, empty_parameter, true_fp32

LN_EPS = 1e-5  # torch LayerNorm's default


@dataclasses.dataclass(frozen=True)
class SyncScorerConfig:
    n_embd: int = 768
    n_layer: int = 3
    n_head: int = 8
    pos_max_len: int = 198
    n_offset_classes: int = 21

    @classmethod
    def tiny(cls) -> "SyncScorerConfig":
        return cls(n_embd=16, n_layer=1, n_head=2, pos_max_len=20, n_offset_classes=5)


def _dense(cin: int, cout: int, dtype, device) -> Dense:
    return Dense(cin, cout, scheme="normal02_zero_bias", dtype=dtype, device=device)


class ScorerBlock(nn.Module):
    def __init__(self, cfg: SyncScorerConfig, dtype, device):
        super().__init__()
        d = cfg.n_embd
        self.ln1 = LayerNorm(d, LN_EPS, dtype, device)
        self.q, self.k, self.v, self.proj = (_dense(d, d, dtype, device) for _ in range(4))
        self.ln2 = LayerNorm(d, LN_EPS, dtype, device)
        self.fc1 = _dense(d, 4 * d, dtype, device)
        self.fc2 = _dense(4 * d, d, dtype, device)


class SyncScorer(nn.Module):
    """The JAX ``sync_scorer.init`` tree as modules (``io/from_jax.py::sync_scorer_from_jax``)."""

    def __init__(self, cfg: SyncScorerConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_embd
        kw = dict(dtype=dtype, device=device)
        self.vproj = _dense(d, d, dtype, device)
        self.aproj = _dense(d, d, dtype, device)
        self.vis_in_lnorm = LayerNorm(d, LN_EPS, dtype, device)
        self.aud_in_lnorm = LayerNorm(d, LN_EPS, dtype, device)
        self.off_tok = empty_parameter(1, 1, d, **kw)
        self.mod_tok = empty_parameter(1, 1, d, **kw)
        self.pos_emb = empty_parameter(1, cfg.pos_max_len, d, **kw)
        self.ln_f = LayerNorm(d, LN_EPS, dtype, device)
        self.off_head = _dense(d, cfg.n_offset_classes, dtype, device)
        self.blocks = nn.ModuleList(ScorerBlock(cfg, dtype, device) for _ in range(cfg.n_layer))


def _block(p: ScorerBlock, x: torch.Tensor, nh: int) -> torch.Tensor:
    """GPT-style block (reference ``synchformer.py:238-256``)."""
    xn = p.ln1(x)
    q, k, v = (u.unflatten(-1, (nh, -1)) for u in (p.q(xn), p.k(xn), p.v(xn)))
    x = x + p.proj(sdpa(q, k, v).flatten(2))
    return x + p.fc2(gelu(p.fc1(p.ln2(x))))


def compare_v_a(model: SyncScorer, vis: torch.Tensor, aud: torch.Tensor) -> torch.Tensor:
    """vis ``[B, S, tv, D]``, aud ``[B, S, ta, D]`` -> offset logits ``[B, classes]``
    (reference ``Synchformer.compare_v_a`` + ``GlobalTransformer.forward``)."""
    cfg = model.cfg
    b, d = vis.shape[0], cfg.n_embd
    vis = model.vis_in_lnorm(model.vproj(vis).reshape(b, -1, d))
    aud = model.aud_in_lnorm(model.aproj(aud).reshape(b, -1, d))
    x = torch.cat([model.off_tok.to(vis.dtype).expand(b, 1, d), vis,
                   model.mod_tok.to(vis.dtype).expand(b, 1, d), aud], dim=1)
    if x.shape[1] > cfg.pos_max_len:
        raise ValueError(f"{x.shape[1]} tokens, the position table holds {cfg.pos_max_len}")
    x = x + model.pos_emb[:, :x.shape[1]].to(x.dtype)
    for blk in model.blocks:
        x = _block(blk, x, cfg.n_head)
    return model.off_head(model.ln_f(x)[:, 0])


def make_class_grid(leftmost: float = -2.0, rightmost: float = 2.0,
                    grid_size: int = 21) -> np.ndarray:
    """The offset classes in seconds (reference ``data_transforms.py:226-244``)."""
    return np.linspace(leftmost, rightmost, grid_size).astype(np.float32)


def quantize_offset(grid: np.ndarray, off_sec: float) -> Tuple[float, int]:
    """An offset in seconds snapped to the nearest grid class (reference
    ``data_transforms.py:247-251``): (grid value, class index), the first on a tie."""
    idx = int(np.abs(np.asarray(grid) - off_sec).argmin())
    return float(grid[idx]), idx


def predicted_offset_seconds(logits: torch.Tensor,
                             grid: Optional[np.ndarray] = None) -> np.ndarray:
    """argmax of the logits -> the offset in seconds (the desync score)."""
    grid = grid if grid is not None else make_class_grid()
    return grid[logits.argmax(dim=-1).cpu().numpy()]


class DesyncScorer:
    """The AV-sync scoring pipeline (reference ``compute_desync_score.py``): 25 fps video
    segments -> MotionFormer features; 16 kHz audio -> segments, mel, AST features; the
    GlobalTransformer -> a 21-class offset prediction in seconds."""

    def __init__(self, video_encoder: "synchformer.SynchformerEncoder", ast: ast_mod.AST,
                 freq_agg: synchformer.SpatialAgg, scorer: SyncScorer):
        self.video_encoder = video_encoder
        self.ast = ast
        self.freq_agg = freq_agg
        self.scorer = scorer

    @torch.no_grad()
    def logits(self, frames_25fps: np.ndarray, waveform_16k: np.ndarray) -> torch.Tensor:
        """frames ``[T, H, W, C]`` float [0, 1] at 25 fps, waveform ``[T16k]`` -> offset logits
        ``[1, classes]`` fp32 on the scorer's device."""
        with true_fp32():
            vis = synchformer.encode_segments(self.video_encoder, frames_25fps)  # [1, S*8, D]
            s = vis.shape[1] // self.video_encoder.cfg.out_features_per_segment
            vis = vis.reshape(1, s, -1, vis.shape[-1])
            wav = torch.as_tensor(np.asarray(waveform_16k, np.float32),
                                  device=self.video_encoder.device)
            spec = sync_audio_spectrogram(segment_audio(wav[None]))  # [1, Sa, 128, 66]
            sa = spec.shape[1]
            spec_tf = spec.reshape(sa, *spec.shape[2:]).transpose(1, 2)  # [Sa, 66, 128]
            aud = ast_mod.extract_features(self.ast, self.freq_agg, spec_tf)
            return compare_v_a(self.scorer, vis, aud.reshape(1, sa, -1, aud.shape[-1]))

    def score(self, frames_25fps: np.ndarray, waveform_16k: np.ndarray) -> np.ndarray:
        """The predicted offset in seconds, ``[1]``."""
        return predicted_offset_seconds(self.logits(frames_25fps, waveform_16k))


def convert_state_dict(sd: Dict[str, torch.Tensor], cfg: SyncScorerConfig,
                       prefix: str = "") -> Dict[str, torch.Tensor]:
    """A Synchformer checkpoint's ``vproj`` / ``aproj`` / ``transformer.*`` keys -> the port's
    ``SyncScorer`` state dict."""
    t = prefix + "transformer."
    out = {"off_tok": sd[t + "OFF_tok"], "mod_tok": sd[t + "MOD_tok"],
           "pos_emb": sd[t + "pos_emb_cfg.pos_emb"]}

    def take(src: str, dst: str) -> None:
        out[dst + ".weight"] = sd[src + ".weight"]
        out[dst + ".bias"] = sd[src + ".bias"]

    for src, dst in ((prefix + "vproj", "vproj"), (prefix + "aproj", "aproj"),
                     (t + "vis_in_lnorm", "vis_in_lnorm"), (t + "aud_in_lnorm", "aud_in_lnorm"),
                     (t + "ln_f", "ln_f"), (t + "off_head", "off_head")):
        take(src, dst)
    for i in range(cfg.n_layer):
        for src, dst in (("ln1", "ln1"), ("attn.query", "q"), ("attn.key", "k"),
                         ("attn.value", "v"), ("attn.proj", "proj"), ("ln2", "ln2"),
                         ("mlp.0", "fc1"), ("mlp.2", "fc2")):
            take(f"{t}blocks.{i}.{src}", f"blocks.{i}.{dst}")
    return out


def freq_agg_from_state_dict(sd: Dict[str, torch.Tensor], prefix: str, dim: int,
                             device: DeviceLike = None,
                             dtype=torch.float32) -> synchformer.SpatialAgg:
    """AST's frequency pooling (a torch encoder layer with a CLS probe) -> a ``SpatialAgg``
    whose MLP width is the checkpoint's."""
    state = synchformer.convert_torch_encoder_layer(sd, prefix, dim)
    agg = synchformer.SpatialAgg(dim, state["linear1.weight"].shape[0], dtype,
                                 resolve_device(device))
    agg.load_state_dict(state, strict=True)
    return agg


def random_checkpoint(seed: int, video_cfg: Optional[SynchformerConfig] = None,
                      ast_cfg: Optional[ast_mod.ASTConfig] = None,
                      scorer_cfg: Optional[SyncScorerConfig] = None,
                      ast_positions: int = 1214) -> Dict[str, torch.Tensor]:
    """A full Synchformer checkpoint under the reference's key names (``vfeat_extractor.*``,
    ``afeat_extractor.ast.*`` with HF AST's names and ``ast_positions`` position embeddings,
    ``afeat_extractor.freq_attn_agg.*``, ``vproj`` / ``aproj``, ``transformer.*``), fp32
    weights drawn from ``seed`` on the CPU: for checkpoint-free runs of the scorer (no
    reference checkpoint ships with the repo). Linear weights normal(0.02), biases
    normal(0.02), LayerNorm weights 1 + normal(0.02), tokens and embeddings normal(0.02),
    the OFF / MOD tokens and the scorer's position table normal(1)."""
    video_cfg = video_cfg or SynchformerConfig()
    ast_cfg = ast_cfg or ast_mod.ASTConfig()
    scorer_cfg = scorer_cfg or SyncScorerConfig()
    g = torch.Generator().manual_seed(int(seed))
    sd: Dict[str, torch.Tensor] = {}

    def rand(*shape, std=0.02):
        return torch.randn(*shape, generator=g) * std

    def lin(name, o, i):
        sd[name + ".weight"] = rand(o, i)
        sd[name + ".bias"] = rand(o)

    def ln(name, d):
        sd[name + ".weight"] = 1.0 + rand(d)
        sd[name + ".bias"] = rand(d)

    def encoder_layer(prefix, d, hidden):
        sd[prefix + "cls_token"] = rand(1, 1, d)
        sd[prefix + "self_attn.in_proj_weight"] = rand(3 * d, d)
        sd[prefix + "self_attn.in_proj_bias"] = rand(3 * d)
        lin(prefix + "self_attn.out_proj", d, d)
        lin(prefix + "linear1", hidden, d)
        lin(prefix + "linear2", d, hidden)
        ln(prefix + "norm1", d)
        ln(prefix + "norm2", d)

    v, d = "vfeat_extractor.", video_cfg.embed_dim
    hid = int(d * video_cfg.mlp_ratio)
    sd[v + "patch_embed_3d.proj.weight"] = rand(d, 3, video_cfg.temporal_patch_size,
                                                video_cfg.patch_size, video_cfg.patch_size)
    sd[v + "patch_embed_3d.proj.bias"] = rand(d)
    sd[v + "cls_token"] = rand(1, 1, d)
    sd[v + "pos_embed"] = rand(1, video_cfg.patches_per_frame + 1, d)
    sd[v + "temp_embed"] = rand(1, video_cfg.temporal_resolution, d)
    ln(v + "norm", d)
    for i in range(video_cfg.depth):
        b = f"{v}blocks.{i}."
        for name in ("norm1", "norm3", "norm2"):
            ln(b + name, d)
        for name, o, k in (("attn.qkv", 3 * d, d), ("attn.proj", d, d),
                           ("timeattn.qkv", 3 * d, d), ("timeattn.proj", d, d),
                           ("mlp.fc1", hid, d), ("mlp.fc2", d, hid)):
            lin(b + name, o, k)
    encoder_layer(v + "spatial_attn_agg.", d, hid)

    a, d = "afeat_extractor.ast.", ast_cfg.hidden_size
    p = ast_cfg.patch_size
    sd[a + "embeddings.cls_token"] = rand(1, 1, d)
    sd[a + "embeddings.distillation_token"] = rand(1, 1, d)
    sd[a + "embeddings.position_embeddings"] = rand(1, ast_positions, d)
    sd[a + "embeddings.patch_embeddings.projection.weight"] = rand(d, 1, p, p)
    sd[a + "embeddings.patch_embeddings.projection.bias"] = rand(d)
    ln(a + "layernorm", d)
    for i in range(ast_cfg.num_hidden_layers):
        b = f"{a}encoder.layer.{i}."
        ln(b + "layernorm_before", d)
        ln(b + "layernorm_after", d)
        for name in ("attention.attention.query", "attention.attention.key",
                     "attention.attention.value", "attention.output.dense"):
            lin(b + name, d, d)
        lin(b + "intermediate.dense", ast_cfg.intermediate_size, d)
        lin(b + "output.dense", d, ast_cfg.intermediate_size)
    encoder_layer("afeat_extractor.freq_attn_agg.", d, ast_cfg.intermediate_size)

    t, d = "transformer.", scorer_cfg.n_embd
    lin("vproj", d, video_cfg.embed_dim)
    lin("aproj", d, ast_cfg.hidden_size)
    ln(t + "vis_in_lnorm", d)
    ln(t + "aud_in_lnorm", d)
    sd[t + "OFF_tok"] = rand(1, 1, d, std=1.0)
    sd[t + "MOD_tok"] = rand(1, 1, d, std=1.0)
    sd[t + "pos_emb_cfg.pos_emb"] = rand(1, scorer_cfg.pos_max_len, d, std=1.0)
    ln(t + "ln_f", d)
    lin(t + "off_head", scorer_cfg.n_offset_classes, d)
    for i in range(scorer_cfg.n_layer):
        b = f"{t}blocks.{i}."
        ln(b + "ln1", d)
        ln(b + "ln2", d)
        for name in ("attn.query", "attn.key", "attn.value", "attn.proj"):
            lin(b + name, d, d)
        lin(b + "mlp.0", 4 * d, d)
        lin(b + "mlp.2", d, 4 * d)
    return sd


def load_desync_scorer(model_path: str, device: DeviceLike = None,
                       video_cfg: Optional[SynchformerConfig] = None,
                       ast_cfg: Optional[ast_mod.ASTConfig] = None,
                       scorer_cfg: Optional[SyncScorerConfig] = None) -> DesyncScorer:
    """The full Synchformer checkpoint (``vfeat_extractor.*``, ``afeat_extractor.ast.*``,
    ``afeat_extractor.freq_attn_agg.*``, ``vproj`` / ``aproj``, ``transformer.*``) -> a
    ``DesyncScorer`` on ``device`` (``cuda`` unless given), in fp32. The configs default to
    the reference's (``divided_224_16x4``, AST base, the 3-layer head)."""
    from foley_tpu_torch.io.convert import load_torch_state_dict, module_from_state_dict

    dev = resolve_device(device)
    sd = load_torch_state_dict(model_path)
    video_cfg = video_cfg or SynchformerConfig()
    ast_cfg = ast_cfg or ast_mod.ASTConfig()
    scorer_cfg = scorer_cfg or SyncScorerConfig()
    video = synchformer.SynchformerEncoder(module_from_state_dict(
        synchformer.Synchformer, synchformer.convert_state_dict(sd, video_cfg),
        video_cfg, dev, torch.float32))
    ast = module_from_state_dict(
        ast_mod.AST, ast_mod.convert_hf_state_dict(sd, ast_cfg, "afeat_extractor.ast."),
        ast_cfg, dev, torch.float32)
    freq_agg = freq_agg_from_state_dict(sd, "afeat_extractor.freq_attn_agg.",
                                        ast_cfg.hidden_size, dev)
    scorer = module_from_state_dict(SyncScorer, convert_state_dict(sd, scorer_cfg), scorer_cfg,
                                    dev, torch.float32)
    return DesyncScorer(video, ast, freq_agg, scorer)
