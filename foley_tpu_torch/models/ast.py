"""AST (Audio Spectrogram Transformer), Synchformer's audio branch, as ``nn.Module``s
(``foley_tpu/models/ast.py`` counterpart).

A 16x16 patch embedding at stride 10x10 over the ``[mel 128, time 66]`` spectrogram, tokens
in (frequency-major, time) order behind a CLS and a distillation token, learned position
embeddings cut to ``f * t + 2`` (74), pre-LN ViT layers and a final LayerNorm; then the
frequency pooling (a CLS-probe encoder layer over the 12 frequency patches of each time
step, ``synchformer.SpatialAgg``) -> ``[B, t = 6, 768]``. Every attention is the port's
plain ``ops/attention.py::sdpa`` (the JAX package runs it outside any Pallas kernel); fp32
models run in true fp32.

The training path's content mask (``cont_mask``, 0 = masked spectrogram cell) drops every
patch token whose 16x16 receptive field holds a masked cell, from the encoder's attention
(as keys: ``sdpa``'s mask sets their logits to the float32 minimum, where the JAX package
adds that minimum; both give exact zeros after the softmax, since every query keeps CLS)
and from the frequency pooling (``key_mask``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from foley_tpu_torch.models.synchformer import SpatialAgg, _spatial_agg
from foley_tpu_torch.ops.activations import gelu
from foley_tpu_torch.ops.attention import sdpa
from foley_tpu_torch.ops.nn import Dense, LayerNorm, empty_parameter


@dataclasses.dataclass(frozen=True)
class ASTConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    frequency_stride: int = 10
    time_stride: int = 10
    num_mel_bins: int = 128
    max_length: int = 66           # the reference's max_spec_t
    layer_norm_eps: float = 1e-12

    @property
    def freq_patches(self) -> int:
        return (self.num_mel_bins - self.patch_size) // self.frequency_stride + 1

    @property
    def time_patches(self) -> int:
        return (self.max_length - self.patch_size) // self.time_stride + 1

    @classmethod
    def tiny(cls) -> "ASTConfig":
        return cls(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=64, num_mel_bins=36, max_length=26)


def _dense(cin: int, cout: int, dtype, device) -> Dense:
    return Dense(cin, cout, scheme="normal02_zero_bias", dtype=dtype, device=device)


class ASTLayer(nn.Module):
    def __init__(self, cfg: ASTConfig, dtype, device):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ln_before = LayerNorm(d, eps, dtype, device)
        self.q, self.k, self.v, self.attn_out = (_dense(d, d, dtype, device) for _ in range(4))
        self.ln_after = LayerNorm(d, eps, dtype, device)
        self.inter = _dense(d, cfg.intermediate_size, dtype, device)
        self.out = _dense(cfg.intermediate_size, d, dtype, device)


class AST(nn.Module):
    """The JAX ``ast.init`` tree as modules (``io/from_jax.py::ast_from_jax``)."""

    def __init__(self, cfg: ASTConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        n_tok = cfg.freq_patches * cfg.time_patches + 2
        kw = dict(dtype=dtype, device=device)
        self.cls_token = empty_parameter(1, 1, d, **kw)
        self.distillation_token = empty_parameter(1, 1, d, **kw)
        self.position_embeddings = empty_parameter(1, n_tok, d, **kw)
        self.patch_proj = _dense(cfg.patch_size * cfg.patch_size, d, dtype, device)
        self.layernorm = LayerNorm(d, cfg.layer_norm_eps, dtype, device)
        self.layers = nn.ModuleList(ASTLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_hidden_layers))


def _patchify_spec(spec_tf: torch.Tensor, cfg: ASTConfig) -> torch.Tensor:
    """``[B, T, F]`` -> ``[B, f * t, P * P]``: HF AST's conv2d patches over ``[B, 1, F, T]``
    at stride (10, 10), tokens in (f-major, t) order, each patch (freq, time)-flattened."""
    x = spec_tf.transpose(1, 2)  # [B, F, T]
    p = cfg.patch_size
    patches = x.unfold(1, p, cfg.frequency_stride).unfold(2, p, cfg.time_stride)
    return patches.reshape(x.shape[0], -1, p * p)


def token_mask_from_cont_mask(cont_mask: torch.Tensor, cfg: ASTConfig) -> torch.Tensor:
    """Spectrogram mask ``[B, T, F]`` (0 = masked) -> token keep-mask ``[B, 2 + f * t]``
    (True = keep): a patch token is kept only if every cell of its patch is unmasked; CLS
    and distillation are always kept."""
    keep = (_patchify_spec(cont_mask.float(), cfg) > 0).all(-1)
    aux = torch.ones(keep.shape[0], 2, dtype=torch.bool, device=keep.device)
    return torch.cat([aux, keep], dim=1)


def apply(model: AST, spec_tf: torch.Tensor,
          token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[B, T = max_length, F = num_mel_bins]`` -> last hidden state ``[B, 2 + f * t, D]``.
    ``token_mask``: an optional ``[B, 2 + f * t]`` keep-mask (``token_mask_from_cont_mask``);
    no token attends to a masked one."""
    cfg = model.cfg
    mask = None if token_mask is None else token_mask[:, None, None, :]
    x = model.patch_proj(_patchify_spec(spec_tf, cfg))
    b, d = x.shape[0], x.shape[-1]
    x = torch.cat([model.cls_token.to(x.dtype).expand(b, 1, d),
                   model.distillation_token.to(x.dtype).expand(b, 1, d), x], dim=1)
    x = x + model.position_embeddings.to(x.dtype)
    nh = cfg.num_attention_heads
    for layer in model.layers:
        xn = layer.ln_before(x)
        q, k, v = (u.unflatten(-1, (nh, -1)) for u in (layer.q(xn), layer.k(xn), layer.v(xn)))
        x = x + layer.attn_out(sdpa(q, k, v, mask).flatten(2))
        x = x + layer.out(gelu(layer.inter(layer.ln_after(x))))
    return model.layernorm(x)


def extract_features_segments(model: AST, freq_agg: SpatialAgg, specs: torch.Tensor,
                              for_loop: bool = False,
                              cont_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segmented features ``[B, S, T, F]`` -> ``[B, S, t, D]``: one segment at a time
    (``for_loop``, the reference's memory-lean mode, which takes no ``cont_mask``) or every
    segment in one batch. ``cont_mask``: ``[B, S, T, F]``, 0 = masked."""
    b, s = specs.shape[:2]
    if for_loop:
        if cont_mask is not None:
            raise ValueError("cont_mask is not supported with for_loop (ast_model.py:162)")
        return torch.stack([extract_features(model, freq_agg, specs[:, i])
                            for i in range(s)], dim=1)
    flat_mask = None if cont_mask is None else cont_mask.flatten(0, 1)
    out = extract_features(model, freq_agg, specs.flatten(0, 1), cont_mask=flat_mask)
    return out.unflatten(0, (b, s))


def extract_features(model: AST, freq_agg: SpatialAgg, spec_tf: torch.Tensor,
                     num_heads_agg: Optional[int] = None,
                     cont_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Factorised frequency / time features ``[BS, T, F]`` -> ``[BS, t, D]`` (reference
    ``ast_model.forward_segments`` + ``FrequencyTransformerEncoderLayer``). ``cont_mask``
    ``[BS, T, F]`` (0 = masked) drops the masked tokens from the encoder's attention and
    from the frequency pooling."""
    cfg = model.cfg
    token_mask = None if cont_mask is None else token_mask_from_cont_mask(cont_mask, cfg)
    tokens = apply(model, spec_tf, token_mask)[:, 2:]  # CLS and distillation dropped
    bs, f_n, t_n, d = tokens.shape[0], cfg.freq_patches, cfg.time_patches, cfg.hidden_size
    x = tokens.reshape(bs, f_n, t_n, d).transpose(1, 2).reshape(bs * t_n, f_n, d)
    key_mask = None
    if token_mask is not None:
        key_mask = token_mask[:, 2:].reshape(bs, f_n, t_n).transpose(1, 2).reshape(bs * t_n, f_n)
    pooled = _spatial_agg(freq_agg, x, num_heads_agg or cfg.num_attention_heads,
                          key_mask=key_mask)
    return pooled.reshape(bs, t_n, d)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: ASTConfig,
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """An HF ``ASTModel`` state dict -> the port's ``AST`` state dict: the conv patch
    embedding ``[D, 1, P, P]`` flattened to a dense ``[D, P * P]``, the position embeddings
    cut to ``f * t + 2`` tokens (reference ``ast_model.py:250-255``)."""
    n_tok = cfg.freq_patches * cfg.time_patches + 2
    proj = sd[prefix + "embeddings.patch_embeddings.projection.weight"]
    out = {"cls_token": sd[prefix + "embeddings.cls_token"],
           "distillation_token": sd[prefix + "embeddings.distillation_token"],
           "position_embeddings": sd[prefix + "embeddings.position_embeddings"][:, :n_tok],
           "patch_proj.weight": proj.reshape(proj.shape[0], -1),
           "patch_proj.bias": sd[prefix + "embeddings.patch_embeddings.projection.bias"]}

    def take(src: str, dst: str) -> None:
        out[dst + ".weight"] = sd[prefix + src + ".weight"]
        out[dst + ".bias"] = sd[prefix + src + ".bias"]

    take("layernorm", "layernorm")
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layer.{i}."
        for src, dst in (("layernorm_before", "ln_before"), ("attention.attention.query", "q"),
                         ("attention.attention.key", "k"), ("attention.attention.value", "v"),
                         ("attention.output.dense", "attn_out"),
                         ("layernorm_after", "ln_after"), ("intermediate.dense", "inter"),
                         ("output.dense", "out")):
            take(b + src, f"layers.{i}.{dst}")
    return out
