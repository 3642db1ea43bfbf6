"""CLAP text encoder (laion/larger_clap_general's text tower) as ``nn.Module``s
(``foley_tpu/models/clap.py`` counterpart).

The reference uses the tower's last hidden state, not its projection, as the 768-d token
sequence that conditions the denoiser. The tower is a RoBERTa post-LN encoder:
- position ids are ``cumsum(mask) * mask + pad_token_id`` (valid positions count from
  ``pad_token_id + 1``, padded ones keep ``pad_token_id``);
- token-type row 0 is added at every position;
- LayerNorm eps 1e-12 and the exact (erf) GELU;
- key-padding masked self-attention, head dim 64, through the plain ``ops/attention.py::sdpa``
  (the JAX package runs no Pallas kernel here either).

It runs in fp32, the checkpoint's dtype, with TF32 off (``true_fp32``). Tokenization stays
on the host: ``ClapTextEncoder`` takes an optional tokenizer callable with the call of
``transformers.AutoTokenizer``; without one it encodes token ids and masks
(``encode_ids``). ``load`` reads a Hugging Face checkpoint and RoBERTa's byte-level BPE
tokenizer through the port's own reader (``io/tokenizer.py``).

Parameter names follow the JAX tree (``w``/``b`` become ``weight``/``bias``), so
``io/from_jax.py`` maps one onto the other by name.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from foley_tpu_torch.configs import ClapTextConfig
from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.ops.attention import sdpa
from foley_tpu_torch.ops.nn import Dense, LayerNorm, empty_parameter, init_parameters, true_fp32


class Embeddings(nn.Module):
    def __init__(self, cfg: ClapTextConfig, dtype, device):
        super().__init__()
        h = cfg.hidden_size
        self.word = empty_parameter(cfg.vocab_size, h, dtype=dtype, device=device)
        self.position = empty_parameter(cfg.max_position_embeddings, h, dtype=dtype,
                                        device=device)
        self.token_type = empty_parameter(cfg.type_vocab_size, h, dtype=dtype, device=device)
        self.ln = LayerNorm(h, cfg.layer_norm_eps, dtype, device)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        for p in (self.word, self.position, self.token_type):
            p.normal_(0.0, 0.02, generator=g)


class Layer(nn.Module):
    def __init__(self, cfg: ClapTextConfig, dtype, device):
        super().__init__()
        h, inter, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.q, self.k, self.v, self.attn_out = (Dense(h, h, dtype=dtype, device=device)
                                                 for _ in range(4))
        self.attn_ln = LayerNorm(h, eps, dtype, device)
        self.inter = Dense(h, inter, dtype=dtype, device=device)
        self.out = Dense(inter, h, dtype=dtype, device=device)
        self.out_ln = LayerNorm(h, eps, dtype, device)


class ClapText(nn.Module):
    def __init__(self, cfg: ClapTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, dtype, device)
        self.layers = nn.ModuleList(Layer(cfg, dtype, device)
                                    for _ in range(cfg.num_hidden_layers))


def init(cfg: ClapTextConfig, generator: torch.Generator, device: DeviceLike = None,
         dtype=torch.float32) -> ClapText:
    """A randomly initialized tower on ``device`` (``cuda`` unless given; the generator must
    live there), in the JAX ``init``'s schemes: normal(0.02) embeddings, nn.Linear's
    Kaiming-uniform dense layers, unit LayerNorms."""
    model = ClapText(cfg, dtype=dtype, device=resolve_device(device))
    init_parameters(model, generator)
    return model


@torch.no_grad()
def apply(model: ClapText, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """input_ids, attention_mask [B, L] (mask 1 = token, 0 = padding) -> last hidden state
    [B, L, hidden], in fp32 with TF32 off."""
    cfg = model.cfg
    emb = model.embeddings
    mask = attention_mask.long()
    position_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
    b, length = input_ids.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    keep = (mask > 0)[:, None, None, :]  # [B, 1, 1, L]: every query sees the valid keys
    with true_fp32():
        x = (F.embedding(input_ids.long(), emb.word) + F.embedding(position_ids, emb.position)
             + emb.token_type[0])
        x = emb.ln(x)
        for layer in model.layers:
            q, k, v = (proj(x).view(b, length, nh, hd) for proj in (layer.q, layer.k, layer.v))
            ctx = sdpa(q, k, v, mask=keep).reshape(b, length, -1)
            x = layer.attn_ln(x + layer.attn_out(ctx))
            x = layer.out_ln(x + layer.out(F.gelu(layer.inter(x))))  # exact erf GELU
    return x


class ClapTextEncoder:
    """The tower's weights and an optional host tokenizer, the call of the JAX package's
    ``ClapTextEncoder`` (``encode_text_feat`` in the reference)."""

    def __init__(self, model: ClapText, tokenizer: Optional[Callable] = None):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return self.model.embeddings.word.device

    def encode(self, prompts: List[str], max_length: Optional[int] = None) -> torch.Tensor:
        """Prompts -> [N, L, hidden] fp32 on the encoder's device, L the longest prompt's
        token count (padded, truncated to ``max_length``)."""
        if self.tokenizer is None:
            raise ValueError("this CLAP encoder has no tokenizer; pass token ids and masks "
                             "to encode_ids")
        tok = self.tokenizer(prompts, padding=True, truncation=True,
                             max_length=max_length or self.cfg.max_position_embeddings - 2,
                             return_tensors="np")
        return self.encode_ids(tok["input_ids"], tok["attention_mask"])

    def encode_ids(self, input_ids, attention_mask) -> torch.Tensor:
        """Token ids and masks [N, L] (arrays or tensors) -> [N, L, hidden] fp32."""
        ids, mask = (torch.as_tensor(a).to(self.device) for a in (input_ids, attention_mask))
        return apply(self.model, ids, mask)


def encode_text(encoder: ClapTextEncoder, prompts: List[str]) -> torch.Tensor:
    """[neg, pos, ...] prompts -> [N, L, hidden]; the caller keeps the CFG row order."""
    return encoder.encode(prompts)


# ---------------------------------------------------------------------------------
# Checkpoint conversion and loading
# ---------------------------------------------------------------------------------

def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: ClapTextConfig,
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """A Hugging Face ClapTextModel state dict (or ``text_model.``-prefixed) -> the port's
    ``ClapText`` state dict (the pooler and projection are not used)."""
    out: Dict[str, torch.Tensor] = {}

    def lin(src, dst):
        out[dst + ".weight"] = sd[prefix + src + ".weight"]
        if prefix + src + ".bias" in sd:
            out[dst + ".bias"] = sd[prefix + src + ".bias"]

    for src, dst in (("word_embeddings", "word"), ("position_embeddings", "position"),
                     ("token_type_embeddings", "token_type")):
        out[f"embeddings.{dst}"] = sd[f"{prefix}embeddings.{src}.weight"]
    lin("embeddings.LayerNorm", "embeddings.ln")
    for i in range(cfg.num_hidden_layers):
        for src, dst in (("attention.self.query", "q"), ("attention.self.key", "k"),
                         ("attention.self.value", "v"), ("attention.output.dense", "attn_out"),
                         ("attention.output.LayerNorm", "attn_ln"),
                         ("intermediate.dense", "inter"), ("output.dense", "out"),
                         ("output.LayerNorm", "out_ln")):
            lin(f"encoder.layer.{i}.{src}", f"layers.{i}.{dst}")
    return out


def _infer_config(sd: Dict[str, torch.Tensor], prefix: str, model_path: str) -> ClapTextConfig:
    """The tower's config from the checkpoint's shapes and a colocated ``config.json``; the
    head count, pad id and LayerNorm eps are not in the shapes (larger_clap_general's
    defaults: head dim 64, pad id 1, eps 1e-12)."""
    vocab_size, hidden = sd[prefix + "embeddings.word_embeddings.weight"].shape
    max_pos = sd[prefix + "embeddings.position_embeddings.weight"].shape[0]
    type_vocab = sd[prefix + "embeddings.token_type_embeddings.weight"].shape[0]
    inter = sd[prefix + "encoder.layer.0.intermediate.dense.weight"].shape[0]
    n_layers = 1 + max(int(k.split(".")[len(prefix.split(".")) + 1])
                       for k in sd if k.startswith(prefix + "encoder.layer."))
    heads, pad_token_id, eps = max(1, hidden // 64), 1, 1e-12
    cfg_json = os.path.join(model_path, "config.json") if os.path.isdir(model_path) else None
    if cfg_json and os.path.exists(cfg_json):
        with open(cfg_json) as f:
            raw = json.load(f)
        raw = raw.get("text_config", raw)
        heads = int(raw.get("num_attention_heads", heads))
        pad_token_id = int(raw.get("pad_token_id") or pad_token_id)
        eps = float(raw.get("layer_norm_eps", eps))
    return ClapTextConfig(
        vocab_size=int(vocab_size), hidden_size=int(hidden), num_hidden_layers=int(n_layers),
        num_attention_heads=heads, intermediate_size=int(inter),
        max_position_embeddings=int(max_pos), type_vocab_size=int(type_vocab),
        pad_token_id=pad_token_id, layer_norm_eps=eps)


def load(model_path: str, tokenizer_path: Optional[str] = None,
         device: DeviceLike = None) -> ClapTextEncoder:
    """A local Hugging Face checkpoint (directory or state-dict file) -> an fp32 encoder on
    ``device`` (``cuda`` unless given). The tokenizer comes from ``tokenizer_path``, else
    from the checkpoint's directory; there is no download, so without either it raises."""
    from foley_tpu_torch.io.convert import load_torch_state_dict, module_from_state_dict
    from foley_tpu_torch.io.tokenizer import load_tokenizer

    sd = load_torch_state_dict(model_path)
    prefix = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    cfg = _infer_config(sd, prefix, model_path)
    model = module_from_state_dict(ClapText, convert_hf_state_dict(sd, cfg, prefix), cfg,
                                   device, torch.float32)
    if not tokenizer_path and os.path.isdir(model_path) and any(
            os.path.exists(os.path.join(model_path, f)) for f in ("tokenizer.json",
                                                                  "vocab.json")):
        tokenizer_path = model_path
    if not tokenizer_path:
        raise FileNotFoundError(
            "CLAP tokenizer: pass tokenizer_path (a directory with tokenizer.json, or "
            "vocab.json and merges.txt) or colocate it with a directory checkpoint")
    return ClapTextEncoder(model, load_tokenizer(tokenizer_path))
