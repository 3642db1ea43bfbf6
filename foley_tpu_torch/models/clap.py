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
(``encode_ids``). The checkpoint converter and ``load`` are not ported yet.

Parameter names follow the JAX tree (``w``/``b`` become ``weight``/``bias``), so
``io/from_jax.py`` maps one onto the other by name.
"""

from __future__ import annotations

from typing import Callable, List, Optional

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
