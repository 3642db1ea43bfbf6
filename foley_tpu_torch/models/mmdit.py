"""HunyuanVideoFoley MMDiT denoiser as ``nn.Module``s (``foley_tpu/models/mmdit.py``
counterpart).

N triple-stream blocks (audio + visual streams with joint self-attention, text
cross-attention, 9-way adaLN each) followed by M single-stream blocks (6-way per-token
modulation, fused qkv, conv output projections), with learned empty clip/sync features for
CFG/T2A, interleaved audio-visual RoPE and additive Synchformer conditioning before the
first triple block.

``MMDiT.forward`` is the JAX ``apply``. The attention of every single block goes through
``fused_qk_attention`` (K1): the Hopper kernel for CUDA tensors, its plain version for CPU
tensors, in the parameters' type (bf16, fp16 or fp32; an fp32 model runs its products in
true fp32, ``ops/nn.py::exact_fp32``). So does the joint ``[v_cond; audio]`` attention of
every triple block under K1's precondition in the JAX package (``qk_norm`` on, no attention
mask, interleaved RoPE whose decomposition holds at these lengths: every shipped config).
Outside it the joint attention takes the JAX package's XLA route on every device: qk-norm
when configured, the RoPE of the config (the exact interleave / rotate / decouple path when
the identity check fails, ``ops/rope.py``), then the plain ``ops/attention.py::sdpa`` with
the mask the JAX ``apply`` builds. ``attention_tables`` makes that choice once per config
and lengths, before any launch.

Memory modes: the ``Dense`` / ``Conv1d`` weights may be in quantized storage
(``io/quantize.py``), and the last blocks may live in host memory (``block_swap``,
``parallel/offload.py``): the block loops fetch each swapped block through
``offload.stream_blocks``, whose window ``offload_prefetch`` the forward takes. The qk-norm
weight tables K1 reads are built on the device whatever the block's place, and the
timestep-invariant hoists (``precompute_text_kv``, ``precompute_triple_mods``) return
None when the triple stack is split, as in the JAX package: the blocks then compute them.

Training (``training/train.py``) takes the JAX package's ``"xla"`` route, which no kernel
lies on (``attn_impl="xla"``: the plain joint attention in the triple blocks, qk-norm, RoPE
and ``sdpa`` in the single blocks, as ``jax.grad`` differentiates them), with each block
checkpointed (``remat``, the JAX ``_run_stack``'s ``jax.checkpoint``) and, for LoRA, the
adapter applied unmerged inside each block (``lora``, ``models/lora.py::block_lora``). The
kernels have no backward and raise under autograd.

Parameter names follow the JAX tree (``w``/``b`` become ``weight``/``bias``; the stacked
block axis becomes ``triple_blocks.<i>`` / ``single_blocks.<i>``), so ``io/from_jax.py``
maps one onto the other by name.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from foley_tpu_torch.configs import MMDiTConfig
from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.models import lora as lora_mod
from foley_tpu_torch.ops.activations import get_activation, swiglu
from foley_tpu_torch.ops.attention import sdpa
from foley_tpu_torch.ops.interp import nearest_exact_indices, nearest_exact_resize
from foley_tpu_torch.ops.kernels.fused_attention import fused_qk_attention
from foley_tpu_torch.ops.modulate import apply_gate, modulate, modulate_ref
from foley_tpu_torch.ops.nn import Conv1d, Dense, exact_fp32, init_parameters
from foley_tpu_torch.ops.norms import layer_norm, rms_norm
from foley_tpu_torch.ops.rope import (
    apply_rotary_emb,
    decouple_interleaved,
    interleave_sequences,
    rope_table,
)
from foley_tpu_torch.parallel import offload


# ---------------------------------------------------------------------------------
# Sub-modules
# ---------------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """qk RMSNorm weight (ones at init); the norm itself is ``ops.norms.rms_norm``."""

    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype, device=device),
                                   requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, eps=self.eps)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.weight.fill_(1.0)


class Mlp(nn.Module):
    """timm-style MLP: fc2(act(fc1 x)), bias on both."""

    def __init__(self, dim: int, hidden: int, act: str, dtype, device):
        super().__init__()
        self.act = get_activation(act)
        self.fc1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class ConvMLP(nn.Module):
    """w2(silu(w1 x) * w3 x) with bias-free channel-last convs."""

    def __init__(self, dim: int, hidden: int, kernel_size: int, dtype, device):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.w1 = Conv1d(dim, hidden, kernel_size, **kw)
        self.w2 = Conv1d(hidden, dim, kernel_size, **kw)
        self.w3 = Conv1d(dim, hidden, kernel_size, **kw)

    def forward(self, x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
        pad = (kernel_size - 1) // 2
        return self.w2(swiglu(self.w1(x, padding=pad), self.w3(x, padding=pad)), padding=pad)


class SwiGLUProj(nn.Module):
    """Visual projection w2(silu(w1 x) * w3 x), bias-free dense layers."""

    def __init__(self, in_dim: int, dim: int, dtype, device):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.w1 = Dense(in_dim, dim, **kw)
        self.w2 = Dense(dim, dim, **kw)
        self.w3 = Dense(in_dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(swiglu(self.w1(x), self.w3(x)))


class CondIn(nn.Module):
    """ConditionProjection: linear_2(silu(linear_1 x))."""

    def __init__(self, in_dim: int, dim: int, dtype, device):
        super().__init__()
        self.linear_1 = Dense(in_dim, dim, dtype=dtype, device=device)
        self.linear_2 = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


def timestep_embedding(t: torch.Tensor, dim: int = 256,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding in fp32. t: [B] in [0, 1000)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimeIn(nn.Module):
    """TimestepEmbedder: normal(0.02) weights."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.mlp_0 = Dense(256, dim, scheme="normal02", dtype=dtype, device=device)
        self.mlp_2 = Dense(dim, dim, scheme="normal02", dtype=dtype, device=device)

    def forward(self, t: torch.Tensor, compute_dtype) -> torch.Tensor:
        return self.mlp_2(F.silu(self.mlp_0(timestep_embedding(t).to(compute_dtype))))


class FinalLayer(nn.Module):
    """FinalLayer1D. With per-token ``c`` the adaLN output would be dropped by
    ``modulate_ref``, so its dense is skipped (the JAX package's ``apply_final_layer``)."""

    def __init__(self, dim: int, out_dim: int, dtype, device):
        super().__init__()
        self.linear = Dense(dim, out_dim, scheme="zeros", dtype=dtype, device=device)
        self.adaLN = Dense(dim, 2 * dim, scheme="zeros", dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if x.ndim == 3 and c.ndim == 3:
            x = modulate_ref(layer_norm(x), None, None)
        else:
            shift, scale = self.adaLN(F.silu(c)).chunk(2, dim=-1)
            x = modulate_ref(layer_norm(x), shift, scale)
        return self.linear(x)


class SyncIn(nn.Module):
    def __init__(self, cfg: MMDiTConfig, dtype, device):
        super().__init__()
        h = cfg.hidden_size
        self.linear = Dense(cfg.sync_feat_dim, h, dtype=dtype, device=device)
        self.conv_mlp = ConvMLP(h, _conv_mlp_hidden(4 * h, cfg.conv_mlp_multiple_of),
                                cfg.sync_in_ksz, dtype, device)


def _conv_mlp_hidden(hidden_dim: int, multiple_of: int) -> int:
    hidden = int(2 * hidden_dim / 3)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)


def _split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """[..., H * D] -> [..., H, D], the head count read from the width: a tensor-parallel
    rank (``parallel/sharding.py``) holds whole heads, fewer than ``cfg.num_heads``."""
    return x.unflatten(-1, (-1, head_dim))


def _qk_norm(norm: Optional["RMSNorm"], x: torch.Tensor) -> torch.Tensor:
    """The qk RMSNorm, or ``x`` itself without ``qk_norm`` (the JAX ``_qk_norm``)."""
    return x if norm is None else norm(x)


def _on(tables: tuple, device) -> tuple:
    """A block's norm tables on the computing device (a swapped block's weights are in host
    memory)."""
    return tuple(t.to(device) for t in tables)


# ---------------------------------------------------------------------------------
# RoPE tables
# ---------------------------------------------------------------------------------

class RopeTables(NamedTuple):
    """All RoPE tables of one forward pass (fp32 [L, D] cos/sin pairs)."""

    joint: tuple                      # interleaved table [2*T_audio, D]
    v_joint: Optional[tuple]          # visual-stream table when not interleaved
    audio: tuple                      # [T_audio, D]: single blocks and cross-attn q
    visual_cross: tuple               # [L_visual, D] cross-attn q table
    text: tuple                       # [L_text, D] cross-attn k table
    audio_joint: Optional[tuple] = None   # even rows of the interleaved table
    visual_joint: Optional[tuple] = None  # odd rows gathered at the decouple positions


def build_rope_tables(cfg: MMDiTConfig, audio_len: int, visual_len: int, text_len: int,
                      device=None) -> RopeTables:
    """Every table of a forward pass.

    Interleaved RoPE interleaves [audio; visual-resized] tokens, rotates with a 2T table and
    decouples with a second nearest-exact resize. Rotation is positionwise, so whenever
    up-then-down resampling is the identity (checked here, on the host) the round trip
    equals rotating audio with the even rows and visual with the odd rows gathered at the
    decouple positions; ``audio_joint``/``visual_joint`` are then set, else left None.
    The non-interleaved visual table is frequency-rescaled by audio_len/visual_len.
    """
    d, theta = cfg.head_dim, cfg.rope_theta
    audio = rope_table(audio_len, d, theta, device=device)
    audio_joint = visual_joint = None
    if cfg.interleaved_audio_visual_rope:
        joint = rope_table(audio_len * 2, d, theta, device=device)
        v_joint = None
        if visual_len == audio_len:
            g2 = np.arange(audio_len)
            identity = True
        else:
            g1 = nearest_exact_indices(visual_len, audio_len)  # upsample gather
            g2 = nearest_exact_indices(audio_len, visual_len)  # decouple gather
            identity = bool(np.array_equal(g1[g2], np.arange(visual_len)))
        if identity:
            cos, sin = joint
            idx = torch.from_numpy(np.asarray(g2, np.int64)).to(cos.device)
            audio_joint = (cos[0::2], sin[0::2])
            visual_joint = (cos[1::2][idx], sin[1::2][idx])
    else:
        joint = audio
        v_joint = rope_table(visual_len, d, theta, freq_scaling=audio_len / visual_len,
                             device=device)
    return RopeTables(
        joint=joint,
        v_joint=v_joint,
        audio=audio,
        visual_cross=rope_table(visual_len, d, theta, device=device),
        text=rope_table(text_len, d, theta, device=device),
        audio_joint=audio_joint,
        visual_joint=visual_joint,
    )


def fused_joint(cfg: MMDiTConfig, ropes: RopeTables) -> bool:
    """K1's precondition for the joint attention, as the JAX ``triple_block_apply`` states
    it: qk-norm on, no attention mask, interleaved RoPE whose decomposition holds."""
    return (cfg.qk_norm and not cfg.use_attention_mask and cfg.interleaved_audio_visual_rope
            and ropes.audio_joint is not None)


def joint_attention_mask(cond_mask: torch.Tensor, visual_len: int,
                         audio_len: int) -> torch.Tensor:
    """The JAX ``apply``'s ``use_attention_mask`` mask (reference ``hifi_foley.py:774-793``):
    the full ``[text; visual; audio]`` mask, column 0 forced on, then its
    ``[visual; audio]`` block, [B, 1, L, L] boolean (True = attend)."""
    bs, text_len = cond_mask.shape
    seq_len = text_len + visual_len + audio_len
    ones_av = torch.ones(bs, visual_len + audio_len, dtype=torch.bool, device=cond_mask.device)
    concat = torch.cat([cond_mask.to(torch.bool), ones_av], dim=1)
    m1 = concat[:, None, None, :].expand(bs, 1, seq_len, seq_len)
    full = m1 & m1.transpose(2, 3)
    full[:, :, :, 0] = True
    return full[:, :, text_len:, text_len:]


class AttentionTables(NamedTuple):
    """The timestep-invariant tables of a forward pass at one set of lengths: built once
    per generation by ``MMDiT.attention_tables`` and passed to every step."""

    ropes: RopeTables
    joint_rope: Optional[tuple]    # (cos, sin) [L_visual + T_audio, D]; None: plain route
    triple_norms: Optional[tuple]  # per triple block: (wq, wk) fp32; None: plain route
    single_norms: tuple            # per single block: (wq, wk) fp32 [T_audio, D]


# ---------------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------------

class TripleBlock(nn.Module):
    """TwoStreamCABlock: joint self-attention, text cross-attention, gated MLPs."""

    def __init__(self, cfg: MMDiTConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        h, hd, eps = cfg.hidden_size, cfg.head_dim, cfg.qk_norm_eps
        kw = dict(dtype=dtype, device=device)
        qb = dict(bias=cfg.qkv_bias, **kw)

        def qk_norm():  # the JAX tree's leaf is empty without qk_norm
            return RMSNorm(hd, eps, **kw) if cfg.qk_norm else None

        self.audio_mod = Dense(h, 9 * h, scheme="zeros", **kw)
        self.v_cond_mod = Dense(h, 9 * h, scheme="zeros", **kw)
        self.audio_self_attn_qkv = Dense(h, 3 * h, **qb)
        self.audio_self_q_norm = qk_norm()
        self.audio_self_k_norm = qk_norm()
        self.audio_self_proj = Dense(h, h, **qb)
        self.v_cond_attn_qkv = Dense(h, 3 * h, **qb)
        self.v_cond_attn_q_norm = qk_norm()
        self.v_cond_attn_k_norm = qk_norm()
        self.v_cond_self_proj = Dense(h, h, **qb)
        self.audio_cross_q = Dense(h, h, **qb)
        self.v_cond_cross_q = Dense(h, h, **qb)
        self.text_cross_kv = Dense(h, 2 * h, **qb)
        self.audio_cross_q_norm = qk_norm()
        self.v_cond_cross_q_norm = qk_norm()
        self.text_cross_k_norm = qk_norm()
        self.audio_cross_proj = Dense(h, h, **qb)
        self.v_cond_cross_proj = Dense(h, h, **qb)
        self.audio_mlp = Mlp(h, cfg.mlp_hidden_dim, cfg.mlp_act_type, **kw)
        self.v_cond_mlp = Mlp(h, cfg.mlp_hidden_dim, cfg.mlp_act_type, **kw)

    def text_kv(self, cond: torch.Tensor, ropes_text) -> Tuple[torch.Tensor, torch.Tensor]:
        """Text-side K/V of the cross-attention: projection, k-norm, RoPE (all
        timestep-invariant)."""
        t_k, t_v = (_split_heads(u, self.cfg.head_dim)
                    for u in self.text_cross_kv(cond).chunk(2, dim=-1))
        t_k = apply_rotary_emb(_qk_norm(self.text_cross_k_norm, t_k), *ropes_text)
        return t_k, t_v

    def norm_tables(self, audio_len: int, visual_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The joint attention's fp32 per-position q and k norm weights over
        ``[v_cond; audio]`` ([L_visual + T_audio, D] each)."""
        def cat_tab(v_w, a_w):
            return torch.cat([v_w.float().expand(visual_len, v_w.shape[-1]),
                              a_w.float().expand(audio_len, a_w.shape[-1])], dim=0)

        return (cat_tab(self.v_cond_attn_q_norm.weight, self.audio_self_q_norm.weight),
                cat_tab(self.v_cond_attn_k_norm.weight, self.audio_self_k_norm.weight))

    def plain_joint_attention(self, a_q, a_k, a_v, v_q, v_k, v_v, ropes: RopeTables,
                              attn_mask=None) -> torch.Tensor:
        """The JAX package's XLA route of the joint attention (outside K1's precondition):
        qk-norm when configured, the config's RoPE (decomposed, exact interleave / decouple,
        or per stream), then the plain attention over ``[v_cond; audio]`` with ``attn_mask``."""
        a_q = _qk_norm(self.audio_self_q_norm, a_q)
        a_k = _qk_norm(self.audio_self_k_norm, a_k)
        v_q = _qk_norm(self.v_cond_attn_q_norm, v_q)
        v_k = _qk_norm(self.v_cond_attn_k_norm, v_k)
        audio_len, visual_len = a_q.shape[1], v_q.shape[1]
        if self.cfg.interleaved_audio_visual_rope and ropes.audio_joint is not None:
            a_q, a_k = (apply_rotary_emb(u, *ropes.audio_joint) for u in (a_q, a_k))
            v_q, v_k = (apply_rotary_emb(u, *ropes.visual_joint) for u in (v_q, v_k))
        elif self.cfg.interleaved_audio_visual_rope:
            q_i = apply_rotary_emb(interleave_sequences(a_q, v_q), *ropes.joint)
            k_i = apply_rotary_emb(interleave_sequences(a_k, v_k), *ropes.joint)
            a_q, v_q = decouple_interleaved(q_i, audio_len, visual_len)
            a_k, v_k = decouple_interleaved(k_i, audio_len, visual_len)
        else:
            a_q, a_k = (apply_rotary_emb(u, *ropes.joint) for u in (a_q, a_k))
            if ropes.v_joint is not None:
                v_q, v_k = (apply_rotary_emb(u, *ropes.v_joint) for u in (v_q, v_k))
        return sdpa(torch.cat([v_q, a_q], dim=1), torch.cat([v_k, a_k], dim=1),
                    torch.cat([v_v, a_v], dim=1), mask=attn_mask)

    def forward(self, audio, cond, v_cond, vec, ropes: RopeTables, joint_rope, norms,
                sync_vec=None, text_kv=None, mods=None, attn_mask=None):
        """Returns (audio, v_cond). ``joint_rope``: the (cos, sin) tables of the
        ``[v_cond; audio]`` sequence and ``norms`` this block's ``norm_tables``, both None on
        the plain route (``plain_joint_attention``, with ``attn_mask``). ``text_kv``:
        precomputed (t_k, t_v) of this block (then ``cond`` is unused). ``mods``: precomputed
        (a_mod, v_mod) [1, 9H] adaLN vectors."""
        hd, eps = self.cfg.head_dim, self.cfg.qk_norm_eps
        visual_len = v_cond.shape[1]
        if mods is not None:
            a_mod, v_mod = mods
        else:
            mod_src = sync_vec if sync_vec is not None else vec
            a_mod = self.audio_mod(F.silu(mod_src))
            v_mod = self.v_cond_mod(F.silu(vec))
        (a1_shift, a1_scale, a1_gate, a2_shift, a2_scale, a2_gate,
         a3_shift, a3_scale, a3_gate) = a_mod.chunk(9, dim=-1)
        (v1_shift, v1_scale, v1_gate, v2_shift, v2_scale, v2_gate,
         v3_shift, v3_scale, v3_gate) = v_mod.chunk(9, dim=-1)

        # ---- 1. joint self-attention over [v_cond; audio], norm + RoPE fused ----
        a_in = modulate_ref(layer_norm(audio), a1_shift, a1_scale)
        a_q, a_k, a_v = (_split_heads(u, hd)
                         for u in self.audio_self_attn_qkv(a_in).chunk(3, dim=-1))
        v_in = modulate_ref(layer_norm(v_cond), v1_shift, v1_scale)
        v_q, v_k, v_v = (_split_heads(u, hd)
                         for u in self.v_cond_attn_qkv(v_in).chunk(3, dim=-1))

        if norms is None:
            attn = self.plain_joint_attention(a_q, a_k, a_v, v_q, v_k, v_v, ropes, attn_mask)
        else:
            cos, sin = joint_rope
            attn = fused_qk_attention(torch.cat([v_q, a_q], dim=1), torch.cat([v_k, a_k], dim=1),
                                      torch.cat([v_v, a_v], dim=1), *norms, cos, sin, cos, sin,
                                      eps=eps)
        v_attn, a_attn = attn[:, :visual_len], attn[:, visual_len:]
        audio = audio + apply_gate(self.audio_self_proj(a_attn.flatten(2)), a1_gate)
        v_cond = v_cond + apply_gate(self.v_cond_self_proj(v_attn.flatten(2)), v1_gate)

        # ---- 2. cross-attention: [v_cond; audio] queries vs text k/v ----
        a_in = modulate_ref(layer_norm(audio), a2_shift, a2_scale)
        v_in = modulate_ref(layer_norm(v_cond), v2_shift, v2_scale)
        a_q = _qk_norm(self.audio_cross_q_norm, _split_heads(self.audio_cross_q(a_in), hd))
        v_q = _qk_norm(self.v_cond_cross_q_norm, _split_heads(self.v_cond_cross_q(v_in), hd))
        t_k, t_v = text_kv if text_kv is not None else self.text_kv(cond, ropes.text)
        a_q = apply_rotary_emb(a_q, *ropes.audio)
        v_q = apply_rotary_emb(v_q, *ropes.visual_cross)
        cross = sdpa(torch.cat([v_q, a_q], dim=1), t_k, t_v)
        v_x, a_x = cross[:, :visual_len], cross[:, visual_len:]
        audio = audio + apply_gate(self.audio_cross_proj(a_x.flatten(2)), a2_gate)
        v_cond = v_cond + apply_gate(self.v_cond_cross_proj(v_x.flatten(2)), v2_gate)

        # ---- 3. MLPs ----
        audio = audio + apply_gate(
            self.audio_mlp(modulate_ref(layer_norm(audio), a3_shift, a3_scale)), a3_gate)
        v_cond = v_cond + apply_gate(
            self.v_cond_mlp(modulate_ref(layer_norm(v_cond), v3_shift, v3_scale)), v3_gate)
        return audio, v_cond


class SingleBlock(nn.Module):
    """SingleStreamBlock; ``vec`` is per-token [B, T, H] (2-D [B, H] when neither sync flag
    is set). ``vec`` may carry half of ``x``'s batch rows (``visual_rows_shared``): the
    modulation GEMM then runs on the half and its result is tiled."""

    def __init__(self, cfg: MMDiTConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        h, hd, eps = cfg.hidden_size, cfg.head_dim, cfg.qk_norm_eps
        kw = dict(dtype=dtype, device=device)
        self.modulation = Dense(h, 6 * h, scheme="zeros", **kw)
        self.linear_qkv = Dense(h, 3 * h, **kw)
        self.q_norm = RMSNorm(hd, eps, **kw)
        self.k_norm = RMSNorm(hd, eps, **kw)
        self.linear1 = Conv1d(h, h, 3, **kw)
        self.linear2 = ConvMLP(h, cfg.conv_mlp_hidden_dim, 3, **kw)

    def norm_tables(self, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 per-position q and k norm weights ([length, D] each)."""
        return tuple(w.float().expand(length, w.shape[-1]).contiguous()
                     for w in (self.q_norm.weight, self.k_norm.weight))

    def forward(self, x: torch.Tensor, vec: torch.Tensor, ropes: RopeTables,
                norms) -> torch.Tensor:
        """``norms``: this block's ``norm_tables`` (K1), or None for the JAX package's XLA
        route: RMS-norm of q and k, RoPE, then the plain ``sdpa``."""
        mod = self.modulation(F.silu(vec))
        if mod.shape[0] != x.shape[0]:
            mod = torch.cat([mod] * (x.shape[0] // mod.shape[0]), dim=0)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)

        x_n = modulate(layer_norm(x), shift_msa, scale_msa)
        q, k, v = (_split_heads(u, self.cfg.head_dim)
                   for u in self.linear_qkv(x_n).chunk(3, dim=-1))
        cos, sin = ropes.audio
        eps = self.cfg.qk_norm_eps
        if norms is None:
            q = apply_rotary_emb(rms_norm(q, self.q_norm.weight, eps=eps), cos, sin)
            k = apply_rotary_emb(rms_norm(k, self.k_norm.weight, eps=eps), cos, sin)
            out = sdpa(q, k, v).flatten(2)
        else:
            out = fused_qk_attention(q, k, v, *norms, cos, sin, cos, sin, eps=eps).flatten(2)
        x = x + apply_gate(self.linear1(out, padding=1), gate_msa)
        x_n = modulate(layer_norm(x), shift_mlp, scale_mlp)
        return x + apply_gate(self.linear2(x_n, kernel_size=3), gate_mlp)


# ---------------------------------------------------------------------------------
# The denoiser
# ---------------------------------------------------------------------------------

class MMDiT(nn.Module):
    def __init__(self, cfg: MMDiTConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(dtype=dtype, device=device)
        self.audio_embedder = Conv1d(cfg.audio_vae_latent_dim, h, cfg.patch_size, **kw)
        self.visual_proj = SwiGLUProj(cfg.clip_dim, h, **kw)
        self.cond_in = CondIn(cfg.condition_dim, h, **kw)
        self.time_in = TimeIn(h, **kw)
        self.final_layer = FinalLayer(h, cfg.patch_size * cfg.audio_vae_latent_dim, **kw)
        self.empty_clip_feat = nn.Parameter(torch.empty(1, cfg.clip_dim, **kw),
                                            requires_grad=False)
        self.empty_sync_feat = nn.Parameter(torch.empty(1, cfg.sync_feat_dim, **kw),
                                            requires_grad=False)
        self.sync_in = None
        self.sync_pos_emb = None
        if cfg.sync_modulation or cfg.add_sync_feat_to_audio:
            self.sync_in = SyncIn(cfg, **kw)
            self.sync_pos_emb = nn.Parameter(torch.empty(1, 1, 8, cfg.sync_feat_dim, **kw),
                                             requires_grad=False)
        self.triple_blocks = nn.ModuleList(
            TripleBlock(cfg, **kw) for _ in range(cfg.depth_triple_blocks))
        self.single_blocks = nn.ModuleList(
            SingleBlock(cfg, **kw) for _ in range(cfg.depth_single_blocks))
        self.block_swap: Optional[offload.BlockSwap] = None  # parallel/offload.py

    @property
    def device(self) -> torch.device:
        """Where the model computes: a parameter no memory mode moves or quantizes."""
        return self.empty_clip_feat.device

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.empty_clip_feat.zero_()
        self.empty_sync_feat.zero_()
        if self.sync_pos_emb is not None:
            self.sync_pos_emb.zero_()

    def attention_tables(self, audio_len: int, visual_len: int, text_len: int,
                         device=None) -> AttentionTables:
        """Every RoPE and qk-norm weight table of a forward pass at these lengths (they do
        not depend on the timestep), and with them the joint attention's route: K1 under its
        precondition (``fused_joint``), else the plain route, whose ``joint_rope`` and
        ``triple_norms`` are None."""
        cfg = self.cfg
        ropes = build_rope_tables(cfg, audio_len, visual_len, text_len, device=device)
        single_norms = tuple(_on(b.norm_tables(audio_len), ropes.audio[0].device)
                             for b in self.single_blocks)
        if not fused_joint(cfg, ropes):
            return AttentionTables(ropes=ropes, joint_rope=None, triple_norms=None,
                                   single_norms=single_norms)
        joint_rope = tuple(torch.cat([vt, at], dim=0)
                           for vt, at in zip(ropes.visual_joint, ropes.audio_joint))
        return AttentionTables(
            ropes=ropes, joint_rope=joint_rope,
            triple_norms=tuple(_on(b.norm_tables(audio_len, visual_len), joint_rope[0].device)
                               for b in self.triple_blocks),
            single_norms=single_norms)

    def forward(self, x, t, cond, clip_feat, sync_feat, *, cond_mask=None, text_kv=None,
                triple_mods=None, tables: Optional[AttentionTables] = None,
                visual_rows_shared: bool = False, offload_prefetch: int = 1,
                attn_impl: str = "fused", remat: bool = False, lora=None,
                lora_scale: float = 1.0) -> torch.Tensor:
        """``_velocity``, in true fp32 when ``x`` is fp32 (``ops/nn.py::exact_fp32``)."""
        with exact_fp32(x.dtype):
            return self._velocity(x, t, cond, clip_feat, sync_feat, cond_mask=cond_mask,
                                  text_kv=text_kv, triple_mods=triple_mods, tables=tables,
                                  visual_rows_shared=visual_rows_shared,
                                  offload_prefetch=offload_prefetch, attn_impl=attn_impl,
                                  remat=remat, lora=lora, lora_scale=lora_scale)

    def _velocity(self, x, t, cond, clip_feat, sync_feat, *, cond_mask=None, text_kv=None,
                  triple_mods=None, tables: Optional[AttentionTables] = None,
                  visual_rows_shared: bool = False, offload_prefetch: int = 1,
                  attn_impl: str = "fused", remat: bool = False, lora=None,
                  lora_scale: float = 1.0) -> torch.Tensor:
        """Velocity [B, T, C_latent] (the JAX ``apply``).

        x: audio latents [B, T, C_latent]; t: [B] timesteps in [0, 1000); cond: text
        features [B, L_text, condition_dim] (raw: projected here, unless ``text_kv`` holds
        the hoisted per-block text K/V); clip_feat [B, L_clip, clip_dim]; sync_feat
        [B, S*8, sync_feat_dim]. ``cond_mask``: [B, L_text] text mask, read only by a
        ``use_attention_mask`` config (the JAX ``apply``'s mask). ``triple_mods``: this step's hoisted adaLN vectors
        (a_mods, v_mods), each [N, 1, 9H]. ``tables``: the hoisted ``attention_tables`` of
        these lengths (built here when None). ``visual_rows_shared``: the caller's promise
        that the two CFG halves of ``clip_feat`` and ``sync_feat`` are identical; the
        visual-derived projections then run on the first half and are tiled.
        ``offload_prefetch``: the device window of each swapped block family
        (``offload.stream_blocks``; 1 fetches each block after the last one ran).

        Training (the JAX ``apply``'s ``attn_impl``, ``remat``, ``lora``, ``lora_scale``):
        ``attn_impl`` ``"fused"`` sends the attention to K1 as described above, ``"xla"``
        takes the plain route in every block (what the train step differentiates).
        ``remat`` checkpoints each block (``torch.utils.checkpoint``, non-reentrant): the
        backward recomputes it from its inputs. ``lora``: an unmerged adapter
        (``models/lora.py``'s names), applied inside each block at ``lora_scale``; it
        refuses the hoists, whose weights would bypass it, and swapped blocks, as does
        ``remat`` (a recomputed block would read a device slot handed on since).
        """
        cfg = self.cfg
        if attn_impl not in ("fused", "xla"):
            raise ValueError(f"attn_impl {attn_impl!r}: expected 'fused' or 'xla'")
        if lora is not None and (text_kv is not None or triple_mods is not None):
            raise ValueError(
                "runtime (unmerged) LoRA is the training path; the denoise hoists read block "
                "weights directly — use lora.merge_lora(params, lora, scale) for inference")
        if (lora is not None or remat) and any(offload.swapped_blocks(self, f)
                                               for f in lora_mod.FAMILIES):
            raise ValueError("extra_xs is unsupported for placement-split stacks: runtime "
                             "LoRA and remat need every block on the device (merge the block "
                             "swap back first)")
        factors = None if lora is None else lora_mod.block_factors(self, lora)
        bs, tl = x.shape[0], x.shape[1] // cfg.patch_size
        if visual_rows_shared and bs % 2:
            raise ValueError(f"visual_rows_shared needs an even CFG batch, got {bs}")
        half = bs // 2

        def run(block, family: str, i: int, *args, **kwargs):
            """Block ``i`` of ``family``: checkpointed under ``remat``, its adapter applied."""
            f = None if factors is None else factors[family][i]
            if not remat and f is None:
                return block(*args, **kwargs)
            fn = functools.partial(_run_block, block, f, lora_scale, x.dtype)
            if remat:
                return checkpoint(fn, *args, use_reentrant=False, **kwargs)
            return fn(*args, **kwargs)

        vec = self.time_in(t, x.dtype)  # [B, H]

        sync_vec = sync_add = sync_add_half = None
        if cfg.sync_modulation or cfg.add_sync_feat_to_audio:
            if sync_feat.shape[1] % 8:
                raise ValueError(f"sync length {sync_feat.shape[1]} is not a multiple of 8")
            sfin = sync_feat[:half] if visual_rows_shared else sync_feat
            b_s, s = sfin.shape[0], sync_feat.shape[1] // 8
            sf = sfin.reshape(b_s, s, 8, cfg.sync_feat_dim) + self.sync_pos_emb.to(sfin.dtype)
            sf = F.silu(self.sync_in.linear(sf.reshape(b_s, s * 8, cfg.sync_feat_dim)))
            sf = self.sync_in.conv_mlp(sf, kernel_size=cfg.sync_in_ksz)
            sf = nearest_exact_resize(sf, tl, dim=1)  # [B or B/2, T, H]
            if visual_rows_shared:
                sync_add_half = sf
                sf = torch.cat([sf, sf], dim=0)
            if cfg.sync_modulation:
                sync_vec = sf + vec[:, None, :]
            else:
                sync_add = sf

        if text_kv is None:
            cond = self.cond_in(cond)
        audio = self.audio_embedder(x, stride=cfg.patch_size)  # [B, T, H]
        v_cond = self.visual_proj(clip_feat[:half] if visual_rows_shared else clip_feat)
        if visual_rows_shared:
            v_cond = torch.cat([v_cond, v_cond], dim=0)  # identical only at entry

        audio_len, visual_len = audio.shape[1], v_cond.shape[1]
        if tables is None:
            tables = self.attention_tables(audio_len, visual_len, cond.shape[1], x.device)
        elif (tables.ropes.audio[0].shape[0], tables.ropes.visual_cross[0].shape[0]) != (
                audio_len, visual_len):
            raise ValueError(f"attention tables cover {tables.ropes.visual_cross[0].shape[0]} "
                             f"+ {tables.ropes.audio[0].shape[0]} joint positions, the input "
                             f"{visual_len} + {audio_len}")
        if attn_impl == "xla":  # the RoPE tables alone: no block takes K1
            tables = tables._replace(joint_rope=None, triple_norms=None, single_norms=None)
        ropes = tables.ropes
        attn_mask = None
        if cfg.use_attention_mask:
            if cond_mask is None:
                raise ValueError("use_attention_mask needs the text mask cond_mask")
            attn_mask = joint_attention_mask(cond_mask, visual_len, audio_len)

        if cfg.add_sync_feat_to_audio:
            audio = audio + sync_add  # injected before block 0
        for i, block in enumerate(offload.stream_blocks(self, "triple_blocks",
                                                         offload_prefetch)):
            audio, v_cond = run(
                block, "triple_blocks", i, audio, cond, v_cond, vec, ropes, tables.joint_rope,
                None if tables.triple_norms is None else tables.triple_norms[i],
                sync_vec=sync_vec, attn_mask=attn_mask,
                text_kv=None if text_kv is None else (text_kv[0][i], text_kv[1][i]),
                mods=None if triple_mods is None else (triple_mods[0][i], triple_mods[1][i]))

        vec_tok_mod = None
        if cfg.sync_modulation:
            vec_tok = sync_vec
        elif cfg.add_sync_feat_to_audio:
            vec_tok = sync_add + vec[:, None, :]
            if visual_rows_shared:
                # the per-token modulation input's CFG halves match: the mod GEMM runs on one
                vec_tok_mod = sync_add_half + vec[:half, None, :]
        else:
            vec_tok = vec  # per-batch 2-D modulation (reference parity)
        mod_vec = vec_tok_mod if vec_tok_mod is not None else vec_tok
        blocks = offload.stream_blocks(self, "single_blocks", offload_prefetch)
        for i, block in enumerate(blocks):
            norms = None if tables.single_norms is None else tables.single_norms[i]
            audio = run(block, "single_blocks", i, audio, mod_vec, ropes, norms)

        out = self.final_layer(audio, sync_vec if sync_vec is not None else vec_tok)
        if cfg.patch_size != 1:
            out = out.reshape(bs, tl * cfg.patch_size, cfg.audio_vae_latent_dim)
        return out

    def precompute_text_kv(self, cond: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every triple block's text cross-attention K/V, once per generation (they do not
        depend on the timestep). ``cond``: raw text features in the compute dtype. Returns
        (t_k, t_v), each stacked [N_blocks, B, L_text, H, D], or None when triple blocks are
        swapped (they compute their K/V in-block)."""
        if offload.swapped_blocks(self, "triple_blocks"):
            return None
        with exact_fp32(cond.dtype):
            cond_p = self.cond_in(cond)
            ropes_text = rope_table(cond.shape[1], self.cfg.head_dim, self.cfg.rope_theta,
                                    device=cond.device)
            kv = [block.text_kv(cond_p, ropes_text) for block in self.triple_blocks]
            return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])

    def precompute_triple_mods(self, timesteps: torch.Tensor, compute_dtype):
        """Every triple block's adaLN vectors for the whole timestep schedule.

        With ``sync_modulation`` off (every shipped config) the modulation source is the
        timestep embedding alone, and every CFG row shares the timestep, so one vector per
        (step, block) serves the batch. Returns (a_mods, v_mods), each [S, N, 1, 9H] in the
        compute dtype, or None when the source is per-token (``sync_modulation``) or triple
        blocks are swapped (they compute their vectors in-block)."""
        if self.cfg.sync_modulation or offload.swapped_blocks(self, "triple_blocks"):
            return None
        with exact_fp32(compute_dtype):
            sv = F.silu(self.time_in(timesteps, compute_dtype))  # [S, H]
            a_mods = torch.stack([b.audio_mod(sv) for b in self.triple_blocks], dim=1)
            v_mods = torch.stack([b.v_cond_mod(sv) for b in self.triple_blocks], dim=1)
            return a_mods[:, :, None, :], v_mods[:, :, None, :]


def _run_block(block: nn.Module, factors, scale: float, dtype, *args, **kwargs):
    """One block's forward with its adapter applied (``factors`` None: none). A checkpointed
    block runs this again in the backward, after ``MMDiT.forward``'s ``exact_fp32`` has
    exited: so it enters ``exact_fp32`` itself, and the recomputed activations of an fp32
    model equal the saved ones whatever the caller's matmul precision."""
    adapter = (contextlib.nullcontext() if factors is None
               else lora_mod.block_lora(block, factors, scale))
    with exact_fp32(dtype), adapter:
        return block(*args, **kwargs)


# ---------------------------------------------------------------------------------
# Init and the empty (uncond / T2A) sequences
# ---------------------------------------------------------------------------------

def init(cfg: MMDiTConfig, generator: torch.Generator, device: DeviceLike = None,
         dtype=torch.float32) -> MMDiT:
    """A randomly initialized denoiser, drawn from ``generator`` directly on the device
    (``cuda`` unless given). The generator must live on that device. The schemes are the
    JAX ``mmdit.init``'s: torch-default uniform, zero adaLN and final layers, normal(0.02)
    timestep MLP, unit norm weights, zero empty features."""
    model = MMDiT(cfg, dtype=dtype, device=resolve_device(device))
    init_parameters(model, generator)
    return model


def get_empty_clip_sequence(model: MMDiT, bs: int, length: int) -> torch.Tensor:
    """Learned empty clip features broadcast to [bs, length, clip_dim]."""
    return model.empty_clip_feat[None].expand(bs, length, model.empty_clip_feat.shape[-1])


def get_empty_sync_sequence(model: MMDiT, bs: int, length: int) -> torch.Tensor:
    return model.empty_sync_feat[None].expand(bs, length, model.empty_sync_feat.shape[-1])
