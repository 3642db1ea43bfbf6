"""HunyuanVideo-Foley's denoiser (``HunyuanVideoFoley.forward``, ``hifi_foley.py``) in plain
fp32 PyTorch, read straight from a checkpoint-layout state dict ``W``.

What it follows, from the published architecture and configuration:
- a 256-wide cos-first sinusoidal timestep embedding through ``time_in`` (SiLU between);
- the Synchformer path: ``sync_pos_emb`` added per 8-token segment, ``sync_in`` (linear,
  SiLU, a bias-free SwiGLU ConvMLP of kernel ``sync_in_ksz``), resized nearest-exact to the
  latent length and added to the audio tokens before the first triple block;
- the triple blocks: 9-way adaLN per stream from the timestep vector, joint self-attention
  over ``[visual; audio]`` with qk RMSNorm and interleaved audio-visual RoPE (the visual
  stream resized nearest-exact to the audio length, interleaved, rotated with a table of
  twice the audio length, then de-interleaved and resized back), text cross-attention
  with RoPE on the queries of each stream and on the text keys, tanh-GELU MLPs;
- the single blocks: 6-way per-token modulation from ``sync + vec``, a fused qkv whose
  outputs are laid out (heads, head_dim, 3), conv-3 output projection and conv-3 SwiGLU MLP;
- the final layer: LayerNorm then linear. The reference's ``modulate`` drops a per-token
  shift and scale, and the final layer's condition is per token here, so its adaLN
  contributes nothing and is not computed.

Attention is the plain product: softmax(q k^T / sqrt(d)) v. Tensors are [B, L, ...]. It
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _lin(W, name, x, bias=True):
    return F.linear(x, W[name + ".weight"], W.get(name + ".bias") if bias else None)


def _conv(W, name, x, pad):
    """A channel-last conv1d: x [B, L, C]."""
    y = F.conv1d(x.transpose(1, 2), W[name + ".weight"], W.get(name + ".bias"), padding=pad)
    return y.transpose(1, 2)


def _ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(length, dim, theta, device):
    pos = torch.arange(length, dtype=torch.float64, device=device)
    idx = torch.arange(0, dim, 2, dtype=torch.float64, device=device)[: dim // 2]
    freqs = torch.outer(pos, theta ** (-(idx / dim)))
    return (freqs.cos().repeat_interleave(2, 1).float(),
            freqs.sin().repeat_interleave(2, 1).float())


def _rot_half(x):
    re, im = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack([-im, re], -1).flatten(-2)


def _apply_rope(x, cos, sin):
    return x * cos[None, :, None] + _rot_half(x) * sin[None, :, None]


def _resize(x, length):
    """Nearest-exact resize of [B, L, ...] along L."""
    if x.shape[1] == length:
        return x
    b, n = x.shape[:2]
    rest = x.shape[2:]
    y = F.interpolate(x.reshape(b, n, -1).transpose(1, 2), size=length, mode="nearest-exact")
    return y.transpose(1, 2).reshape(b, length, *rest)


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v over [B, L, H, D]."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(s, -1), v).transpose(1, 2)


def timestep_embedding(t, dim=256):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def _swiglu_conv(W, name, x, k):
    pad = (k - 1) // 2
    return _conv(W, name + ".w2", F.silu(_conv(W, name + ".w1", x, pad))
                 * _conv(W, name + ".w3", x, pad), pad)


def _triple(W, m, p, audio, v_cond, cond, vec, eps):
    h, nh = m["hidden_size"], m["num_heads"]
    hd = h // nh
    b, la, lv, lt = audio.shape[0], audio.shape[1], v_cond.shape[1], cond.shape[1]
    am = [x[:, None] for x in _lin(W, p + "audio_mod.linear", F.silu(vec)).chunk(9, -1)]
    vm = [x[:, None] for x in _lin(W, p + "v_cond_mod.linear", F.silu(vec)).chunk(9, -1)]
    dev = audio.device

    a_in = _ln(audio) * (1 + am[1]) + am[0]
    aq, ak, av = _lin(W, p + "audio_self_attn_qkv", a_in).reshape(b, la, 3, nh, hd).unbind(2)
    aq = _rms(aq, W[p + "audio_self_q_norm.weight"], eps)
    ak = _rms(ak, W[p + "audio_self_k_norm.weight"], eps)
    v_in = _ln(v_cond) * (1 + vm[1]) + vm[0]
    vq, vk, vv = _lin(W, p + "v_cond_attn_qkv", v_in).reshape(b, lv, 3, nh, hd).unbind(2)
    vq = _rms(vq, W[p + "v_cond_attn_q_norm.weight"], eps)
    vk = _rms(vk, W[p + "v_cond_attn_k_norm.weight"], eps)
    cos, sin = rope(2 * la, hd, m["rope_theta"], dev)

    def interleave_rotate(a, v):
        x = torch.stack((a, _resize(v, la)), 2).reshape(b, 2 * la, nh, hd)
        x = _apply_rope(x, cos, sin).reshape(b, la, 2, nh, hd)
        return x[:, :, 0], _resize(x[:, :, 1], lv)

    aq, vq = interleave_rotate(aq, vq)
    ak, vk = interleave_rotate(ak, vk)
    attn = attention(torch.cat([vq, aq], 1), torch.cat([vk, ak], 1),
                     torch.cat([vv, av], 1)).reshape(b, lv + la, h)
    audio = audio + _lin(W, p + "audio_self_proj", attn[:, lv:]) * am[2]
    v_cond = v_cond + _lin(W, p + "v_cond_self_proj", attn[:, :lv]) * vm[2]

    a_in = _ln(audio) * (1 + am[4]) + am[3]
    v_in = _ln(v_cond) * (1 + vm[4]) + vm[3]
    aq = _rms(_lin(W, p + "audio_cross_q", a_in).reshape(b, la, nh, hd),
              W[p + "audio_cross_q_norm.weight"], eps)
    vq = _rms(_lin(W, p + "v_cond_cross_q", v_in).reshape(b, lv, nh, hd),
              W[p + "v_cond_cross_q_norm.weight"], eps)
    tk, tv = _lin(W, p + "text_cross_kv", cond).reshape(b, lt, 2, nh, hd).unbind(2)
    tk = _rms(tk, W[p + "text_cross_k_norm.weight"], eps)
    aq = _apply_rope(aq, *rope(la, hd, m["rope_theta"], dev))
    vq = _apply_rope(vq, *rope(lv, hd, m["rope_theta"], dev))
    tk = _apply_rope(tk, *rope(lt, hd, m["rope_theta"], dev))
    cross = attention(torch.cat([vq, aq], 1), tk, tv).reshape(b, lv + la, h)
    audio = audio + _lin(W, p + "audio_cross_proj", cross[:, lv:]) * am[5]
    v_cond = v_cond + _lin(W, p + "v_cond_cross_proj", cross[:, :lv]) * vm[5]

    def mlp(name, x, mod):
        y = _ln(x) * (1 + mod[7]) + mod[6]
        return _lin(W, name + ".fc2", F.gelu(_lin(W, name + ".fc1", y), approximate="tanh"))

    audio = audio + mlp(p + "audio_mlp", audio, am) * am[8]
    v_cond = v_cond + mlp(p + "v_cond_mlp", v_cond, vm) * vm[8]
    return audio, v_cond


def _single(W, m, p, x, vec_tok, eps):
    h, nh = m["hidden_size"], m["num_heads"]
    hd = h // nh
    b, la = x.shape[:2]
    s_msa, c_msa, g_msa, s_mlp, c_mlp, g_mlp = _lin(
        W, p + "modulation.linear", F.silu(vec_tok)).chunk(6, -1)
    xn = _ln(x) * (1 + c_msa) + s_msa
    qkv = _lin(W, p + "linear_qkv", xn).reshape(b, la, nh, hd, 3)
    q = _rms(qkv[..., 0], W[p + "q_norm.weight"], eps)
    k = _rms(qkv[..., 1], W[p + "k_norm.weight"], eps)
    cos, sin = rope(la, hd, m["rope_theta"], x.device)
    out = attention(_apply_rope(q, cos, sin), _apply_rope(k, cos, sin),
                    qkv[..., 2]).reshape(b, la, h)
    x = x + _conv(W, p + "linear1", out, 1) * g_msa
    xn = _ln(x) * (1 + c_mlp) + s_mlp
    return x + _swiglu_conv(W, p + "linear2", xn, 3) * g_mlp


def forward(W, m, x, t, cond, clip_feat, sync_feat):
    """Velocity [B, T, C] of latents ``x`` [B, T, C] at timesteps ``t`` [B] (in [0, 1000)),
    text ``cond`` [B, L_text, condition_dim], ``clip_feat`` [B, L_clip, clip_dim] and
    ``sync_feat`` [B, S * 8, sync_feat_dim]. ``m``: the configuration's ``model`` group."""
    if m["condition_projection"] != "linear" or m["patch_size"] != 1:
        raise ValueError("the reference follows condition_projection 'linear', patch_size 1")
    if (m["sync_modulation"] or not m["add_sync_feat_to_audio"]
            or not m["interleaved_audio_visual_rope"] or m["use_attention_mask"]
            or not m["qk_norm"] or m["qk_norm_type"] != "rms"
            or m["mlp_act_type"] != "gelu_tanh"):
        raise ValueError("the reference follows the shipped configurations' switches")
    eps = 1e-6
    b, tl = x.shape[:2]
    vec = _lin(W, "time_in.mlp.2", F.silu(_lin(W, "time_in.mlp.0", timestep_embedding(t))))

    s = sync_feat.shape[1] // 8
    sf = sync_feat.reshape(b, s, 8, -1) + W["sync_pos_emb"]
    sf = F.silu(_lin(W, "sync_in.0", sf.reshape(b, s * 8, -1)))
    sync_add = _resize(_swiglu_conv(W, "sync_in.2", sf, m["sync_in_ksz"]), tl)

    cond = _lin(W, "cond_in.linear_2", F.silu(_lin(W, "cond_in.linear_1", cond)))
    audio = _conv(W, "audio_embedder.proj", x, 0)
    v_cond = _lin(W, "visual_proj.w2", F.silu(_lin(W, "visual_proj.w1", clip_feat, False))
                  * _lin(W, "visual_proj.w3", clip_feat, False), False)
    audio = audio + sync_add
    for i in range(m["depth_triple_blocks"]):
        audio, v_cond = _triple(W, m, f"triple_blocks.{i}.", audio, v_cond, cond, vec, eps)
    vec_tok = sync_add + vec[:, None]
    for i in range(m["depth_single_blocks"]):
        audio = _single(W, m, f"single_blocks.{i}.", audio, vec_tok, eps)
    return _lin(W, "final_layer.linear", _ln(audio))
