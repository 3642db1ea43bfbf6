"""The checkpoint layout of HunyuanVideo-Foley's denoiser and DAC-VAE: every key of the
published state dicts with its shape, and the role its values play, from the published
architecture (``hifi_foley.py``, ``dac_vae``). The benchmark draws its weights in this
layout, hands them to the program through its checkpoint converter and to the plain
reference as they are.

``model`` and ``dac`` are the configuration file's groups of the same names (plain dicts).
Roles: ``weight`` and ``bias`` of a linear or convolution (the fan-in is the weight's
``shape[1:]``), ``zero`` (a leaf the reference initialises to zero: the adaLN and final
layers, the learned empty features), ``time`` (the timestep MLP), ``norm`` (an RMSNorm
weight); for the codec ``wn_v`` / ``wn_g:<part>`` (a weight-normed convolution's direction
and per-channel magnitude), ``alpha`` (a Snake alpha), ``conv`` (a plain convolution).
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

Entry = Tuple[str, Tuple[int, ...], str, int]  # key, shape, role, fan-in


def conv_mlp_hidden(m: dict) -> int:
    """The ConvMLP's hidden width: 2/3 of the MLP width, rounded up to ``multiple_of``
    (``mlp_layers.py``)."""
    hidden = int(2 * int(m["hidden_size"] * m["mlp_ratio"]) / 3)
    mult = m["conv_mlp_multiple_of"]
    return mult * ((hidden + mult - 1) // mult)


def mmdit_entries(m: dict) -> Iterator[Entry]:
    h = m["hidden_size"]
    hd = h // m["num_heads"]
    hc = conv_mlp_hidden(m)
    mlp = int(h * m["mlp_ratio"])
    c = m["audio_vae_latent_dim"] * m["patch_size"]

    def layer(name, out, inp, k=None, bias=True, role="weight"):
        shape = (out, inp) if k is None else (out, inp, k)
        fan = inp * (k or 1)
        yield name + ".weight", shape, role, fan
        if bias:
            yield name + ".bias", (out,), "bias" if role == "weight" else role, fan

    yield from layer("audio_embedder.proj", h, m["audio_vae_latent_dim"], m["patch_size"])
    yield from layer("visual_proj.w1", h, m["clip_dim"], bias=False)
    yield from layer("visual_proj.w2", h, h, bias=False)
    yield from layer("visual_proj.w3", h, m["clip_dim"], bias=False)
    yield from layer("cond_in.linear_1", h, m["condition_dim"])
    yield from layer("cond_in.linear_2", h, h)
    yield from layer("time_in.mlp.0", h, 256, role="time")
    yield from layer("time_in.mlp.2", h, h, role="time")
    yield from layer("final_layer.linear", c, h, role="zero")
    yield from layer("final_layer.adaLN_modulation.1", 2 * h, h, role="zero")
    yield "empty_clip_feat", (1, m["clip_dim"]), "zero", 1
    yield "empty_sync_feat", (1, m["sync_feat_dim"]), "zero", 1
    yield from layer("sync_in.0", h, m["sync_feat_dim"])
    k = m["sync_in_ksz"]
    yield from layer("sync_in.2.w1", hc, h, k, bias=False)
    yield from layer("sync_in.2.w2", h, hc, k, bias=False)
    yield from layer("sync_in.2.w3", hc, h, k, bias=False)
    yield "sync_pos_emb", (1, 1, 8, m["sync_feat_dim"]), "zero", 1
    qb = m["qkv_bias"]
    for i in range(m["depth_triple_blocks"]):
        p = f"triple_blocks.{i}."
        yield from layer(p + "audio_mod.linear", 9 * h, h, role="zero")
        yield from layer(p + "v_cond_mod.linear", 9 * h, h, role="zero")
        for stream, qkv in (("audio_self", "audio_self_attn_qkv"), ("v_cond_attn", "v_cond_attn_qkv")):
            yield from layer(p + qkv, 3 * h, h, bias=qb)
            yield p + stream + "_q_norm.weight", (hd,), "norm", 1
            yield p + stream + "_k_norm.weight", (hd,), "norm", 1
            yield from layer(p + ("audio_self_proj" if stream == "audio_self"
                                  else "v_cond_self_proj"), h, h, bias=qb)
        yield from layer(p + "audio_cross_q", h, h, bias=qb)
        yield from layer(p + "v_cond_cross_q", h, h, bias=qb)
        yield from layer(p + "text_cross_kv", 2 * h, h, bias=qb)
        for norm in ("audio_cross_q_norm", "v_cond_cross_q_norm", "text_cross_k_norm"):
            yield p + norm + ".weight", (hd,), "norm", 1
        yield from layer(p + "audio_cross_proj", h, h, bias=qb)
        yield from layer(p + "v_cond_cross_proj", h, h, bias=qb)
        for stream in ("audio_mlp", "v_cond_mlp"):
            yield from layer(p + stream + ".fc1", mlp, h)
            yield from layer(p + stream + ".fc2", h, mlp)
    for i in range(m["depth_single_blocks"]):
        p = f"single_blocks.{i}."
        yield from layer(p + "modulation.linear", 6 * h, h, role="zero")
        yield from layer(p + "linear_qkv", 3 * h, h)
        yield p + "q_norm.weight", (hd,), "norm", 1
        yield p + "k_norm.weight", (hd,), "norm", 1
        yield from layer(p + "linear1", h, h, 3)
        yield from layer(p + "linear2.w1", hc, h, 3, bias=False)
        yield from layer(p + "linear2.w2", h, hc, 3, bias=False)
        yield from layer(p + "linear2.w3", hc, h, 3, bias=False)


def dac_entries(d: dict) -> Iterator[Entry]:
    """The codec's keys (``dac_vae``'s Sequential indices): decoder.model = [conv, block *
    len(rates), snake, conv], each block [snake, convT, res, res, res]; encoder.block = [conv,
    block * len(rates), snake, conv], each block [res, res, res, snake, conv]; a residual
    unit's block = [snake, conv k7 dilated, snake, conv k1]. Weight norm keeps a magnitude
    over dimension 0 (a transposed convolution's input channel)."""

    def wn(name, shape, part):
        yield name + ".weight_g", (shape[0], 1, 1), "wn_g:" + part, shape[1] * shape[2]
        yield name + ".weight_v", shape, "wn_v", shape[1] * shape[2]
        out = shape[1] if part == "conv_t" else shape[0]
        yield name + ".bias", (out,), "dac_bias", shape[1] * shape[2]

    def alpha(name, ch):
        yield name + ".alpha", (1, ch, 1), "alpha", 1

    def residual(name, ch, part):
        yield from alpha(name + ".block.0", ch)
        yield from wn(name + ".block.1", (ch, ch, 7), part + "_res1")
        yield from alpha(name + ".block.2", ch)
        yield from wn(name + ".block.3", (ch, ch, 1), part + "_res2")

    lat, dim, rates = d["latent_dim"], d["decoder_dim"], d["decoder_rates"]
    yield from wn("decoder.model.0", (dim, lat, 7), "conv_in")
    for i, s in enumerate(rates):
        cin, cout = dim // 2 ** i, dim // 2 ** (i + 1)
        b = f"decoder.model.{i + 1}.block"
        yield from alpha(b + ".0", cin)
        yield from wn(b + ".1", (cin, cout, 2 * s), "conv_t")
        for j in (2, 3, 4):
            yield from residual(f"{b}.{j}", cout, "dec")
    out = dim // 2 ** len(rates)
    yield from alpha(f"decoder.model.{len(rates) + 1}", out)
    yield from wn(f"decoder.model.{len(rates) + 2}", (1, out, 7), "conv_out")
    yield "post_quant_conv.weight", (lat, lat, 1), "conv", lat
    yield "post_quant_conv.bias", (lat,), "dac_bias", lat
    e, enc_rates = d["encoder_dim"], d["encoder_rates"]
    yield from wn("encoder.block.0", (e, 1, 7), "enc")
    for i, s in enumerate(enc_rates):
        cout = e * 2 ** (i + 1)
        b = f"encoder.block.{i + 1}.block"
        for j in range(3):
            yield from residual(f"{b}.{j}", cout // 2, "enc")
        yield from alpha(b + ".3", cout // 2)
        yield from wn(b + ".4", (cout, cout // 2, 2 * s), "enc")
    top = e * 2 ** len(enc_rates)
    yield from alpha(f"encoder.block.{len(enc_rates) + 1}", top)
    yield from wn(f"encoder.block.{len(enc_rates) + 2}", (lat, top, 3), "enc")
    yield "quant_conv.weight", (2 * lat, lat, 1), "conv", lat
    yield "quant_conv.bias", (2 * lat,), "dac_bias", lat


def count(entries) -> int:
    """The number of values in ``entries``."""
    return sum(math.prod(shape) for _, shape, _, _ in entries)
