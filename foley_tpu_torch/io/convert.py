"""Checkpoint loading: reference-layout torch state dicts (``.pth`` / ``.safetensors``) ->
the port's ``MMDiT`` and ``DAC`` modules (``foley_tpu/io/convert.py`` counterpart).

The JAX package's converter transposes every linear and conv into the JAX layout; the port's
modules keep torch's ``[out, in(, K)]`` layouts, so here a weight changes only its name,
except:
- the single blocks' fused qkv, whose output features the reference interleaves as (H D K)
  (``hifi_foley.py:362``), is reordered K-major (K H D), as the triple blocks and the port's
  split expect (``_hdk_to_khd``);
- the DAC's weight-norm pairs (old-style ``weight_g``/``weight_v`` and new-style
  ``parametrizations.weight.original0/1``) fold into plain weights
  (``ops/nn.py::fold_weight_norm``) and the Snake alphas ``[1, C, 1]`` become ``[C]``.

``.safetensors`` goes through the port's own reader (``load_safetensors``: an 8-byte header
length, a JSON header, then raw little-endian buffers), since the card's machine has no
``safetensors`` package; ``.pth`` through ``torch.load(weights_only=True)``. An fp8 checkpoint
loads as it is: ``module_from_state_dict`` keeps every fp8 ``Dense`` / ``Conv1d`` weight in
fp8 (upcast at use, ``ops/nn.py::_match``), as the JAX package keeps fp8 leaves, and casts
the rest (an fp8 tensor elsewhere upcasts exactly). The RVQ and discriminator converters
serve the codec's training: their weight-norm pairs fold the same way, the RVQ's 1x1 convs
into dense ``[out, in]`` weights.
"""

from __future__ import annotations

import glob
import json
import logging
import mmap
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from foley_tpu_torch.configs import DACConfig, MMDiTConfig
from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.io.quantize import FP8_DTYPES
from foley_tpu_torch.ops.nn import QUANT_KINDS, QuantizableWeight, fold_weight_norm

logger = logging.getLogger("foley_tpu_torch")

# safetensors dtype names <-> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2, "I64": torch.int64,
    "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


# ---------------------------------------------------------------------------------
# The .safetensors format, read and written without the safetensors package
# ---------------------------------------------------------------------------------

def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}. Each tensor owns a copy of its bytes
    (an aligned ``bytearray`` under ``torch.frombuffer``), so none keeps the file open,
    whatever the alignment of its offsets; ``__metadata__`` is skipped."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        n = int.from_bytes(mm[:8], "little")
        header = json.loads(bytes(mm[8:8 + n]).decode("utf-8"))
        base = 8 + n
        view = memoryview(mm)
        try:
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                dtype = _ST_DTYPES.get(info["dtype"])
                if dtype is None:
                    raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the "
                                     "reader does not take")
                start, end = info["data_offsets"]
                shape = tuple(info["shape"])
                if end == start:
                    out[name] = torch.empty(shape, dtype=dtype)
                    continue
                raw = bytearray(view[base + start: base + end])
                out[name] = torch.frombuffer(raw, dtype=torch.uint8).view(dtype).reshape(shape)
        finally:
            view.release()
    return out


def save_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} as a ``.safetensors`` file (what ``load_safetensors`` and the
    safetensors package read): the header padded with spaces to 8 bytes, the buffers
    in name order, little-endian."""
    names = sorted(tensors)
    header: Dict[str, object] = {"__metadata__": metadata} if metadata else {}
    offset = 0
    for name in names:
        t = tensors[name]
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            f.write(t.view(torch.uint8).numpy().tobytes())


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` / ``.safetensors`` file, or a checkpoint directory, -> {key: CPU tensor}.

    A ``.pth`` payload may be a flat tensor dict or a ``{"state_dict": ...}`` wrapper (the
    reference's ``_extract_state``); it is read with ``weights_only=True``, so a pickled
    ``nn.Module`` is refused. A directory is read as a Hugging Face checkpoint directory:
    ``model.safetensors``, ``pytorch_model.bin``, the shards ``model-*-of-*.safetensors``
    merged, or the first ``*.safetensors`` / ``*.pth`` found."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                return load_torch_state_dict(p)
        shards = sorted(glob.glob(os.path.join(path, "model-*-of-*.safetensors")))
        if shards:
            merged: Dict[str, torch.Tensor] = {}
            for s in shards:
                merged.update(load_safetensors(s))
            return merged
        candidates = sorted(glob.glob(os.path.join(path, "*.safetensors"))) or sorted(
            glob.glob(os.path.join(path, "*.pth")))
        if not candidates:
            raise FileNotFoundError(f"No checkpoint file under directory {path}")
        return load_torch_state_dict(candidates[0])
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise RuntimeError(f"Unsupported checkpoint payload: {type(obj)}")
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


# ---------------------------------------------------------------------------------
# Checkpoint dtype detection (reference utils.py:492-515)
# ---------------------------------------------------------------------------------

def detect_ckpt_fp8(sd: Dict[str, torch.Tensor]) -> Optional[str]:
    """'fp8_e4m3fn' / 'fp8_e5m2' if any tensor is stored in fp8, else None."""
    for v in sd.values():
        if v.dtype == torch.float8_e4m3fn:
            return "fp8_e4m3fn"
        if v.dtype == torch.float8_e5m2:
            return "fp8_e5m2"
    return None


def detect_ckpt_major_precision(sd: Dict[str, torch.Tensor]) -> str:
    """Dominant precision by element count among {bf16, fp16, fp32}."""
    counts = {"bf16": 0, "fp16": 0, "fp32": 0}
    names = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}
    for v in sd.values():
        if v.dtype in names:
            counts[names[v.dtype]] += v.numel()
    return max(counts, key=counts.get)


# ---------------------------------------------------------------------------------
# Key tracking
# ---------------------------------------------------------------------------------

class _KeyTracker:
    """Consumption of a source state dict. ``take`` pops the source tensor once converted
    (with ``consume``, the caller's dict), so peak host memory stays near one checkpoint."""

    def __init__(self, sd: Dict[str, torch.Tensor]):
        self.sd = sd
        self.all_keys = set(sd)
        self.used = set()
        self.missing: List[str] = []

    def take(self, key: str, transform: Optional[Callable] = None) -> Optional[torch.Tensor]:
        if key not in self.sd:
            self.missing.append(key)
            return None
        self.used.add(key)
        t = self.sd.pop(key)
        return transform(t) if transform is not None else t

    def has(self, key: str) -> bool:
        return key in self.sd

    def unexpected(self) -> List[str]:
        return sorted(self.all_keys - self.used)


def _report(t: _KeyTracker, strict: bool, name: str) -> None:
    if t.missing:
        msg = f"{name}: {len(t.missing)} missing keys (e.g. {t.missing[:5]})"
        if strict:
            raise KeyError(msg)
        logger.warning(msg)
    unexpected = t.unexpected()
    if unexpected:
        logger.info(f"{name}: {len(unexpected)} unexpected ckpt keys ignored "
                    f"(e.g. {unexpected[:5]})")


def _put(out: Dict[str, torch.Tensor], key: str, value: Optional[torch.Tensor]) -> None:
    if value is not None:
        out[key] = value


def _take_linear(t: _KeyTracker, out: Dict, src: str, dst: str, weight_fn=None,
                 bias_fn=None) -> None:
    """A linear or conv layer: ``src.weight`` (and ``src.bias`` when present) -> ``dst``."""
    _put(out, dst + ".weight", t.take(src + ".weight", weight_fn))
    if t.has(src + ".bias"):
        _put(out, dst + ".bias", t.take(src + ".bias", bias_fn))


# ---------------------------------------------------------------------------------
# MMDiT
# ---------------------------------------------------------------------------------

def _hdk_to_khd(w: torch.Tensor, num_heads: int, head_dim: int, k: int = 3) -> torch.Tensor:
    """Reorder (H D K)-interleaved output features K-major (K H D): the first axis of a
    torch-layout weight [H*D*K, in] or bias [H*D*K]."""
    x = w.reshape(num_heads, head_dim, k, *w.shape[1:])
    return x.movedim(2, 0).reshape(w.shape).contiguous()


def mmdit_key_map(cfg: MMDiTConfig) -> Iterator[Tuple[str, str, str]]:
    """(reference name, port name, kind) of every denoiser weight, in the reference's order
    (``hifi_foley.py:392-527``). ``kind``: ``layer`` (``.weight`` and an optional
    ``.bias``), ``qkv`` (a layer whose outputs are reordered, ``_hdk_to_khd``) or ``tensor``
    (the key itself)."""
    yield "audio_embedder.proj", "audio_embedder", "layer"
    for w in ("w1", "w2", "w3"):
        yield f"visual_proj.{w}", f"visual_proj.{w}", "layer"
    yield "cond_in.linear_1", "cond_in.linear_1", "layer"
    yield "cond_in.linear_2", "cond_in.linear_2", "layer"
    yield "time_in.mlp.0", "time_in.mlp_0", "layer"
    yield "time_in.mlp.2", "time_in.mlp_2", "layer"
    yield "final_layer.linear", "final_layer.linear", "layer"
    yield "final_layer.adaLN_modulation.1", "final_layer.adaLN", "layer"
    yield "empty_clip_feat", "empty_clip_feat", "tensor"
    yield "empty_sync_feat", "empty_sync_feat", "tensor"
    if cfg.sync_modulation or cfg.add_sync_feat_to_audio:
        yield "sync_in.0", "sync_in.linear", "layer"
        for w in ("w1", "w2", "w3"):
            yield f"sync_in.2.{w}", f"sync_in.conv_mlp.{w}", "layer"
        yield "sync_pos_emb", "sync_pos_emb", "tensor"
    triple = ("audio_self_attn_qkv", "audio_self_q_norm", "audio_self_k_norm",
              "audio_self_proj", "v_cond_attn_qkv", "v_cond_attn_q_norm",
              "v_cond_attn_k_norm", "v_cond_self_proj", "audio_cross_q", "v_cond_cross_q",
              "text_cross_kv", "audio_cross_q_norm", "v_cond_cross_q_norm",
              "text_cross_k_norm", "audio_cross_proj", "v_cond_cross_proj",
              "audio_mlp.fc1", "audio_mlp.fc2", "v_cond_mlp.fc1", "v_cond_mlp.fc2")
    for i in range(cfg.depth_triple_blocks):
        p = f"triple_blocks.{i}"
        yield f"{p}.audio_mod.linear", f"{p}.audio_mod", "layer"
        yield f"{p}.v_cond_mod.linear", f"{p}.v_cond_mod", "layer"
        for name in triple:
            yield f"{p}.{name}", f"{p}.{name}", "layer"
    for i in range(cfg.depth_single_blocks):
        p = f"single_blocks.{i}"
        yield f"{p}.modulation.linear", f"{p}.modulation", "layer"
        yield f"{p}.linear_qkv", f"{p}.linear_qkv", "qkv"
        for name in ("q_norm", "k_norm", "linear1", "linear2.w1", "linear2.w2", "linear2.w3"):
            yield f"{p}.{name}", f"{p}.{name}", "layer"


def convert_mmdit_state_dict(sd: Dict[str, torch.Tensor], cfg: MMDiTConfig,
                             strict: bool = False, consume: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """The reference's HunyuanVideoFoley state dict -> the port's ``MMDiT`` state dict.
    ``consume=True`` pops source tensors as they convert (the caller's dict is emptied)."""
    t = _KeyTracker(sd if consume else dict(sd))
    nh, hd = cfg.num_heads, cfg.head_dim
    khd = lambda w: _hdk_to_khd(w, nh, hd)  # noqa: E731
    out: Dict[str, torch.Tensor] = {}
    for src, dst, kind in mmdit_key_map(cfg):
        if kind == "tensor":
            _put(out, dst, t.take(src))
        elif kind == "qkv":
            _take_linear(t, out, src, dst, khd, khd)
        else:
            _take_linear(t, out, src, dst)
    _report(t, strict, "MMDiT")
    return out


# ---------------------------------------------------------------------------------
# DAC (weight norm folded)
# ---------------------------------------------------------------------------------

def dac_key_map(cfg: DACConfig) -> Iterator[Tuple[str, str, str]]:
    """(reference prefix, port prefix, kind) of every codec weight. ``kind``: ``wn_conv`` (a
    weight-normed conv, or a plain one), ``conv`` or ``alpha`` (a Snake alpha). The
    reference's Sequential indices (``dac.py:68-149``): decoder.model = [conv,
    block * len(rates), snake, conv, tanh], each block [snake, convT, res, res, res];
    encoder.block = [conv, block * len(rates), snake, conv], each block [res, res, res,
    snake, conv]; a residual unit's block = [snake, conv, snake, conv]."""
    def residual(src, dst):
        yield f"{src}.block.0", f"{dst}.alpha1", "alpha"
        yield f"{src}.block.1", f"{dst}.conv1", "wn_conv"
        yield f"{src}.block.2", f"{dst}.alpha2", "alpha"
        yield f"{src}.block.3", f"{dst}.conv2", "wn_conv"

    yield "decoder.model.0", "decoder.conv_in", "wn_conv"
    n_dec = len(cfg.decoder_rates)
    for i in range(n_dec):
        b, d = f"decoder.model.{i + 1}.block", f"decoder.blocks.{i}"
        yield f"{b}.0", f"{d}.alpha", "alpha"
        yield f"{b}.1", f"{d}.conv_t", "wn_conv"
        for r, j in enumerate((2, 3, 4)):
            yield from residual(f"{b}.{j}", f"{d}.res.{r}")
    yield f"decoder.model.{n_dec + 1}", "decoder.alpha_out", "alpha"
    yield f"decoder.model.{n_dec + 2}", "decoder.conv_out", "wn_conv"
    yield "post_quant_conv", "post_quant_conv", "conv"
    yield "encoder.block.0", "encoder.conv_in", "wn_conv"
    n_enc = len(cfg.encoder_rates)
    for i in range(n_enc):
        b, d = f"encoder.block.{i + 1}.block", f"encoder.blocks.{i}"
        for r in range(3):
            yield from residual(f"{b}.{r}", f"{d}.res.{r}")
        yield f"{b}.3", f"{d}.alpha", "alpha"
        yield f"{b}.4", f"{d}.conv_d", "wn_conv"
    yield f"encoder.block.{n_enc + 1}", "encoder.alpha_out", "alpha"
    yield f"encoder.block.{n_enc + 2}", "encoder.conv_out", "wn_conv"
    yield "quant_conv", "quant_conv", "conv"


_WEIGHT_KEYS = (".weight_v", ".parametrizations.weight.original1", ".weight")


def infer_dac_config(sd: Dict[str, torch.Tensor]) -> DACConfig:
    """The codec's widths and rates from a reference-layout checkpoint's shapes (the
    transposed convs' and strided convs' kernels are twice their strides); the sample rate
    is not in the shapes and keeps its default."""
    def weight(prefix):
        for suffix in _WEIGHT_KEYS:
            if prefix + suffix in sd:
                return sd[prefix + suffix]
        return None

    def rates(block):
        out, i = [], 1
        while (w := weight(block.format(i))) is not None:
            out.append(w.shape[2] // 2)
            i += 1
        return tuple(out)

    conv_in, enc_in = weight("decoder.model.0"), weight("encoder.block.0")
    if conv_in is None or enc_in is None:
        raise KeyError("not a DAC-VAE checkpoint: no decoder.model.0 / encoder.block.0 conv")
    return DACConfig(encoder_dim=enc_in.shape[0], encoder_rates=rates("encoder.block.{}.block.4"),
                     latent_dim=conv_in.shape[1], decoder_dim=conv_in.shape[0],
                     decoder_rates=rates("decoder.model.{}.block.1"))


def _take_wn_conv(t: _KeyTracker, out: Dict, src: str, dst: str) -> None:
    """A weight-normed conv, its g/v pair (old- or new-style keys) folded into a plain
    weight in torch's layout; a plain ``.weight`` passes through."""
    for g_key, v_key in ((".weight_g", ".weight_v"),
                         (".parametrizations.weight.original0",
                          ".parametrizations.weight.original1")):
        if t.has(src + g_key):
            out[dst + ".weight"] = fold_weight_norm(t.take(src + g_key), t.take(src + v_key))
            break
    else:
        _put(out, dst + ".weight", t.take(src + ".weight"))
    if t.has(src + ".bias"):
        out[dst + ".bias"] = t.take(src + ".bias")


def convert_dac_state_dict(sd: Dict[str, torch.Tensor], cfg: DACConfig, strict: bool = False,
                           consume: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's DAC-VAE state dict -> the port's ``DAC`` state dict, weight norm
    folded. ``consume=True`` pops source tensors as they convert."""
    t = _KeyTracker(sd if consume else dict(sd))
    out: Dict[str, torch.Tensor] = {}
    for src, dst, kind in dac_key_map(cfg):
        if kind == "alpha":  # Snake1d stores alpha [1, C, 1] (reference layers.py:29)
            _put(out, dst, t.take(src + ".alpha", lambda a: a.reshape(-1)))
        elif kind == "wn_conv":
            _take_wn_conv(t, out, src, dst)
        else:
            _take_linear(t, out, src, dst)
    _report(t, strict, "DAC")
    return out


def convert_rvq_state_dict(sd: Dict[str, torch.Tensor], cfg, strict: bool = False,
                           consume: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's ``ResidualVectorQuantize`` state dict (``dac_vae/nn/quantize.py:
    96-141``) -> the port's ``RVQ`` state dict (``cfg``: an ``RVQConfig``):
    ``quantizers.<i>.{in_proj, out_proj}`` are weight-normed 1x1 convs, folded to dense
    ``[out, in]``; ``quantizers.<i>.codebook.weight`` is an embedding [size, dim]."""
    t = _KeyTracker(sd if consume else dict(sd))
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_codebooks):
        q = f"quantizers.{i}"
        for proj in ("in_proj", "out_proj"):
            _take_wn_conv(t, out, f"{q}.{proj}", f"{q}.{proj}")
            key = f"{q}.{proj}.weight"
            if key in out:
                out[key] = out[key][..., 0]  # [out, in, 1] -> [out, in]
        _put(out, f"{q}.codebook", t.take(f"{q}.codebook.weight"))
    _report(t, strict, "RVQ")
    return out


def convert_discriminator_state_dict(sd: Dict[str, torch.Tensor], cfg, strict: bool = False,
                                     consume: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's GAN ``Discriminator`` state dict (``dac_vae/model/discriminator.py:
    175-216``) -> the port's ``Discriminator`` state dict (``cfg``: a
    ``DiscriminatorConfig``). ``discriminators`` holds the MPDs (one a period), then the MSDs
    (one a rate), then the MRDs (one an FFT size); a conv with an activation sits at index 0
    of its Sequential, the ``conv_post`` layers are bare; every conv is weight-normed (folded
    here, torch's layout kept)."""
    t = _KeyTracker(sd if consume else dict(sd))
    out: Dict[str, torch.Tensor] = {}
    families = ([("mpd", i, 5) for i in range(len(cfg.periods))]
                + [("msd", i, 6) for i in range(len(cfg.rates))]
                + [("mrd", i, None) for i in range(len(cfg.fft_sizes))])
    for idx, (family, i, n_convs) in enumerate(families):
        src, dst = f"discriminators.{idx}", f"{family}.{i}"
        if n_convs is None:  # MRD: five bands of five convs
            for b in range(5):
                for j in range(5):
                    _take_wn_conv(t, out, f"{src}.band_convs.{b}.{j}.0",
                                  f"{dst}.band_convs.{b}.{j}")
        else:
            for j in range(n_convs):
                _take_wn_conv(t, out, f"{src}.convs.{j}.0", f"{dst}.convs.{j}")
        _take_wn_conv(t, out, f"{src}.conv_post", f"{dst}.post")
    _report(t, strict, "Discriminator")
    return out


def dac_reference_state_dict(state: Dict[str, torch.Tensor],
                             cfg: DACConfig) -> Dict[str, torch.Tensor]:
    """The port's ``DAC`` state dict -> the reference's layout with plain (already folded)
    conv weights: what ``convert_dac_state_dict`` reads back to the same tensors."""
    out: Dict[str, torch.Tensor] = {}
    for src, dst, kind in dac_key_map(cfg):
        if kind == "alpha":
            out[src + ".alpha"] = state[dst].reshape(1, -1, 1)
        else:
            out[src + ".weight"] = state[dst + ".weight"]
            out[src + ".bias"] = state[dst + ".bias"]
    return out


def _adopt_storage(model: torch.nn.Module, state: Dict[str, torch.Tensor],
                   device: torch.device) -> None:
    """Give each ``Dense`` / ``Conv1d`` the storage ``state`` holds for it: fp8 weights and
    quantized codes and scales (``weight_<kind>``, ``weight_scale``) keep their own dtypes."""
    for name, m in model.named_modules():
        if not isinstance(m, QuantizableWeight):
            continue
        p = f"{name}." if name else ""
        for kind in QUANT_KINDS:
            if p + "weight_" + kind in state:
                m.set_quantized(kind, state[p + "weight_" + kind].to(device),
                                state[p + "weight_scale"].to(device))
        w = state.get(p + "weight")
        if w is not None and w.dtype in FP8_DTYPES.values():
            m.set_weight(w.to(device))


def module_from_state_dict(cls, state: Dict[str, torch.Tensor], cfg, device: DeviceLike = None,
                           dtype=torch.float32) -> torch.nn.Module:
    """``cls(cfg)`` allocated on ``device`` (``cuda`` unless given) in ``dtype``, holding
    ``state``: every key cast to ``dtype``, except the ``Dense`` / ``Conv1d`` weights stored
    in fp8 or quantized, which keep their bits."""
    dev = resolve_device(device)
    model = cls(cfg, dtype=dtype, device=dev)
    _adopt_storage(model, state, dev)
    model.load_state_dict(state, strict=True)
    return model
