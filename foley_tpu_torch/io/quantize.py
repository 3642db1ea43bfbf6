"""Weight-only quantized storage of the denoiser (``foley_tpu/io/quantize.py`` counterpart):
fp8 (e4m3fn, e5m2), int8 with per-output-channel scales, int8_dynamic (int8 storage whose
dense products run int8 x int8 -> int32, ``ops/nn.py::dense``) and group-wise int4.

The functions act on a module in place: they walk its ``Dense`` and ``Conv1d`` modules
(``ops/nn.py::QuantizableWeight``), match the deny substrings against each weight's
qualified name, and put each weight they take into fp8 (the ``weight`` parameter in its new
dtype) or into codes and scales (the buffers ``weight_<kind>`` and ``weight_scale``). Every
op dequantizes at use (``ops/nn.py::_match``). Each returns ``(counts, bytes_saved)``, the
numbers the JAX functions return for the same model: the JAX tree stacks each block weight
over the blocks as one leaf, so ``counts`` counts a block weight once, over every block.

Memory: each weight is quantized on its own device, in fp32, one at a time, so the transient
is one weight's fp32 copy. The JAX package's ``on_host`` and ``consume`` knobs bound the
transient of its stacked leaves (a whole stack of blocks at once); the port's per-block
modules are bounded already, so there are no such knobs here.

The codes and scales equal the JAX package's bit for bit, after the layout transpose: the
scale is the max magnitude over its axes divided (not multiplied by a reciprocal) by 127
or 7, clamped at 1e-12; the codes are the weight divided by the scale, rounded half to even
(``torch.round``, ``np.round`` and ``jnp.round`` all do), and clipped. Every division is a
true one on the card too (``ops/nn.py::divide``), so a quantization on the card equals one
on the CPU.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

import torch
from torch import nn

from foley_tpu_torch.ops.nn import QuantizableWeight, divide

# The reference's deny list (utils.py:298-310), as the JAX package names its leaves.
FP8_DENY_SUBSTRINGS = (
    "norm",             # every LayerNorm / RMSNorm / qk-norm weight
    "final_layer",      # the output projection stays in the model's precision
    "visual_proj",      # the early visual projection
    "audio_cross_q",    # the cross-attention queries and projections (audio and v_cond)
    "v_cond_cross_q",
    "audio_cross_proj",
    "v_cond_cross_proj",
    "empty_clip_feat",  # the learned condition embeddings
    "empty_sync_feat",
    "sync_pos_emb",
)

FP8_DTYPES = {"fp8_e4m3fn": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}
MODES = ("fp8_e4m3fn", "fp8_e5m2", "int8", "int8_dynamic", "int4")

# a block weight's name without its block index: the JAX tree's one stacked leaf
_BLOCK = re.compile(r"^(triple_blocks|single_blocks)\.\d+\.")


def _leaf(name: str) -> str:
    return _BLOCK.sub(r"\1.", name)


def _leaves(model: nn.Module) -> set:
    """The JAX tree's leaves of ``model``: its parameter and buffer names, block index
    dropped."""
    return {_leaf(n) for n, _ in model.named_parameters()} | {
        _leaf(n) for n, _ in model.named_buffers()}


def _targets(model: nn.Module, deny: Tuple[str, ...]
             ) -> Iterator[Tuple[str, QuantizableWeight]]:
    """(qualified weight name, module) of every float ``weight`` outside the deny list."""
    for name, m in list(model.named_modules()):
        if isinstance(m, QuantizableWeight) and "weight" in m._parameters:
            path = f"{name}.weight" if name else "weight"
            if not any(s in path for s in deny) and m.weight.is_floating_point():
                yield path, m


def _counts(leaves: set, quantized: List[str]) -> Dict[str, int]:
    done = {_leaf(p) for p in quantized}
    return {"quantized": len(done), "skipped": len(leaves) - len(done)}


@torch.no_grad()
def quantize_fp8(model: nn.Module, quantization: str = "fp8_e4m3fn",
                 deny_substrings: Tuple[str, ...] = FP8_DENY_SUBSTRINGS
                 ) -> Tuple[Dict[str, int], int]:
    """fp8 storage: each weight cast to ``quantization``'s type. Returns (counts,
    bytes_saved)."""
    if quantization not in FP8_DTYPES:
        raise ValueError(f"fp8 type {quantization!r}: expected one of {sorted(FP8_DTYPES)}")
    qdtype = FP8_DTYPES[quantization]
    leaves, done, saved = _leaves(model), [], 0
    for path, m in _targets(model, deny_substrings):
        if "norm" in path:
            continue
        w = m.weight
        saved += w.numel() * (w.element_size() - 1)
        m.set_weight(w.to(qdtype))
        done.append(path)
    return _counts(leaves, done), saved


def _int8_dims(path: str, ndim: int) -> Tuple[int, ...]:
    """The axes each int8 scale reduces. The JAX rule, ``range(1 if ndim >= 3 else 0,
    ndim - 1)`` over JAX layouts, takes a 3-D leaf's first axis for a depth: a block's
    weight (stacked over the blocks in JAX) gets one scale per output channel, taken over
    the inputs and, for a conv, its taps; a conv outside the blocks ([K, in, out] in JAX)
    gets one scale per (output channel, tap)."""
    if ndim == 3 and not _BLOCK.match(path):
        return (1,)
    return tuple(range(1, ndim))


@torch.no_grad()
def quantize_int8(model: nn.Module, deny_substrings: Tuple[str, ...] = FP8_DENY_SUBSTRINGS,
                  dynamic: bool = False) -> Tuple[Dict[str, int], int]:
    """int8 codes with fp32 per-output-channel scales (``_int8_dims``); ``dynamic`` stores
    them as ``int8_dyn``, whose dense products run int8 x int8 -> int32. Returns (counts,
    bytes_saved)."""
    kind = "int8_dyn" if dynamic else "int8"
    leaves, done, saved = _leaves(model), [], 0
    for path, m in _targets(model, deny_substrings):
        w = m.weight
        w32 = w.float()
        scale = torch.clamp_min(
            divide(w32.abs().amax(dim=_int8_dims(path, w.ndim), keepdim=True), 127.0), 1e-12)
        q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
        saved += w.numel() * (w.element_size() - 1) - scale.numel() * 4
        m.set_quantized(kind, q, scale)
        done.append(path)
    return _counts(leaves, done), saved


@torch.no_grad()
def quantize_int4(model: nn.Module, deny_substrings: Tuple[str, ...] = FP8_DENY_SUBSTRINGS,
                  group_size: int = 128) -> Tuple[Dict[str, int], int]:
    """Symmetric 4-bit codes in [-7, 7] with an fp32 scale per (output channel, group of
    ``group_size`` input rows, tap), packed split-half along the input axis
    (``ops/nn.py::QuantizedWeight``). An input axis that ``group_size`` does not divide
    takes one group; an odd input axis stays unquantized. Returns (counts, bytes_saved)."""
    leaves, done, saved = _leaves(model), [], 0
    for path, m in _targets(model, deny_substrings):
        w = m.weight
        cin = w.shape[1]
        if w.ndim < 2 or cin % 2:
            continue
        g = group_size if cin % group_size == 0 else cin
        w32 = w.float().unflatten(1, (cin // g, g))  # [out, n_groups, g(, K)]
        scale = torch.clamp_min(divide(w32.abs().amax(dim=2, keepdim=True), 7.0), 1e-12)
        qb = (torch.clamp(torch.round(w32 / scale), -7, 7).flatten(1, 2) + 8).to(torch.uint8)
        packed = ((qb[:, cin // 2:] << 4) | qb[:, :cin // 2]).contiguous()
        saved += w.numel() * w.element_size() - packed.numel() - scale.numel() * 4
        m.set_quantized("int4", packed, scale)
        done.append(path)
    return _counts(leaves, done), saved


def quantize_params(model: nn.Module, mode: str) -> Tuple[Dict[str, int], int]:
    """The storage-mode dispatch every entry point goes through: fp8_e4m3fn, fp8_e5m2, int8,
    int8_dynamic or int4, in place. Returns (counts, bytes_saved)."""
    if mode in FP8_DTYPES:
        return quantize_fp8(model, mode)
    if mode == "int4":
        return quantize_int4(model)
    if mode in ("int8", "int8_dynamic"):
        return quantize_int8(model, dynamic=mode == "int8_dynamic")
    raise ValueError(f"unknown quantization mode {mode!r}; known: {', '.join(MODES)}")
