"""LoRA merge at load (``foley_tpu/models/lora.py`` counterpart: ``merge_lora``,
``load_lora``).

An adapter holds a factor pair per targeted weight of the denoiser's blocks, under the JAX
tree's flat names with the stacked block axis first:

- a dense weight: ``<family>.<path>.a`` ``[L, in, r]`` and ``.b`` ``[L, r, out]``;
- a conv weight (``linear1``, the ``linear2`` ConvMLP convs): per-tap factors
  ``a [L, K, in, r]``, ``b [L, K, r, out]``.

``merge_lora`` folds ``scale * a @ b`` into the port's per-block weights in place, one weight
at a time, in the layouts of ``io/from_jax.py`` (a dense delta ``[in, out]`` becomes
``[out, in]``, a conv's ``[K, in, out]`` becomes ``[out, in, K]``). The arithmetic is the JAX
package's eager one, copied and not improved:

- ``a @ b`` is formed in fp32 as the XLA CPU product forms it, one fused multiply-add a rank
  step in order (``lora_delta``); elementwise ops give the same bits on the CPU and the card,
  and no TF32 setting reaches them;
- the delta is cast to the weight's dtype, then ``w + scale * delta`` runs one op at a time
  in that dtype, rounding after each (``scale`` first rounded to the dtype);
- an fp8 weight (from an fp8 checkpoint: the precision cast leaves it alone) takes the same
  arithmetic in fp8: PyTorch has no fp8 arithmetic, so each op widens to fp32 and rounds back,
  which is what the JAX package's fp8 ops do;
- a weight in integer storage raises with the JAX package's message: the loaders merge
  before they quantize.

The adapter format of the port is a directory holding ``lora.safetensors`` (those names) and
``lora_meta.json`` (``{"rank", "scale"}``), written by ``save_lora`` or by
``tools/lora_to_safetensors.py`` from an orbax adapter of the JAX package.

The training side (``training/train.py``) applies an adapter unmerged, inside each block:
``init_lora`` draws a fresh adapter, ``block_factors`` splits one into per-block factor views
and ``block_lora`` sets each adapted weight's effective ``merge_block_lora(w, a, b, scale)``
for the duration of one block's forward. With the block checkpointed (``MMDiT.forward``'s
``remat``) autograd keeps only the factors, and the backward re-forms one block's weights at
a time: no second weight stack is ever held. That merge is the JAX ``merge_block_lora``'s
differentiable arithmetic (``a @ b`` in fp32, TF32 off, cast to the weight's dtype, then
``w + scale * delta``), not ``lora_delta``'s emulated fused multiply-adds.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch import nn

from foley_tpu_torch.io.convert import load_safetensors, save_safetensors
from foley_tpu_torch.ops.nn import QuantizableWeight, true_fp32
from foley_tpu_torch.parallel import offload

ADAPTER_FILE = "lora.safetensors"
META_FILE = "lora_meta.json"
FAMILIES = ("triple_blocks", "single_blocks")

#: The JAX package's default targets (``foley_tpu/models/lora.py::DEFAULT_TARGETS``): every
#: attention projection and MLP map of both block families, dense and conv; a targeted
#: non-leaf name (``linear2``) adapts every weight under it.
DEFAULT_TARGETS = frozenset({
    "audio_self_attn_qkv", "audio_self_proj", "v_cond_attn_qkv", "v_cond_self_proj",
    "audio_cross_q", "v_cond_cross_q", "text_cross_kv", "audio_cross_proj",
    "v_cond_cross_proj", "fc1", "fc2", "linear_qkv", "linear1", "linear2"})


def load_lora(path: str) -> Tuple[Dict[str, torch.Tensor], float]:
    """An adapter directory (or its ``lora.safetensors``) -> (flat-name tensors, the scale of
    ``lora_meta.json``, 1.0 without one)."""
    directory = path if os.path.isdir(path) else os.path.dirname(path)
    file = os.path.join(path, ADAPTER_FILE) if os.path.isdir(path) else path
    adapter = load_safetensors(file)
    scale = 1.0
    meta = os.path.join(directory, META_FILE)
    if os.path.exists(meta):
        with open(meta) as f:
            scale = float(json.load(f).get("scale", 1.0))
    return adapter, scale


def save_lora(path: str, adapter: Dict[str, torch.Tensor], rank: int,
              scale: float = 1.0) -> str:
    """Write an adapter directory: ``lora.safetensors`` and ``lora_meta.json``."""
    os.makedirs(path, exist_ok=True)
    save_safetensors(os.path.join(path, ADAPTER_FILE), adapter)
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump({"rank": int(rank), "scale": float(scale)}, f)
    return path


def lora_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 over the last two axes, formed as XLA's CPU product forms it: one
    fused multiply-add per rank step, in rank order, each rounded once to fp32 (an fp32
    product is exact in fp64, so the fp64 sum rounded to fp32 is the fused multiply-add).
    Elementwise ops, so the card's result equals the CPU's bit for bit."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc = (acc.double() + a64[..., :, k:k + 1] * b64[..., k:k + 1, :]).float()
    return acc


def _port_layout(delta: torch.Tensor) -> torch.Tensor:
    """A delta in the JAX layout -> the port's (``io/from_jax.py::_weight_layout``): dense
    ``[in, out]`` -> ``[out, in]``, conv ``[K, in, out]`` -> ``[out, in, K]``."""
    return delta.t() if delta.ndim == 2 else delta.permute(2, 1, 0)


def _pairs(adapter: Dict[str, torch.Tensor]) -> Iterator[Tuple[str, str, torch.Tensor,
                                                                  torch.Tensor]]:
    """(family, module path in a block, a, b) of every factor pair: the triple blocks'
    first, each family's in name order (the JAX ``merge_lora``'s order)."""
    groups: Dict[str, Dict[str, torch.Tensor]] = defaultdict(dict)
    for name, t in adapter.items():
        stem, _, factor = name.rpartition(".")
        if factor not in ("a", "b"):
            raise ValueError(f"adapter tensor {name!r}: expected a name ending in .a or .b")
        groups[stem][factor] = t
    for stem in groups:
        family = stem.partition(".")[0]
        if family not in FAMILIES or set(groups[stem]) != {"a", "b"}:
            raise ValueError(f"adapter entry {stem!r}: expected a and b under one of "
                             f"{FAMILIES}")
    for stem in sorted(groups, key=lambda n: (FAMILIES.index(n.partition(".")[0]), n)):
        family, _, path = stem.partition(".")
        yield family, path, groups[stem]["a"], groups[stem]["b"]


def _check_mergeable(m: QuantizableWeight, name: str) -> None:
    if "weight" not in m._parameters:
        raise ValueError(
            f"cannot merge LoRA into '{name}': leaf has no dense 'w' (quantized "
            "storage?) — merge BEFORE quantization (the loader does; see "
            "_merge_lora_if_given), and train over an unquantized base")


@torch.no_grad()
def _merge_weight(m: QuantizableWeight, name: str, a: torch.Tensor, b: torch.Tensor,
                  scale: float) -> None:
    _check_mergeable(m, name)
    w = m.weight
    dev = w.device
    delta32 = lora_delta(a.to(dev), b.to(dev))
    delta = _port_layout(delta32.to(torch.result_type(a, b))).to(w.dtype)
    s = torch.tensor(scale, dtype=torch.float32, device=dev).to(w.dtype)
    if w.element_size() == 1:  # fp8: each op widened to fp32 and rounded back
        prod = (s.float() * delta.float()).to(w.dtype)
        merged = (w.float() + prod.float()).to(w.dtype)
    else:
        merged = w + s * delta
    w.copy_(merged)


@torch.no_grad()
def merge_lora(model: nn.Module, adapter: Dict[str, torch.Tensor], scale: float = 1.0) -> int:
    """Fold ``scale * a @ b`` into every adapted weight of ``model`` (the port's ``MMDiT``),
    in place; returns the number of block weights merged. Merge before quantizing and
    before a block swap moves blocks to host memory (both raise otherwise)."""
    merged = 0
    for family, path, a, b in _pairs(adapter):
        blocks = getattr(model, family)
        if offload.swapped_blocks(model, family):
            raise ValueError(f"merge LoRA before the block swap: {family} has blocks in host "
                             "memory")
        if a.shape[0] != len(blocks) or b.shape[0] != len(blocks):
            raise ValueError(f"adapter {family}.{path}: {a.shape[0]} blocks, the model "
                             f"{len(blocks)}")
        for i, block in enumerate(blocks):
            m = block.get_submodule(path)
            if not isinstance(m, QuantizableWeight):
                raise ValueError(f"adapter {family}.{path}: not a dense or conv weight")
            _merge_weight(m, path.rpartition(".")[2], a[i], b[i], scale)
            merged += 1
    return merged


# ---------------------------------------------------------------------------------
# The training side: a fresh adapter, and the adapter applied unmerged inside each block
# ---------------------------------------------------------------------------------

def init_lora(model: nn.Module, generator: torch.Generator, rank: int = 16,
              targets: Optional[Iterable[str]] = None,
              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A fresh adapter for ``model`` (the port's ``MMDiT``), on the model's device, in the
    adapter format's names and layouts (the JAX ``init_lora``): a weight of the blocks is
    adapted when its path names one of ``targets`` (``DEFAULT_TARGETS`` when None; a
    targeted non-leaf, such as ``linear2``, adapts every weight under it); ``a`` uniform in
    ±1/sqrt(fan_in) (a conv's fan_in is K * in, as its base weight's init), ``b`` zeros, so
    the adapted model equals the base exactly. Drawn from ``generator`` (on the model's
    device) in name order; a weight in integer storage is left out, as JAX leaves it."""
    tset = DEFAULT_TARGETS if targets is None else frozenset(targets)
    out: Dict[str, torch.Tensor] = {}
    for family in FAMILIES:
        blocks = getattr(model, family)
        mods = dict(blocks[0].named_modules()) if len(blocks) else {}
        for path in sorted(mods):
            m = mods[path]
            if not (isinstance(m, QuantizableWeight) and tset & set(path.split("."))
                    and "weight" in m._parameters):
                continue
            w = m.weight
            out_dim, in_dim = w.shape[0], w.shape[1]
            taps = () if w.ndim == 2 else (w.shape[2],)
            limit = 1.0 / math.sqrt(in_dim * (taps[0] if taps else 1))
            a = torch.empty(len(blocks), *taps, in_dim, rank, dtype=dtype, device=w.device)
            out[f"{family}.{path}.a"] = a.uniform_(-limit, limit, generator=generator)
            out[f"{family}.{path}.b"] = torch.zeros(len(blocks), *taps, rank, out_dim,
                                                    dtype=dtype, device=w.device)
    if not out:
        raise ValueError(f"no LoRA targets matched in params (targets={sorted(tset)})")
    return out


def merge_block_lora(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """``w + scale * a @ b`` in the port's layout, differentiable in ``a`` and ``b`` (the JAX
    ``merge_block_lora`` of one weight): ``a @ b`` in the factors' dtype with TF32 off, cast
    to ``w``'s dtype, then ``w + scale * delta`` in that dtype, ``scale`` first rounded to
    it."""
    with true_fp32():
        delta = a @ b
    s = float(torch.tensor(scale, dtype=w.dtype))
    return w + _port_layout(delta.to(w.dtype)) * s


def block_factors(model: nn.Module, adapter: Dict[str, torch.Tensor]
                  ) -> Dict[str, List[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]]:
    """An adapter split by block: ``{family: [{path: (a_i, b_i)} for each block i]}``, the
    factors unbound along the block axis (views, so their gradients land in the stacked
    factors)."""
    out = {family: [{} for _ in getattr(model, family)] for family in FAMILIES}
    for family, path, a, b in _pairs(adapter):
        n = len(out[family])
        if a.shape[0] != n or b.shape[0] != n:
            raise ValueError(f"adapter {family}.{path}: {a.shape[0]} blocks, the model {n}")
        for blk, ai, bi in zip(out[family], a.unbind(0), b.unbind(0)):
            blk[path] = (ai, bi)
    return out


@contextlib.contextmanager
def block_lora(block: nn.Module, factors: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
               scale: float):
    """Within the block, every adapted weight reads ``merge_block_lora`` of its factors
    (``QuantizableWeight.lora_weight``); a weight in integer storage raises, as the JAX
    merge does."""
    mods = []
    try:
        for path, (a, b) in factors.items():
            m = block.get_submodule(path)
            _check_mergeable(m, path.rpartition(".")[2])
            m.lora_weight = merge_block_lora(m.weight, a, b, scale)
            mods.append(m)
        yield
    finally:
        for m in mods:
            m.lora_weight = None
