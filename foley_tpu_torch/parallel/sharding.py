"""Tensor-parallel placement of the denoiser's weights (``foley_tpu/parallel/sharding.py``
counterpart).

The rule table is the JAX package's, regex for regex, matched against the port's state-dict
names: ``col`` (column-parallel: the output features shard on ``model``), ``row``
(row-parallel: the input features shard), ``replicate``. In torch's layouts (``ops/nn.py``)
a dense weight is ``[out, in]`` and a conv's ``[out, in, K]``: ``col`` shards axis 0 and
``row`` axis 1. A column-parallel bias shards with its outputs; a row-parallel bias is
replicated and added once, after the sum. Norms, embedders and the final layer replicate.

GSPMD keeps every op's global meaning, so the JAX rules need not say how a block reads a
sharded output. Here a rank computes on its own slices, which must hold whole heads:

- a fused projection that the block splits into equal parts (``chunk(3)`` of q, k, v;
  ``chunk(2)`` of the text k, v; ``chunk(9)`` and ``chunk(6)`` of the adaLN vectors) shards
  each part by itself (``FUSED_PARTS``): a contiguous half of ``[q; k; v]`` would give one
  rank all of q;
- the adaLN projections (``audio_mod``, ``v_cond_mod``, ``modulation``: ``col`` in JAX)
  shard part by part, and their vectors are all-gathered (``GATHERED``): every rank
  modulates its whole hidden state with them.

``shard_params`` places a denoiser in place: each ``Dense`` / ``Conv1d`` that a rule shards is
replaced by a ``ColumnParallel*`` or ``RowParallel*`` subclass holding this rank's slices, and
nothing else of the model changes. The head count of a block is read from its widths
(``models/mmdit.py::_split_heads``), so a rank with ``num_heads / model`` heads runs the
unchanged blocks, K1 included. With ``model == 1`` no layer is replaced.

Training (``parallel/training.py``) differentiates the same layers: a column layer's input
goes through ``RankMesh.copy_to`` (its gradient summed over ``model``), a row layer's sum is
``RankMesh.sum_over`` and the adaLN gather ``RankMesh.gather_parts``, all three
differentiable. A replicated LoRA adapter is sliced as its layer is (``lora_slices``), and
the replicated leaves that act on a rank's own heads (``RANK_LOCAL``) take a share of their
gradient on each rank.

Quantized storage: fp8 weights shard as any weight. int8, int8_dynamic and int4 keep scales
whose input axis has size 1 (``[..., 1, out]`` in JAX's layout, int4 ``[..., n_groups, 1,
out]``): the row rules shard that axis, which JAX's ``device_put`` refuses, and so does the
port (``check_quantization``: the server calls it on its flag before anything is loaded,
``shard_params`` on the storage it finds).
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from foley_tpu_torch.ops.nn import Conv1d, Dense, QUANT_KINDS, conv1d, dense
from foley_tpu_torch.parallel.mesh import MODEL_AXIS, RankMesh

# (path-regex, kind) in priority order, the JAX package's table.
MMDIT_PARAM_RULES: Tuple[Tuple[str, str], ...] = (
    # triple blocks
    (r"audio_self_attn_qkv|v_cond_attn_qkv|text_cross_kv|audio_cross_q\.|v_cond_cross_q\.", "col"),
    (r"audio_self_proj|v_cond_self_proj|audio_cross_proj|v_cond_cross_proj", "row"),
    (r"(audio_mlp|v_cond_mlp)\.fc1", "col"),
    (r"(audio_mlp|v_cond_mlp)\.fc2", "row"),
    (r"(audio_mod|v_cond_mod|modulation)\.", "col"),
    # single blocks
    (r"linear_qkv", "col"),
    (r"linear1\.", "row"),
    (r"linear2\.(w1|w3)", "col"),
    (r"linear2\.w2", "row"),
    # sync conditioning MLP
    (r"sync_in\.conv_mlp\.(w1|w3)", "col"),
    (r"sync_in\.conv_mlp\.w2", "row"),
    # everything else (embedders, norms, final layer, empties): replicated
    (r".*", "replicate"),
)

#: Column-parallel outputs that a block splits into equal parts: each part shards by itself.
FUSED_PARTS: Tuple[Tuple[str, int], ...] = (
    (r"audio_self_attn_qkv|v_cond_attn_qkv|linear_qkv", 3),
    (r"text_cross_kv", 2),
    (r"audio_mod|v_cond_mod", 9),
    (r"modulation", 6),
)

#: Column-parallel outputs that every rank applies whole: all-gathered after the product.
GATHERED = r"(audio_mod|v_cond_mod|modulation)\."

#: Replicated leaves that act on a rank's own slice of the heads: the qk RMSNorm weights
#: (``models/mmdit.py``'s ``*_q_norm`` / ``*_k_norm`` and the single blocks' ``q_norm`` /
#: ``k_norm``). A rank's gradient of one is its heads' share of the whole.
RANK_LOCAL = r"(q_norm|k_norm)\.weight$"

class Spec(NamedTuple):
    """A leaf's placement: its ``kind`` (col, row, replicate), the torch ``axis`` sharded on
    ``model`` (None: replicated) and the equal ``parts`` that axis is fused from."""

    kind: str
    axis: Optional[int]
    parts: int = 1


REPLICATED = Spec("replicate", None)


def _first(table, path: str, default):
    for pattern, value in table:
        if re.search(pattern, path):
            return value
    return default


def partition_spec_for(path: str, leaf: torch.Tensor,
                       rules: Sequence[Tuple[str, str]] = MMDIT_PARAM_RULES) -> Spec:
    """The placement of the leaf ``path`` (a state-dict name) from the rule table, as the
    JAX ``partition_spec_for`` resolves it: column biases shard with their outputs, row
    biases replicate, 1-D weights (norms) and scalars replicate."""
    kind = _first(rules, path, "replicate")
    if kind == "replicate" or leaf.ndim == 0:
        return REPLICATED
    parts = _first(FUSED_PARTS, path, 1) if kind == "col" else 1
    if path.endswith(".bias"):
        return Spec("col", 0, parts) if kind == "col" else REPLICATED
    if leaf.ndim == 1:
        return REPLICATED
    return Spec(kind, 0 if kind == "col" else 1, parts)


def param_shardings(model: nn.Module, rules=MMDIT_PARAM_RULES) -> Dict[str, Spec]:
    """Every leaf's ``Spec``, by state-dict name (the JAX ``param_shardings``' table)."""
    return {name: partition_spec_for(name, t, rules) for name, t in model.state_dict().items()}


def take_slice(t: torch.Tensor, dim: int, parts: int, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim``, an axis of ``parts`` equal parts each
    split in ``size`` contiguous pieces: piece ``rank`` of every part, a new tensor
    (differentiable)."""
    dim %= t.ndim
    if t.shape[dim] % (parts * size):
        raise ValueError(f"an axis of {t.shape[dim]} does not split into {parts} part(s) x "
                         f"model={size}")
    return t.unflatten(dim, (parts, size, -1)).select(dim + 1, rank).flatten(dim, dim + 1).clone()


def check_quantization(mode: str, model: int) -> None:
    """Refuse integer weight storage (``mode`` int8, int8_dynamic or int4, or the storage
    kind ``int8_dyn``) at ``model > 1`` (module docstring)."""
    if model > 1 and mode.startswith("int"):
        raise ValueError(f"{mode} weight storage at model={model}: the row-parallel weights' "
                         "per-channel scales cannot shard on the model axis (the JAX "
                         "package's shard_params refuses them too); use fp8 or model=1")


def check_widths(cfg, model: int) -> None:
    """The widths the rules shard divide by ``model``, whole heads to a rank."""
    widths = {"num_heads": cfg.num_heads, "mlp_hidden_dim": cfg.mlp_hidden_dim,
              "conv_mlp_hidden_dim": cfg.conv_mlp_hidden_dim}
    bad = {k: v for k, v in widths.items() if v % model}
    if bad:
        raise ValueError(f"model={model} does not divide the denoiser's {bad}")


def shard_state_dict(state: Dict[str, torch.Tensor], mesh: RankMesh,
                     rules=MMDIT_PARAM_RULES) -> Dict[str, torch.Tensor]:
    """This rank's slice of every leaf of an unsharded denoiser state dict: what the
    ``shard_params``'d model's ``state_dict`` holds."""
    out = {}
    for name, t in state.items():
        spec = partition_spec_for(name, t, rules)
        if mesh.model > 1 and spec.axis is not None:
            t = take_slice(t, spec.axis, spec.parts, mesh.model, mesh.model_rank)
        out[name] = t
    return out


def lora_placement(name: str, rules=MMDIT_PARAM_RULES) -> Tuple[str, int]:
    """(kind, parts) of the layer an adapter factor ``<family>.<path>.a|b`` adapts."""
    family, _, path = name.rpartition(".")[0].partition(".")
    layer = f"{family}.0.{path}"
    kind = _first(rules, layer + ".weight", "replicate")
    return kind, (_first(FUSED_PARTS, layer, 1) if kind == "col" else 1)


def lora_slices(adapter: Dict[str, torch.Tensor], model: nn.Module, mesh: RankMesh,
                rules=MMDIT_PARAM_RULES) -> Dict[str, torch.Tensor]:
    """This rank's part of a replicated adapter over the placed ``model``: a column layer's
    ``b`` keeps its output columns (part by part, as the weight's rows), a row layer's ``a``
    its input rows; the rest is whole. Differentiable, so the gradient of a slice lands in
    the whole factor. The adapter must have been drawn for the whole model (before
    ``shard_params``): ``init_lora`` reads the weights' shapes."""
    if mesh.model == 1:
        return adapter
    out = {}
    for name, t in adapter.items():
        kind, parts = lora_placement(name, rules)
        factor = name.rpartition(".")[2]
        if (kind, factor) not in (("col", "b"), ("row", "a")):
            out[name] = t
            continue
        family, _, path = name.rpartition(".")[0].partition(".")
        w = getattr(model, family)[0].get_submodule(path).weight
        # a: [L, (K,) in, r], b: [L, (K,) r, out]; the weight [out, in(, K)], sliced
        dim, local = (t.ndim - 1, w.shape[0]) if factor == "b" else (t.ndim - 2, w.shape[1])
        if t.shape[dim] != local * mesh.model:
            raise ValueError(f"adapter {name}: {t.shape[dim]} features where the placed layer "
                             f"holds {local} of {local * mesh.model}: draw the adapter from "
                             "the whole model, before shard_params")
        out[name] = take_slice(t, dim, parts, mesh.model, mesh.model_rank)
    return out


# ---------------------------------------------------------------------------------
# The parallel layers
# ---------------------------------------------------------------------------------

class _Parallel:
    """What a parallel layer adds to its ``Dense`` / ``Conv1d``: the rank's mesh, and the
    parts its sharded axis is fused from."""

    mesh: RankMesh
    parts: int = 1
    gather: bool = False

    @classmethod
    def replacing(cls, layer: nn.Module, name: str, mesh: RankMesh, rules=MMDIT_PARAM_RULES):
        """A layer of this class holding ``layer``'s slices for ``mesh``'s rank (``layer``'s
        leaves are not changed); ``name`` is ``layer``'s name in the denoiser."""
        new = cls.__new__(cls)
        nn.Module.__init__(new)
        new.__dict__.update({k: v for k, v in layer.__dict__.items() if not k.startswith("_")})
        for leaf, p in layer._parameters.items():
            spec = partition_spec_for(f"{name}.{leaf}", p, rules) if p is not None else None
            if spec is not None and spec.axis is not None:
                p = nn.Parameter(take_slice(p.data, spec.axis, spec.parts, mesh.model,
                                            mesh.model_rank), requires_grad=p.requires_grad)
            new._parameters[leaf] = p
        new.mesh = mesh
        new.parts = _first(FUSED_PARTS, name, 1) if issubclass(cls, _Column) else 1
        new.gather = bool(re.search(GATHERED, name + "."))
        return new


class _Column(_Parallel):
    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """The replicated input; its gradient summed over ``model``."""
        return self.mesh.copy_to(x, MODEL_AXIS)

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return self.mesh.gather_parts(y, MODEL_AXIS, self.parts) if self.gather else y


class _Row(_Parallel):
    def _out(self, y: torch.Tensor) -> torch.Tensor:
        """The partial products summed over ``model``, then the replicated bias."""
        y = self.mesh.sum_over(y, MODEL_AXIS)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ColumnParallelDense(_Column, Dense):
    """A ``Dense`` with this rank's output features (all-gathered for the adaLN vectors)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._out(dense(self._in(x), self.stored_weight(), self.bias))


class RowParallelDense(_Row, Dense):
    """A ``Dense`` with this rank's input features: its product summed over ``model``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._out(dense(x, self.stored_weight()))


class ColumnParallelConv1d(_Column, Conv1d):
    """A ``Conv1d`` with this rank's output channels."""

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self._out(conv1d(self._in(x), self.stored_weight(), self.bias, **kw))


class RowParallelConv1d(_Row, Conv1d):
    """A ``Conv1d`` with this rank's input channels: its product summed over ``model``."""

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self._out(conv1d(x, self.stored_weight(), **kw))


_PARALLEL = {(Dense, "col"): ColumnParallelDense, (Dense, "row"): RowParallelDense,
             (Conv1d, "col"): ColumnParallelConv1d, (Conv1d, "row"): RowParallelConv1d}


@torch.no_grad()
def shard_params(model: nn.Module, mesh: RankMesh, rules=MMDIT_PARAM_RULES) -> nn.Module:
    """Place an unsharded denoiser on ``mesh``'s rank in place (module docstring): each
    sharded layer is replaced by its parallel subclass, and the whole leaves it held are
    freed. Returns ``model``."""
    if getattr(model, "block_swap", None) is not None:
        raise ValueError("a denoiser with blocks swapped to the host cannot be placed on a "
                         "mesh (block swap is a one-device memory mode)")
    if mesh.model == 1:
        return model
    check_widths(model.cfg, mesh.model)
    for kind in {k for m in model.modules() for k in QUANT_KINDS if "weight_" + k in m._buffers}:
        check_quantization(kind, mesh.model)
    for name, layer in list(model.named_modules()):
        cls = _PARALLEL.get((type(layer), _first(rules, name + ".weight", "replicate")))
        if cls is not None:
            parent, _, attr = name.rpartition(".")
            setattr(model.get_submodule(parent), attr, cls.replacing(layer, name, mesh, rules))
    return model
