"""Weight bridge: JAX parameter trees (as numpy arrays) -> the port's modules, and optax
Adam state -> the port's (``optimizer_state_from_jax``).

The trees are those of the JAX ``init`` functions (``mmdit``, ``dac_vae``, ``siglip2``,
``synchformer``, ``clap``, ``quantize``, ``dac_discriminator``) after the caller has fetched them to the host
(``jax.device_get``); this module imports no JAX. It owns every layout change between the
two packages:

- the depth axis of ``triple_blocks`` / ``single_blocks`` is unstacked into ``<name>.<i>``;
- dense ``w`` [in, out] -> ``weight`` [out, in];
- conv ``w`` [K, in, out] -> ``weight`` [out, in, K]; transposed conv (``conv_t``)
  ``w`` [K, in, out] -> ``weight`` [in, out, K]; 2-D conv (the DAC's discriminators) ``w``
  HWIO [Kh, Kw, in, out] -> OIHW [out, in, Kh, Kw];
- ``b`` -> ``bias``; list indices and every other name stay (the encoders'
  ``position_embedding``, ``probe``, ``cls_token``, ``pos_embed`` and ``temp_embed``, and
  CLAP's ``word``, ``position`` and ``token_type`` tables, pass through unchanged).

A JAX-quantized tree (``foley_tpu/io/quantize.py``) crosses too: a ``{kind, "scale"}`` leaf
(kind ``int8``, ``int8_dyn`` or ``int4``) becomes the buffers ``weight_<kind>`` and
``weight_scale`` (``ops/nn.py::QuantizedWeight``): the codes take the weight's layout change
(int4's packed rows are input rows, so they do too), an int8 scale takes it as well
(``[.., 1, out]`` -> ``[out, 1(, ..)]``), and an int4 scale ``[(K,) n_groups, 1, out]`` becomes
``[out, n_groups, 1(, K)]``. fp8 leaves stay fp8 (``module_from_state_dict`` keeps them).

bf16 and fp8 leaves (``ml_dtypes`` types, which ``torch.from_numpy`` refuses) pass through a
``uint16`` / ``uint8`` view.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from foley_tpu_torch.configs import DACConfig, MMDiTConfig
from foley_tpu_torch.core.device import DeviceLike
from foley_tpu_torch.ops.nn import QUANT_KINDS

_STACKED = ("triple_blocks", "single_blocks")
_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
          "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def to_tensor(a) -> torch.Tensor:
    """numpy array (fp32, fp16, int, or ml_dtypes bfloat16 / float8) -> CPU tensor, same
    bits."""
    a = np.ascontiguousarray(a)
    if str(a.dtype) in _VIEWS:
        view, dtype = _VIEWS[str(a.dtype)]
        return torch.from_numpy(a.view(view).copy()).view(dtype)
    return torch.from_numpy(a.copy())


def _leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, np.ndarray]]:
    if isinstance(tree, dict) and "scale" in tree:  # a quantized weight: name its scale's kind
        kind = next(k for k in QUANT_KINDS if k in tree)
        yield prefix + (kind,), np.asarray(tree[kind])
        yield prefix + ("scale_" + kind,), np.asarray(tree["scale"])
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, np.asarray(tree)


def _weight_layout(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:
        return a.T
    if a.ndim == 3:
        return a.transpose(1, 2, 0) if "conv_t" in path else a.transpose(2, 1, 0)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a


def _convert(path: Tuple[str, ...], a: np.ndarray) -> Tuple[str, np.ndarray]:
    name = path[-1]
    if name == "b":
        name = "bias"
    elif name == "w":
        name = "weight"
        a = _weight_layout(path, a)
    elif path[-2:-1] == ("w",) and name in QUANT_KINDS:
        return ".".join(path[:-2] + ("weight_" + name,)), _weight_layout(path, a)
    elif path[-2:-1] == ("w",) and name == "scale_int4":  # [(K,) n_groups, 1, out]
        a = a.transpose(2, 0, 1) if a.ndim == 3 else a.transpose(3, 1, 2, 0)
        return ".".join(path[:-2] + ("weight_scale",)), a
    elif path[-2:-1] == ("w",) and name.startswith("scale_"):
        return ".".join(path[:-2] + ("weight_scale",)), _weight_layout(path, a)
    return ".".join(path[:-1] + (name,)), a


def state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree -> a flat state dict in the port's names and layouts."""
    out = {}
    for path, a in _leaves(params):
        if path[0] in _STACKED:
            for i in range(a.shape[0]):
                key, t = _convert((path[0], str(i)) + path[1:], a[i])
                out[key] = to_tensor(t)
        else:
            key, t = _convert(path, a)
            out[key] = to_tensor(t)
    return out


def _dtype_of(state: Dict[str, torch.Tensor]) -> torch.dtype:
    """The model's float dtype: that of its first float tensor that is neither fp8 storage nor
    a quantized weight's fp32 scale."""
    return next(t.dtype for k, t in state.items() if t.is_floating_point()
                and t.element_size() > 1 and not k.endswith("weight_scale"))


def _module_from_jax(cls, params: Dict, cfg, device: DeviceLike, dtype):
    from foley_tpu_torch.io.convert import module_from_state_dict

    state = state_dict_from_jax(params)
    return module_from_state_dict(cls, state, cfg, device, dtype or _dtype_of(state))


def mmdit_from_jax(params: Dict, cfg: MMDiTConfig, device: DeviceLike = None,
                   dtype=None):
    """Build the port's ``MMDiT`` on ``device`` holding the JAX tree's weights (in ``dtype``,
    by default the tree's own float dtype)."""
    from foley_tpu_torch.models.mmdit import MMDiT

    return _module_from_jax(MMDiT, params, cfg, device, dtype)


def dac_from_jax(params: Dict, cfg: DACConfig, device: DeviceLike = None, dtype=None):
    """Build the port's ``DAC`` (encoder and decoder) on ``device`` from a JAX ``dac_vae``
    tree."""
    from foley_tpu_torch.models.dac_vae import DAC

    return _module_from_jax(DAC, params, cfg, device, dtype)


def rvq_from_jax(params: Dict, cfg, device: DeviceLike = None, dtype=None):
    """Build the port's ``RVQ`` from a JAX ``quantize.init`` tree (``cfg``: the port's
    ``RVQConfig``)."""
    from foley_tpu_torch.models.quantize import RVQ

    return _module_from_jax(RVQ, params, cfg, device, dtype)


def discriminator_from_jax(params: Dict, cfg, device: DeviceLike = None, dtype=None):
    """Build the port's ``Discriminator`` from a JAX ``dac_discriminator.init`` tree
    (``cfg``: the port's ``DiscriminatorConfig``)."""
    from foley_tpu_torch.models.dac_discriminator import Discriminator

    return _module_from_jax(Discriminator, params, cfg, device, dtype)


def clap_from_jax(params: Dict, cfg, device: DeviceLike = None, dtype=None):
    """Build the port's ``ClapText`` from a JAX ``clap.init`` tree (``cfg``: the port's
    ``ClapTextConfig``)."""
    from foley_tpu_torch.models.clap import ClapText

    return _module_from_jax(ClapText, params, cfg, device, dtype)


def siglip2_from_jax(params: Dict, cfg, device: DeviceLike = None, dtype=None):
    """Build the port's ``Siglip2`` tower from a JAX ``siglip2.init`` tree (``cfg``: the
    port's ``SiglipVisionConfig``)."""
    from foley_tpu_torch.models.siglip2 import Siglip2

    return _module_from_jax(Siglip2, params, cfg, device, dtype)


def synchformer_from_jax(params: Dict, cfg, device: DeviceLike = None, dtype=None):
    """Build the port's ``Synchformer`` from a JAX ``synchformer.init`` tree (``cfg``: the
    port's ``SynchformerConfig``)."""
    from foley_tpu_torch.models.synchformer import Synchformer

    return _module_from_jax(Synchformer, params, cfg, device, dtype)


def lora_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A JAX LoRA tree (``foley_tpu/models/lora.py::init_lora`` / ``load_lora``, fetched to
    the host) -> the port's adapter tensors (``models/lora.py``): the tree's flat names
    (``triple_blocks.audio_mlp.fc1.a``), each factor in its JAX layout with the stacked block
    axis first; ``merge_lora`` maps each delta onto the port's weight layout."""
    return {".".join(path): to_tensor(a) for path, a in _leaves(tree)}


def ast_from_jax(params: Dict, freq_agg_params: Dict, cfg, device: DeviceLike = None,
                 dtype=None):
    """Build the port's ``AST`` and its frequency pooling (``synchformer.SpatialAgg``) from
    the JAX ``ast`` tree and its ``freq_agg`` tree (``cfg``: the port's ``ASTConfig``).
    Returns (ast, freq_agg)."""
    from foley_tpu_torch.core.device import resolve_device
    from foley_tpu_torch.models.ast import AST
    from foley_tpu_torch.models.synchformer import SpatialAgg

    state = state_dict_from_jax(freq_agg_params)
    hidden, d = state["linear1.weight"].shape
    freq_agg = SpatialAgg(d, hidden, dtype or _dtype_of(state), resolve_device(device))
    freq_agg.load_state_dict(state, strict=True)
    return _module_from_jax(AST, params, cfg, device, dtype), freq_agg


def sync_scorer_from_jax(params: Dict, cfg, device: DeviceLike = None, dtype=None):
    """Build the port's ``SyncScorer`` (the GlobalTransformer head) from a JAX
    ``sync_scorer`` tree (``cfg``: the port's ``SyncScorerConfig``)."""
    from foley_tpu_torch.models.sync_scorer import SyncScorer

    return _module_from_jax(SyncScorer, params, cfg, device, dtype)


def optimizer_state_from_jax(opt_state, lora: bool = False):
    """An optax Adam / AdamW state (``optax.adam(...).init`` or ``adamw``'s chain, fetched to
    the host) -> the port's ``training/optim.py::AdamState``: the ``ScaleByAdamState``'s
    ``mu`` and ``nu`` trees in the port's names and layouts (the parameters' with
    ``state_dict_from_jax``; with ``lora``, the adapter's with ``lora_from_jax``) and its
    ``count``. The chain's other members (weight decay, learning rate) hold no state."""
    from foley_tpu_torch.training.optim import AdamState

    def find(node):
        if all(hasattr(node, f) for f in ("count", "mu", "nu")):
            return node
        if isinstance(node, (list, tuple)):
            for child in node:
                found = find(child)
                if found is not None:
                    return found
        return None

    adam_state = find(opt_state)
    if adam_state is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer state")
    convert = lora_from_jax if lora else state_dict_from_jax
    return AdamState(mu=convert(adam_state.mu), nu=convert(adam_state.nu),
                     count=int(np.asarray(adam_state.count)))
