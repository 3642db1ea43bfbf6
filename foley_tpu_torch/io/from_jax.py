"""Weight bridge: JAX parameter trees (as numpy arrays) -> the port's modules.

The trees are those of the JAX ``init`` functions (``mmdit``, ``dac_vae``, ``siglip2``,
``synchformer``, ``clap``) after the caller has fetched them to the host
(``jax.device_get``); this module imports no JAX. It owns every layout change between the
two packages:

- the depth axis of ``triple_blocks`` / ``single_blocks`` is unstacked into ``<name>.<i>``;
- dense ``w`` [in, out] -> ``weight`` [out, in];
- conv ``w`` [K, in, out] -> ``weight`` [out, in, K]; transposed conv (``conv_t``)
  ``w`` [K, in, out] -> ``weight`` [in, out, K];
- ``b`` -> ``bias``; list indices and every other name stay (the encoders'
  ``position_embedding``, ``probe``, ``cls_token``, ``pos_embed`` and ``temp_embed``, and
  CLAP's ``word``, ``position`` and ``token_type`` tables, pass through unchanged).

bf16 leaves (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) pass through a
``uint16`` view.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from foley_tpu_torch.configs import DACConfig, MMDiTConfig
from foley_tpu_torch.core.device import DeviceLike

_STACKED = ("triple_blocks", "single_blocks")


def to_tensor(a) -> torch.Tensor:
    """numpy array (fp32, fp16, int, or ml_dtypes bfloat16) -> CPU tensor, same bits."""
    a = np.ascontiguousarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, np.asarray(tree)


def _convert(path: Tuple[str, ...], a: np.ndarray) -> Tuple[str, np.ndarray]:
    name = path[-1]
    if name == "b":
        name = "bias"
    elif name == "w":
        name = "weight"
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 3:
            a = a.transpose(1, 2, 0) if "conv_t" in path else a.transpose(2, 1, 0)
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
    return next(t.dtype for t in state.values() if t.is_floating_point())


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
