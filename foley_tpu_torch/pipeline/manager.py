"""Model residency: parking a module's weights in pinned host memory between uses, and the
lazily loaded model registry (``foley_tpu/pipeline/manager.py::OffloadModelManager``
counterpart).

``park`` copies every parameter and buffer of a module into host buffers and points the
module at them, which frees its device memory; ``restore`` copies them back to the module's
device. The host buffers are allocated at the first park and reused by every later one
(page-locked when the module lives on a card, so both copies run at the card's copy rate),
so a park-restore cycle allocates no host memory. The values round-trip bit for bit. The
blocks a block swap keeps in host memory (``parallel/offload.py``) are left where they are:
``park`` and ``restore`` move only the rest.
"""

from __future__ import annotations

import itertools
import logging
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn

logger = logging.getLogger("foley_tpu_torch")

FEATURE_MODELS = ("clap", "siglip2", "synchformer")
INFERENCE_MODELS = ("foley", "dac")


def _tensors(module: nn.Module) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter and buffer of ``module``, but those of the blocks its block swap holds
    in host memory (``parallel/offload.py``)."""
    swap = getattr(module, "block_swap", None)
    skip = swap.prefixes() if swap is not None else ()
    for name, t in itertools.chain(module.named_parameters(), module.named_buffers()):
        if not name.startswith(skip):
            yield name, t


def module_device(module: nn.Module) -> torch.device:
    return next(t for _, t in _tensors(module)).device


def _signature(module: nn.Module):
    return [(name, t.shape, t.dtype) for name, t in _tensors(module)]


class HostBuffers:
    """One host allocation holding a view for every parameter and buffer of a module, each
    64-byte aligned. For a module on a card it is page-locked with ``cudaHostRegister`` at
    its exact size (the pinned allocator would round 9.6 GiB up to a power of two)."""

    def __init__(self, module: nn.Module, pin: bool):
        offsets, total = {}, 0
        for name, t in _tensors(module):
            offsets[name] = total
            total += -(-t.numel() * t.element_size() // 64) * 64
        self.flat = torch.empty(max(total, 1), dtype=torch.uint8)
        self.pinned = pin and int(torch.cuda.cudart().cudaHostRegister(
            self.flat.data_ptr(), self.flat.numel(), 0)) == 0
        self.signature = _signature(module)
        self.views = {
            name: self.flat[offsets[name]: offsets[name] + t.numel() * t.element_size()]
            .view(t.dtype).view(t.shape) for name, t in _tensors(module)}

    def __del__(self):
        if getattr(self, "pinned", False):
            torch.cuda.cudart().cudaHostUnregister(self.flat.data_ptr())


@torch.no_grad()
def park(module: nn.Module, host: Optional[HostBuffers] = None) -> HostBuffers:
    """Move ``module``'s weights into ``host`` (allocated here when None, or when the module's
    tensors changed since: a block swap moved blocks or a quantization replaced weights),
    synchronously, and point the module at them. Returns the buffers, which the next park
    of the same module reuses."""
    device = module_device(module)
    if host is None or host.signature != _signature(module):
        host = HostBuffers(module, pin=device.type == "cuda")
    for name, t in _tensors(module):
        host.views[name].copy_(t, non_blocking=host.pinned)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for name, t in _tensors(module):
        t.data = host.views[name]
    return host


@torch.no_grad()
def restore(module: nn.Module, device: torch.device) -> None:
    """Copy a parked module's weights back to ``device`` and wait for the copies (the next
    request reads every weight first, so waiting costs it nothing)."""
    for _, t in _tensors(module):
        dev = torch.empty(t.shape, dtype=t.dtype, device=device)
        dev.copy_(t, non_blocking=True)
        t.data = dev
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _module_of(obj: Any) -> Optional[nn.Module]:
    """The module of a registry entry: a ``{"params": module, ...}`` dict, or an encoder
    holding its module as ``.model``."""
    if isinstance(obj, dict) and isinstance(obj.get("params"), nn.Module):
        return obj["params"]
    return getattr(obj, "model", None)


class OffloadModelManager:
    """Lazily loaded models with residency by phase.

    Register loader thunks once; access them as attributes (``manager.foley``); release a
    phase's models with ``release_feature_models()`` / ``release_inference_models()``.
    ``policy``: ``host`` parks a released model in pinned host memory (``park``; the next
    access restores it), ``drop`` frees it (the next access loads it again)."""

    def __init__(self, policy: str = "host"):
        if policy not in ("host", "drop"):
            raise ValueError(f"policy {policy!r}: expected 'host' or 'drop'")
        self.policy = policy
        self._loaders: Dict[str, Callable[[], Any]] = {}
        self._live: Dict[str, Any] = {}
        self._parked: Dict[str, Tuple[Any, torch.device]] = {}
        self._host: Dict[str, HostBuffers] = {}

    def register(self, name: str, loader: Callable[[], Any]) -> None:
        self._loaders[name] = loader

    def __getattr__(self, name: str):
        if name.startswith("_") or name in ("policy", "pipeline_cfg", "device"):
            raise AttributeError(name)
        return self.get(name)

    def get(self, name: str):
        if name in self._live:
            return self._live[name]
        if name in self._parked:
            logger.info(f"restoring {name} to its device")
            obj, device = self._parked.pop(name)
            restore(_module_of(obj), device)
            self._live[name] = obj
            return obj
        if name not in self._loaders:
            raise KeyError(f"No model {name!r} registered; have {sorted(self._loaders)}")
        logger.info(f"lazy-loading {name}")
        obj = self._loaders[name]()
        self._live[name] = obj
        return obj

    def release(self, *names: str) -> None:
        for name in names:
            if name not in self._live:
                continue
            obj = self._live.pop(name)
            module = _module_of(obj)
            if self.policy == "host" and module is not None:
                device = module_device(module)
                self._host[name] = park(module, self._host.get(name))
                self._parked[name] = (obj, device)
                logger.info(f"parked {name} in host memory")
            else:
                self._host.pop(name, None)
                logger.info(f"dropped {name} (loaded again on the next access)")

    def release_feature_models(self) -> None:
        """Free the condition encoders before denoising."""
        self.release(*FEATURE_MODELS)

    def release_inference_models(self) -> None:
        """Free the denoiser and the codec before feature extraction."""
        self.release(*INFERENCE_MODELS)

    @property
    def loaded(self):
        return sorted(self._live)
