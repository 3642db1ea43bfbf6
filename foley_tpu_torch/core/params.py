"""Parameter utilities over a module's parameters (``foley_tpu/core/params.py`` counterpart)."""

from __future__ import annotations

import itertools

import torch
from torch import nn


@torch.no_grad()
def perturb_zero_leaves(module: nn.Module, generator: torch.Generator,
                        scale: float = 0.02) -> nn.Module:
    """Replace every all-zero float parameter with small random values, in place.

    The reference zero-initializes the output layers (its FinalLayer and the adaLN
    modulation tails), so a randomly-initialized model emits exactly zero velocity and any
    comparison through it is vacuous. This perturbs exactly the zero-init parameters and
    leaves the others untouched. Deterministic given the generator's state and the module's
    parameter order. Returns the module.
    """
    for p in module.parameters():
        if p.is_floating_point() and not bool(p.any()):
            noise = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
            p.copy_(noise * scale)
    return module


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def param_bytes(module: nn.Module) -> int:
    """The bytes of every parameter and buffer (quantized codes and scales are buffers)."""
    return sum(t.numel() * t.element_size()
               for t in itertools.chain(module.parameters(), module.buffers()))
