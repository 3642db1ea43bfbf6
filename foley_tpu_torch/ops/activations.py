"""Activations: gelu (exact and tanh), silu, relu, the SwiGLU combine and the DAC Snake
activation (``foley_tpu/ops/activations.py`` counterpart)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


_ACTIVATIONS = {"gelu": gelu, "gelu_tanh": gelu_tanh, "silu": silu, "relu": relu}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}") from None


def swiglu(x_gate: torch.Tensor, x_lin: torch.Tensor) -> torch.Tensor:
    """silu(w1 x) * (w3 x) combine."""
    return F.silu(x_gate) * x_lin


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation ``x + sin(alpha x)^2 / (alpha + 1e-9)``; ``alpha`` broadcasts
    against ``x`` (``[C]`` for channel-last x, ``[C, 1]`` for channels-first)."""
    s = torch.sin(alpha * x)
    return x + s * s / (alpha + 1e-9)
