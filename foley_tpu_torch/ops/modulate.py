"""adaLN modulation primitives (``foley_tpu/ops/modulate.py`` counterpart).

``modulate``: x * (1 + scale) + shift; ``apply_gate``: x * gate. Per-batch 2-D vectors
broadcast over the sequence axis; per-token 3-D vectors apply directly.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bcast(m: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    if m is not None and x.ndim == 3 and m.ndim == 2:
        return m[:, None, :]
    return m


def modulate(x: torch.Tensor, shift: Optional[torch.Tensor] = None,
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    shift = _bcast(shift, x)
    scale = _bcast(scale, x)
    if scale is None and shift is None:
        return x
    if shift is None:
        return x * (1 + scale)
    if scale is None:
        return x + shift
    return x * (1 + scale) + shift


def modulate_ref(x: torch.Tensor, shift: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference ``modulate()`` helper's exact semantics (``modulate_layers.py:19-30``).

    When x is 3-D, shift/scale are kept only if they are per-batch 2-D; per-token 3-D
    modulation is silently dropped. Every shipped config's final layer hits this, and its
    checkpoints were trained that way, so the port copies the quirk.
    """
    if x.ndim == 3:
        shift = shift if shift is not None and shift.ndim == 2 else None
        scale = scale if scale is not None and scale.ndim == 2 else None
    return modulate(x, shift, scale)


def apply_gate(x: torch.Tensor, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    return x if gate is None else x * _bcast(gate, x)
