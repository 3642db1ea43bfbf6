"""Adam and AdamW in optax's arithmetic, on dicts of tensors (``optax.adam`` /
``optax.adamw`` as ``foley_tpu/training/train.py`` builds them).

One update of a leaf ``p`` with gradient ``g``, each op rounded in the leaf's dtype (the
constants first rounded to it, as JAX rounds a Python number against an array), in optax's
order:

- ``scale_by_adam``: ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g**2 + b2 * nu``,
  ``count += 1``; ``mu_hat = mu / (1 - b1**count)`` and ``nu_hat = nu / (1 - b2**count)``
  (the power and the subtraction in fp32, then cast to the leaf's dtype);
  ``u = mu_hat / (sqrt(nu_hat) + eps)``;
- ``add_decayed_weights`` (AdamW only): ``u = u + weight_decay * p``;
- ``scale_by_learning_rate``: ``u = (-learning_rate) * u``;
- ``apply_updates``: ``p = p + u``.

The moments are held in each leaf's own dtype, as optax holds them (bf16 parameters keep
bf16 moments). Every leaf is updated at every step: a leaf without a gradient (``None``,
as ``torch.autograd.grad`` gives for a parameter the loss does not reach, such as the empty
clip features when a batch brings its own) takes a zero gradient, so its moments decay and
AdamW decays the leaf, as optax does with ``jax.grad``'s zeros. (``torch.optim.AdamW``
skips a parameter whose ``.grad`` is None.) The update runs in place, leaf by leaf, so it
holds one leaf's temporaries at a time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the first and second moments by leaf name, and the
    number of updates made."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int


class Adam:
    """``optax.adamw(learning_rate, b1, b2, eps, weight_decay=weight_decay)``, or
    ``optax.adam`` when ``weight_decay`` is None (no decay step at all)."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: Optional[float] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        """Zero moments in each leaf's dtype, count 0."""
        return AdamState(mu={k: torch.zeros_like(p) for k, p in params.items()},
                         nu={k: torch.zeros_like(p) for k, p in params.items()}, count=0)

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, Optional[torch.Tensor]], state: AdamState) -> AdamState:
        """One step: ``params`` and the moments of ``state`` updated in place; returns the
        state with its count advanced."""
        count = state.count + 1
        # 1 - decay**count in fp32, the power a float one (XLA's pow of an fp32 and an int32
        # count; an integer power rounds otherwise at some counts), cast to each leaf's dtype
        # below
        n = torch.tensor(float(count), dtype=torch.float32)
        bc1, bc2 = (float(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), n))
                    for b in (self.b1, self.b2))
        consts = {}
        for name, p in params.items():
            if p.dtype not in consts:  # the constants rounded to the leaf's dtype, on the host
                consts[p.dtype] = [torch.tensor(c, dtype=torch.float64).to(p.dtype).item()
                                   for c in (1 - self.b1, self.b1, 1 - self.b2, self.b2, bc1,
                                             bc2, self.eps, self.weight_decay or 0.0,
                                             -self.learning_rate)]
            c1, b1, c2, b2, bc1_t, bc2_t, eps, wd, neg_lr = consts[p.dtype]
            g = grads.get(name)
            if g is None:
                g = torch.zeros_like(p)
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_(g * c1 + mu * b1)
            nu.copy_((g * g) * c2 + nu * b2)
            u = (mu / bc1_t) / (torch.sqrt(nu / bc2_t) + eps)
            if self.weight_decay is not None:
                u = u + p * wd
            p.copy_(p + u * neg_lr)
        return AdamState(state.mu, state.nu, count)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Adam:
    """``optax.adamw`` (its defaults)."""
    return Adam(learning_rate, b1, b2, eps, weight_decay)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Adam:
    """``optax.adam`` (its defaults)."""
    return Adam(learning_rate, b1, b2, eps)
