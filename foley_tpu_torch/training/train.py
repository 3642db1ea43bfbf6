"""Flow-matching train steps, full and LoRA (``foley_tpu/training/train.py`` counterpart).

Objective (the reference's flow / linear path / velocity prediction,
``configs/hunyuanvideo-foley-xxl.yaml:41-44``): data latents x1, noise x0, sigma ~ U(0, 1),
``x_sigma = (1 - sigma) * x1 + sigma * x0``, target velocity ``x0 - x1``, timestep
``t = sigma * 1000``, the loss the mean squared error in fp32.

The forward is the one ``jax.grad`` differentiates in the JAX package: the plain attention
route (``MMDiT.forward(..., attn_impl="xla")``; the CUDA kernels have no backward and raise
under autograd) with every block checkpointed (``remat``). A step runs its forward and its
backward inside ``ops/nn.py::true_fp32`` (a checkpointed block's forward is recomputed in
the backward, after the forward's own context has exited: the step's context keeps TF32 out
of the recomputed products and of the backward's) and with cuDNN restricted to deterministic
algorithms, so that a step depends on nothing but its inputs (an exact resume,
``training/loop.py``).

The denoiser's parameters are built with ``requires_grad=False``. The full step switches
gradients on for exactly the leaves ``jax.grad`` covers, every parameter of the model, for
the step's duration; the LoRA step differentiates the adapter's factors alone and never
touches the base's flags, so the base stays frozen. Gradients come from
``torch.autograd.grad`` (None for a leaf the loss does not reach, which the optimizer
treats as zero, as optax treats ``jax.grad``'s zeros).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from foley_tpu_torch.models.mmdit import MMDiT
from foley_tpu_torch.ops.nn import true_fp32
from foley_tpu_torch.training.optim import Adam, AdamState, adam, adamw

Batch = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    """``params``: the model's parameters by name (the module's own tensors, updated in
    place), ``opt_state`` their moments, ``step`` the steps taken."""

    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    step: int


class LoraTrainState(NamedTuple):
    """LoRA fine-tuning: only the adapter's factors train (the frozen base has no gradients
    and no moments). ``lora``: the factors by adapter name (``models/lora.py``)."""

    lora: Dict[str, torch.Tensor]
    opt_state: AdamState
    step: int


def flow_match_loss(model: MMDiT, batch: Batch, generator: Optional[torch.Generator] = None,
                    compute_dtype=torch.bfloat16, num_train_timesteps: int = 1000,
                    lora: Optional[Dict[str, torch.Tensor]] = None, lora_scale: float = 1.0,
                    *, noise: Optional[torch.Tensor] = None,
                    sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE between predicted and target velocity on the linear flow path (fp32 scalar).

    ``batch``: ``{latents [B, T, C], cond, clip_feat, sync_feat}`` on the model's device.
    The noise x0 [B, T, C] and sigma [B] are drawn from ``generator`` (x0 first), unless
    given as ``noise`` and ``sigma`` (the tests pass the JAX package's draws: ``jax.random``
    bits cannot be reproduced)."""
    x1 = batch["latents"].float()
    if noise is None:
        noise = torch.randn(x1.shape, generator=generator, device=x1.device)
    if sigma is None:
        sigma = torch.rand((x1.shape[0],), generator=generator, device=x1.device)
    x0, sigma = noise.to(x1.device, torch.float32), sigma.to(x1.device, torch.float32)
    x_sigma = (1.0 - sigma)[:, None, None] * x1 + sigma[:, None, None] * x0
    target_v = x0 - x1
    t = sigma * num_train_timesteps
    pred_v = model(x_sigma.to(compute_dtype), t, batch["cond"].to(compute_dtype),
                   batch["clip_feat"].to(compute_dtype), batch["sync_feat"].to(compute_dtype),
                   attn_impl="xla", remat=True, lora=lora, lora_scale=lora_scale).float()
    return (pred_v - target_v).square().mean()


@contextlib.contextmanager
def step_context():
    """Where a step's forward and backward run: TF32 off (``true_fp32``) and cuDNN's
    deterministic algorithms (their flags restored after)."""
    cudnn = torch.backends.cudnn
    with true_fp32(), cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                                  allow_tf32=cudnn.allow_tf32):
        yield


def value_and_grad(loss_fn: Callable[[], torch.Tensor], leaves: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
    """``loss_fn()`` and its gradients with respect to ``leaves`` (which require them), both
    computed in ``step_context``; a leaf the loss does not reach gets None."""
    names = list(leaves)
    with step_context():
        loss = loss_fn()
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(model: MMDiT, optimizer: Optional[Adam] = None,
                    compute_dtype=torch.bfloat16):
    """(init_state, train_step) for full training of ``model``'s parameters.

    ``init_state(model) -> TrainState``; ``train_step(state, batch, generator=None, *,
    noise=None, sigma=None) -> (state, loss)`` updates the parameters and moments in place.
    The optimizer defaults to ``adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.01)``."""
    if optimizer is None:
        optimizer = adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.01)

    def init_state(m: MMDiT) -> TrainState:
        params = dict(m.named_parameters())
        return TrainState(params, optimizer.init(params), 0)

    def train_step(state: TrainState, batch: Batch, generator=None, *, noise=None,
                   sigma=None) -> Tuple[TrainState, torch.Tensor]:
        params = state.params
        for p in params.values():
            p.requires_grad_(True)
        try:
            loss, grads = value_and_grad(
                lambda: flow_match_loss(model, batch, generator, compute_dtype, noise=noise,
                                        sigma=sigma), params)
        finally:
            for p in params.values():
                p.requires_grad_(False)
        opt_state = optimizer.update_(params, grads, state.opt_state)
        return TrainState(params, opt_state, state.step + 1), loss

    return init_state, train_step


def make_lora_train_step(model: MMDiT, lora_scale: float = 1.0,
                         optimizer: Optional[Adam] = None, compute_dtype=torch.bfloat16):
    """(init_state, train_step) for LoRA fine-tuning over ``model``, the frozen base.

    ``init_state(lora) -> LoraTrainState`` (``lora``: ``models/lora.py::init_lora``'s
    factors, copied); ``train_step(state, batch, generator=None, *,
    noise=None, sigma=None) -> (state, loss)`` updates the factors and moments in place. The
    per-block ``w + scale * a @ b`` is formed inside each checkpointed block
    (``models/lora.py::block_lora``), so memory adds one block's effective weights. The
    optimizer defaults to ``adam(1e-4, b1=0.9, b2=0.95)``: decaying the factors of a delta
    would pull the adapter toward the base, a prior, not a default."""
    if optimizer is None:
        optimizer = adam(1e-4, b1=0.9, b2=0.95)

    def init_state(lora: Dict[str, torch.Tensor]) -> LoraTrainState:
        lora = {k: v.detach().clone().requires_grad_(True) for k, v in lora.items()}
        return LoraTrainState(lora, optimizer.init(lora), 0)

    def train_step(state: LoraTrainState, batch: Batch, generator=None, *, noise=None,
                   sigma=None) -> Tuple[LoraTrainState, torch.Tensor]:
        loss, grads = value_and_grad(
            lambda: flow_match_loss(model, batch, generator, compute_dtype, lora=state.lora,
                                    lora_scale=lora_scale, noise=noise, sigma=sigma),
            state.lora)
        opt_state = optimizer.update_(state.lora, grads, state.opt_state)
        return LoraTrainState(state.lora, opt_state, state.step + 1), loss

    return init_state, train_step
