"""Discrete flow-matching ODE solvers (``foley_tpu/sampling/flow_match.py`` counterpart).

Behavioural contract = the reference ``FlowMatchDiscreteScheduler``:
- sigmas: ``linspace(1, 0, steps+1)``; optional SD3 shift ``s*t / (1+(s-1)t)`` or the flux
  token-count shift; timesteps fed to the model are ``sigmas[:-1] * 1000``;
- all step math in fp32;
- solvers euler / heun-2 / midpoint-2 / kutta-4. The multi-stage solvers are stateful
  across ``step()`` calls: each call consumes one model evaluation and only the last inner
  stage advances the sigma index, so heun-2/kutta-4 cover 1/2 / 1/4 of the schedule in a
  fixed step budget, exactly as the reference does.

The JAX package carries a fixed-shape state through ``lax.scan``; here the state is a plain
Python object that ``solver_step`` updates in place. Stage and step index are Python ints,
so no step waits on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

SUPPORTED_SOLVERS = ("euler", "heun-2", "midpoint-2", "kutta-4")

def get_sigmas(num_steps: int, shift: float = 1.0, reverse: bool = True,
               use_flux_shift: bool = False, flux_base_shift: float = 0.5,
               flux_max_shift: float = 1.15, n_tokens: Optional[int] = None,
               device=None) -> torch.Tensor:
    """[num_steps+1] fp32 sigma schedule."""
    sigmas = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)
    if use_flux_shift:
        if n_tokens is None:
            raise ValueError("n_tokens is required for the flux shift")
        m = (flux_max_shift - flux_base_shift) / (4096 - 256)
        b = flux_base_shift - m * 256
        mu = m * n_tokens + b
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    elif shift != 1.0:
        sigmas = (shift * sigmas) / (1.0 + (shift - 1.0) * sigmas)
    if not reverse:
        sigmas = 1.0 - sigmas
    return sigmas


def get_timesteps(sigmas: torch.Tensor, num_train_timesteps: int = 1000) -> torch.Tensor:
    """Model-facing timesteps: sigmas[:-1] * 1000."""
    return (sigmas[:-1] * num_train_timesteps).float()


@dataclasses.dataclass
class SolverState:
    """``stage``: inner-stage counter in [0, stages); ``step_index``: completed sigma
    intervals; ``d1/d2/d3``: stored derivatives; ``saved_sample``: the sample at the
    interval start; ``dt``: the full interval width saved at stage 0 (fp32 0-d tensor)."""

    stage: int = 0
    step_index: int = 0
    d1: Optional[torch.Tensor] = None
    d2: Optional[torch.Tensor] = None
    d3: Optional[torch.Tensor] = None
    saved_sample: Optional[torch.Tensor] = None
    dt: Optional[torch.Tensor] = None


def solver_init(solver: str) -> SolverState:
    if solver not in SUPPORTED_SOLVERS:
        raise ValueError(f"Solver {solver!r} not supported; supported: {SUPPORTED_SOLVERS}")
    return SolverState()


def solver_step(solver: str, state: SolverState, model_output: torch.Tensor,
                sample: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """One scheduler ``step()``: consumes one model evaluation, returns the next sample and
    advances ``state`` in place. fp32 math; ``sigmas`` is the full [steps+1] schedule."""
    sample = sample.float()
    v = model_output.float()
    sigma = sigmas[state.step_index]
    interval = sigmas[state.step_index + 1] - sigma  # negative for the reverse schedule

    if solver == "euler":
        state.step_index += 1
        return sample + v * interval

    if solver in ("heun-2", "midpoint-2"):
        if state.stage == 0:
            dt = interval if solver == "heun-2" else interval / 2
            state.stage, state.d1, state.saved_sample, state.dt = 1, v, sample, interval
            return sample + v * dt
        derivative = 0.5 * (state.d1 + v) if solver == "heun-2" else v
        prev = state.saved_sample + derivative * state.dt
        _finish_interval(state)
        return prev

    if solver == "kutta-4":
        if state.stage == 0:
            state.stage, state.d1, state.saved_sample, state.dt = 1, v, sample, interval
            return sample + v * (interval / 2)
        if state.stage == 1:
            state.stage, state.d2 = 2, v
            return sample + v * (state.dt / 2)
        if state.stage == 2:
            state.stage, state.d3 = 3, v
            return sample + v * state.dt
        derivative = (state.d1 + 2 * state.d2 + 2 * state.d3 + v) / 6.0
        prev = state.saved_sample + derivative * state.dt
        _finish_interval(state)
        return prev

    raise ValueError(f"Solver {solver!r} not supported; supported: {SUPPORTED_SOLVERS}")


def _finish_interval(state: SolverState) -> None:
    state.stage = 0
    state.step_index += 1
    state.d1 = state.d2 = state.d3 = state.saved_sample = state.dt = None


#: Nominal position (fraction of the current sigma interval) of the sample returned by a
#: solver_step that left the state at inner stage ``s``; stage 0 means an interval boundary
#: was just completed. heun-2's predictor lands at the interval end, midpoint-2's at the
#: midpoint; kutta-4 uses the classical RK4 stage positions.
_STAGE_FRACS = {
    "euler": (0.0,),
    "heun-2": (0.0, 1.0),
    "midpoint-2": (0.0, 0.5),
    "kutta-4": (0.0, 0.5, 0.5, 1.0),
}


def interpolant_sigma(solver: str, state: SolverState, sigmas: torch.Tensor) -> torch.Tensor:
    """Effective sigma of the sample a ``solver_step`` just returned, given the post-step
    state: the sigma at which to clamp a known prefix's interpolant (fp32 0-d tensor)."""
    sig0 = sigmas[state.step_index]
    if solver == "euler":
        return sig0
    # the fractions are exact in fp32, so a Python scalar keeps the JAX fp32 arithmetic
    return sig0 + _STAGE_FRACS[solver][state.stage] * (sigmas[state.step_index + 1] - sig0)
