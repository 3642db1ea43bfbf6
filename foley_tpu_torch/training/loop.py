"""Training loops with ``.safetensors`` checkpoints and exact resume, and the train -> deploy
handoff (``foley_tpu/training/loop.py`` counterpart).

- Per-step randomness: step ``s`` of a run with ``seed`` draws its noise and sigma from a
  fresh ``torch.Generator`` on the model's device (``step_generator``), the counterpart of
  ``jax.random.fold_in(PRNGKey(seed), s)``: its seed is splitmix64's finalizer of ``(seed
  mod 2**32) * 2**32 + (s mod 2**32)``, a bijection on 64 bits, so the seed's low 32 bits
  (all a CPU generator's Mersenne twister reads) as well as all 64 (a CUDA generator's)
  differ from one (seed, step) to the next. A step's draws depend on (seed, step) alone, so
  a resumed run draws what an uninterrupted one would. (A CUDA generator draws other numbers
  than a CPU one for the same seed.)
- Checkpoints: ``<ckpt_dir>/step_XXXXXXXX/state.safetensors`` (``io/convert.py``'s writer)
  holding the parameters (``params.<name>``) or the adapter's factors (``lora.<name>``),
  both Adam moments (``mu.<name>``, ``nu.<name>``), the step and the optimizer's count;
  the file is written beside and then renamed into place. A LoRA checkpoint leaves out the
  frozen base: resume passes the same base. Restoring copies every tensor into the state in
  place, so a run interrupted at step k and resumed continues bit for bit as the
  uninterrupted run (given the same data stream from step k).
- ``export_lora``: the adapter directory ``models/lora.py::save_lora`` writes, which the
  loaders merge at load (``lora_path``, ``--lora``).
- ``export_for_inference``: the bare parameters as ``mmdit.safetensors`` in the port's names
  (no optimizer state, no step) plus ``latent_stats.npz`` when the model was trained on
  standardized latents; ``HunyuanModelLoader.load_model`` loads the directory
  (``load_export``) and re-attaches the stats, so the CLI and the server serve the model.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from foley_tpu_torch.io.convert import load_safetensors, save_safetensors
from foley_tpu_torch.models.mmdit import MMDiT
from foley_tpu_torch.training.optim import AdamState
from foley_tpu_torch.training.train import (
    LoraTrainState,
    TrainState,
    make_lora_train_step,
    make_train_step,
)

logger = logging.getLogger("foley_tpu_torch")

STATE_FILE = "state.safetensors"
EXPORT_FILE = "mmdit.safetensors"
LATENT_STATS_FILE = "latent_stats.npz"

State = Union[TrainState, LoraTrainState]

_M64 = (1 << 64) - 1


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of a run seeded ``seed`` (module docstring)."""
    x = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return torch.Generator(device=device).manual_seed(x ^ (x >> 31))


def _trained(state: State) -> Tuple[str, Dict[str, torch.Tensor]]:
    return ("lora", state.lora) if isinstance(state, LoraTrainState) else ("params",
                                                                          state.params)


def _to_tensors(state: State) -> Dict[str, torch.Tensor]:
    kind, leaves = _trained(state)
    out = {f"{kind}.{k}": v.detach() for k, v in leaves.items()}
    out.update({f"mu.{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.opt_state.nu.items()})
    out["step"] = torch.tensor(state.step, dtype=torch.int64)
    out["count"] = torch.tensor(state.opt_state.count, dtype=torch.int64)
    return out


def save_checkpoint(ckpt_dir: str, state: State) -> str:
    """Write ``state`` under ``ckpt_dir/step_XXXXXXXX``; returns that directory."""
    path = os.path.join(ckpt_dir, f"step_{int(state.step):08d}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    save_safetensors(tmp, _to_tensors(state))
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the highest step under ``ckpt_dir`` (None without one)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and os.path.exists(os.path.join(ckpt_dir, d, STATE_FILE)))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


@torch.no_grad()
def restore_checkpoint(path: str, template: State) -> State:
    """Copy the checkpoint at ``path`` into ``template``'s tensors (the same names, shapes
    and dtypes, or it raises); returns the state at the checkpoint's step."""
    saved = load_safetensors(os.path.join(path, STATE_FILE))
    targets = _to_tensors(template)
    if set(saved) != set(targets):
        raise ValueError(f"{path}: the checkpoint's tensors differ from the state's: missing "
                         f"{sorted(set(targets) - set(saved))[:5]}, unexpected "
                         f"{sorted(set(saved) - set(targets))[:5]}")
    kind, leaves = _trained(template)
    for name, t in saved.items():
        dst = targets[name]
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"{path}: {name} is {t.dtype} {tuple(t.shape)}, the state's "
                             f"{dst.dtype} {tuple(dst.shape)}")
        if name.partition(".")[0] in (kind, "mu", "nu"):
            dst.copy_(t)
    opt_state = AdamState(template.opt_state.mu, template.opt_state.nu, int(saved["count"]))
    return template._replace(opt_state=opt_state, step=int(saved["step"]))


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _run(state: State, train_step, data_iter, device, num_steps: int, ckpt_dir, ckpt_every,
         log_every, seed, metrics_fn, what: str) -> State:
    for step in range(state.step, num_steps):
        batch = _to_device(next(data_iter), device)
        state, loss = train_step(state, batch, step_generator(seed, step, device))
        if log_every and (step + 1) % log_every == 0:
            loss_v = float(loss)
            logger.info(f"{what}step {step + 1}/{num_steps}: loss {loss_v:.5f}")
            if metrics_fn:
                metrics_fn(step + 1, loss_v)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, state)
    return state


def _resume(state: State, ckpt_dir: Optional[str], resume: bool, what: str) -> State:
    latest = latest_checkpoint(ckpt_dir) if resume and ckpt_dir else None
    if latest:
        state = restore_checkpoint(latest, state)
        logger.info(f"resumed {what}from {latest} at step {state.step}")
    return state


def train(model: MMDiT, data_iter: Iterator[Dict], num_steps: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 1000, log_every: int = 100,
          seed: int = 0, compute_dtype=torch.float32, resume: bool = True, optimizer=None,
          metrics_fn: Optional[Callable[[int, float], None]] = None) -> TrainState:
    """Full flow-matching training of ``model``'s parameters, in place, to ``num_steps``.

    ``data_iter`` yields ``{latents, cond, clip_feat, sync_feat}`` batches (numpy arrays or
    tensors; moved to the model's device). With ``ckpt_dir`` the state is saved every
    ``ckpt_every`` steps and at the end, and ``resume`` continues from its latest
    checkpoint."""
    init_state, train_step = make_train_step(model, optimizer, compute_dtype)
    state = _resume(init_state(model), ckpt_dir, resume, "")
    return _run(state, train_step, data_iter, model.device, num_steps, ckpt_dir, ckpt_every,
                log_every, seed, metrics_fn, "")


def train_lora(model: MMDiT, lora_init: Dict[str, torch.Tensor], data_iter: Iterator[Dict],
               num_steps: int, lora_scale: float = 1.0, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 1000, log_every: int = 100, seed: int = 0,
               compute_dtype=torch.float32, resume: bool = True, optimizer=None,
               metrics_fn: Optional[Callable[[int, float], None]] = None) -> LoraTrainState:
    """LoRA fine-tuning over the frozen ``model`` from ``lora_init`` (copied), with
    :func:`train`'s contract; a checkpoint holds the factors, their moments and the step."""
    init_state, train_step = make_lora_train_step(model, lora_scale, optimizer, compute_dtype)
    state = _resume(init_state(lora_init), ckpt_dir, resume, "LoRA ")
    return _run(state, train_step, data_iter, model.device, num_steps, ckpt_dir, ckpt_every,
                log_every, seed, metrics_fn, "lora ")


def export_lora(state: LoraTrainState, path: str, rank: int, scale: float = 1.0) -> str:
    """Save the trained adapter alone (``models/lora.py::save_lora``): the shareable artifact
    the loaders merge over a compatible base at load."""
    from foley_tpu_torch.models.lora import save_lora

    save_lora(path, {k: v.detach() for k, v in state.lora.items()}, rank=rank, scale=scale)
    logger.info(f"exported LoRA adapter (step {state.step}) to {path}")
    return path


def export_for_inference(state: TrainState, path: str, latent_stats=None) -> str:
    """Save only the trained parameters, in the directory layout ``HunyuanModelLoader``
    loads: ``mmdit.safetensors`` in the port's names, plus ``latent_stats.npz`` with
    ``latent_stats=(mean[C], std[C])``, which MUST be passed when the model was trained on
    standardized latents (``data.py::latent_stats_from_shards``): the loader re-attaches it
    and the sampler un-standardizes before the DAC decode. Omit it for fine-tunes in the raw
    DAC latent space."""
    os.makedirs(path, exist_ok=True)
    save_safetensors(os.path.join(path, EXPORT_FILE),
                     {k: v.detach() for k, v in state.params.items()})
    if latent_stats is not None:
        mean, std = (np.asarray(torch.as_tensor(s).cpu(), np.float32) for s in latent_stats)
        np.savez(os.path.join(path, LATENT_STATS_FILE), mean=mean, std=std)
    logger.info(f"exported inference params (step {state.step}) to {path}"
                + (" with latent stats" if latent_stats is not None else ""))
    return path


def is_export(path: str) -> bool:
    """Whether ``path`` is a directory ``export_for_inference`` wrote."""
    return os.path.isfile(os.path.join(path, EXPORT_FILE))


def load_export(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[Tuple[np.ndarray,
                                                                             np.ndarray]]]:
    """An ``export_for_inference`` directory -> (the state dict, CPU tensors in the port's
    names; ``(mean, std)`` fp32 arrays, or None without ``latent_stats.npz``)."""
    state = load_safetensors(os.path.join(path, EXPORT_FILE))
    stats_file = os.path.join(path, LATENT_STATS_FILE)
    stats = None
    if os.path.exists(stats_file):
        with np.load(stats_file) as z:
            stats = (z["mean"], z["std"])
    return state, stats
