"""Denoiser training over a ("data", "model") mesh (``foley_tpu/training/train.py``'s steps
under ``jax.jit`` on a mesh, ``tests/test_parallel.py``'s sharded train steps, and
``foley_tpu/training/data.py::PrefetchLoader(sharding=NamedSharding(mesh, P("data")))``).

The JAX package trains over its mesh with no code of its own: the parameters are placed by
``shard_params``, the batch by a ``NamedSharding`` on ``data``, and XLA partitions the jitted
step. Here each rank runs the one-card pieces unchanged on its own slices and rows
(``training/train.py::flow_match_loss`` with ``noise=`` / ``sigma=``, ``value_and_grad``,
``step_context``; ``training/optim.py``'s ``update_``; ``training/loop.py``'s generators,
checkpoint layout and exports), and the mesh adds:

- the placed denoiser (``parallel/sharding.py::shard_params``), whose collectives autograd
  differentiates (``parallel/mesh.py``), and a replicated LoRA adapter sliced as its layers
  (``sharding.lora_slices``);
- the draws: every rank draws the *global* batch's noise, then its sigma, from the step's
  generator in ``flow_match_loss``'s order, and keeps its own rows, so a mesh step draws
  what one card draws for the global batch (a caller's ``noise`` / ``sigma`` are the global
  batch's too);
- the loss: the mean over ``data`` of the ranks' means (the batch splits evenly on ``data``,
  or ``RankMesh.data_rows`` raises);
- the gradients (``reduce_gradients``), in a few flat buckets of one dtype and one
  reduction each (``BUCKET_BYTES``), in the gradients' own dtype:

  - a leaf sharded on ``model``: averaged over ``data``;
  - a replicated leaf that acts on a rank's own heads (``sharding.RANK_LOCAL``: the qk-norm
    weights) or a LoRA factor of a sharded layer: summed over ``model`` (each rank holds
    its heads' share) and averaged over ``data``, in one all-reduce over every rank;
  - any other replicated leaf: each rank computes its whole gradient, so it is not summed
    over ``model`` (that would count it ``model`` times) but averaged over every rank. The
    ranks of a ``model`` row hold the same gradient, so the average over ``data`` is
    unchanged, and every rank holds the same bits of it, so each replicated leaf stays
    bit-identical across the ranks through the optimizer's update (a backward with atomic
    sums may differ in the last bit from rank to rank);

  a reduction over one rank is skipped;
- checkpoints in the one-card layout (``training/loop.py``): each sharded leaf and its two
  moments gathered over ``model``, leaf by leaf, to rank 0's host, which writes the file
  (beside the target, then renamed into place) while every rank waits; orbax saves the JAX
  package's global arrays the same way. ``loop.restore_checkpoint`` on one card reads a
  mesh checkpoint, and ``restore_checkpoint_sharded`` slices a one-card checkpoint for a
  rank (``sharding.shard_state_dict``);
- the exports: the whole model gathered, or the replicated adapter, written by rank 0 in the
  layout ``HunyuanModelLoader`` loads on one card.

Every rank calls every function here in the same order: each may issue collectives.
``data_rows`` hands a rank its rows of each global batch, for the unchanged
``training/data.py::PrefetchLoader(device=mesh.device)``; every rank reads the same global
stream, so a resumed run skips the batches a one-card run skips.

Refusals, each at one entry (``make_sharded_*_train_step`` places the model): a denoiser
with blocks swapped to the host and integer weight storage at ``model > 1``
(``shard_params``); a LoRA base in integer storage (``models/lora.py::block_lora``, as the
JAX merge refuses it).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch

from foley_tpu_torch.io.convert import load_safetensors
from foley_tpu_torch.models.mmdit import MMDiT
from foley_tpu_torch.parallel.mesh import ALL_AXES, DATA_AXIS, MODEL_AXIS, RankMesh
from foley_tpu_torch.parallel.sharding import (
    RANK_LOCAL,
    REPLICATED,
    Spec,
    lora_placement,
    lora_slices,
    partition_spec_for,
    shard_params,
    shard_state_dict,
)
from foley_tpu_torch.training import loop
from foley_tpu_torch.training.optim import Adam, AdamState, adam, adamw
from foley_tpu_torch.training.train import (
    Batch,
    LoraTrainState,
    TrainState,
    flow_match_loss,
    value_and_grad,
)

logger = logging.getLogger("foley_tpu_torch")

#: The largest flat bucket of gradients one all-reduce sums: a full XXL step has 1,087
#: leaves, and a collective over gloo costs milliseconds of its own.
BUCKET_BYTES = 256 << 20

State = loop.State
#: A leaf's reduction: the axis its gradient is summed over and the divisor after the sum.
Reduction = Tuple[str, int]


# ---------------------------------------------------------------------------------
# Rows, draws and gradients
# ---------------------------------------------------------------------------------

def data_rows(batches: Iterable[Dict], mesh: RankMesh) -> Iterator[Dict]:
    """This rank's rows of each global batch (numpy arrays or tensors, sliced on their
    first axis); a batch that ``data`` does not divide raises."""
    for batch in batches:
        rows = {len(v) for v in batch.values()}
        if len(rows) != 1:
            raise ValueError(f"a batch's arrays have different row counts: {sorted(rows)}")
        lo, hi = mesh.data_rows(rows.pop())
        yield {k: v[lo:hi] for k, v in batch.items()}


def rank_draws(batch: Batch, mesh: RankMesh, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               sigma: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows of the global batch's noise and sigma: drawn from ``generator``
    (noise first, as ``flow_match_loss`` draws them for the global batch) unless given, in
    which case they are the global batch's."""
    x1 = batch["latents"]
    total = x1.shape[0] * mesh.data
    shape = (total,) + tuple(x1.shape[1:])
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=x1.device)
    if sigma is None:
        sigma = torch.rand((total,), generator=generator, device=x1.device)
    if tuple(noise.shape) != shape or tuple(sigma.shape) != (total,):
        raise ValueError(f"noise {tuple(noise.shape)} and sigma {tuple(sigma.shape)} are not "
                         f"the global batch's {shape} over data={mesh.data}")
    lo, hi = mesh.data_rows(total)
    return noise[lo:hi], sigma[lo:hi]


def param_reduction(name: str, leaf: torch.Tensor, mesh: RankMesh) -> Reduction:
    """How the gradient of the placed denoiser's parameter ``name`` is reduced (module
    docstring)."""
    if mesh.model > 1 and partition_spec_for(name, leaf).axis is not None:
        return DATA_AXIS, mesh.data
    if mesh.model > 1 and re.search(RANK_LOCAL, name):
        return ALL_AXES, mesh.data
    return ALL_AXES, mesh.world


def lora_reduction(name: str, mesh: RankMesh) -> Reduction:
    """How the gradient of the adapter factor ``name`` is reduced: summed over ``model``
    where its layer is sharded (``sharding.lora_slices``), averaged over the rest."""
    if mesh.model > 1 and lora_placement(name)[0] != "replicate":
        return ALL_AXES, mesh.data
    return ALL_AXES, mesh.world


def reduce_gradients(grads: Dict[str, Optional[torch.Tensor]], plan: Dict[str, Reduction],
                     mesh: RankMesh, bucket_bytes: int = BUCKET_BYTES
                     ) -> Dict[str, Optional[torch.Tensor]]:
    """``grads`` reduced over the mesh by ``plan``, in place, bucket by bucket (leaves of one
    reduction and one dtype flattened into one all-reduce, op ``all_reduce_grads``); a leaf
    the loss does not reach stays None (on every rank alike)."""
    groups: Dict[tuple, list] = {}
    for name, g in grads.items():
        axis, div = plan[name]
        if g is not None and mesh.size(axis) > 1:
            groups.setdefault((axis, div, g.dtype), []).append(name)
    out = dict(grads)
    for (axis, div, _), names in groups.items():
        bucket, size = [], 0
        for i, name in enumerate(names):
            g = out[name] = out[name].contiguous()
            bucket.append(name)
            size += g.numel() * g.element_size()
            if size < bucket_bytes and i + 1 < len(names):
                continue
            flat = torch.cat([out[n].reshape(-1) for n in bucket])
            mesh.all_reduce(flat, axis, op="all_reduce_grads")
            if div != 1:
                flat.div_(div)
            offset = 0
            for n in bucket:
                k = out[n].numel()
                out[n].copy_(flat[offset:offset + k].view_as(out[n]))
                offset += k
            bucket, size = [], 0
    return out


def sharded_value_and_grad(model: MMDiT, mesh: RankMesh, batch: Batch,
                           leaves: Dict[str, torch.Tensor], plan: Dict[str, Reduction],
                           generator: Optional[torch.Generator] = None, *,
                           noise: Optional[torch.Tensor] = None,
                           sigma: Optional[torch.Tensor] = None,
                           lora: Optional[Dict[str, torch.Tensor]] = None,
                           lora_scale: float = 1.0, compute_dtype=torch.bfloat16
                           ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
    """The global batch's loss and the gradients of ``leaves`` (which require them), reduced
    by ``plan``: ``training/train.py::value_and_grad`` of ``flow_match_loss`` on this rank's
    rows (``batch``) and draws, the adapter ``lora`` sliced for the rank inside the loss.
    The collectives the backward issues are counted under ``"backward."``."""
    noise, sigma = rank_draws(batch, mesh, generator, noise, sigma)

    def backward_started(grad):
        mesh.phase = "backward"

    def loss_fn():
        adapter = None if lora is None else lora_slices(lora, model, mesh)
        loss = flow_match_loss(model, batch, None, compute_dtype, lora=adapter,
                               lora_scale=lora_scale, noise=noise, sigma=sigma)
        loss.register_hook(backward_started)
        return loss

    try:
        loss, grads = value_and_grad(loss_fn, leaves)
    finally:
        mesh.phase = "forward"
    grads = reduce_gradients(grads, plan, mesh)
    if mesh.data > 1:
        loss = mesh.all_reduce(loss.clone(), DATA_AXIS, op="all_reduce_loss") / mesh.data
    return loss, grads


# ---------------------------------------------------------------------------------
# The train steps
# ---------------------------------------------------------------------------------

def make_sharded_train_step(model: MMDiT, mesh: RankMesh, optimizer: Optional[Adam] = None,
                            compute_dtype=torch.bfloat16):
    """(init_state, train_step) for full training of ``model`` on ``mesh``'s rank:
    ``training/train.py::make_train_step``'s contract (the same default optimizer), the
    model placed here in place (``shard_params``; a placed model stays as it is). The state
    holds the rank's slices; ``train_step(state, batch, generator=None, *, noise=None,
    sigma=None)`` takes this rank's rows of the global batch (``data_rows``) and returns the
    global loss."""
    shard_params(model, mesh)
    if optimizer is None:
        optimizer = adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.01)
    plan = {n: param_reduction(n, p, mesh) for n, p in model.named_parameters()}

    def init_state(m: MMDiT) -> TrainState:
        params = dict(m.named_parameters())
        return TrainState(params, optimizer.init(params), 0)

    def train_step(state: TrainState, batch: Batch, generator=None, *, noise=None,
                   sigma=None) -> Tuple[TrainState, torch.Tensor]:
        params = state.params
        for p in params.values():
            p.requires_grad_(True)
        try:
            loss, grads = sharded_value_and_grad(model, mesh, batch, params, plan, generator,
                                                 noise=noise, sigma=sigma,
                                                 compute_dtype=compute_dtype)
        finally:
            for p in params.values():
                p.requires_grad_(False)
        opt_state = optimizer.update_(params, grads, state.opt_state)
        return TrainState(params, opt_state, state.step + 1), loss

    return init_state, train_step


def make_sharded_lora_train_step(model: MMDiT, mesh: RankMesh, lora_scale: float = 1.0,
                                 optimizer: Optional[Adam] = None,
                                 compute_dtype=torch.bfloat16):
    """(init_state, train_step) for LoRA fine-tuning over the frozen ``model`` on ``mesh``'s
    rank: ``make_lora_train_step``'s contract (the same default optimizer), the model placed
    here. ``init_state(lora)`` takes an adapter drawn for the whole model (``init_lora``
    before ``shard_params``) and keeps it whole and replicated; each step slices it for the
    rank inside the loss."""
    shard_params(model, mesh)
    if optimizer is None:
        optimizer = adam(1e-4, b1=0.9, b2=0.95)

    def init_state(lora: Dict[str, torch.Tensor]) -> LoraTrainState:
        lora = {k: v.detach().clone().requires_grad_(True) for k, v in lora.items()}
        lora_slices(lora, model, mesh)  # an adapter of the placed model's shapes raises here
        return LoraTrainState(lora, optimizer.init(lora), 0)

    def train_step(state: LoraTrainState, batch: Batch, generator=None, *, noise=None,
                   sigma=None) -> Tuple[LoraTrainState, torch.Tensor]:
        plan = {n: lora_reduction(n, mesh) for n in state.lora}
        loss, grads = sharded_value_and_grad(model, mesh, batch, state.lora, plan, generator,
                                             noise=noise, sigma=sigma, lora=state.lora,
                                             lora_scale=lora_scale,
                                             compute_dtype=compute_dtype)
        opt_state = optimizer.update_(state.lora, grads, state.opt_state)
        return LoraTrainState(state.lora, opt_state, state.step + 1), loss

    return init_state, train_step


# ---------------------------------------------------------------------------------
# Whole leaves, checkpoints and exports
# ---------------------------------------------------------------------------------

def gather_leaf(t: torch.Tensor, spec: Spec, mesh: RankMesh) -> torch.Tensor:
    """The whole of a leaf placed by ``spec`` (every rank joins; a replicated leaf is its
    own)."""
    if mesh.model == 1 or spec.axis is None:
        return t.detach()
    whole = mesh.gather_parts(t.detach().movedim(spec.axis, -1), MODEL_AXIS, spec.parts)
    return whole.movedim(-1, spec.axis).contiguous()


def gather_leaves(tensors: Dict[str, torch.Tensor], mesh: RankMesh, lora: bool = False
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """The whole of every leaf of the placed denoiser (``lora``: of an adapter, replicated),
    gathered leaf by leaf (every rank joins): rank 0's copy on its host; None on the other
    ranks."""
    out = {}
    for name, t in tensors.items():
        whole = gather_leaf(t, REPLICATED if lora else partition_spec_for(name, t), mesh)
        if mesh.rank == 0:
            out[name] = whole.to("cpu", copy=True)
    return out if mesh.rank == 0 else None


def whole_state(state: State, mesh: RankMesh) -> Optional[State]:
    """``state`` in the one-card layout, on rank 0's host (None on the other ranks)."""
    kind, leaves = loop._trained(state)
    lora = kind == "lora"
    parts = [gather_leaves(d, mesh, lora) for d in (leaves, state.opt_state.mu,
                                                     state.opt_state.nu)]
    if mesh.rank != 0:
        return None
    whole, mu, nu = parts
    return state._replace(**{kind: whole},
                          opt_state=AdamState(mu, nu, state.opt_state.count))


def save_checkpoint_sharded(ckpt_dir: str, state: State, mesh: RankMesh) -> str:
    """``training/loop.py::save_checkpoint`` of the whole state, written by rank 0 once every
    sharded leaf has been gathered; every rank returns once the file is in place."""
    whole = whole_state(state, mesh)
    path = os.path.join(ckpt_dir, f"step_{int(state.step):08d}")
    if mesh.rank == 0:
        loop.save_checkpoint(ckpt_dir, whole)
    mesh.barrier()
    return path


@torch.no_grad()
def restore_checkpoint_sharded(path: str, template: State, mesh: RankMesh) -> State:
    """A checkpoint in the one-card layout (written on one card or on any mesh) copied into
    this rank's ``template`` (its slices of the same names, dtypes and shapes, or it raises);
    returns the state at the checkpoint's step."""
    saved = load_safetensors(os.path.join(path, loop.STATE_FILE))
    kind, _ = loop._trained(template)
    if kind == "params":
        for prefix in ("params", "mu", "nu"):
            sliced = shard_state_dict({k.partition(".")[2]: v for k, v in saved.items()
                                       if k.partition(".")[0] == prefix}, mesh)
            saved.update({f"{prefix}.{k}": v for k, v in sliced.items()})
    targets = loop._to_tensors(template)
    if set(saved) != set(targets):
        raise ValueError(f"{path}: the checkpoint's tensors differ from the state's: missing "
                         f"{sorted(set(targets) - set(saved))[:5]}, unexpected "
                         f"{sorted(set(saved) - set(targets))[:5]}")
    for name, t in saved.items():
        dst = targets[name]
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"{path}: {name} is {t.dtype} {tuple(t.shape)}, this rank's "
                             f"{dst.dtype} {tuple(dst.shape)}")
        if name.partition(".")[0] in (kind, "mu", "nu"):
            dst.copy_(t)
    opt_state = AdamState(template.opt_state.mu, template.opt_state.nu, int(saved["count"]))
    return template._replace(opt_state=opt_state, step=int(saved["step"]))


def export_for_inference_sharded(state: TrainState, path: str, mesh: RankMesh,
                                 latent_stats=None) -> str:
    """``training/loop.py::export_for_inference`` of the whole model (gathered), written by
    rank 0; every rank returns once it is written."""
    params = gather_leaves(state.params, mesh)
    if mesh.rank == 0:
        loop.export_for_inference(state._replace(params=params), path, latent_stats)
    mesh.barrier()
    return path


def export_lora_sharded(state: LoraTrainState, path: str, mesh: RankMesh, rank: int,
                        scale: float = 1.0) -> str:
    """``training/loop.py::export_lora`` of the replicated adapter, written by rank 0; every
    rank returns once it is written."""
    if mesh.rank == 0:
        loop.export_lora(state, path, rank, scale)
    mesh.barrier()
    return path


# ---------------------------------------------------------------------------------
# The loops
# ---------------------------------------------------------------------------------

def _run(state: State, train_step, data_iter, mesh: RankMesh, num_steps: int, ckpt_dir,
         ckpt_every, log_every, seed, metrics_fn, what: str) -> State:
    for step in range(state.step, num_steps):
        batch = loop._to_device(next(data_iter), mesh.device)
        state, loss = train_step(state, batch, loop.step_generator(seed, step, mesh.device))
        if log_every and (step + 1) % log_every == 0:
            loss_v = float(loss)
            if mesh.rank == 0:
                logger.info(f"{what}step {step + 1}/{num_steps}: loss {loss_v:.5f}")
            if metrics_fn:
                metrics_fn(step + 1, loss_v)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            save_checkpoint_sharded(ckpt_dir, state, mesh)
    if ckpt_dir:
        save_checkpoint_sharded(ckpt_dir, state, mesh)
    return state


def _resume(state: State, mesh: RankMesh, ckpt_dir: Optional[str], resume: bool,
            what: str) -> State:
    latest = loop.latest_checkpoint(ckpt_dir) if resume and ckpt_dir else None
    if latest:
        state = restore_checkpoint_sharded(latest, state, mesh)
        if mesh.rank == 0:
            logger.info(f"resumed {what}from {latest} at step {state.step} on the "
                        f"{mesh.data}x{mesh.model} mesh")
    return state


def train_sharded(model: MMDiT, mesh: RankMesh, data_iter: Iterator[Dict], num_steps: int,
                  ckpt_dir: Optional[str] = None, ckpt_every: int = 1000,
                  log_every: int = 100, seed: int = 0, compute_dtype=torch.float32,
                  resume: bool = True, optimizer=None,
                  metrics_fn: Optional[Callable[[int, float], None]] = None) -> TrainState:
    """``training/loop.py::train`` on ``mesh``'s rank (every rank calls it): ``model`` (whole
    or placed) is placed and trained in place; ``data_iter`` yields this rank's rows of each
    global batch (``data_rows``), in the one-card run's order. Checkpoints hold the whole
    state (module docstring); ``metrics_fn`` sees the global loss on every rank, and rank 0
    logs it."""
    init_state, train_step = make_sharded_train_step(model, mesh, optimizer, compute_dtype)
    state = _resume(init_state(model), mesh, ckpt_dir, resume, "")
    return _run(state, train_step, data_iter, mesh, num_steps, ckpt_dir, ckpt_every,
                log_every, seed, metrics_fn, "")


def train_lora_sharded(model: MMDiT, mesh: RankMesh, lora_init: Dict[str, torch.Tensor],
                       data_iter: Iterator[Dict], num_steps: int, lora_scale: float = 1.0,
                       ckpt_dir: Optional[str] = None, ckpt_every: int = 1000,
                       log_every: int = 100, seed: int = 0, compute_dtype=torch.float32,
                       resume: bool = True, optimizer=None,
                       metrics_fn: Optional[Callable[[int, float], None]] = None
                       ) -> LoraTrainState:
    """``training/loop.py::train_lora`` on ``mesh``'s rank, with :func:`train_sharded`'s
    contract; ``lora_init`` is drawn for the whole model (``init_lora`` before placing)."""
    init_state, train_step = make_sharded_lora_train_step(model, mesh, lora_scale, optimizer,
                                                          compute_dtype)
    state = _resume(init_state(lora_init), mesh, ckpt_dir, resume, "LoRA ")
    return _run(state, train_step, data_iter, mesh, num_steps, ckpt_dir, ckpt_every,
                log_every, seed, metrics_fn, "lora ")
