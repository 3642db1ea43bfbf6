"""Rank programs of the mesh tests (``tests/test_torch_parallel.py``): ``parallel/launch.py``
starts each in spawned processes, which import this module by name, so it imports torch and
the port only (no JAX: a rank has no use for it, and importing it would cost each rank
seconds)."""

import os

import numpy as np
import torch

from foley_tpu_torch.configs import TINY
from foley_tpu_torch.models import dac_vae, mmdit
from foley_tpu_torch.io.quantize import quantize_params
from foley_tpu_torch.parallel.inference import place_denoiser, shard_bundle, sharded_generate
from foley_tpu_torch.parallel.sharding import shard_state_dict
from foley_tpu_torch.pipeline import generate as tgen


def _denoiser(mmdit_state, quantization=None):
    model = mmdit.MMDiT(TINY.model, device="cpu")
    model.load_state_dict(mmdit_state)
    if quantization:
        quantize_params(model, quantization)
    return model


def forward_and_generate(mesh, mmdit_state, dac_state, inputs, text, gen_kw, noise):
    """The TINY fp32 bundle of these weights placed on the mesh: its forward over the whole
    batch ``inputs`` (also with the weights in fp8_e4m3fn storage), and
    ``sharded_generate(text, text, **gen_kw)`` with ``noise`` as the initial latents (the
    JAX package's noise, as the port's generate tests inject it). Returns rank 0's
    velocities, audio and latents, and every rank's collective counts, layer types and
    local parameter count and gathered adaLN layers."""
    fp8 = place_denoiser(_denoiser(mmdit_state, "fp8_e4m3fn"), mesh)
    with torch.no_grad():
        fp8_velocity = fp8(*inputs)
    mesh.reset_counts()
    model = _denoiser(mmdit_state)
    dac = dac_vae.DAC(TINY.dac, device="cpu")
    dac.load_state_dict(dac_state)
    bundle = shard_bundle(tgen.ModelBundle(model, dac, TINY, compute_dtype=torch.float32), mesh)
    with torch.no_grad():
        velocity = bundle.mmdit(*inputs)
    counts = mesh.counts()
    tgen.prepare_latents = lambda gen, b, length, dim, dtype=torch.float32: noise.clone()
    result = sharded_generate(bundle, mesh, text, text, return_latents=True, **gen_kw)
    layers = sorted({type(m).__name__ for m in model.modules()})
    slices = shard_state_dict(mmdit_state, mesh)
    placed = model.state_dict()
    ranks = mesh.gather_object({
        "forward_counts": counts, "layers": layers,
        "params": sum(p.numel() for p in model.parameters()),
        "gathered": sum(bool(getattr(m, "gather", False)) for m in model.modules()),
        "state_is_its_slices": placed.keys() == slices.keys() and all(
            torch.equal(placed[k], slices[k]) for k in placed)})
    return {"velocity": velocity.numpy(), "fp8_velocity": fp8_velocity.numpy(),
            "audio": result.audio_batch,
            "latents": result.latents, "ranks": ranks}


def fail_on_rank(mesh, rank: int, how: str):
    """Rank ``rank`` raises (``how`` "raise") or dies without a word ("exit"); the others
    wait in a collective that it never joins."""
    if mesh.rank == rank:
        if how == "raise":
            raise RuntimeError(f"rank {rank} refuses")
        os._exit(3)
    mesh.all_gather(torch.zeros(1), "data")
    return np.zeros(1)


def card_model_and_inputs(cfg, dtype, dev):
    """A seeded ``cfg`` denoiser (its zero-initialized leaves perturbed) and a seeded CFG
    batch of forward inputs, on ``dev`` (``tests/test_torch_cuda.py``)."""
    from foley_tpu_torch.core.params import perturb_zero_leaves

    model = perturb_zero_leaves(
        mmdit.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=dtype),
        torch.Generator(device=dev).manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    inputs = (rnd(2, 40, cfg.audio_vae_latent_dim), torch.full((2,), 500.0, device=dev),
              rnd(2, 16, cfg.condition_dim), rnd(2, 8, cfg.clip_dim), rnd(2, 16, cfg.sync_feat_dim))
    return model, inputs


def card_forward(mesh, cfg, dtype):
    """The ``card_model_and_inputs`` denoiser placed on the mesh, its forward over the whole
    batch on the rank's card: rank 0's velocity and every rank's K1 launches by heads."""
    import collections

    from foley_tpu_torch.ops.kernels import fused_attention as FA
    heads = collections.Counter()
    k1 = mmdit.fused_qk_attention

    def by_heads(q, *args, **kw):
        heads[q.shape[2]] += 1
        return k1(q, *args, **kw)

    mmdit.fused_qk_attention = by_heads
    model, inputs = card_model_and_inputs(cfg, dtype, mesh.device)
    denoiser = place_denoiser(model, mesh)
    FA.fused_qk_attention.launches = 0
    with torch.no_grad():
        velocity = denoiser(*inputs).cpu()
    mine = {"heads": dict(heads), "launches": FA.fused_qk_attention.launches}
    return {"velocity": velocity, "ranks": mesh.gather_object(mine)}


# ---------------------------------------------------------------------------------
# Training over the mesh (tests/test_torch_parallel_training.py)
# ---------------------------------------------------------------------------------

def _digests(tensors) -> dict:
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def _rows(mesh, batch):
    lo, hi = mesh.data_rows(len(batch["latents"]))
    return {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()}


def _whole(state):
    """A gathered state (rank 0's) as host tensors: (leaves, mu, nu, step, count)."""
    from foley_tpu_torch.training import loop

    if state is None:
        return None
    _, leaves = loop._trained(state)
    return (leaves, state.opt_state.mu, state.opt_state.nu, state.step, state.opt_state.count)


def _loop_batches(batches, mesh, skip=0):
    """This rank's rows of the global stream ``batches`` (numpy) from ``skip`` on, staged by
    the unchanged ``PrefetchLoader`` on the rank's device."""
    from foley_tpu_torch.parallel.training import data_rows
    from foley_tpu_torch.training.data import PrefetchLoader

    return PrefetchLoader(data_rows(iter(batches[skip:]), mesh), device=mesh.device)


def train_program(mesh, plan):
    """Every train check of one mesh on the TINY fp32 denoiser ``plan["state"]``: the
    reduced full and LoRA gradients at those weights (``plan["lora_random"]``, scale 0.7)
    on the global batch ``plan["batch"]`` with the global draws ``plan["draws"]``; two full
    steps (``make_sharded_train_step``'s defaults) and three LoRA steps from
    ``plan["lora_fresh"]`` (adam 1e-2) on that batch with ``plan["step_draws"]``; with
    ``plan["loops"]``, the loops' checkpoint and resume, a one-rank checkpoint restored and
    the exports. Returns rank 0's gathered results and every rank's collective counts and
    leaf digests."""
    from foley_tpu_torch.parallel import training as pt
    from foley_tpu_torch.parallel.sharding import partition_spec_for, shard_params
    from foley_tpu_torch.training.optim import adam

    f32 = dict(compute_dtype=torch.float32)
    batch = _rows(mesh, plan["batch"])
    noise, sigma = plan["draws"]
    out, mine = {}, {}

    model = shard_params(_denoiser(plan["state"]), mesh)
    params = dict(model.named_parameters())
    reductions = {n: pt.param_reduction(n, p, mesh) for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    mesh.reset_counts()
    try:
        loss, grads = pt.sharded_value_and_grad(model, mesh, batch, params, reductions,
                                                noise=noise, sigma=sigma, **f32)
    finally:
        for p in params.values():
            p.requires_grad_(False)
    mine["counts"] = mesh.counts()
    mine["layers"] = sorted({type(m).__name__ for m in model.modules()})
    whole = pt.gather_leaves({k: v for k, v in grads.items() if v is not None}, mesh)
    unreached = sorted(k for k, v in grads.items() if v is None)
    lora = {k: v.clone().requires_grad_(True) for k, v in plan["lora_random"].items()}
    lora_loss, lora_grads = pt.sharded_value_and_grad(
        model, mesh, batch, lora, {n: pt.lora_reduction(n, mesh) for n in lora},
        noise=noise, sigma=sigma, lora=lora, lora_scale=0.7, **f32)
    out.update(full_loss=loss, full_grads=whole, unreached=unreached, lora_loss=lora_loss,
               lora_grads=lora_grads)

    step_noise, step_sigma = plan["step_draws"]
    init_state, step = pt.make_sharded_train_step(model, mesh, **f32)
    state, losses, states = init_state(model), [], []
    for _ in range(2):
        state, loss = step(state, batch, noise=step_noise, sigma=step_sigma)
        losses.append(float(loss))
        states.append(_whole(pt.whole_state(state, mesh)))
    out.update(full_losses=losses, full_states=states)
    specs = {k: partition_spec_for(k, v) for k, v in state.params.items()}
    mine["param_digests"] = _digests(state.params)
    mine["sharded"] = sorted(k for k, s in specs.items() if s.axis is not None and mesh.model > 1)

    base = shard_params(_denoiser(plan["state"]), mesh)
    init_state, step = pt.make_sharded_lora_train_step(base, mesh, optimizer=adam(1e-2), **f32)
    state, losses, states = init_state(plan["lora_fresh"]), [], []
    for _ in range(3):
        state, loss = step(state, batch, noise=step_noise, sigma=step_sigma)
        losses.append(float(loss))
        states.append(_whole(pt.whole_state(state, mesh)))
    out.update(lora_losses=losses, lora_states=states)
    mine["lora_digests"] = _digests(state.lora)
    sliced = shard_state_dict(plan["state"], mesh)
    mine["base_unchanged"] = all(torch.equal(v, sliced[k]) for k, v in base.state_dict().items())
    if plan.get("loops"):
        out.update(_loops(mesh, plan))
    out["ranks"] = mesh.gather_object(dict(mine, model_rank=mesh.model_rank))
    return out


def _loops(mesh, plan) -> dict:
    """``train_sharded`` / ``train_lora_sharded``: two steps straight; one step with a
    checkpoint, then a resume from it to two (bit for bit, both); the one-rank checkpoint
    ``plan["one_rank_ckpt"]`` restored on the mesh; the exports."""
    from foley_tpu_torch.parallel import training as pt
    from foley_tpu_torch.parallel.sharding import shard_params
    from foley_tpu_torch.training.optim import adam

    kw = dict(log_every=0, seed=7, compute_dtype=torch.float32)
    batches, tmp = plan["loop_batches"], plan["tmp"]
    lora_kw = dict(lora_scale=0.5, optimizer=adam(1e-3), **kw)
    out, trained = {}, {}
    for kind in ("full", "lora"):
        def run(steps, skip=0, ckpt=None, resume=True):
            loader = _loop_batches(batches, mesh, skip)
            try:
                model = _denoiser(plan["state"])
                if kind == "full":
                    return pt.train_sharded(model, mesh, loader, steps, ckpt_dir=ckpt,
                                            ckpt_every=10, resume=resume, **kw)
                return pt.train_lora_sharded(model, mesh, plan["lora_fresh"], loader, steps,
                                             ckpt_dir=ckpt, ckpt_every=10, resume=resume,
                                             **lora_kw)
            finally:
                loader.close()

        ck = os.path.join(tmp, f"ck_{kind}")
        straight = run(2)
        run(1, ckpt=ck)
        resumed = run(2, skip=1, ckpt=ck)
        out[f"{kind}_straight"] = _whole(pt.whole_state(straight, mesh))
        out[f"{kind}_resumed"] = _whole(pt.whole_state(resumed, mesh))
        out[f"{kind}_ckpt"] = ck
        trained[kind] = resumed
    out["full_export"] = pt.export_for_inference_sharded(
        trained["full"], os.path.join(tmp, "export"), mesh, latent_stats=plan["latent_stats"])
    out["lora_export"] = pt.export_lora_sharded(trained["lora"], os.path.join(tmp, "adapter"),
                                                mesh, rank=4, scale=0.5)
    model = shard_params(_denoiser(plan["state"]), mesh)
    init_state, _ = pt.make_sharded_train_step(model, mesh, compute_dtype=torch.float32)
    restored = pt.restore_checkpoint_sharded(plan["one_rank_ckpt"], init_state(model), mesh)
    out["one_rank_restored"] = _whole(pt.whole_state(restored, mesh))
    return out


def card_train_batch(cfg, dev, rows=2):
    """A seeded global batch of flow-matching inputs on ``dev`` (``tests/test_torch_cuda.py``)."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return {"latents": rnd(rows, 40, cfg.audio_vae_latent_dim),
            "cond": rnd(rows, 16, cfg.condition_dim), "clip_feat": rnd(rows, 8, cfg.clip_dim),
            "sync_feat": rnd(rows, 16, cfg.sync_feat_dim)}


def card_train_grads(mesh, cfg):
    """The ``card_model_and_inputs`` denoiser (fp32) placed on the mesh: the loss and the
    gathered gradients of every parameter on ``card_train_batch``, step 0 of seed 3's
    draws; rank 0's, on the host."""
    from foley_tpu_torch.parallel import training as pt
    from foley_tpu_torch.parallel.sharding import shard_params
    from foley_tpu_torch.training.loop import step_generator

    model, _ = card_model_and_inputs(cfg, torch.float32, mesh.device)
    shard_params(model, mesh)
    batch = card_train_batch(cfg, mesh.device)
    lo, hi = mesh.data_rows(len(batch["latents"]))
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, grads = pt.sharded_value_and_grad(
        model, mesh, {k: v[lo:hi] for k, v in batch.items()}, params,
        {n: pt.param_reduction(n, p, mesh) for n, p in params.items()},
        step_generator(3, 0, mesh.device), compute_dtype=torch.float32)
    return {"loss": float(loss),
            "grads": pt.gather_leaves({k: v for k, v in grads.items() if v is not None}, mesh)}
