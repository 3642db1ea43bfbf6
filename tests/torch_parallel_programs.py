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
