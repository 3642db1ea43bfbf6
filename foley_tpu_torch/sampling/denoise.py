"""The denoise loop: CFG-batched MMDiT evaluations and the solver, then DAC decode
(``foley_tpu/sampling/denoise.py`` counterpart).

Reference behaviour: initial latents [B, T, 128] from a seeded generator; CFG pairs built
once outside the loop as ``cat([uncond, cond])``; per step ``cat([latents] * 2)``, the model
in the compute dtype, ``v = u + s * (c - u)`` and the scheduler step in fp32; after the
loop an fp32 DAC decode and a trim to ``duration * sample_rate`` samples.

The JAX package runs the loop as one ``lax.scan`` inside one ``jit``; here it is a Python
loop of eager launches. The text K/V and the triple blocks' adaLN vectors are hoisted out
of it as in the JAX package, and so are the RoPE and qk-norm weight tables.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from foley_tpu_torch.configs import DACConfig, DiffusionConfig
from foley_tpu_torch.sampling.flow_match import (
    get_sigmas,
    get_timesteps,
    interpolant_sigma,
    solver_init,
    solver_step,
)


class DenoiseFeatures(NamedTuple):
    """Condition tensors, already CFG-stacked to leading dim 2B (or B without CFG)."""

    cond: torch.Tensor       # [2B, L_text, D_text]
    clip_feat: torch.Tensor  # [2B, L_clip, D_clip]
    sync_feat: torch.Tensor  # [2B, S*8, D_sync]


@torch.no_grad()
def denoise_latents(model, latents: torch.Tensor, features: DenoiseFeatures,
                    guidance_scale: float, known_latents: Optional[torch.Tensor] = None, *,
                    diffusion: DiffusionConfig, num_steps: int, solver: str = "euler",
                    use_cfg: bool = True, compute_dtype=torch.bfloat16, begin_index: int = 0,
                    visual_rows_shared: bool = False, known_frames: int = 0) -> torch.Tensor:
    """Run the flow-matching ODE. latents: [B, T, C] -> fp32 [B, T, C].

    ``begin_index`` starts mid-schedule (latents already noised to ``sigmas[begin_index]``).
    ``visual_rows_shared``: promise that the CFG halves of the visual features are identical
    (T2A); the forward then halves the visual-derived GEMMs. ``known_frames`` /
    ``known_latents``: the first ``known_frames`` latent frames are clamped after every
    solver step to the interpolant ``(1-sigma)*known + sigma*noise0`` at the sigma the
    sample nominally sits at, and hard-set to ``known_latents`` after the loop.
    """
    device = latents.device
    sigmas = get_sigmas(
        num_steps, shift=diffusion.sample_flow_shift, reverse=diffusion.flow_reverse,
        use_flux_shift=diffusion.use_flux_shift, flux_base_shift=diffusion.flux_base_shift,
        flux_max_shift=diffusion.flux_max_shift,
        n_tokens=latents.shape[1] if diffusion.use_flux_shift else None, device=device)
    timesteps = get_timesteps(sigmas, diffusion.num_train_timesteps)[begin_index:]

    cond = features.cond.to(device=device, dtype=compute_dtype)
    clip_feat = features.clip_feat.to(device=device, dtype=compute_dtype)
    sync_feat = features.sync_feat.to(device=device, dtype=compute_dtype)
    g = torch.tensor(guidance_scale, dtype=torch.float32, device=device)

    # timestep-invariant text K/V, RoPE and qk-norm tables, and the whole schedule's
    # triple-block adaLN vectors
    text_kv = model.precompute_text_kv(cond)
    tables = model.attention_tables(latents.shape[1] // model.cfg.patch_size,
                                    clip_feat.shape[1], cond.shape[1], device)
    triple_mods = model.precompute_triple_mods(timesteps, compute_dtype)

    known_noise = latents[:, :known_frames].float() if known_frames else None
    lat = latents.float()
    state = solver_init(solver)
    state.step_index = begin_index
    shared = visual_rows_shared and use_cfg
    for i in range(timesteps.shape[0]):
        latent_input = (torch.cat([lat, lat], dim=0) if use_cfg else lat).to(compute_dtype)
        t_expand = timesteps[i].expand(latent_input.shape[0])
        mods = None if triple_mods is None else (triple_mods[0][i], triple_mods[1][i])
        v = model(latent_input, t_expand, cond, clip_feat, sync_feat, text_kv=text_kv,
                  triple_mods=mods, tables=tables, visual_rows_shared=shared).float()
        if use_cfg:
            v_uncond, v_cond = v.chunk(2, dim=0)
            v = v_uncond + g * (v_cond - v_uncond)
        lat = solver_step(solver, state, v, lat, sigmas)
        if known_frames:
            sig = interpolant_sigma(solver, state, sigmas)
            clamp = (1.0 - sig) * known_latents.float() + sig * known_noise
            lat = torch.cat([clamp, lat[:, known_frames:]], dim=1)
    if known_frames:
        # hard-set the prefix: exact whatever sigma the trajectory ended at
        lat = torch.cat([known_latents.float(), lat[:, known_frames:]], dim=1)
    return lat


@torch.no_grad()
def denoise_and_decode(model, dac, latents: torch.Tensor, features: DenoiseFeatures,
                       guidance_scale: float, latent_stats=None, *, diffusion: DiffusionConfig,
                       dac_cfg: DACConfig, num_steps: int, solver: str = "euler",
                       use_cfg: bool = True, compute_dtype=torch.bfloat16, begin_index: int = 0,
                       decode_chunk_frames: Optional[int] = None, output_pcm16: bool = False,
                       visual_rows_shared: bool = False):
    """Denoise + DAC decode. Returns (final_latents fp32 in model latent space, audio
    [B, T*hop, 1]: fp32, or int16 PCM with ``output_pcm16``).

    ``latent_stats=(mean[C], std[C])``: latents standardized in training are mapped back
    with ``z*std + mean`` before the decode; ``None`` decodes the model output directly."""
    from foley_tpu_torch.models import dac_vae

    if dac.cfg != dac_cfg:
        raise ValueError("dac_cfg does not match the DAC module's config")
    final_latents = denoise_latents(
        model, latents, features, guidance_scale, diffusion=diffusion, num_steps=num_steps,
        solver=solver, use_cfg=use_cfg, compute_dtype=compute_dtype, begin_index=begin_index,
        visual_rows_shared=visual_rows_shared)
    raw = final_latents
    if latent_stats is not None:
        mean, std = latent_stats
        raw = final_latents * std + mean
    if decode_chunk_frames:
        audio = dac_vae.decode_chunked(dac, raw, decode_chunk_frames)
    else:
        audio = dac_vae.decode(dac, raw)
    return final_latents, to_pcm16(audio) if output_pcm16 else audio


def to_pcm16(audio: torch.Tensor) -> torch.Tensor:
    """16-bit PCM with write_wav's rounding: clip, *32767, round half to even."""
    return torch.round(torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)


def prepare_latents(generator: torch.Generator, batch_size: int, latent_length: int,
                    latent_dim: int, dtype=torch.float32) -> torch.Tensor:
    """Seeded standard-normal initial latents [B, T, C] on the generator's device. The
    bits differ from ``jax.random``'s; tests inject the same noise on both sides."""
    return torch.randn((batch_size, latent_length, latent_dim), generator=generator,
                       device=generator.device, dtype=dtype)
