"""Audio-to-audio editing, SDEdit (``foley_tpu/pipeline/edit.py`` counterpart).

Encode the source waveform to latents (the DAC posterior's mode), renoise them to
``sigmas[begin_index]`` on the linear flow path, then resume the CFG denoise from there with
the new prompt and decode. ``strength`` in (0, 1] picks how much of the schedule to re-run:
1.0 regenerates from noise, a small value touches the source up.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from foley_tpu_torch.models import dac_vae
from foley_tpu_torch.pipeline.features import (
    pick_text_bucket,
    prepare_cfg_features,
    t2a_features,
)
from foley_tpu_torch.pipeline.generate import (
    GenerationResult,
    ModelBundle,
    _device_of,
    encode_latents,
)
from foley_tpu_torch.sampling.denoise import denoise_latents, prepare_latents
from foley_tpu_torch.sampling.flow_match import get_sigmas


def edit_audio(bundle: ModelBundle, audio: np.ndarray, text_feat, uncond_text_feat, *,
               strength: float = 0.6, guidance_scale: float = 4.5,
               num_inference_steps: int = 50, sampler: str = "euler", seed: int = 0,
               clip_feat=None, sync_feat=None,
               text_bucket: Optional[int] = None) -> GenerationResult:
    """Edit ``audio`` ([T] or [B, T] float waveform at the DAC's sample rate) toward the new
    prompt. The renoising draw comes from a ``torch.Generator`` seeded with ``seed`` on the
    model's device (its bits differ from the JAX package's). Returns the audio trimmed to the
    input's samples."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must lie in (0, 1], got {strength}")
    cfg = bundle.pipeline_cfg
    device = _device_of(bundle)
    wav = torch.as_tensor(np.asarray(audio, np.float32))
    if wav.ndim == 1:
        wav = wav[None]
    b, t = wav.shape
    wav = dac_vae.preprocess(wav[..., None], cfg.dac)[..., 0].to(device)
    duration_s = wav.shape[1] / cfg.dac.sample_rate

    z1 = encode_latents(bundle, wav)  # the data end of the flow
    begin_index = min(max(int(round((1.0 - strength) * num_inference_steps)), 0),
                      num_inference_steps - 1)
    sigma = get_sigmas(num_inference_steps, shift=cfg.diffusion.sample_flow_shift,
                       reverse=cfg.diffusion.flow_reverse, device=device)[begin_index]
    noise = prepare_latents(torch.Generator(device=device).manual_seed(int(seed)), *z1.shape)
    latents = (1.0 - sigma) * z1 + sigma * noise

    if clip_feat is None or sync_feat is None:  # a text-driven edit: the empty visuals
        clip_feat, sync_feat = t2a_features(bundle.mmdit, cfg, duration_s, batch_size=1)
    text_feat, uncond_text_feat, clip_feat, sync_feat = (
        torch.as_tensor(x).to(device) for x in (text_feat, uncond_text_feat, clip_feat,
                                                 sync_feat))
    use_cfg = guidance_scale > 1.0
    features = prepare_cfg_features(
        bundle.mmdit, text_feat, uncond_text_feat, clip_feat, sync_feat, batch_size=b,
        use_cfg=use_cfg, text_bucket=text_bucket or pick_text_bucket(int(text_feat.shape[1])))
    final = denoise_latents(
        bundle.mmdit, latents, features, guidance_scale, diffusion=cfg.diffusion,
        num_steps=num_inference_steps, solver=sampler, use_cfg=use_cfg,
        compute_dtype=bundle.compute_dtype, begin_index=begin_index,
        offload_prefetch=bundle.offload_prefetch)
    if bundle.latent_stats is not None:
        mean, std = bundle.latent_stats
        final = final * std + mean
    out = dac_vae.decode(bundle.dac, final)[:, :t, 0].cpu().numpy()[:, None, :]
    return GenerationResult(audio_first=out[:1], audio_batch=out,
                            sample_rate=cfg.dac.sample_rate)
