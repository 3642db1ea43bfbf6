"""Generation orchestration, the sampler node's phase 2 (``foley_tpu/pipeline/generate.py``
counterpart): CFG features, seeded initial latents, the denoise loop and the DAC decode,
returning the sampler's two AUDIO outputs (first of batch and full batch) at 48 kHz.

The models run where their parameters live: ``mmdit.init`` and ``dac_vae.init`` put them on
``cuda`` unless the caller names another device. Text features may come from anywhere; they
are moved to that device; so are the visual features of V2A, which
``pipeline/features.py::encode_video`` makes with ``bundle.encoders``. Host offload and LoRA
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from foley_tpu_torch.configs import PipelineConfig
from foley_tpu_torch.models import dac_vae
from foley_tpu_torch.models import mmdit as mmdit_mod
from foley_tpu_torch.models.dac_vae import DAC
from foley_tpu_torch.pipeline.features import (
    pad_or_trim_time,
    pick_text_bucket,
    prepare_cfg_features,
    t2a_features,
)
from foley_tpu_torch.sampling.denoise import DenoiseFeatures, denoise_and_decode, prepare_latents


class ModelBundle(NamedTuple):
    """All loaded model state for generation."""

    mmdit: mmdit_mod.MMDiT
    dac: DAC
    pipeline_cfg: PipelineConfig
    # {"clap": ..., "siglip2": ..., "synchformer": ...} (pipeline.features)
    encoders: Optional[Dict] = None
    compute_dtype: torch.dtype = torch.bfloat16
    latent_stats: Optional[tuple] = None  # (mean[C], std[C]) for from-scratch-trained models


@dataclasses.dataclass
class GenerationResult:
    """The sampler node's two AUDIO outputs."""

    audio_first: np.ndarray   # [1, C, T]
    audio_batch: np.ndarray   # [B, C, T]
    sample_rate: int
    latents: Optional[np.ndarray] = None
    timings: Optional[Dict[str, float]] = None


# Above this latent length the decode runs in chunks (dac_vae.decode_chunked): exact output,
# about a fifth of the fp32 decode temporaries. 1536 frames is about 30 s.
_DECODE_CHUNK_THRESHOLD = 1536
_DECODE_CHUNK_FRAMES = 512


def _device_of(bundle: ModelBundle) -> torch.device:
    return next(bundle.mmdit.parameters()).device


def encode_latents(bundle: ModelBundle, wav: torch.Tensor) -> torch.Tensor:
    """Waveform [B, T] (T a hop multiple) -> the posterior's mode [B, T/hop, C] in the
    denoiser's latent space (standardized with ``bundle.latent_stats`` when it has them):
    the data end of SDEdit's flow and continuation's known prefix."""
    z = dac_vae.encode(bundle.dac, wav[..., None]).mode().float()
    if bundle.latent_stats is not None:
        mean, std = bundle.latent_stats
        z = (z - mean) / std
    return z


def _seeded_latents(seed: int, latent_len: int, latent_dim: int,
                    device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return prepare_latents(gen, 1, latent_len, latent_dim)


def _run(bundle: ModelBundle, latents, features, guidance_scale, num_inference_steps, sampler,
         use_cfg, visual_rows_shared, output_pcm16):
    cfg = bundle.pipeline_cfg
    latent_len = latents.shape[1]
    return denoise_and_decode(
        bundle.mmdit, bundle.dac, latents, features, guidance_scale, bundle.latent_stats,
        diffusion=cfg.diffusion, dac_cfg=cfg.dac, num_steps=num_inference_steps, solver=sampler,
        use_cfg=use_cfg, compute_dtype=bundle.compute_dtype,
        decode_chunk_frames=(_DECODE_CHUNK_FRAMES if latent_len > _DECODE_CHUNK_THRESHOLD
                             else None),
        output_pcm16=output_pcm16, visual_rows_shared=visual_rows_shared)


def _to_host(audio: torch.Tensor, duration_s: float, sample_rate: int,
             pcm16: bool) -> np.ndarray:
    # Trim by samples (the reference's channel-dim slice is a no-op bug).
    n_samples = int(duration_s * sample_rate)
    audio_np = audio[:, :n_samples, 0].cpu().numpy()  # [B, T]
    if pcm16:
        audio_np = audio_np.astype(np.float32) / 32767.0
    return audio_np[:, None, :]  # [B, C=1, T] AUDIO layout


def generate_audio(bundle: ModelBundle, text_feat, uncond_text_feat, duration_s: float, *,
                   clip_feat=None, sync_feat=None, guidance_scale: float = 4.5,
                   num_inference_steps: int = 50, sampler: str = "euler", batch_size: int = 1,
                   seed: int = 0, text_bucket: Optional[int] = None,
                   return_latents: bool = False, fetch_pcm16: bool = True) -> GenerationResult:
    """Generate Foley audio from prepared text features (+ optional visual features).

    T2A (no video): ``clip_feat``/``sync_feat`` default to the model's learned empty
    sequences with duration-derived lengths. V2A: ``clip_feat`` [1, L_clip, D] and
    ``sync_feat`` [1, S*8, D] from ``encode_video``; the CFG halves then differ, so every
    visual row is projected. ``fetch_pcm16`` (default): the decode emits
    16-bit PCM and the host dequantizes (``pcm/32767``), the same bytes a 16-bit WAV holds.
    The initial noise comes from a ``torch.Generator`` seeded with ``seed`` on the model's
    device: its bits differ from the JAX package's for the same seed."""
    cfg = bundle.pipeline_cfg
    device = _device_of(bundle)
    t0 = time.perf_counter()

    t2a = clip_feat is None or sync_feat is None
    if t2a:
        clip_feat, sync_feat = t2a_features(bundle.mmdit, cfg, duration_s, batch_size=1)
    text_feat, uncond_text_feat, clip_feat, sync_feat = (
        torch.as_tensor(x).to(device) for x in (text_feat, uncond_text_feat, clip_feat,
                                                 sync_feat))

    use_cfg = guidance_scale > 1.0
    features = prepare_cfg_features(
        bundle.mmdit, text_feat, uncond_text_feat, clip_feat, sync_feat,
        batch_size=batch_size, use_cfg=use_cfg,
        text_bucket=text_bucket or pick_text_bucket(int(text_feat.shape[1])))
    latent_len = cfg.latent_length(duration_s)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    latents = prepare_latents(gen, batch_size, latent_len, cfg.model.audio_vae_latent_dim)

    t1 = time.perf_counter()
    # T2A: the cond visuals ARE the learned empty sequences the uncond half uses, so the
    # CFG halves are identical and the forward halves the visual-derived GEMMs.
    final_latents, audio = _run(bundle, latents, features, guidance_scale,
                                num_inference_steps, sampler, use_cfg,
                                visual_rows_shared=t2a and use_cfg, output_pcm16=fetch_pcm16)
    audio_np = _to_host(audio, duration_s, cfg.dac.sample_rate, fetch_pcm16)
    t2 = time.perf_counter()

    return GenerationResult(
        audio_first=audio_np[:1], audio_batch=audio_np, sample_rate=cfg.dac.sample_rate,
        latents=final_latents.cpu().numpy() if return_latents else None,
        timings={"prepare_s": t1 - t0, "denoise_decode_s": t2 - t1})


def generate_audio_multi(bundle: ModelBundle, text_feats, uncond_text_feats, duration_s: float,
                         seeds: Sequence[int], *, guidance_scale: float = 4.5,
                         num_inference_steps: int = 50, sampler: str = "euler",
                         text_bucket: Optional[int] = None,
                         return_latents: bool = False) -> GenerationResult:
    """Batched generation with distinct per-row prompts and seeds (serving micro-batching):
    ``text_feats``/``uncond_text_feats`` [N, L, D], one row and one seed per request. Row i's
    initial noise is the one ``generate_audio(seed=seeds[i])`` draws. T2A only."""
    cfg = bundle.pipeline_cfg
    device = _device_of(bundle)
    text_feats, uncond_text_feats = (torch.as_tensor(x).to(device)
                                     for x in (text_feats, uncond_text_feats))
    n = text_feats.shape[0]
    if len(seeds) != n:
        raise ValueError(f"{len(seeds)} seeds for {n} requests")
    bucket = text_bucket or pick_text_bucket(int(text_feats.shape[1]))
    text = pad_or_trim_time(text_feats, bucket)
    uncond = pad_or_trim_time(uncond_text_feats, bucket)
    clip, sync = t2a_features(bundle.mmdit, cfg, duration_s, batch_size=n)

    use_cfg = guidance_scale > 1.0
    if use_cfg:
        features = DenoiseFeatures(cond=torch.cat([uncond, text], dim=0),
                                   clip_feat=torch.cat([clip, clip], dim=0),
                                   sync_feat=torch.cat([sync, sync], dim=0))
    else:
        features = DenoiseFeatures(cond=text, clip_feat=clip, sync_feat=sync)

    latent_len = cfg.latent_length(duration_s)
    latents = torch.cat([_seeded_latents(s, latent_len, cfg.model.audio_vae_latent_dim, device)
                         for s in seeds], dim=0)
    final_latents, audio = _run(bundle, latents, features, guidance_scale,
                                num_inference_steps, sampler, use_cfg,
                                visual_rows_shared=use_cfg, output_pcm16=True)
    audio_np = _to_host(audio, duration_s, cfg.dac.sample_rate, True)
    return GenerationResult(
        audio_first=audio_np[:1], audio_batch=audio_np, sample_rate=cfg.dac.sample_rate,
        latents=final_latents.cpu().numpy() if return_latents else None)
