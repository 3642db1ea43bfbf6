"""Feature preparation: CFG stacking, text shape-bucketing, the T2A empty sequences, the text
features of a prompt and the video features of V2A (``foley_tpu/pipeline/features.py``
counterpart, with the sampler node's ``_encode_text`` and ``_encode_video``).

Contracts kept from the reference:
- CFG ordering: uncond (negative prompt) first, cond second;
- two-bucket text padding: 77 tokens normally, 128 when the prompt exceeds 77;
- T2A uses the model's learned empty clip/sync sequences with lengths derived from the
  duration: clip = duration*8, sync segments = (duration*25 - 16)//8 + 1;
- V2A resamples the video to 8 fps (SigLIP2) and 25 fps (Synchformer, 16-frame windows at
  stride 8) over the duration, padding short videos with their last frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from foley_tpu_torch.configs import PipelineConfig
from foley_tpu_torch.models import clap, mmdit, synchformer
from foley_tpu_torch.ops.interp import linspace_resample_indices
from foley_tpu_torch.sampling.denoise import DenoiseFeatures

TEXT_BUCKETS = (77, 128)


def pad_or_trim_time(x: torch.Tensor, t_fixed: int) -> torch.Tensor:
    """[B, T, D] -> [B, t_fixed, D]: right-pad with zeros or trim."""
    t_cur = x.shape[1]
    if t_cur == t_fixed:
        return x
    if t_cur > t_fixed:
        return x[:, :t_fixed]
    return F.pad(x, (0, 0, 0, t_fixed - t_cur))


def pick_text_bucket(token_len: int, cap: Optional[int] = None,
                     sticky: Optional[int] = None) -> int:
    """Two-bucket policy with sticky-max upgrade."""
    bucket = TEXT_BUCKETS[0] if token_len <= TEXT_BUCKETS[0] else TEXT_BUCKETS[1]
    if cap is not None:
        bucket = min(bucket, cap)
    if sticky is not None:
        bucket = max(bucket, sticky)
    return bucket


def t2a_features(model: mmdit.MMDiT, pipeline_cfg: PipelineConfig, duration_s: float,
                 batch_size: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Text-to-audio visual placeholders: the learned empty clip/sync sequences."""
    clip_len, sync_len = pipeline_cfg.t2a_lengths(duration_s)
    return (mmdit.get_empty_clip_sequence(model, batch_size, clip_len),
            mmdit.get_empty_sync_sequence(model, batch_size, sync_len))


def prepare_cfg_features(model: mmdit.MMDiT, text_feat: torch.Tensor,
                         uncond_text_feat: torch.Tensor, clip_feat: torch.Tensor,
                         sync_feat: torch.Tensor, batch_size: int, use_cfg: bool = True,
                         text_bucket: Optional[int] = None) -> DenoiseFeatures:
    """Repeat to batch, pad text to its bucket, and stack [uncond; cond].

    ``text_feat``/``uncond_text_feat`` [1, L, D], ``clip_feat`` [1, L_clip, D], ``sync_feat``
    [1, S*8, D]. The CFG-uncond visual features are the model's learned empty sequences at
    the same lengths as the conditional ones."""
    if text_bucket is None:
        text_bucket = pick_text_bucket(int(text_feat.shape[1]))

    text = pad_or_trim_time(text_feat.repeat_interleave(batch_size, dim=0), text_bucket)
    uncond_text = pad_or_trim_time(uncond_text_feat.repeat_interleave(batch_size, dim=0),
                                   text_bucket)
    clip = clip_feat.repeat_interleave(batch_size, dim=0)
    sync = sync_feat.repeat_interleave(batch_size, dim=0)
    if not use_cfg:
        return DenoiseFeatures(cond=text, clip_feat=clip, sync_feat=sync)

    empty_clip = mmdit.get_empty_clip_sequence(model, batch_size, clip.shape[1]).to(clip.dtype)
    empty_sync = mmdit.get_empty_sync_sequence(model, batch_size, sync.shape[1]).to(sync.dtype)
    return DenoiseFeatures(
        cond=torch.cat([uncond_text, text], dim=0),
        clip_feat=torch.cat([empty_clip, clip], dim=0),
        sync_feat=torch.cat([empty_sync, sync], dim=0),
    )


def apply_drop_visual(model: mmdit.MMDiT, clip_feat: torch.Tensor, sync_feat: torch.Tensor,
                      drop_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace each example's visual features with the learned empty sequences where
    ``drop_mask`` [B] is True (reference ``hifi_foley.py:739-741`` ``drop_visual``, the
    structural CFG-uncond mechanism; the sampler passes explicit empty sequences instead)."""
    b = clip_feat.shape[0]
    empty_clip = mmdit.get_empty_clip_sequence(model, b, clip_feat.shape[1]).to(clip_feat.dtype)
    empty_sync = mmdit.get_empty_sync_sequence(model, b, sync_feat.shape[1]).to(sync_feat.dtype)
    m = drop_mask.reshape(b, 1, 1).to(clip_feat.device)
    return torch.where(m, empty_clip, clip_feat), torch.where(m, empty_sync, sync_feat)


def encode_text(encoders: Dict, prompt: str,
                negative_prompt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(text_feat [1, L, D], uncond_text_feat [1, L, D]) of a prompt through
    ``encoders["clap"]`` (a ``ClapTextEncoder``): the counterpart of the sampler node's
    ``_encode_text``. The two prompts are one batch, ``[negative, prompt]``, so both rows
    share the padded length L."""
    feats = clap.encode_text(encoders["clap"], [negative_prompt, prompt])
    return feats[1:2], feats[0:1]


def resample_frames(frames: np.ndarray, source_fps: float, duration_s: float,
                    target_fps: int) -> np.ndarray:
    """Resample [T, H, W, C] frames to ``target_fps`` over ``duration_s`` (host numpy).
    Short inputs are padded by repeating the last frame."""
    needed_src = int(round(duration_s * source_fps))
    if frames.shape[0] < needed_src:
        pad = np.repeat(frames[-1:], needed_src - frames.shape[0], axis=0)
        frames = np.concatenate([frames, pad], axis=0)
    else:
        frames = frames[:needed_src]
    n_target = int(duration_s * target_fps)
    return frames[linspace_resample_indices(frames.shape[0], n_target)]


def sync_segments(frames_25fps: np.ndarray, segment_size: int = 16, stride: int = 8) -> np.ndarray:
    """Window 25 fps frames into [S, 16, ...] segments at stride 8 (host numpy); an input
    shorter than a segment is padded with its last frame."""
    t = frames_25fps.shape[0]
    num = max((t - segment_size) // stride + 1, 1)
    if t < segment_size:
        pad = np.repeat(frames_25fps[-1:], segment_size - t, axis=0)
        frames_25fps = np.concatenate([frames_25fps, pad], axis=0)
    return np.stack(
        [frames_25fps[i * stride: i * stride + segment_size] for i in range(num)], axis=0)


def encode_video(encoders: Dict, frames: np.ndarray, frame_rate: float, duration_s: float,
                 cfg: PipelineConfig) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Visual features of a video on the encoders' ``preprocess`` routes: the counterpart
    of ``foley_tpu/api/nodes.py::HunyuanFoleySampler._encode_video``.

    ``frames`` [T, H, W, C] (float [0, 1] or uint8) at ``frame_rate``; ``encoders`` may hold
    ``"siglip2"`` (a ``Siglip2Encoder``) and ``"synchformer"`` (a ``SynchformerEncoder``).
    Returns (clip_feat [1, duration*8, D], sync_feat [1, S*8, D]), both fp32 on the
    encoders' device; a missing encoder gives None."""
    frames = np.asarray(frames)
    clip_feat = sync_feat = None
    if "siglip2" in encoders:
        f8 = resample_frames(frames, frame_rate, duration_s, cfg.siglip2_fps)
        clip_feat = encoders["siglip2"].encode(f8)
    if "synchformer" in encoders:
        f25 = resample_frames(frames, frame_rate, duration_s, cfg.synchformer_fps)
        sync_feat = synchformer.encode_frames(encoders["synchformer"], f25)
    return clip_feat, sync_feat
