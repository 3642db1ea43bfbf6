"""Generation of any duration: windowed denoise with flow-match inpainting stitching
(``foley_tpu/pipeline/longform.py`` counterpart).

Audio is generated in fixed-size overlapping windows. Each window after the first clamps
its first ``overlap`` latent frames to the previous window's tail at every solver step, on
the training interpolant ``(1-sigma)*known + sigma*noise``
(``sampling/denoise.py::denoise_latents(known_frames=...)``), and hard-sets them at the end.
So a window's latents are final once it is denoised, the next window reproduces them
exactly, and stitching is a concatenation in latent space. Decode runs per finalized segment
with a halo of true context (``_stream_segments``): the batch path and the streaming path
run the same segment decodes on the same inputs, so the stream's chunks concatenate to the
batch path's audio. The noise of the whole stitched sequence is drawn once from ``seed``;
every window takes its slice.

- An optional latency ramp (``first_window_s``) prepends a smaller preamble window, emitted
  as soon as it is denoised, then runs the normal plan with the preamble as known prefix.
- Continuation (``continue_audio``) encodes the last ``context_s`` seconds of a waveform with
  the DAC encoder (the posterior's mode) and clamps them as window 0's known prefix.
- V2A windows slice the FULL video's features. SigLIP2 features are per 8 fps frame and
  Synchformer's per 16-frame segment at stride 8 with no mixing across segments, so a
  window's slice is what encoding that window alone would give, provided every window
  starts on a multiple of 8 s (``V2A_GRID_S``): ``t0*8`` integral and ``t0*25 = 0 (mod 8)``.
  ``plan_v2a_long`` snaps the window stride down to that grid.

The stitched latents live on the model's device. The JAX package's ``attn_impl`` argument
has no counterpart: both of the denoiser's attention sites always run the fused attention
kernel, at every window length. ``default_window_s`` and ``snap_to_window_grid`` serve the
sampler node and the server (``api/nodes.py``, ``serving/server.py``): their window size,
and a bounded set of window sizes for a server.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from foley_tpu_torch.models import dac_vae
from foley_tpu_torch.pipeline.features import (
    pick_text_bucket,
    prepare_cfg_features,
    t2a_features,
)
from foley_tpu_torch.pipeline.generate import (
    _DECODE_CHUNK_FRAMES,
    GenerationResult,
    ModelBundle,
    _device_of,
    encode_latents,
)
from foley_tpu_torch.sampling.denoise import denoise_latents, prepare_latents, to_pcm16


def window_schedule(total_frames: int, win_frames: int, ov_frames: int,
                    initial_covered: int = 0) -> List[Tuple[int, int]]:
    """[(start_frame, known_frames), ...] covering [0, total_frames) with ``win_frames``
    windows overlapping by >= ``ov_frames``.

    Interior windows advance by ``win - ov``; the final window is right-aligned to end
    exactly at ``total_frames`` (its overlap grows as needed). ``initial_covered`` > 0 marks
    frames [0, initial_covered) as known before the first window (continuation's encoded
    context); window 0 clamps them as an interior window clamps the previous tail. Must be
    < win_frames."""
    if ov_frames >= win_frames:
        raise ValueError(f"overlap ({ov_frames}) must be smaller than window ({win_frames})")
    if not 0 <= initial_covered < win_frames:
        raise ValueError(
            f"initial_covered ({initial_covered}) must be < window ({win_frames})")
    if win_frames >= total_frames:
        return [(0, initial_covered)]
    step = win_frames - ov_frames
    starts = list(range(0, total_frames - win_frames, step))
    starts.append(total_frames - win_frames)
    sched: List[Tuple[int, int]] = []
    prev_end = initial_covered
    for s in starts:
        if s + win_frames <= prev_end:
            continue  # right-aligned final window already covered by the previous one
        sched.append((s, prev_end - s if prev_end else 0))
        prev_end = s + win_frames
    return sched


#: Window starts in V2A long-form must be multiples of this (seconds): the smallest t0
#: with t0*8 integral (clip grid) and t0*25 = 0 mod 8 (sync segment grid).
V2A_GRID_S = 8


def emitted_samples(duration_s: float, sr: int) -> int:
    """``int(duration * sr)`` with a float-noise guard: durations that round-trip through
    ``total_frames / rate`` can land one ulp below the exact product (3.54 * 48000 =
    169919.99999999997), and plain ``int()`` would drop the last sample."""
    return int(duration_s * sr + 1e-6)


def default_window_s(cfg) -> float:
    """The long-form window the sampler node uses: 30 s, capped at the config's single-window
    maximum. One definition, so the V2A encode (``plan_v2a_long``) and the generation agree."""
    return min(30.0, cfg.max_duration_s)


def plan_v2a_long(cfg, duration_s: float, window_s: float = 30.0,
                  overlap_s: Optional[float] = None) -> Tuple[float, float, float]:
    """(feature_duration_s, window_s, overlap_s) for a V2A long-form run.

    The window stride is snapped DOWN to the ``V2A_GRID_S`` grid (more overlap than
    requested, never less) and the total UP to the stride grid, so every window starts on a
    multiple of 8 s. Encode the video at ``feature_duration_s`` (the frame resampler pads past
    the video's end with its last frame) and pass the features, window and overlap to
    ``generate_audio_long``."""
    if overlap_s is None:
        overlap_s = min(5.0, window_s / 4.0)
    rate = cfg.model.audio_frame_rate
    grid = V2A_GRID_S * rate
    win_frames = cfg.latent_length(window_s)
    total_frames = cfg.latent_length(duration_s)
    if total_frames <= win_frames:
        return duration_s, window_s, overlap_s
    step = (win_frames - cfg.latent_length(overlap_s)) // grid * grid
    if step < grid:
        raise ValueError(
            f"V2A long-form needs window - overlap >= {V2A_GRID_S}s "
            f"(got window {window_s}s, overlap {overlap_s}s)"
        )
    total_frames = win_frames + -(-(total_frames - win_frames) // step) * step
    return total_frames / rate, window_s, (win_frames - step) / rate


def _slice_v2a_window(cfg, clip_full, sync_full, start_frames: int, win_frames: int):
    """A window's slices of the full-duration V2A features; exact when ``start_frames`` is a
    multiple of the 8 s grid."""
    rate = cfg.model.audio_frame_rate
    t0_s = start_frames // rate
    clip_len, sync_len = cfg.t2a_lengths(win_frames / rate)
    c0 = t0_s * cfg.siglip2_fps
    # sync token index == 25 fps frame index: the window's first segment is t0*25/8 and
    # each segment contributes 8 tokens, so the token offset is t0*25
    s0 = t0_s * cfg.synchformer_fps
    if clip_full.shape[1] < c0 + clip_len or sync_full.shape[1] < s0 + sync_len:
        raise ValueError(
            f"V2A features too short for window at {t0_s}s: need clip>={c0 + clip_len} "
            f"(got {clip_full.shape[1]}), sync>={s0 + sync_len} (got {sync_full.shape[1]}); "
            "encode the video at plan_v2a_long()'s feature_duration_s"
        )
    return clip_full[:, c0: c0 + clip_len], sync_full[:, s0: s0 + sync_len]


class _LongPrep(NamedTuple):
    """The window plan and the state one long-form run shares across its windows."""

    total_frames: int
    sched: List[Tuple[int, int]]
    sizes: List[int]  # latent frames of each window, aligned with sched
    noise: torch.Tensor  # [B, total_frames, C] on the model's device
    stitched: torch.Tensor  # [B, total_frames, C], written in place by _run_windows
    window_features: Callable  # (start_frame, win_frames) -> CFG feature pack
    use_cfg: bool
    v2a: bool


def _prepare_long(bundle: ModelBundle, text_feat, uncond_text_feat, duration_s: float, *,
                  clip_feat, sync_feat, window_s: float, overlap_s: Optional[float],
                  batch_size: int, seed: int, text_bucket: Optional[int],
                  snap_to_window_grid: bool, use_cfg: bool,
                  known_prefix: Optional[torch.Tensor] = None,
                  first_window_s: Optional[float] = None) -> _LongPrep:
    """The window plan, the per-window conditioning and the buffers the batch and streaming
    paths share.

    ``known_prefix`` ([B or 1, ctx_frames, C], the denoiser's latent space): frames known
    before generation starts (continuation), seeded into the stitch buffer and clamped by
    window 0. ``first_window_s``: the latency ramp, a smaller preamble window over
    [0, first_window_s), then the normal plan with the preamble as its known prefix."""
    cfg = bundle.pipeline_cfg
    device = _device_of(bundle)
    v2a = clip_feat is not None or sync_feat is not None
    if v2a and (clip_feat is None or sync_feat is None):
        raise ValueError("V2A long-form needs both clip_feat and sync_feat")
    if overlap_s is None:
        overlap_s = min(5.0, window_s / 4.0)  # small windows keep a proportional overlap

    total_frames = cfg.latent_length(duration_s)
    win_frames = cfg.latent_length(window_s)
    if v2a and total_frames > win_frames:
        # window starts on the 8 s grid: generate the plan's snapped total, trimmed later
        feat_dur_s, _, overlap_s = plan_v2a_long(cfg, duration_s, window_s, overlap_s)
        total_frames = cfg.latent_length(feat_dur_s)
    ov_frames = cfg.latent_length(overlap_s)
    if snap_to_window_grid and not v2a and total_frames > win_frames:
        # generate on the window-stride grid (trimmed later), so every window clamps
        # exactly ov_frames and the window sizes stay within a bounded set
        step = win_frames - ov_frames
        total_frames = win_frames + -(-(total_frames - win_frames) // step) * step
    ctx_frames = 0 if known_prefix is None else int(known_prefix.shape[1])
    first_frames = 0
    if first_window_s is not None and total_frames > cfg.latent_length(first_window_s):
        first_frames = cfg.latent_length(first_window_s)
        if first_frames >= win_frames:
            raise ValueError(
                f"first_window_s ({first_window_s}) must be smaller than window_s: it is a "
                "streaming latency ramp, not the window itself")
        if ctx_frames >= first_frames:
            raise ValueError(
                f"continuation context ({ctx_frames} latent frames) must fit inside the "
                f"ramp window ({first_frames}); raise first_window_s or lower context_s")
        sched = [(0, ctx_frames)] + window_schedule(
            total_frames, win_frames, ov_frames, initial_covered=first_frames)
    else:
        sched = window_schedule(total_frames, win_frames, ov_frames,
                                initial_covered=ctx_frames)
    sizes = [min(first_frames if (first_frames and i == 0) else win_frames,
                 total_frames - start)
             for i, (start, _) in enumerate(sched)]

    text_feat, uncond_text_feat = (torch.as_tensor(x).to(device)
                                   for x in (text_feat, uncond_text_feat))
    if v2a:
        clip_feat, sync_feat = (torch.as_tensor(x).to(device) for x in (clip_feat, sync_feat))
        if len(sched) > 1:
            # undersized features fail now, not after the earlier windows have run
            _slice_v2a_window(cfg, clip_feat, sync_feat, sched[-1][0], sizes[-1])
    bucket = text_bucket or pick_text_bucket(int(text_feat.shape[1]))
    t2a_cache = {}

    def window_features(start: int, win: int):
        """Conditioning of the window at latent frame ``start`` spanning ``win`` frames.
        T2A's is the learned empty visuals at the window's duration, the same at every
        start, so it is made once per window size."""
        if not v2a and win in t2a_cache:
            return t2a_cache[win]
        if v2a:
            clip_w, sync_w = _slice_v2a_window(cfg, clip_feat, sync_feat, start, win)
        else:
            clip_w, sync_w = t2a_features(bundle.mmdit, cfg, win / cfg.model.audio_frame_rate,
                                          batch_size=1)
        feats = prepare_cfg_features(bundle.mmdit, text_feat, uncond_text_feat, clip_w, sync_w,
                                     batch_size=batch_size, use_cfg=use_cfg, text_bucket=bucket)
        if not v2a:
            t2a_cache[win] = feats
        return feats

    latent_dim = cfg.model.audio_vae_latent_dim
    noise = prepare_latents(torch.Generator(device=device).manual_seed(int(seed)), batch_size,
                            total_frames, latent_dim)
    stitched = torch.zeros(batch_size, total_frames, latent_dim, device=device)
    if ctx_frames:
        stitched[:, :ctx_frames] = known_prefix.float()  # a batch of 1 broadcasts
    return _LongPrep(total_frames=total_frames, sched=sched, sizes=sizes, noise=noise,
                     stitched=stitched, window_features=window_features, use_cfg=use_cfg,
                     v2a=v2a)


def _run_windows(bundle: ModelBundle, prep: _LongPrep, *, guidance_scale: float,
                 num_inference_steps: int, sampler: str) -> Iterator[Tuple[int, int, int]]:
    """Denoise the window schedule in order, writing each window into ``prep.stitched``;
    yields ``(window_index, start_frame, win_frames)`` once a window's latents are final."""
    cfg = bundle.pipeline_cfg
    for w_i, ((start, known), win) in enumerate(zip(prep.sched, prep.sizes)):
        win_out = denoise_latents(
            bundle.mmdit, prep.noise[:, start: start + win], prep.window_features(start, win),
            guidance_scale, prep.stitched[:, start: start + known] if known else None,
            diffusion=cfg.diffusion, num_steps=num_inference_steps, solver=sampler,
            use_cfg=prep.use_cfg, compute_dtype=bundle.compute_dtype,
            # under CFG the T2A halves share visual rows; V2A halves differ (empty vs real)
            visual_rows_shared=prep.use_cfg and not prep.v2a, known_frames=known,
            progress=bundle.progress, offload_prefetch=bundle.offload_prefetch)
        # the clamped prefix equals the previous tail exactly, so the whole window is copied
        prep.stitched[:, start: start + win] = win_out
        yield w_i, start, win


class StreamChunk(NamedTuple):
    """One finalized segment of a streaming long-form generation. Chunks are
    sample-contiguous; their concatenation is ``generate_audio_long``'s output."""

    start_sample: int  # sample offset of this chunk
    audio: np.ndarray  # [B, 1, S] float32 in [-1, 1]
    pcm16: Optional[np.ndarray]  # [B, S] int16 with fetch_pcm16 (audio = pcm / 32767)
    sample_rate: int
    window_index: int
    n_windows: int
    final: bool


#: Latent frames of true context decoded on each interior side of a streamed segment: the
#: chunked decoder's margin (``dac_vae._DECODE_OVERLAP``), well beyond the DAC decoder's
#: receptive field of about 12 frames.
_STREAM_HALO = 32

#: Long-form segment decodes above this many latent frames run in chunks of
#: ``_DECODE_CHUNK_FRAMES`` (``dac_vae.decode_chunked``: the same output, one chunk's
#: temporaries at a time next to the resident denoiser).
_LONG_DECODE_CHUNK_THRESHOLD = 1024


def _decode_long(dac, latents: torch.Tensor, latent_stats, *, fetch_pcm16: bool) -> torch.Tensor:
    raw = latents
    if latent_stats is not None:
        mean, std = latent_stats
        raw = latents * std + mean
    if raw.shape[1] > _LONG_DECODE_CHUNK_THRESHOLD:
        audio = dac_vae.decode_chunked(dac, raw, _DECODE_CHUNK_FRAMES)
    else:
        audio = dac_vae.decode(dac, raw)
    return to_pcm16(audio) if fetch_pcm16 else audio


def _stream_segments(bundle: ModelBundle, prep: _LongPrep, *, duration_s: float,
                     guidance_scale: float, num_inference_steps: int, fetch_pcm16: bool,
                     sampler: str, emit_from_frame: int = 0) -> Iterator[StreamChunk]:
    """Denoise the window schedule and decode and emit each finalized segment as it appears:
    the one segmentation both ``generate_audio_long`` (concatenates) and
    ``generate_audio_long_stream`` (yields) consume, so the two run the same decodes on the
    same inputs. (Decoding per window in one and once at the end in the other would not
    agree: the convolutions' algorithms and sums differ with the input's length.)"""
    cfg = bundle.pipeline_cfg
    hop, sr = cfg.dac.hop_length, cfg.dac.sample_rate
    n_total = emitted_samples(duration_s, sr)
    n_windows = len(prep.sched)
    prev_cut = emit_from_frame  # continuation: the known context is not emitted again
    for w_i, start, win in _run_windows(bundle, prep, guidance_scale=guidance_scale,
                                        num_inference_steps=num_inference_steps,
                                        sampler=sampler):
        avail = start + win  # latent frames final so far
        last = w_i == n_windows - 1
        # hold back a halo before the cut so the next chunk decodes it with its right
        # context; the final window emits through the sequence's end
        cut = prep.total_frames if last else max(avail - _STREAM_HALO, prev_cut)
        seg_lo = max(0, prev_cut - _STREAM_HALO)
        audio_seg = _decode_long(bundle.dac, prep.stitched[:, seg_lo:avail],
                                 bundle.latent_stats, fetch_pcm16=fetch_pcm16)
        o = (prev_cut - seg_lo) * hop
        n_keep = min(cut * hop, n_total) - prev_cut * hop
        raw = audio_seg[:, o: o + n_keep, 0].cpu().numpy()
        if fetch_pcm16:
            pcm16, audio = raw, (raw.astype(np.float32) / 32767.0)[:, None, :]
        else:
            pcm16, audio = None, raw[:, None, :]
        # off the latent grid total_frames*hop < n_total: the last window is final anyway
        final = last or cut * hop >= n_total
        yield StreamChunk(start_sample=prev_cut * hop, audio=audio, pcm16=pcm16,
                          sample_rate=sr, window_index=w_i, n_windows=n_windows, final=final)
        if final:
            return  # what is left (grid-snap padding) lies past the requested length
        prev_cut = cut


def _collect(chunks: Iterator[StreamChunk], fetch_pcm16: bool) -> np.ndarray:
    """Concatenate a run's chunks -> [B, 1, S] float32."""
    audio = np.concatenate([ch.pcm16 if fetch_pcm16 else ch.audio[:, 0] for ch in chunks],
                           axis=-1)
    if fetch_pcm16:
        audio = audio.astype(np.float32) / 32767.0
    return audio[:, None, :]


def generate_audio_long(bundle: ModelBundle, text_feat, uncond_text_feat, duration_s: float,
                        *, clip_feat=None, sync_feat=None, window_s: float = 30.0,
                        overlap_s: Optional[float] = None, guidance_scale: float = 4.5,
                        num_inference_steps: int = 50, sampler: str = "euler",
                        batch_size: int = 1, seed: int = 0, text_bucket: Optional[int] = None,
                        return_latents: bool = False, fetch_pcm16: bool = True,
                        snap_to_window_grid: bool = False,
                        first_window_s: Optional[float] = None) -> GenerationResult:
    """Generate ``duration_s`` seconds of audio (any length) in ``window_s`` windows.

    The noise of the full stitched sequence is drawn once from a ``torch.Generator`` seeded
    with ``seed`` on the model's device, so the result is a function of (seed, conditioning,
    schedule). Every solver works: the prefix clamp is stage-aware and the prefix is
    hard-set at the end of each window. V2A: pass ``clip_feat``/``sync_feat`` encoded from
    the FULL video at ``plan_v2a_long()``'s feature duration, with its window and
    overlap."""
    cfg = bundle.pipeline_cfg
    t0 = time.perf_counter()
    prep = _prepare_long(
        bundle, text_feat, uncond_text_feat, duration_s, clip_feat=clip_feat,
        sync_feat=sync_feat, window_s=window_s, overlap_s=overlap_s, batch_size=batch_size,
        seed=seed, text_bucket=text_bucket, snap_to_window_grid=snap_to_window_grid,
        use_cfg=guidance_scale > 1.0, first_window_s=first_window_s)
    t1 = time.perf_counter()
    audio = _collect(_stream_segments(
        bundle, prep, duration_s=duration_s, guidance_scale=guidance_scale,
        num_inference_steps=num_inference_steps, fetch_pcm16=fetch_pcm16, sampler=sampler),
        fetch_pcm16)
    t2 = time.perf_counter()
    requested_frames = cfg.latent_length(duration_s)  # grid snapping may have padded
    return GenerationResult(
        audio_first=audio[:1], audio_batch=audio, sample_rate=cfg.dac.sample_rate,
        latents=(prep.stitched[:, :requested_frames].cpu().numpy() if return_latents
                 else None),
        timings={"prepare_s": t1 - t0, "denoise_decode_s": t2 - t1,
                 "windows": float(len(prep.sched))})


def generate_audio_long_stream(bundle: ModelBundle, text_feat, uncond_text_feat,
                               duration_s: float, *, clip_feat=None, sync_feat=None,
                               window_s: float = 30.0, overlap_s: Optional[float] = None,
                               guidance_scale: float = 4.5, num_inference_steps: int = 50,
                               sampler: str = "euler", batch_size: int = 1, seed: int = 0,
                               text_bucket: Optional[int] = None, fetch_pcm16: bool = True,
                               snap_to_window_grid: bool = False,
                               first_window_s: Optional[float] = None
                               ) -> Iterator[StreamChunk]:
    """``generate_audio_long`` as a stream: yield each window's finalized audio as soon as
    it is denoised. Nothing emitted is revised; each chunk decodes its segment with a
    ``_STREAM_HALO``-frame halo of true context and holds the halo's samples back for the
    next chunk. Denoising stops once the requested duration is emitted."""
    prep = _prepare_long(
        bundle, text_feat, uncond_text_feat, duration_s, clip_feat=clip_feat,
        sync_feat=sync_feat, window_s=window_s, overlap_s=overlap_s, batch_size=batch_size,
        seed=seed, text_bucket=text_bucket, snap_to_window_grid=snap_to_window_grid,
        use_cfg=guidance_scale > 1.0, first_window_s=first_window_s)
    yield from _stream_segments(
        bundle, prep, duration_s=duration_s, guidance_scale=guidance_scale,
        num_inference_steps=num_inference_steps, fetch_pcm16=fetch_pcm16, sampler=sampler)


def _continuation_prep(bundle: ModelBundle, audio, text_feat, uncond_text_feat,
                       extra_duration_s: float, *, context_s: float, window_s: float,
                       overlap_s: Optional[float], batch_size: int, seed: int,
                       text_bucket: Optional[int], use_cfg: bool,
                       first_window_s: Optional[float]) -> Tuple[_LongPrep, int, float]:
    """Encode the context tail and build the window plan that ``continue_audio`` and
    ``continue_audio_stream`` share -> (prep, ctx_frames, total_duration_s)."""
    cfg = bundle.pipeline_cfg
    sr, hop = cfg.dac.sample_rate, cfg.dac.hop_length
    wav = np.asarray(audio, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    if wav.ndim == 3:  # [B, C, T], the AUDIO layout: mono expected
        wav = wav[:, 0]
    ctx_samples = (min(wav.shape[1], int(context_s * sr)) // hop) * hop
    if ctx_samples < hop:
        raise ValueError(
            f"context audio must cover at least one latent frame ({hop} samples at "
            f"{sr} Hz); got {wav.shape[1]} samples with context_s={context_s}")
    ctx_frames = ctx_samples // hop
    if ctx_frames >= cfg.latent_length(window_s):
        raise ValueError(
            f"context ({ctx_frames} latent frames) must be shorter than the window "
            f"({cfg.latent_length(window_s)}); lower context_s or raise window_s")
    tail = np.ascontiguousarray(wav[:, wav.shape[1] - ctx_samples:])
    z = encode_latents(bundle, torch.from_numpy(tail).to(_device_of(bundle)))

    total_frames = ctx_frames + cfg.latent_length(extra_duration_s)
    total_duration_s = total_frames / cfg.model.audio_frame_rate
    prep = _prepare_long(
        bundle, text_feat, uncond_text_feat, total_duration_s, clip_feat=None, sync_feat=None,
        window_s=window_s, overlap_s=overlap_s, batch_size=batch_size, seed=seed,
        text_bucket=text_bucket, snap_to_window_grid=False, use_cfg=use_cfg,
        known_prefix=z, first_window_s=first_window_s)
    return prep, ctx_frames, total_duration_s


def continue_audio(bundle: ModelBundle, audio, text_feat, uncond_text_feat,
                   extra_duration_s: float, *, context_s: float = 4.0, window_s: float = 30.0,
                   overlap_s: Optional[float] = None, guidance_scale: float = 4.5,
                   num_inference_steps: int = 50, sampler: str = "euler", batch_size: int = 1,
                   seed: int = 0, text_bucket: Optional[int] = None,
                   return_latents: bool = False, fetch_pcm16: bool = True,
                   first_window_s: Optional[float] = None) -> GenerationResult:
    """Generate ``extra_duration_s`` seconds continuing ``audio`` ([T], [B, T] or [B, 1, T]
    float at the DAC's sample rate).

    The last ``context_s`` seconds are encoded (the posterior's mode) and clamped as window
    0's known prefix, so the new audio attends to the real context. Returns the NEW part
    only; its first samples decode with the context's latents as left halo, so it continues
    the context's DAC reconstruction. T2A conditioning only."""
    cfg = bundle.pipeline_cfg
    sr = cfg.dac.sample_rate
    t0 = time.perf_counter()
    prep, ctx_frames, total_duration_s = _continuation_prep(
        bundle, audio, text_feat, uncond_text_feat, extra_duration_s, context_s=context_s,
        window_s=window_s, overlap_s=overlap_s, batch_size=batch_size, seed=seed,
        text_bucket=text_bucket, use_cfg=guidance_scale > 1.0, first_window_s=first_window_s)
    t1 = time.perf_counter()
    out = _collect(_stream_segments(
        bundle, prep, duration_s=total_duration_s, guidance_scale=guidance_scale,
        num_inference_steps=num_inference_steps, fetch_pcm16=fetch_pcm16, sampler=sampler,
        emit_from_frame=ctx_frames), fetch_pcm16)[..., : emitted_samples(extra_duration_s, sr)]
    t2 = time.perf_counter()
    extra_frames = cfg.latent_length(extra_duration_s)
    return GenerationResult(
        audio_first=out[:1], audio_batch=out, sample_rate=sr,
        latents=(prep.stitched[:, ctx_frames: ctx_frames + extra_frames].cpu().numpy()
                 if return_latents else None),
        timings={"prepare_s": t1 - t0, "denoise_decode_s": t2 - t1,
                 "windows": float(len(prep.sched)), "context_frames": float(ctx_frames)})


def continue_audio_stream(bundle: ModelBundle, audio, text_feat, uncond_text_feat,
                          extra_duration_s: float, *, context_s: float = 4.0,
                          window_s: float = 30.0, overlap_s: Optional[float] = None,
                          guidance_scale: float = 4.5, num_inference_steps: int = 50,
                          sampler: str = "euler", batch_size: int = 1, seed: int = 0,
                          text_bucket: Optional[int] = None, fetch_pcm16: bool = True,
                          first_window_s: Optional[float] = None) -> Iterator[StreamChunk]:
    """``continue_audio`` as a stream; ``start_sample`` counts from the start of the NEW
    audio."""
    cfg = bundle.pipeline_cfg
    prep, ctx_frames, total_duration_s = _continuation_prep(
        bundle, audio, text_feat, uncond_text_feat, extra_duration_s, context_s=context_s,
        window_s=window_s, overlap_s=overlap_s, batch_size=batch_size, seed=seed,
        text_bucket=text_bucket, use_cfg=guidance_scale > 1.0, first_window_s=first_window_s)
    base = ctx_frames * cfg.dac.hop_length
    for ch in _stream_segments(
            bundle, prep, duration_s=total_duration_s, guidance_scale=guidance_scale,
            num_inference_steps=num_inference_steps, fetch_pcm16=fetch_pcm16,
            sampler=sampler, emit_from_frame=ctx_frames):
        yield ch._replace(start_sample=ch.start_sample - base)
