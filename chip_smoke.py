#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``foley_tpu_torch``) on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA card: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``foley_tpu_torch/csrc`` (into
``build/torch_kernels/``), then prints one JSON line per phase:

- ``device``: the card (``nvidia-smi`` name and power limit, also printed raw on a line of
  its own), torch and CUDA versions;
- ``build``: both kernel libraries, built in parallel: seconds per library and what ptxas
  reported;
- ``kernel``: one line per kernel and shape: the fused qk-norm + RoPE attention kernel (K1)
  and the flash-attention kernel (K2) against their plain PyTorch versions in bf16 (max abs
  and relative L2 errors and their tolerances), with the kernel's, the plain version's and
  the library call's times and the card's bound for the work;
- ``forward``: one XXL denoiser forward at the 5 s shapes through the kernel, against the
  same forward through the plain attention;
- ``main_path``: XXL text-to-audio, 5 s, 50 Euler steps, CFG 4.5, batch 1, bf16 denoiser,
  fp32 DAC, int16 PCM: a warm-up, three ``generate_audio`` requests and one
  ``generate_audio_multi`` request with two rows, with the kernel's launch count per request;
- ``profile``: one more request timed unprofiled, then one under ``torch.profiler``
  tracing the card alone: its wall, the card's busy time and idle share within that run,
  and kernel time by group (the port's kernels, GEMMs, cuDNN convolutions, the rest) and
  for the heaviest kernels;
- ``v2a_path``: XXL video-to-audio, 5 s of a 25 fps 1280x720 clip made from a seed, with
  SigLIP2 (12 layers, 512x512, K2 in every layer) and Synchformer at their real geometry
  in bf16, on the ``main_path`` denoiser: a warm-up and two requests, each
  ``encode_video`` then ``generate_audio``, with both kernels' launches per request, the
  encode time per encoder and the request's wall;
- ``{"kernels": [...]}``: every ported kernel with its launches on its path (K1 in
  ``main_path``, K2 in ``v2a_path``);
- last, ``{"ok": true, "device": {...}}``.

Any failed check raises, and the run exits non-zero. Without a CUDA card, or outside the
repository, it exits non-zero before printing anything.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

DURATION_S = 5.0
STEPS = 50
GUIDANCE = 4.5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
KERNEL_TOL = 2e-2          # bf16: online softmax rounds unnormalised p, sums in another order
KERNEL_REL_TOL = 1e-2      # relative L2 error per kernel case: holds whatever the output's scale
FORWARD_REL_TOL = 5e-2     # relative L2 error of the XXL velocity, bf16 through 54 blocks
LATENT_STD = (0.1, 100.0)  # plausible std of the final latents (the initial noise has 1)
MOVED_REL = 0.1            # least relative L2 distance of the final latents from the noise
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU spin while the host enqueues a timed loop
KERNEL_LIBS = ("fused_qk_attention", "flash_attention")
CLIP_FPS, CLIP_HW = 25, (720, 1280)  # the V2A source clip: 5 s of 25 fps 1280x720 RGB


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gpu_ms(torch, fn, iters: int) -> float:
    """Device time per call: CUDA events around ``iters`` calls queued behind a GPU spin, so
    the host's launch cost stays hidden unless it exceeds the kernels' own time."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_bound(n_bytes: int, flops: int) -> dict:
    bound = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, "operations": flops / BF16_FLOPS * 1e3}
    return {"bytes": n_bytes, "flops": flops, "bound_ms": max(bound.values()),
            "bound_by": max(bound, key=bound.get)}


def kernel_phase(torch, dev, cfg):
    """K1 against its plain version at the main path's two shapes, ragged lengths and a
    long-form joint shape. Returns {case: result}."""
    from foley_tpu_torch.models.mmdit import build_rope_tables
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.rope import rope_table

    b, h, d = 2, cfg.num_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)

    def norm_weight():
        return torch.empty(d, device=dev).uniform_(0.5, 1.5, generator=gen).to(torch.bfloat16)

    def joint_case(audio_len, visual_len):
        # per-position tables over [v_cond; audio], as TripleBlock builds them
        ropes = build_rope_tables(cfg, audio_len, visual_len, cfg.text_length, device=dev)
        check(ropes.audio_joint is not None, f"identity check failed at {audio_len}")
        cos, sin = (torch.cat([vt, at]) for vt, at in zip(ropes.visual_joint, ropes.audio_joint))
        tabs = [torch.cat([norm_weight().expand(visual_len, d), norm_weight().expand(audio_len, d)])
                for _ in range(2)]
        return audio_len + visual_len, tabs + [cos, sin, cos, sin]

    def single_case(length):
        cos, sin = rope_table(length, d, cfg.rope_theta, device=dev)
        return length, [norm_weight(), norm_weight(), cos, sin, cos, sin]

    cases = {"joint_5s": joint_case(250, 40), "single_5s": single_case(250),
             "ragged_1": single_case(1), "ragged_63": single_case(63),
             "ragged_65": single_case(65), "joint_30s": joint_case(1500, 240)}
    results = {}
    for name, (length, (wq, wk, cq, sq, ck, sk)) in cases.items():
        q, k, v = (torch.randn(b, length, h, d, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        full = lambda w: w.expand(length, d)  # noqa: E731
        args = (q, k, v, wq, wk, cq, sq, ck, sk)
        got = FA.fused_qk_attention(*args)
        ref = FA.fused_qk_attention_plain(q, k, v, full(wq), full(wk), cq, sq, ck, sk)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
        err = float((got.float() - ref.float()).abs().max())
        check(err <= KERNEL_TOL, f"{name}: max abs error {err} > {KERNEL_TOL}")
        rel = float((got.float() - ref.float()).norm() / ref.float().norm())
        check(rel <= KERNEL_REL_TOL, f"{name}: relative L2 error {rel} > {KERNEL_REL_TOL}")

        def library_call():
            qn = FA._norm_rope(q, full(wq), cq, sq, 1e-6).transpose(1, 2)
            kn = FA._norm_rope(k, full(wk), ck, sk, 1e-6).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                qn, kn, v.transpose(1, 2)).transpose(1, 2)

        lib_err = float((library_call().float() - ref.float()).abs().max())
        distinct = {t.data_ptr(): t.numel() * t.element_size() for t in (q, k, v, wq, wk, cq,
                                                                            sq, ck, sk)}
        n_bytes = sum(distinct.values()) + got.numel() * got.element_size()
        flops = 4 * b * h * length * length * d
        res = {
            "phase": "kernel", "case": name, "b": b, "l": length, "h": h, "d": d,
            "max_abs_err": err, "tol": KERNEL_TOL, "rel_l2_err": rel, "rel_tol": KERNEL_REL_TOL,
            "library_max_abs_err": lib_err,
            "kernel_ms": gpu_ms(torch, lambda: FA.fused_qk_attention(*args), 200),
            "plain_ms": gpu_ms(torch, lambda: FA.fused_qk_attention_plain(
                q, k, v, full(wq), full(wk), cq, sq, ck, sk), 20),
            "library_ms": gpu_ms(torch, library_call, 20),
            **kernel_bound(n_bytes, flops),
        }
        emit(res)
        results[name] = res
    return results


def flash_kernel_phase(torch, dev):
    """K2 against its plain version at SigLIP2's 5 s shape (40 frames of 1024 tokens, 12
    heads of 64), ragged self-attention and Lq != Lk. Returns {case: result}."""
    from foley_tpu_torch.ops.kernels import flash_attention as FL

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {"siglip2_5s": (40, 1024, 1024, 12, 64), "ragged_1": (2, 1, 1, 12, 64),
             "ragged_63": (2, 63, 63, 12, 64), "ragged_65": (2, 65, 65, 12, 64),
             "cross_250x77": (2, 250, 77, 12, 128)}
    results = {}
    for name, (b, lq, lk, h, d) in cases.items():
        q = torch.randn(b, lq, h, d, device=dev, generator=gen).to(torch.bfloat16)
        k, v = (torch.randn(b, lk, h, d, device=dev, generator=gen).to(torch.bfloat16)
                for _ in range(2))
        got = FL.flash_attention(q, k, v)
        ref = FL.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K2 {name}: non-finite kernel output")
        err = float((got.float() - ref.float()).abs().max())
        check(err <= KERNEL_TOL, f"K2 {name}: max abs error {err} > {KERNEL_TOL}")
        rel = float((got.float() - ref.float()).norm() / ref.float().norm())
        check(rel <= KERNEL_REL_TOL, f"K2 {name}: relative L2 error {rel} > {KERNEL_REL_TOL}")
        del ref

        def library_call():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)

        res = {
            "phase": "kernel", "kernel": "flash_attention", "case": name, "b": b, "lq": lq,
            "lk": lk, "h": h, "d": d, "max_abs_err": err, "tol": KERNEL_TOL, "rel_l2_err": rel,
            "rel_tol": KERNEL_REL_TOL,
            "kernel_ms": gpu_ms(torch, lambda: FL.flash_attention(q, k, v), 200),
            "plain_ms": gpu_ms(torch, lambda: FL.flash_attention_plain(q, k, v), 10),
            "library_ms": gpu_ms(torch, library_call, 50),
            # q and o, k and v: each read or written once
            **kernel_bound(2 * (q.numel() + k.numel()) * q.element_size(),
                           4 * b * h * lq * lk * d),
        }
        emit(res)
        results[name] = res
    return results


def forward_phase(torch, dev, model, cfg, pipeline_cfg):
    """One XXL forward at the 5 s CFG shapes through the kernel and through the plain
    attention; the velocities must agree."""
    from foley_tpu_torch.models import mmdit as mmdit_mod
    from foley_tpu_torch.ops.kernels import fused_attention as FA

    gen = torch.Generator(device=dev).manual_seed(1)
    clip_len, sync_len = pipeline_cfg.t2a_lengths(DURATION_S)
    t_len = pipeline_cfg.latent_length(DURATION_S)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen).to(torch.bfloat16)  # noqa: E731
    args = (rnd(2, t_len, cfg.audio_vae_latent_dim), torch.full((2,), 500.0, device=dev),
            rnd(2, cfg.text_length, cfg.condition_dim), rnd(2, clip_len, cfg.clip_dim),
            rnd(2, sync_len, cfg.sync_feat_dim))

    def plain(q, k, v, wq, wk, *tabs, eps):
        lq, lk = q.shape[1], k.shape[1]
        return FA.fused_qk_attention_plain(q, k, v, wq.expand(lq, q.shape[-1]),
                                           wk.expand(lk, k.shape[-1]), *tabs, eps=eps)

    with torch.no_grad():
        got = model(*args).float()
        mmdit_mod.fused_qk_attention = plain
        try:
            ref = model(*args).float()
        finally:
            mmdit_mod.fused_qk_attention = FA.fused_qk_attention
    check(bool(torch.isfinite(got).all()), "non-finite velocity")
    rel = float((got - ref).norm() / ref.norm())
    check(float(ref.std()) > 0, "zero velocity: the signal does not reach the output")
    check(rel <= FORWARD_REL_TOL, f"forward relative error {rel} > {FORWARD_REL_TOL}")
    emit({"phase": "forward", "shape": list(got.shape), "velocity_std": float(ref.std()),
          "rel_l2_err": rel, "tol": FORWARD_REL_TOL})


def check_audio(audio, rows: int, pipeline_cfg) -> float:
    """Finite, non-silent audio of the expected shape; returns its RMS."""
    import numpy as np

    n_samples = int(DURATION_S * pipeline_cfg.dac.sample_rate)
    check(audio.shape == (rows, 1, n_samples), f"audio shape {audio.shape}")
    check(bool(np.isfinite(audio).all()), "non-finite audio")
    rms = float(np.sqrt(np.mean(audio.astype(np.float64) ** 2)))
    check(rms > 0, "silent audio")
    return rms


def check_latents(torch, dev, latents, seed: int, pipeline_cfg):
    """What the denoiser controls: the final latents are finite, of a plausible scale, and
    far from the seed's initial noise (generate_audio's own draw). Returns (std, moved)."""
    import numpy as np

    from foley_tpu_torch.sampling.denoise import prepare_latents

    noise = prepare_latents(torch.Generator(device=dev).manual_seed(seed), 1,
                            pipeline_cfg.latent_length(DURATION_S),
                            pipeline_cfg.model.audio_vae_latent_dim).cpu().numpy()
    check(latents.shape == noise.shape, f"latent shape {latents.shape}")
    check(bool(np.isfinite(latents).all()), "non-finite latents")
    std = float(latents.std())
    check(LATENT_STD[0] < std < LATENT_STD[1], f"final latent std {std} outside {LATENT_STD}")
    moved = float(np.linalg.norm(latents - noise) / np.linalg.norm(noise))
    check(moved > MOVED_REL, f"the denoiser moved the latents by only {moved} (rel L2)")
    return std, moved


def main_path_phase(torch, dev, bundle, pipeline_cfg):
    import numpy as np

    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.pipeline.generate import generate_audio, generate_audio_multi

    cfg = pipeline_cfg.model
    per_request = STEPS * (cfg.depth_triple_blocks + cfg.depth_single_blocks)
    text = torch.zeros(1, 77, cfg.condition_dim)
    kw = dict(guidance_scale=GUIDANCE, num_inference_steps=STEPS, sampler="euler")

    def valid(audio, rows):
        return check_audio(audio, rows, pipeline_cfg)

    def valid_latents(latents, seed):
        return check_latents(torch, dev, latents, seed, pipeline_cfg)

    t0 = time.perf_counter()
    warm = generate_audio(bundle, text, text, DURATION_S, batch_size=1, seed=1, **kw)
    warm_s = time.perf_counter() - t0

    FA.fused_qk_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, counts, rms, latents = [], [], [], {}
    for seed in (1, 2, 3):
        before = FA.fused_qk_attention.launches
        t0 = time.perf_counter()
        res = generate_audio(bundle, text, text, DURATION_S, batch_size=1, seed=seed,
                             return_latents=True, **kw)
        walls.append(time.perf_counter() - t0)
        counts.append(FA.fused_qk_attention.launches - before)
        rms.append(valid(res.audio_batch, 1))
        latents[seed] = res.latents
        if seed == 1:
            check(res.audio_batch.tobytes() == warm.audio_batch.tobytes(),
                  "the same seed gave different audio")
    latent_checks = [valid_latents(latents[s], s) for s in latents]
    check(not np.array_equal(latents[1], latents[2]), "two seeds gave the same latents")
    before = FA.fused_qk_attention.launches
    t0 = time.perf_counter()
    multi = generate_audio_multi(bundle, torch.zeros(2, 77, cfg.condition_dim),
                                 torch.zeros(2, 77, cfg.condition_dim), DURATION_S, (4, 5), **kw)
    multi_s = time.perf_counter() - t0
    counts.append(FA.fused_qk_attention.launches - before)
    valid(multi.audio_batch, 2)
    check(not np.array_equal(multi.audio_batch[0], multi.audio_batch[1]),
          "two seeds gave the same audio")
    launches = FA.fused_qk_attention.launches
    check(all(c == per_request for c in counts),
          f"fused_qk_attention launches per request {counts}, expected {per_request}")
    median = statistics.median(walls)
    emit({"phase": "main_path", "config": "xxl", "duration_s": DURATION_S, "steps": STEPS,
          "guidance": GUIDANCE, "warmup_s": warm_s, "walls_s": walls, "median_wall_s": median,
          "audio_sec_per_sec": DURATION_S / median, "multi_2rows_s": multi_s,
          "launches_per_request": counts, "rms": rms,
          "latent_std": [s for s, _ in latent_checks],
          "latent_moved_rel_l2": [m for _, m in latent_checks],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches, latents


PROFILE_GROUPS = (
    ("fused_qk_attention", ("fused_qk_attention",)),
    ("gemm", ("gemm", "sm90_xmma", "cutlass", "cublas", "s16816", "nvjet")),
    ("conv", ("conv", "cudnn", "fprop", "dgrad", "implicit")),
)


def profile_phase(torch, bundle) -> None:
    """Where a request's time goes: one request unprofiled, then one under the profiler
    tracing the card alone (no host-side op recording, so the host runs close to its
    unprofiled pace). Busy time is the summed kernel time of that run, and the idle share
    is taken against the same run's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from foley_tpu_torch.pipeline.generate import generate_audio

    text = torch.zeros(1, 77, bundle.pipeline_cfg.model.condition_dim)

    def request():
        generate_audio(bundle, text, text, DURATION_S, guidance_scale=GUIDANCE,
                       num_inference_steps=STEPS, sampler="euler", seed=1)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    request()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    check(busy_s > 0, "the profiler saw no kernel time on the card")

    def group(name):
        low = name.lower()
        return next((g for g, keys in PROFILE_GROUPS if any(k in low for k in keys)), "other")

    groups = {}
    for e in kernels:
        g = groups.setdefault(group(e.key), {"ms": 0.0, "launches": 0})
        g["ms"] += e.self_device_time_total / 1e3
        g["launches"] += e.count
    heaviest = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": "profile", "unprofiled_wall_s": plain_wall, "wall_s": wall,
          "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / wall,
          "launches": sum(e.count for e in kernels), "groups": groups,
          "top": [{"name": e.key[:120], "ms": e.self_device_time_total / 1e3, "count": e.count}
                  for e in heaviest]})


def make_clip(np, seed: int):
    """5 s of 25 fps 1280x720 RGB uint8 with smooth moving content: per-channel drifting
    sinusoidal gratings and a bright disc crossing the frame, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    h, w = CLIP_HW
    n = int(DURATION_S * CLIP_FPS)
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    freq = rng.uniform(1.0, 4.0, (3, 2)).astype(np.float32)
    speed = rng.uniform(0.2, 1.0, 3).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    x0, y0, vx, vy = rng.uniform(0.1, 0.9, 4)
    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        s = t / CLIP_FPS
        cx, cy = (x0 + vx * s / DURATION_S) % 1.0, (y0 + vy * s / DURATION_S) % 1.0
        disc = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.01)
        for c in range(3):
            grating = np.sin(2 * np.pi * (freq[c, 0] * xx + freq[c, 1] * yy + speed[c] * s)
                             + phase[c])
            frames[t, :, :, c] = np.clip(127.5 + 90.0 * grating + 120.0 * disc, 0, 255)
    return frames


def v2a_path_phase(torch, dev, bundle, pipeline_cfg, t2a_latents):
    """XXL 5 s video-to-audio on the main path's denoiser: SigLIP2 and Synchformer at their
    real geometry in bf16, a warm-up and two requests of ``encode_video`` then
    ``generate_audio``. Returns K2's launches over the two requests."""
    import numpy as np

    from foley_tpu_torch.core.params import perturb_zero_leaves
    from foley_tpu_torch.io.images import box_downsample_u8, frames_to_u8
    from foley_tpu_torch.models import mmdit, siglip2, synchformer
    from foley_tpu_torch.ops.kernels import flash_attention as FL
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.pipeline.features import encode_video, resample_frames
    from foley_tpu_torch.pipeline.generate import generate_audio

    cfg = pipeline_cfg.model
    t0 = time.perf_counter()
    encoders = {"siglip2": siglip2.init_random(0, cfg.clip_dim, device=dev, dtype=torch.bfloat16),
                "synchformer": synchformer.init_random(1, cfg.sync_feat_dim, device=dev,
                                                       dtype=torch.bfloat16)}
    gen = torch.Generator(device=dev).manual_seed(3)
    for enc in encoders.values():
        perturb_zero_leaves(enc.model, gen)
    bundle = bundle._replace(encoders=encoders)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = make_clip(np, 0)
    clip_s = time.perf_counter() - t0
    clip_len, sync_len = pipeline_cfg.t2a_lengths(DURATION_S)
    text = torch.zeros(1, 77, cfg.condition_dim)
    per_k1 = STEPS * (cfg.depth_triple_blocks + cfg.depth_single_blocks)
    per_k2 = encoders["siglip2"].cfg.num_hidden_layers

    def request(seed):
        t0 = time.perf_counter()
        clip, sync = encode_video(bundle.encoders, frames, CLIP_FPS, DURATION_S, pipeline_cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = generate_audio(bundle, text, text, DURATION_S, clip_feat=clip, sync_feat=sync,
                             guidance_scale=GUIDANCE, num_inference_steps=STEPS,
                             sampler="euler", seed=seed, return_latents=True)
        t2 = time.perf_counter()
        return clip, sync, res, {"encode_s": t1 - t0, "generate_s": t2 - t1, "wall_s": t2 - t0}

    t0 = time.perf_counter()
    w_clip, w_sync, warm, _ = request(1)
    warm_s = time.perf_counter() - t0

    FL.flash_attention.launches = 0
    FA.fused_qk_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for seed in (1, 2):
        k1, k2 = FA.fused_qk_attention.launches, FL.flash_attention.launches
        clip, sync, res, times = request(seed)
        times.update(k1=FA.fused_qk_attention.launches - k1, k2=FL.flash_attention.launches - k2)
        runs.append((clip, sync, res, times))
    k2_launches = FL.flash_attention.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    for clip, sync, res, times in runs:
        check(tuple(clip.shape) == (1, clip_len, cfg.clip_dim), f"clip shape {clip.shape}")
        check(tuple(sync.shape) == (1, sync_len, cfg.sync_feat_dim), f"sync shape {sync.shape}")
        for name, feat in (("clip", clip), ("sync", sync)):
            check(feat.dtype == torch.float32 and bool(torch.isfinite(feat).all()),
                  f"{name} features not finite fp32")
            check(float(feat.std()) > 0, f"{name} features are constant")
        check(times["k2"] == per_k2, f"flash_attention launches {times['k2']}, expected {per_k2}")
        check(times["k1"] == per_k1, f"fused_qk_attention launches {times['k1']}, "
                                     f"expected {per_k1}")
        check_audio(res.audio_batch, 1, pipeline_cfg)
    (clip1, sync1, res1, _), (_, _, res2, _) = runs
    check(torch.equal(clip1, w_clip) and torch.equal(sync1, w_sync),
          "the same video gave different features")
    check(res1.audio_batch.tobytes() == warm.audio_batch.tobytes(),
          "the same seed gave different audio")
    latent_checks = [check_latents(torch, dev, r.latents, s, pipeline_cfg)
                     for r, s in ((res1, 1), (res2, 2))]
    check(not np.array_equal(res1.latents, res2.latents), "two seeds gave the same latents")
    # The visual signal reaches the output: the V2A latents differ from the T2A latents of
    # the same seed, and from a request on the same path (unshared CFG rows) whose visual
    # features are the model's learned empty ones, so that only the features differ.
    empty = generate_audio(bundle, text, text, DURATION_S, guidance_scale=GUIDANCE,
                           num_inference_steps=STEPS, sampler="euler", seed=1,
                           return_latents=True,
                           clip_feat=mmdit.get_empty_clip_sequence(bundle.mmdit, 1, clip_len),
                           sync_feat=mmdit.get_empty_sync_sequence(bundle.mmdit, 1, sync_len))

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    v2a_vs_t2a = rel_l2(res1.latents, t2a_latents[1])
    v2a_vs_empty = rel_l2(res1.latents, empty.latents)
    check(v2a_vs_t2a > 0 and v2a_vs_empty > 0,
          f"V2A latents equal those without video (rel L2 {v2a_vs_t2a} against T2A, "
          f"{v2a_vs_empty} against empty visual features): the video does not reach them")

    # the encode split, outside the counted requests: host resampling, Synchformer's host
    # box-downsample alone, then each encoder's whole encode (its host steps included)
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    resample_s, (f8, f25) = timed(lambda: tuple(
        resample_frames(frames, CLIP_FPS, DURATION_S, fps)
        for fps in (pipeline_cfg.siglip2_fps, pipeline_cfg.synchformer_fps)))
    sync_enc = encoders["synchformer"]
    box_s, _ = timed(lambda: box_downsample_u8(frames_to_u8(f25), sync_enc.cfg.img_size))
    siglip2_s, _ = timed(lambda: encoders["siglip2"].encode(f8))
    synchformer_s, _ = timed(lambda: synchformer.encode_frames_device(sync_enc, f25))
    walls = [t["wall_s"] for *_, t in runs]
    median = statistics.median(walls)
    emit({"phase": "v2a_path", "config": "xxl", "duration_s": DURATION_S,
          "clip": [len(frames), *CLIP_HW, CLIP_FPS], "steps": STEPS, "guidance": GUIDANCE,
          "encoder_init_s": init_s, "clip_make_s": clip_s, "warmup_s": warm_s,
          "encode_s": [t["encode_s"] for *_, t in runs],
          "generate_s": [t["generate_s"] for *_, t in runs],
          "resample_s": resample_s, "synchformer_box_downsample_s": box_s,
          "siglip2_s": siglip2_s, "synchformer_s": synchformer_s,
          "walls_s": walls, "median_wall_s": median, "audio_sec_per_sec": DURATION_S / median,
          "flash_attention_per_request": [t["k2"] for *_, t in runs],
          "fused_qk_attention_per_request": [t["k1"] for *_, t in runs],
          "clip_feat_std": float(clip1.std()), "sync_feat_std": float(sync1.std()),
          "latent_std": [s for s, _ in latent_checks],
          "latent_moved_rel_l2": [m for _, m in latent_checks],
          "v2a_vs_t2a_rel_l2": v2a_vs_t2a, "v2a_vs_empty_visuals_rel_l2": v2a_vs_empty,
          "peak_mem_gib": peak})
    return k2_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on a card",
              file=sys.stderr)
        return 2
    from foley_tpu_torch.configs import XXL
    from foley_tpu_torch.core.params import param_count, perturb_zero_leaves
    from foley_tpu_torch.models import dac_vae, mmdit
    from foley_tpu_torch.ops.kernels import build
    from foley_tpu_torch.pipeline.generate import ModelBundle

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi_line,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:  # one nvcc per source, all at once
        list(pool.map(build.library, KERNEL_LIBS))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": build.build_info})

    cfg = XXL.model
    kernel = kernel_phase(torch, dev, cfg)
    flash = flash_kernel_phase(torch, dev)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = perturb_zero_leaves(mmdit.init(cfg, gen, device=dev, dtype=torch.bfloat16), gen)
    dac = dac_vae.init(XXL.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    emit({"phase": "init", "seconds": time.perf_counter() - t0,
          "mmdit_params": param_count(model), "dac_params": param_count(dac)})
    forward_phase(torch, dev, model, cfg, XXL)
    bundle = ModelBundle(model, dac, XXL, compute_dtype=torch.bfloat16)
    launches, t2a_latents = main_path_phase(torch, dev, bundle, XXL)
    profile_phase(torch, bundle)
    flash_launches = v2a_path_phase(torch, dev, bundle, XXL, t2a_latents)

    # per-launch figures weighted by the main path's mix: each step runs one joint call per
    # triple block and one single call per single block
    mix = {"joint_5s": cfg.depth_triple_blocks, "single_5s": cfg.depth_single_blocks}

    def avg(key):
        return sum(kernel[c][key] * n for c, n in mix.items()) / sum(mix.values())

    k1_bound = kernel_bound(avg("bytes"), avg("flops"))
    k2 = flash["siglip2_5s"]  # the one shape the V2A path gives K2
    emit({"kernels": [{
        "name": "fused_qk_attention", "route": "cuda",
        "source": "foley_tpu_torch/csrc/fused_qk_attention.cu",
        "replaces": "foley_tpu/ops/pallas/fused_attention.py:82",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
        "ms": avg("kernel_ms"), "plain_ms": avg("plain_ms"), "bound_ms": k1_bound["bound_ms"],
        "bound_by": k1_bound["bound_by"],
        "library_ms": avg("library_ms"),
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "foley_tpu_torch/csrc/flash_attention.cu",
        "replaces": "foley_tpu/ops/pallas/flash_attention.py:60",
        "launches": flash_launches,
        "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
        "ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
