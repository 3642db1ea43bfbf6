#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``foley_tpu_torch``) on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA card: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``foley_tpu_torch/csrc`` (into
``build/torch_kernels/``), then prints one JSON line per phase:

- ``device``: the card (``nvidia-smi`` name and power limit, also printed raw on a line of
  its own), torch and CUDA versions;
- ``build``: the three kernel libraries, built in parallel: seconds per library and what
  ptxas reported;
- ``kernel``: one line per kernel and shape: the fused qk-norm + RoPE attention kernel (K1,
  at every shape a path below gives it: the 5 s request's, the 30 s long-form window's, the
  14 s continuation window's and the 16 s V2A window's, and ragged lengths), the
  flash-attention kernel (K2, at SigLIP2's 5 s and 24 s batches of frames among others) and
  the chained GEMM sweep (K3) against their plain
  PyTorch versions in bf16 (max abs and relative L2 errors and their tolerances), with the
  kernel's device time (and, for K1 and K2, the wrapper's host time a launch), the plain
  version's and the library call's times and the card's bound for the work (K3's also with
  the tool's full-width library sweep);
- ``probe_gemm``: K3's path, the GEMM sweep probe (``foley_tpu_torch.tools.probe_gemm``) at
  its full shape, 36 blocks of x [784, 1536] @ W_b[:, :1536] of [1536, 4608]: its record
  (each variant's time a sweep, eager and replayed from a CUDA graph, and rates, the
  kernel's error, the floors) and K3's launches, one a sweep;
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
- ``clap``: the CLAP text tower at laion/larger_clap_general's geometry in fp32, a prompt
  and a negative prompt through ``features.encode_text`` (a seeded stand-in tokenizer: the
  tokenizer's files are not in the repository), held against the CPU with the default and
  with ``"high"`` fp32 matmul precision; its features condition every request below;
- ``longform_path``: XXL long-form on the ``main_path`` denoiser: a 75 s text-to-audio
  request in 30 s windows overlapping 5 s, batch (``generate_audio_long``) and streamed
  (``generate_audio_long_stream``, time to the first chunk, the chunks against the batch
  audio), 10 s continuing its last 4 s (``continue_audio``), an SDEdit of its first 5 s
  (``edit_audio``, strength 0.6), 24 s of video-to-audio from a 640x360 clip in 16 s
  windows (``encode_video`` then ``generate_audio_long``), with K1's and K2's launches, and
  one 30 s window profiled as in ``profile`` (K1's share of the busy time);
- ``{"kernels": [...]}``: every ported kernel with its launches on its path (K1 in
  ``main_path`` and, as ``launches_longform``, in the 75 s request; K2 in ``v2a_path`` and,
  as ``launches_longform``, in the 24 s V2A request; K3 in one sweep of ``probe_gemm``;
  K3's times are the probe's graph-replayed device times);
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
KERNEL_TOL = 2e-2          # bf16: online softmax rounds unnormalised p, sums in another order;
                           # K3: tanh bounds the output by 1, the tool's own limit
                           # (probe_gemm_pallas.py:122); the same fp32 products summed in another
                           # order, and the chained bf16 roundings carry any flip forward
KERNEL_REL_TOL = 1e-2      # relative L2 error per kernel case: holds whatever the output's scale
                           # (K3: per weight block, on the plain version's activations)
CHAIN_DRIFT = 2.0          # K3's chain may drift from the plain one at most this many times as far
                           # as the plain chain drifts from itself summed in fp64: every block
                           # rounds to bf16, so two right chains drift apart as they go (more
                           # than 1e-2 relative L2 over the probe's 36 blocks); a fault is O(1)
FORWARD_REL_TOL = 5e-2     # relative L2 error of the XXL velocity, bf16 through 54 blocks
LATENT_STD = (0.1, 100.0)  # plausible std of the final latents (the initial noise has 1)
MOVED_REL = 0.1            # least relative L2 distance of the final latents from the noise
KERNEL_LIBS = ("fused_qk_attention", "flash_attention", "gemm_sweep")
CLIP_FPS, CLIP_HW = 25, (720, 1280)  # the V2A source clip: 5 s of 25 fps 1280x720 RGB
CLAP_REL_TOL = 1e-5        # CLAP fp32 on the card against the CPU, relative L2 (fp32 reads
                           # ~7e-7; the phase's control, TF32 let in, ~4e-4 and must break it)
PROMPT = "a glass bottle shatters on a stone floor while heavy rain drums on a tin roof"  # 77
NEGATIVE_PROMPT = "noisy, harsh"
LONG_S, LONG_WINDOW_S, LONG_OVERLAP_S = 75.0, 30.0, 5.0  # past the sampler node's 60 s cap
CONTINUE_S, CONTEXT_S = 10.0, 4.0
EDIT_STRENGTH = 0.6
V2A_LONG_S, V2A_LONG_HW = 24.0, (360, 640)  # 24 s of 25 fps 640x360 RGB
STREAM_TOL = 1.5 / 32767   # stream against batch: the same decodes, at most a PCM step apart


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def timed_ms(torch, fn, iters: int):
    """(device ms, host ms) per call of ``fn``: CUDA events around ``iters`` calls queued
    behind a GPU spin, and the host clock around the same loop
    (``foley_tpu_torch.tools.bench_kernels.timed``)."""
    from foley_tpu_torch.tools.bench_kernels import timed

    return timed(torch, fn, iters)


def gpu_ms(torch, fn, iters: int) -> float:
    """Device time per call (``timed_ms``)."""
    return timed_ms(torch, fn, iters)[0]


def kernel_bound(n_bytes: int, flops: int) -> dict:
    bound = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3, "operations": flops / BF16_FLOPS * 1e3}
    return {"bytes": n_bytes, "flops": flops, "bound_ms": max(bound.values()),
            "bound_by": max(bound, key=bound.get)}


def kernel_phase(torch, dev, cfg):
    """K1 against its plain version at the main path's two shapes, ragged lengths on both
    sides of its 64-row tiles and the long-form path's windows: 30 s (joint L 1740, single
    L 1500), the 14 s continuation window (joint L 812, single L 700) and the 16 s V2A
    window (joint L 928, single L 800). Returns {case: result}.

    K1's bound counts what the function must move: q, k and v read and o written in bf16,
    the per-position fp32 cos/sin tables read once (one pair, shared by q and k, as the
    denoiser passes them), and the norm weights as the [D] rows they are made of (one per
    stream: two for the joint [v_cond; audio] sequence, one for a single block), for q and
    for k. The kernel reads the weights as per-position [L, D] tables, which the bound does
    not charge it for."""
    from foley_tpu_torch.models.mmdit import build_rope_tables
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.rope import rope_table

    b, h, d = 2, cfg.num_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)

    def norm_weight():  # an RMSNorm weight [D], in fp32 as the denoiser's tables hold it
        return torch.empty(d, device=dev).uniform_(0.5, 1.5, generator=gen)

    def joint_case(audio_len, visual_len):
        # per-position tables over [v_cond; audio], as TripleBlock builds them
        ropes = build_rope_tables(cfg, audio_len, visual_len, cfg.text_length, device=dev)
        check(ropes.audio_joint is not None, f"identity check failed at {audio_len}")
        cos, sin = (torch.cat([vt, at]) for vt, at in zip(ropes.visual_joint, ropes.audio_joint))
        tabs = [torch.cat([norm_weight().expand(visual_len, d), norm_weight().expand(audio_len, d)])
                for _ in range(2)]
        return audio_len + visual_len, 2, tabs + [cos, sin, cos, sin]

    def single_case(length):
        cos, sin = rope_table(length, d, cfg.rope_theta, device=dev)
        # per-position fp32 [L, D] tables, as SingleBlock.norm_tables builds them
        return length, 1, [norm_weight().expand(length, d).contiguous() for _ in range(2)] + [
            cos, sin, cos, sin]

    cases = {"joint_5s": joint_case(250, 40), "single_5s": single_case(250),
             "ragged_1": single_case(1), "ragged_63": single_case(63),
             "ragged_64": single_case(64), "ragged_65": single_case(65),
             "ragged_128": single_case(128), "joint_30s": joint_case(1500, 240),
             "single_30s": single_case(1500), "joint_cont": joint_case(700, 112),
             "single_cont": single_case(700), "joint_v2a16": joint_case(800, 128),
             "single_v2a16": single_case(800)}
    results = {}
    for name, (length, streams, (wq, wk, cq, sq, ck, sk)) in cases.items():
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
        tables = {t.data_ptr(): t.numel() * 4 for t in (cq, sq, ck, sk)}  # fp32 [L, D]
        n_bytes = (4 * q.numel() * q.element_size() + sum(tables.values())
                   + 2 * streams * d * 4)  # q, k, v, o; cos/sin; [D] weight rows, q and k
        flops = 4 * b * h * length * length * d
        kernel_ms, host_ms = timed_ms(torch, lambda: FA.fused_qk_attention(*args), 200)
        res = {
            "phase": "kernel", "case": name, "b": b, "l": length, "h": h, "d": d,
            "max_abs_err": err, "tol": KERNEL_TOL, "rel_l2_err": rel, "rel_tol": KERNEL_REL_TOL,
            "library_max_abs_err": lib_err, "kernel_ms": kernel_ms, "host_ms": host_ms,
            "plain_ms": gpu_ms(torch, lambda: FA.fused_qk_attention_plain(
                q, k, v, full(wq), full(wk), cq, sq, ck, sk), 20),
            "library_ms": gpu_ms(torch, library_call, 20),
            **kernel_bound(n_bytes, flops),
        }
        emit(res)
        results[name] = res
    return results


def flash_kernel_phase(torch, dev):
    """K2 against its plain version at SigLIP2's shapes on the two V2A paths (all the
    frames of a clip in one launch: 40 frames of 1024 tokens for 5 s, 192 for the long-form
    path's 24 s; 12 heads of 64), ragged self-attention and Lq != Lk. Returns
    {case: result}."""
    from foley_tpu_torch.ops.kernels import flash_attention as FL

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = {"siglip2_5s": (40, 1024, 1024, 12, 64), "siglip2_24s": (192, 1024, 1024, 12, 64),
             "ragged_1": (2, 1, 1, 12, 64),
             "ragged_63": (2, 63, 63, 12, 64), "ragged_65": (2, 65, 65, 12, 64),
             "cross_250x77": (2, 250, 77, 12, 128), "cross_1024x77": (2, 1024, 77, 12, 128),
             "cross_1024x77_d64": (2, 1024, 77, 12, 64)}
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

        kernel_ms, host_ms = timed_ms(torch, lambda: FL.flash_attention(q, k, v), 200)
        res = {
            "phase": "kernel", "kernel": "flash_attention", "case": name, "b": b, "lq": lq,
            "lk": lk, "h": h, "d": d, "max_abs_err": err, "tol": KERNEL_TOL, "rel_l2_err": rel,
            "rel_tol": KERNEL_REL_TOL, "kernel_ms": kernel_ms, "host_ms": host_ms,
            "plain_ms": gpu_ms(torch, lambda: FL.flash_attention_plain(q, k, v), 10),
            "library_ms": gpu_ms(torch, library_call, 50),
            # q and o, k and v: each read or written once
            **kernel_bound(2 * (q.numel() + k.numel()) * q.element_size(),
                           4 * b * h * lq * lk * d),
        }
        emit(res)
        results[name] = res
    return results


def gemm_kernel_phase(torch, dev):
    """K3 against its plain version at the probe's full shape, ragged M, M 4096 (every block
    walks several tiles), a K that is not a multiple of 128 and weights passed as a strided
    view: the chain's max abs error, each block's relative L2 error on the plain version's
    activations, and the chain's relative L2 error beside the plain chain's own drift from
    fp64 sums. Then repeated sweeps at the probe's shape, ten back to back and twenty
    replays of a captured sweep, each equal to the first bit for bit (the flags that carry
    the chain are reset before every sweep and race with nothing). Returns {case: result}."""
    from foley_tpu_torch.ops.kernels import gemm_sweep as GS
    from foley_tpu_torch.tools import probe_gemm as PG

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    gen = torch.Generator(device=dev).manual_seed(4)
    cases = {"probe_full": (PG.M, PG.K, PG.N, PG.BLOCKS, False),
             "ragged_1": (1, PG.K, PG.N, 2, False), "ragged_65": (65, PG.K, PG.N, 2, False),
             "k_192": (PG.M, 192, 576, 3, False), "strided_w": (PG.M, PG.K, PG.N, 4, True),
             "m_4096": (4096, PG.K, PG.N, 3, False)}
    results = {}
    for name, (m, k, n, blocks, strided) in cases.items():
        x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn(blocks, k, n, device=dev, generator=gen) / k ** 0.5).to(torch.bfloat16)
        wk = w[:, :, :k] if strided else w  # a view: the kernel reads it through its strides
        check(wk.is_contiguous() != strided, f"K3 {name}: the view is not what the case says")
        got = GS.gemm_sweep(x, wk)
        ref = GS.gemm_sweep_plain(x, w)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K3 {name}: non-finite kernel output")
        err = float((got.float() - ref.float()).abs().max())
        check(err <= KERNEL_TOL, f"K3 {name}: max abs error {err} > {KERNEL_TOL}")
        # the kernel's own error: each block on the plain version's activations
        xb, step = x, 0.0
        for b in range(blocks):
            nxt = GS.gemm_sweep_plain(xb, w[b:b + 1])
            step = max(step, rel(GS.gemm_sweep(xb, wk[b:b + 1]), nxt))
            xb = nxt
        check(step <= KERNEL_REL_TOL, f"K3 {name}: a block's relative L2 error {step} > "
                                      f"{KERNEL_REL_TOL}")
        chain, drift = rel(got, ref), rel(GS.gemm_sweep_plain(x, w, torch.float64), ref)
        chain_tol = max(KERNEL_REL_TOL, CHAIN_DRIFT * drift)
        check(chain <= chain_tol, f"K3 {name}: relative L2 error {chain} > {chain_tol} (the "
                                  f"plain chain drifts {drift} from fp64 sums)")
        res = {
            "phase": "kernel", "kernel": "gemm_sweep", "case": name, "m": m, "k": k, "n": n,
            "blocks": blocks, "strided_w": strided, "max_abs_err": err, "tol": KERNEL_TOL,
            "block_rel_l2_err": step, "rel_tol": KERNEL_REL_TOL, "rel_l2_err": chain,
            "plain_fp64_rel_l2": drift, "chain_rel_tol": chain_tol,
            "kernel_ms": gpu_ms(torch, lambda: GS.gemm_sweep(x, wk), 50),
            "plain_ms": gpu_ms(torch, lambda: GS.gemm_sweep_plain(x, w), 5),
            "library_ms": gpu_ms(torch, lambda: PG.library_sweep(x, w), 50),
            "library_full_ms": gpu_ms(torch, lambda: PG.library_sweep_full(x, w), 20),
            # the work the chain uses: x read and the last x written once, each block's
            # [K, K] head of the weights read once
            **kernel_bound(2 * m * k * 2 + blocks * k * k * 2, 2 * blocks * m * k * k),
        }
        emit(res)
        results[name] = res
        del x, w, wk, got, ref, xb, nxt
    emit(repeat_sweeps(torch, dev))
    return results


def repeat_sweeps(torch, dev) -> dict:
    """Ten eager sweeps back to back and twenty replays of a captured one, at the probe's
    shape, each compared with the first eager sweep bit for bit."""
    from foley_tpu_torch.ops.kernels import gemm_sweep as GS
    from foley_tpu_torch.tools import probe_gemm as PG

    x, w = PG.make_inputs(dev, seed=1)
    first = GS.gemm_sweep(x, w)
    eager = [torch.equal(GS.gemm_sweep(x, w), first) for _ in range(10)]
    check(all(eager), f"K3: repeated sweeps differ from the first ({eager})")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm up off the capture, as torch.cuda.graph asks
        GS.gemm_sweep(x, w)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = GS.gemm_sweep(x, w)
    replays = []
    for _ in range(20):
        out.zero_()
        graph.replay()
        replays.append(torch.equal(out, first))
    check(all(replays), f"K3: graph replays differ from the eager sweep ({replays})")
    return {"phase": "kernel", "kernel": "gemm_sweep", "case": "repeat_bit_for_bit",
            "eager_sweeps": len(eager), "graph_replays": len(replays), "identical": True}


def probe_gemm_phase(torch, dev) -> dict:
    """K3's path: the probe as a user runs it, at its full shape. Returns its record, with
    K3's launches over the run."""
    from foley_tpu_torch.ops.kernels import gemm_sweep as GS
    from foley_tpu_torch.tools import probe_gemm as PG

    t0 = time.perf_counter()
    GS.gemm_sweep.launches = 0
    rec = PG.measure(dev)
    launches = GS.gemm_sweep.launches
    check(rec["launches_per_sweep"] == 1,
          f"gemm_sweep launches a sweep {rec['launches_per_sweep']}, expected 1")
    check(launches == rec["kernel_sweeps"],
          f"gemm_sweep launches over the probe {launches}, expected {rec['kernel_sweeps']}")
    chain_tol = max(KERNEL_REL_TOL, CHAIN_DRIFT * rec["plain_fp64_rel_l2"])
    check(rec["max_abs_err"] <= KERNEL_TOL and rec["rel_l2_err"] <= chain_tol,
          f"probe: kernel against plain {rec['max_abs_err']} max abs, {rec['rel_l2_err']} rel L2 "
          f"(limits {KERNEL_TOL}, {chain_tol})")
    check(all(rec[v][t] > 0 for v in ("kernel", "library_sweep", "plain")
              for t in ("ms_per_sweep", "graph_ms_per_sweep")), "probe: a variant took no time")
    rec.update(phase="probe_gemm", launches_in_run=launches, seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


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


def check_audio(audio, rows: int, pipeline_cfg, duration_s=DURATION_S) -> float:
    """Finite, non-silent audio of the expected shape; returns its RMS."""
    import numpy as np

    n_samples = int(duration_s * pipeline_cfg.dac.sample_rate)
    check(audio.shape == (rows, 1, n_samples), f"audio shape {audio.shape}")
    check(bool(np.isfinite(audio).all()), "non-finite audio")
    rms = float(np.sqrt(np.mean(audio.astype(np.float64) ** 2)))
    check(rms > 0, "silent audio")
    return rms


def check_latents(torch, dev, latents, seed: int, pipeline_cfg, duration_s=DURATION_S):
    """What the denoiser controls: the final latents are finite, of a plausible scale, and
    far from the seed's initial noise (the generation's own draw, of which the latents of
    ``duration_s`` are the head). Returns (std, moved)."""
    import numpy as np

    from foley_tpu_torch.sampling.denoise import prepare_latents

    noise = prepare_latents(torch.Generator(device=dev).manual_seed(seed), 1,
                            pipeline_cfg.latent_length(duration_s),
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


def profiled(torch, request) -> dict:
    """Where a request's time goes: ``request`` (which ends in a synchronize) once
    unprofiled, then once under the profiler tracing the card alone (no host-side op
    recording, so the host runs close to its unprofiled pace). Busy time is the summed
    kernel time of that run, and the idle share is taken against the same run's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    return {"unprofiled_wall_s": plain_wall, "wall_s": wall, "device_busy_s": busy_s,
            "idle_share": 1.0 - busy_s / wall, "launches": sum(e.count for e in kernels),
            "groups": groups,
            "top": [{"name": e.key[:120], "ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in heaviest]}


def profile_phase(torch, bundle) -> None:
    """One main-path request, profiled (``profiled``)."""
    from foley_tpu_torch.pipeline.generate import generate_audio

    text = torch.zeros(1, 77, bundle.pipeline_cfg.model.condition_dim)

    def request():
        generate_audio(bundle, text, text, DURATION_S, guidance_scale=GUIDANCE,
                       num_inference_steps=STEPS, sampler="euler", seed=1)
        torch.cuda.synchronize()

    emit({"phase": "profile", **profiled(torch, request)})


def make_clip(np, seed: int, duration_s=DURATION_S, hw=CLIP_HW):
    """``duration_s`` of 25 fps RGB uint8 frames of ``hw`` (height, width) with smooth
    moving content: per-channel drifting sinusoidal gratings and a bright disc crossing the
    frame, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    h, w = hw
    n = int(duration_s * CLIP_FPS)
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    freq = rng.uniform(1.0, 4.0, (3, 2)).astype(np.float32)
    speed = rng.uniform(0.2, 1.0, 3).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    x0, y0, vx, vy = rng.uniform(0.1, 0.9, 4)
    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        s = t / CLIP_FPS
        cx, cy = (x0 + vx * s / duration_s) % 1.0, (y0 + vy * s / duration_s) % 1.0
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


class SeededTokenizer:
    """A stand-in for CLAP's RoBERTa tokenizer, whose files are not in the repository, with
    its call: each prompt becomes one random token id per character (at most
    ``max_length``), drawn from a seed made from the prompt; rows are padded to the
    longest."""

    def __init__(self, vocab_size: int, pad_token_id: int):
        self.vocab_size, self.pad_token_id = vocab_size, pad_token_id

    def __call__(self, prompts, padding, truncation, max_length, return_tensors):
        import zlib

        import numpy as np

        rows = [np.random.default_rng(zlib.crc32(p.encode())).integers(
            2, self.vocab_size, min(len(p), max_length)) for p in prompts]
        width = max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)], mask[i, :len(r)] = r, 1
        return {"input_ids": ids, "attention_mask": mask}


def clap_phase(torch, dev):
    """The CLAP text tower at laion/larger_clap_general's geometry (12 layers, hidden 768,
    12 heads, vocabulary 50265), random fp32 weights from a seed: the prompt and the
    negative prompt, one full row of 77 tokens and one padded row, through
    ``features.encode_text`` on the card, held against the same module on the CPU, with
    the default fp32 matmul precision and with ``"high"`` (TF32 outside ``true_fp32``).
    The control: the same encode with ``true_fp32`` bypassed under ``"high"`` (TF32 in
    every matmul) must break the bound, so that the bound tells TF32 from fp32.
    Returns (text_feat, uncond_text_feat) on the card."""
    import contextlib
    import copy

    from foley_tpu_torch.configs import ClapTextConfig
    from foley_tpu_torch.models import clap
    from foley_tpu_torch.ops.nn import true_fp32 as nn_true_fp32
    from foley_tpu_torch.pipeline.features import encode_text

    cfg = ClapTextConfig()
    cpu_model = clap.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    tokenizer = SeededTokenizer(cfg.vocab_size, cfg.pad_token_id)
    encoders = {"clap": clap.ClapTextEncoder(copy.deepcopy(cpu_model).to(dev), tokenizer)}
    tok = tokenizer([NEGATIVE_PROMPT, PROMPT], True, True, 77, "np")
    check(tok["attention_mask"].shape == (2, 77) and tok["attention_mask"][1].all()
          and not tok["attention_mask"][0].all(), "expected a padded and a full row of 77")
    ref = clap.apply(cpu_model, *(torch.from_numpy(tok[k])
                                  for k in ("input_ids", "attention_mask")))

    def encode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text, uncond = encode_text(encoders, PROMPT, NEGATIVE_PROMPT)
        torch.cuda.synchronize()
        return text, uncond, time.perf_counter() - t0

    def rel_l2(text, uncond):
        got = torch.cat([uncond, text]).cpu()
        check(bool(torch.isfinite(got).all()), "non-finite CLAP features")
        return float((got - ref).norm() / ref.norm())

    saved = torch.get_float32_matmul_precision()
    rel, walls = {}, []
    try:
        for precision in ("default", "high", "default"):
            torch.set_float32_matmul_precision(saved if precision == "default" else precision)
            text, uncond, wall = encode()
            walls.append(wall)
            rel[precision] = rel_l2(text, uncond)
            check(rel[precision] <= CLAP_REL_TOL, f"CLAP on the card ({precision} precision) "
                  f"{rel[precision]} from the CPU, limit {CLAP_REL_TOL}")
        torch.set_float32_matmul_precision("high")
        clap.true_fp32 = contextlib.nullcontext  # the control: TF32 let in
        rel["tf32"] = rel_l2(*encode()[:2])
    finally:
        clap.true_fp32 = nn_true_fp32
        torch.set_float32_matmul_precision(saved)
    check(rel["tf32"] > CLAP_REL_TOL, f"control: CLAP with TF32 reads {rel['tf32']} from the "
                                      f"CPU, within the limit {CLAP_REL_TOL}: the bound cannot "
                                      "tell TF32 from fp32")
    check(tuple(text.shape) == (1, 77, cfg.hidden_size), f"text features {tuple(text.shape)}")
    emit({"phase": "clap", "config": "larger_clap_general", "rows": 2, "tokens": 77,
          "padded_row_tokens": int(tok["attention_mask"][0].sum()), "default_precision": saved,
          "rel_l2_vs_cpu": rel["default"], "rel_l2_vs_cpu_high": rel["high"],
          "control_tf32_rel_l2_vs_cpu": rel["tf32"], "rel_tol": CLAP_REL_TOL, "encode_walls_s": walls,
          "feat_std": float(text.std())})
    return text, uncond


def longform_path_phase(torch, dev, bundle, pipeline_cfg, text, uncond):
    """XXL long-form on the main path's denoiser, with CLAP's text features: a 75 s T2A
    request in 30 s windows overlapping 5 s (the sampler node's long-form route past its
    60 s cap) batch and streamed, a continuation of it, an SDEdit of its first 5 s, a 24 s
    V2A request in 16 s windows, and one 30 s window profiled. Returns K1's launches in the
    75 s request and K2's in the V2A request."""
    import numpy as np

    from foley_tpu_torch.models import siglip2, synchformer
    from foley_tpu_torch.core.params import perturb_zero_leaves
    from foley_tpu_torch.ops.kernels import flash_attention as FL
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.pipeline.edit import edit_audio
    from foley_tpu_torch.pipeline.features import encode_video
    from foley_tpu_torch.pipeline.longform import (
        continue_audio,
        generate_audio_long,
        generate_audio_long_stream,
        plan_v2a_long,
        window_schedule,
    )

    cfg = pipeline_cfg.model
    sr = pipeline_cfg.dac.sample_rate
    per_step = cfg.depth_triple_blocks + cfg.depth_single_blocks
    kw = dict(guidance_scale=GUIDANCE, num_inference_steps=STEPS, sampler="euler")
    long_kw = dict(window_s=LONG_WINDOW_S, overlap_s=LONG_OVERLAP_S, **kw)
    sched = window_schedule(*(pipeline_cfg.latent_length(t)
                              for t in (LONG_S, LONG_WINDOW_S, LONG_OVERLAP_S)))
    check(sched == [(0, 0), (1250, 250), (2250, 500)], f"75 s schedule {sched}")
    out = {"phase": "longform_path", "config": "xxl", "duration_s": LONG_S,
           "window_s": LONG_WINDOW_S, "overlap_s": LONG_OVERLAP_S, "schedule": sched}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # T2A 75 s, batch then streamed
    FA.fused_qk_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res, out["t2a_wall_s"] = timed(lambda: generate_audio_long(
        bundle, text, uncond, LONG_S, seed=1, return_latents=True, **long_kw))
    long_launches = FA.fused_qk_attention.launches
    out["t2a_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = len(sched) * STEPS * per_step
    check(long_launches == expected, f"K1 launches in the 75 s request {long_launches}, "
                                     f"expected {expected}")
    check(res.audio_batch.shape == (1, 1, int(LONG_S * sr)), f"audio {res.audio_batch.shape}")
    out["t2a_rms"] = check_audio(res.audio_batch, 1, pipeline_cfg, LONG_S)
    out["t2a_latent_std"], out["t2a_latent_moved_rel_l2"] = check_latents(
        torch, dev, res.latents, 1, pipeline_cfg, LONG_S)

    FA.fused_qk_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    chunks, first_s = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ch in generate_audio_long_stream(bundle, text, uncond, LONG_S, seed=1, **long_kw):
        chunks.append(ch)
        if first_s is None:
            first_s = time.perf_counter() - t0
    out["stream_wall_s"] = time.perf_counter() - t0
    out["stream_first_chunk_s"] = first_s
    out["stream_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    check(FA.fused_qk_attention.launches == expected,
          f"K1 launches in the stream {FA.fused_qk_attention.launches}, expected {expected}")
    check([c.final for c in chunks] == [False] * (len(chunks) - 1) + [True],
          "only the last chunk is final")
    check(all(a.start_sample + a.audio.shape[-1] == b.start_sample
              for a, b in zip(chunks, chunks[1:])), "the stream's chunks are not contiguous")
    streamed = np.concatenate([c.audio for c in chunks], axis=-1)
    check(streamed.shape == res.audio_batch.shape, f"streamed {streamed.shape}")
    out["stream_chunks_s"] = [c.audio.shape[-1] / sr for c in chunks]
    out["stream_vs_batch_max_abs"] = float(np.abs(streamed - res.audio_batch).max())
    check(out["stream_vs_batch_max_abs"] <= STREAM_TOL,
          f"stream against batch {out['stream_vs_batch_max_abs']} > {STREAM_TOL}")

    # continuation: 10 s after the last 4 s, one window of 700 frames with 200 known
    FA.fused_qk_attention.launches = 0
    cont, out["continue_wall_s"] = timed(lambda: continue_audio(
        bundle, res.audio_batch[0, 0], text, uncond, CONTINUE_S, context_s=CONTEXT_S,
        seed=2, **long_kw))
    check(cont.timings["windows"] == 1.0 and cont.timings["context_frames"] == 200.0,
          f"continuation plan {cont.timings}")
    check(FA.fused_qk_attention.launches == STEPS * per_step, "continuation: K1 launches "
          f"{FA.fused_qk_attention.launches}, expected {STEPS * per_step}")
    out["continue_rms"] = check_audio(cont.audio_batch, 1, pipeline_cfg, CONTINUE_S)

    # SDEdit of the first 5 s at strength 0.6: steps 20..49
    FA.fused_qk_attention.launches = 0
    edited, out["edit_wall_s"] = timed(lambda: edit_audio(
        bundle, res.audio_batch[0, 0, :int(DURATION_S * sr)], text, uncond,
        strength=EDIT_STRENGTH, seed=3, **kw))
    edit_steps = STEPS - round((1.0 - EDIT_STRENGTH) * STEPS)
    check(FA.fused_qk_attention.launches == edit_steps * per_step, "edit: K1 launches "
          f"{FA.fused_qk_attention.launches}, expected {edit_steps * per_step}")
    out["edit_rms"] = check_audio(edited.audio_batch, 1, pipeline_cfg)

    # V2A 24 s: the full clip's features, two 16 s windows at 0 and 8 s
    encoders = {"siglip2": siglip2.init_random(0, cfg.clip_dim, device=dev, dtype=torch.bfloat16),
                "synchformer": synchformer.init_random(1, cfg.sync_feat_dim, device=dev,
                                                       dtype=torch.bfloat16)}
    gen = torch.Generator(device=dev).manual_seed(3)
    for enc in encoders.values():
        perturb_zero_leaves(enc.model, gen)
    feat_s, win_s, ov_s = plan_v2a_long(pipeline_cfg, V2A_LONG_S, window_s=16.0, overlap_s=4.0)
    check((feat_s, win_s, ov_s) == (24.0, 16.0, 8.0), f"V2A plan {(feat_s, win_s, ov_s)}")
    frames = make_clip(np, 1, V2A_LONG_S, V2A_LONG_HW)
    FA.fused_qk_attention.launches = FL.flash_attention.launches = 0
    (clip, sync), out["v2a_encode_s"] = timed(lambda: encode_video(
        encoders, frames, CLIP_FPS, feat_s, pipeline_cfg))
    v2a, out["v2a_generate_s"] = timed(lambda: generate_audio_long(
        bundle, text, uncond, V2A_LONG_S, clip_feat=clip, sync_feat=sync, window_s=win_s,
        overlap_s=ov_s, seed=4, **kw))
    out["v2a_k1_launches"] = FA.fused_qk_attention.launches
    out["v2a_k2_launches"] = FL.flash_attention.launches
    check(v2a.timings["windows"] == 2.0, f"V2A windows {v2a.timings['windows']}")
    check(out["v2a_k1_launches"] == 2 * STEPS * per_step, "V2A: K1 launches "
          f"{out['v2a_k1_launches']}, expected {2 * STEPS * per_step}")
    per_k2 = encoders["siglip2"].cfg.num_hidden_layers
    check(out["v2a_k2_launches"] == per_k2, f"V2A: K2 launches {out['v2a_k2_launches']}, "
                                            f"expected {per_k2}")
    out["v2a_rms"] = check_audio(v2a.audio_batch, 1, pipeline_cfg, V2A_LONG_S)
    out["v2a_clip"] = [len(frames), *V2A_LONG_HW, CLIP_FPS]
    del frames, encoders

    # one 30 s window (a single-window request), profiled
    def window():
        generate_audio_long(bundle, text, uncond, LONG_WINDOW_S, seed=5, **long_kw)
        torch.cuda.synchronize()

    prof = profiled(torch, window)
    k1 = prof["groups"].get("fused_qk_attention", {"ms": 0.0})
    prof["k1_share_of_busy"] = k1["ms"] / 1e3 / prof["device_busy_s"]
    check(k1["ms"] > 0, "the profiled window ran no fused_qk_attention kernel")
    out["window_30s_profile"] = prof
    emit(out)
    return long_launches, out["v2a_k2_launches"]


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
    gemm = gemm_kernel_phase(torch, dev)
    probe = probe_gemm_phase(torch, dev)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = perturb_zero_leaves(mmdit.init(cfg, gen, device=dev, dtype=torch.bfloat16), gen)
    dac = dac_vae.init(XXL.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    emit({"phase": "init", "seconds": time.perf_counter() - t0,
          "mmdit_params": param_count(model),
          "dac_decoder_params": param_count(dac.decoder) + param_count(dac.post_quant_conv),
          "dac_encoder_params": param_count(dac.encoder) + param_count(dac.quant_conv)})
    forward_phase(torch, dev, model, cfg, XXL)
    bundle = ModelBundle(model, dac, XXL, compute_dtype=torch.bfloat16)
    launches, t2a_latents = main_path_phase(torch, dev, bundle, XXL)
    profile_phase(torch, bundle)
    flash_launches = v2a_path_phase(torch, dev, bundle, XXL, t2a_latents)
    text, uncond = clap_phase(torch, dev)
    long_k1, long_k2 = longform_path_phase(torch, dev, bundle, XXL, text, uncond)

    # per-launch figures weighted by the main path's mix: each step runs one joint call per
    # triple block and one single call per single block
    mix = {"joint_5s": cfg.depth_triple_blocks, "single_5s": cfg.depth_single_blocks}

    def avg(key):
        return sum(kernel[c][key] * n for c, n in mix.items()) / sum(mix.values())

    k1_bound = kernel_bound(avg("bytes"), avg("flops"))
    k2 = flash["siglip2_5s"]  # the main V2A path's shape (the 24 s run's is siglip2_24s)
    k3_bound = gemm["probe_full"]  # the probe's shape: one sweep of the probe
    emit({"kernels": [{
        "name": "fused_qk_attention", "route": "cuda",
        "source": "foley_tpu_torch/csrc/fused_qk_attention.cu",
        "replaces": "foley_tpu/ops/pallas/fused_attention.py:82",
        "launches": launches, "launches_longform": long_k1,
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
        "ms": avg("kernel_ms"), "plain_ms": avg("plain_ms"), "bound_ms": k1_bound["bound_ms"],
        "bound_by": k1_bound["bound_by"],
        "library_ms": avg("library_ms"),
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "foley_tpu_torch/csrc/flash_attention.cu",
        "replaces": "foley_tpu/ops/pallas/flash_attention.py:60",
        "launches": flash_launches, "launches_longform": long_k2,
        "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
        "ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
    }, {
        "name": "gemm_sweep", "route": "cuda",
        "source": "foley_tpu_torch/csrc/gemm_sweep.cu",
        "replaces": "tools/probe_gemm_pallas.py:93",
        "launches": probe["launches_per_sweep"],
        "max_abs_err": max([r["max_abs_err"] for r in gemm.values()] + [probe["max_abs_err"]]),
        # device times from graph replays: the eager library sweep (72 calls) is bound by
        # the host's launches, not by the card
        "ms": probe["kernel"]["graph_ms_per_sweep"],
        "plain_ms": probe["plain"]["graph_ms_per_sweep"],
        "bound_ms": k3_bound["bound_ms"], "bound_by": k3_bound["bound_by"],
        "library_ms": probe["library_sweep"]["graph_ms_per_sweep"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
