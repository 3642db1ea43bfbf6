#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``foley_tpu_torch``) on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA card: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``foley_tpu_torch/csrc`` (into
``build/torch_kernels/``), then prints one JSON line per phase:

- ``device``: the card (``nvidia-smi`` name and power limit, also printed raw on a line of
  its own), torch and CUDA versions;
- ``build``: the four kernel libraries (K1 and K2 in bf16 / fp16, their fp32 kernels, K3),
  built in parallel: seconds per library and what ptxas reported;
- ``kernel``: one line per kernel and shape: the fused qk-norm + RoPE attention kernel (K1,
  at every shape a path below gives it: the 5 s request's, the 30 s long-form window's, the
  14 s continuation window's and the 16 s V2A window's, and ragged lengths), the
  flash-attention kernel (K2, at SigLIP2's 5 s and 24 s batches of frames among others) and
  the chained GEMM sweep (K3) against their plain
  PyTorch versions in bf16 (max abs and relative L2 errors and their tolerances), with the
  kernel's device time (and, for K1 and K2, the wrapper's host time a launch), the plain
  version's and the library call's times and the card's bound for the work (K3's also with
  the tool's full-width library sweep); then K1 and K2 in fp16 (within the bf16 tolerances)
  and fp32 (the 3xTF32 kernels, within 1e-5 relative L2 of the plain version in true fp32,
  with the control, the plain version under TF32, outside that bound), each with its times
  and bound (fp32 with two: three TF32 tensor-core products a product, and the CUDA cores'
  fp32 rate);
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
- ``nodes``: the node API on the ``main_path`` bundle: its DAC written as a reference-layout
  ``.safetensors`` under ``build/`` and read back through ``HunyuanDependenciesLoader``
  (every weight equal, the write and load seconds); the sampler node on 5 s T2A twice with
  ``force_offload`` (the same bytes, equal to ``generate_audio``'s; park and restore
  seconds, peak memory), once on 5 s of a 640x360 clip through ``image``, once on a batch of
  2 for ``SelectAudioFromBatch``; the dependencies loader at fp16 with fp16 encoders
  encoding through the node (12 fp16 K2 launches);
- ``serving``: the HTTP server on 127.0.0.1 around a ``FoleyService`` on the same bundle,
  CLAP and the video encoders, warmed at 5 s: one line per request (T2A as WAV and as JSON,
  ``frames_b64`` V2A, the PCM16 stream, a 2 s continuation of a 4 s context) with the
  client's wall, the generation and CLAP inside it, the server's own share and K1's and
  K2's launches; then a ``BatchingFoleyService`` coalescing two concurrent requests into one
  batch-2 call, each row's latents against its solo request;
- ``precision``: the XXL denoiser in fp16 and in fp32 (``HunyuanModelLoader.init_random``,
  one at a time): a 5 s forward through the kernels against the plain attention, fp32 also
  under ``"high"`` matmul precision (equal within 1e-5); SigLIP2 and Synchformer in the same
  type encoding the 5 s 1280x720 clip, 12 K2 launches of that type, SigLIP2's features
  against the plain attention;
- ``cli``: ``foley_tpu_torch.cli.main`` in this process, XXL 5 s T2A with 50 steps in fp16
  and in fp32: the WAV (48 kHz, mono, 240,000 frames, non-silent), 2,700 K1 launches of the
  type and the wall;
- ``{"kernels": [...]}``: every ported kernel with its launches on its path (K1 in
  ``main_path`` and, as ``launches_longform``, in the 75 s request and, as
  ``launches_serving``, over the ``serving`` requests; K2 in ``v2a_path``, the 24 s V2A
  request and the served V2A request; K3 in one sweep of ``probe_gemm``; K3's times are the
  probe's graph-replayed device times), then the fp16 and fp32 kernels of K1 (launches in
  the ``cli`` request of their type) and K2 (launches in the ``precision`` encode of their
  type);
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
BF16_FLOPS = 989e12        # H100 SXM dense bf16 (and fp16) tensor-core peak
FP32_FLOPS = 67e12         # H100 SXM fp32 on the CUDA cores: the parent's fp32 kernels' bound
TF32_FLOPS = 495e12        # H100 SXM dense TF32 tensor-core peak
TF32_PASSES = 3            # the fp32 kernels form each product from three TF32 ones (3xTF32)
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
KERNEL_LIBS = ("fused_qk_attention", "flash_attention", "gemm_sweep", "attention_f32")
CLIP_FPS, CLIP_HW = 25, (720, 1280)  # the V2A source clip: 5 s of 25 fps 1280x720 RGB
CLAP_REL_TOL = 1e-5        # CLAP fp32 on the card against the CPU, relative L2 (fp32 reads
                           # ~7e-7; the phase's control, TF32 let in, ~4e-4 and must break it)
PROMPT = "a glass bottle shatters on a stone floor while heavy rain drums on a tin roof"  # 77
NEGATIVE_PROMPT = "noisy, harsh"
LONG_S, LONG_WINDOW_S, LONG_OVERLAP_S = 75.0, 30.0, 5.0  # past the sampler node's 60 s cap
CONTINUE_S, CONTEXT_S = 10.0, 4.0
EDIT_STRENGTH = 0.6
V2A_LONG_S, V2A_LONG_HW = 24.0, (360, 640)  # 24 s of 25 fps 640x360 RGB
CONT_SERVE_S = 2.0         # the served continuation: 2 s after the last CONTEXT_S of a request
STREAM_TOL = 1.5 / 32767   # stream against batch: the same decodes, at most a PCM step apart
FP32_KERNEL_REL_TOL = 1e-5  # fp32 K1 / K2 against the plain version in true fp32, relative L2:
                            # their 3xTF32 products drop a_lo.b_lo (2^-22 of a product) and
                            # sum in another order, ~1e-6; the control, the plain version with
                            # TF32 let in (one pass), must land outside it
FP32_MODEL_REL_TOL = 1e-5   # the fp32 XXL velocity and SigLIP2 features, kernel against plain
                            # attention, relative L2: read 4.8e-7 and 6.7e-7 on an H100 with
                            # the CUDA-core fp32 kernels; a single TF32 pass reads ~4e-4, so
                            # 1e-5 holds the 3xTF32 kernels to fp32's accuracy


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


def kernel_bound(n_bytes: int, flops: int, peak: float = BF16_FLOPS, passes: int = 1) -> dict:
    """The least time the card takes for the work: bytes at the memory rate or operations at
    ``peak`` (the tensor cores' bf16 / fp16 rate unless given), each operation done
    ``passes`` times (3 for the fp32 kernels' 3xTF32 at ``TF32_FLOPS``)."""
    bound = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": passes * flops / peak * 1e3}
    return {"bytes": n_bytes, "flops": flops, "bound_ms": max(bound.values()),
            "bound_by": max(bound, key=bound.get)}


def fp32_bound(n_bytes: int, flops: int) -> dict:
    """An fp32 kernel's two bounds: ``bound_ms`` at three TF32 tensor-core products a
    product (the least time for fp32-accurate attention on the tensor cores: the 3xTF32
    kernels' bound), and ``bound_cuda_core_ms`` at the CUDA cores' fp32 rate (the bound the
    CUDA-core kernels they replaced were held to)."""
    cuda_core = kernel_bound(n_bytes, flops, FP32_FLOPS)
    return {**kernel_bound(n_bytes, flops, TF32_FLOPS, TF32_PASSES),
            "bound_cuda_core_ms": cuda_core["bound_ms"],
            "bound_cuda_core_by": cuda_core["bound_by"]}


def with_shares(res: dict) -> dict:
    """``res`` with each bound's share of the kernel's time (1 is the bound)."""
    res["bound_share"] = res["bound_ms"] / res["kernel_ms"]
    if "bound_cuda_core_ms" in res:
        res["bound_cuda_core_share"] = res["bound_cuda_core_ms"] / res["kernel_ms"]
    return res


def k1_cases(torch, dev, cfg, gen) -> dict:
    """K1's cases at every shape a path gives it: {name: (length, streams, [wq, wk, cq, sq,
    ck, sk])}, the fp32 tables as the denoiser builds them (``streams``: the norm weights'
    [D] rows a call is made of)."""
    from foley_tpu_torch.models.mmdit import build_rope_tables
    from foley_tpu_torch.ops.rope import rope_table

    d = cfg.head_dim

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

    return {"joint_5s": joint_case(250, 40), "single_5s": single_case(250),
            "ragged_1": single_case(1), "ragged_63": single_case(63),
            "ragged_64": single_case(64), "ragged_65": single_case(65),
            "ragged_128": single_case(128), "joint_30s": joint_case(1500, 240),
            "single_30s": single_case(1500), "joint_cont": joint_case(700, 112),
            "single_cont": single_case(700), "joint_v2a16": joint_case(800, 128),
            "single_v2a16": single_case(800)}


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
    from foley_tpu_torch.ops.kernels import fused_attention as FA

    b, h, d = 2, cfg.num_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = k1_cases(torch, dev, cfg, gen)
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
    Returns (text_feat, uncond_text_feat) on the card and the encoder."""
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
    return text, uncond, encoders["clap"]


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


def random_video_encoders(torch, dev, pipeline_cfg, dtype=None) -> dict:
    """SigLIP2 and Synchformer at their real geometry, random weights of ``dtype`` (bf16
    unless given) from a seed with the zero leaves perturbed, as ``v2a_path`` makes them."""
    from foley_tpu_torch.core.params import perturb_zero_leaves
    from foley_tpu_torch.models import siglip2, synchformer

    cfg = pipeline_cfg.model
    dtype = dtype or torch.bfloat16
    encoders = {"siglip2": siglip2.init_random(0, cfg.clip_dim, device=dev, dtype=dtype),
                "synchformer": synchformer.init_random(1, cfg.sync_feat_dim, device=dev,
                                                       dtype=dtype)}
    gen = torch.Generator(device=dev).manual_seed(3)
    for enc in encoders.values():
        perturb_zero_leaves(enc.model, gen)
    return encoders


def nodes_phase(torch, dev, bundle, pipeline_cfg, clap_encoder, video_encoders) -> None:
    """The node API at XXL on the main path's bundle. The bundle's DAC is written as a
    reference-layout ``.safetensors`` under ``build/`` and read back through
    ``HunyuanDependenciesLoader`` (the port's own reader: the card's machine has no
    safetensors package), every weight equal; the sampler node, with ``force_offload``,
    twice on 5 s T2A (50 Euler steps, CFG 4.5; the same bytes, the park and restore
    seconds), its ``audio_first`` against ``generate_audio`` on the same bundle and seed bit
    for bit; one 5 s V2A call through ``image`` (640x360); ``SelectAudioFromBatch`` on a
    batch of 2; and the dependencies loader at fp16 (the reference's GPU default for the
    visual encoders), whose fp16 encoders encode through the node with 12 fp16 K2 launches."""
    import os

    import numpy as np

    from foley_tpu_torch.api import nodes
    from foley_tpu_torch.io.convert import dac_reference_state_dict, save_safetensors
    from foley_tpu_torch.ops.kernels import flash_attention as FL
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.kernels.common import reset_launches
    from foley_tpu_torch.pipeline.features import encode_text
    from foley_tpu_torch.pipeline.generate import generate_audio

    t_phase = time.perf_counter()
    cfg = pipeline_cfg.model
    per_k1 = STEPS * (cfg.depth_triple_blocks + cfg.depth_single_blocks)
    out = {"phase": "nodes", "config": "xxl", "duration_s": DURATION_S, "steps": STEPS}

    # the DAC through a reference-layout checkpoint and the dependencies loader
    state = {k: v.detach().cpu() for k, v in bundle.dac.state_dict().items()}
    os.makedirs("build/chip_smoke", exist_ok=True)
    path = "build/chip_smoke/vae_128d_48k.safetensors"
    t0 = time.perf_counter()
    save_safetensors(path, dac_reference_state_dict(state, pipeline_cfg.dac))
    out["dac_write_s"] = time.perf_counter() - t0
    out["dac_checkpoint_bytes"] = os.path.getsize(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (deps,) = nodes.HunyuanDependenciesLoader().load_dependencies(
        path, synchformer_model="", precision="bf16", device=dev)
    torch.cuda.synchronize()
    out["dac_load_s"] = time.perf_counter() - t0
    out["dac_load_gb_per_s"] = out["dac_checkpoint_bytes"] / out["dac_load_s"] / 1e9
    # the loader at fp16, the reference's own GPU default for the visual encoders: it loads,
    # and the sampler node's encode runs fp16 encoders through K2's fp16 kernel
    (deps16,) = nodes.HunyuanDependenciesLoader().load_dependencies(
        path, synchformer_model="", precision="fp16", device=dev)
    os.remove(path)
    loaded = deps["dac_params"].state_dict()
    check(deps["dac_cfg"] == pipeline_cfg.dac, f"DAC config read as {deps['dac_cfg']}")
    check(sorted(loaded) == sorted(state) and all(
        torch.equal(loaded[k].cpu(), state[k]) for k in state),
        "the DAC read back from its checkpoint differs from the bundle's")
    out["dac_tensors"] = len(state)
    del state, loaded

    deps.update(clap=clap_encoder, **video_encoders)
    foley_model = {"params": bundle.mmdit, "cfg": pipeline_cfg, "dtype": bundle.compute_dtype}
    sampler = nodes.HunyuanFoleySampler()
    kw = dict(prompt=PROMPT, negative_prompt=NEGATIVE_PROMPT, duration=DURATION_S,
              cfg_scale=GUIDANCE, steps=STEPS, sampler="euler", seed=7)

    text, uncond = encode_text(deps, PROMPT, NEGATIVE_PROMPT)
    ref = generate_audio(bundle, text, uncond, DURATION_S, guidance_scale=GUIDANCE,
                         num_inference_steps=STEPS, sampler="euler", seed=7)
    torch.cuda.reset_peak_memory_stats()
    runs, parks, walls = [], [], []
    for _ in range(2):
        FA.fused_qk_attention.launches = 0
        t0 = time.perf_counter()
        first, batch = sampler.generate_audio(foley_model, deps, force_offload=True, **kw)
        walls.append(time.perf_counter() - t0)
        check(FA.fused_qk_attention.launches == per_k1,
              f"sampler node: K1 launches {FA.fused_qk_attention.launches}, expected {per_k1}")
        check(foley_model["_offloaded"] and next(bundle.mmdit.parameters()).device.type == "cpu",
              "force_offload left the denoiser on the card")
        runs.append(first["waveform"])
        parks.append(foley_model["_park_s"])
    out["t2a_walls_s"] = walls
    out["park_s"] = parks  # the first also page-locks the host buffers
    out["restore_s"] = foley_model["_restore_s"]
    out["parked_gib"] = foley_model["_host"].flat.numel() / 2 ** 30
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    check(runs[0].tobytes() == runs[1].tobytes(), "force_offload: two calls differ")
    check(runs[0].tobytes() == ref.audio_first.tobytes(),
          "the sampler node's audio_first differs from generate_audio's")
    out["t2a_rms"] = check_audio(runs[0], 1, pipeline_cfg, DURATION_S)
    nodes._resident_params(foley_model)
    check(all(p.device == dev or p.device.type == "cuda" for p in bundle.mmdit.parameters()),
          "the restore left a parameter off the card")

    # V2A through ``image``: 5 s of the 640x360 clip
    frames = make_clip(np, 1, DURATION_S, V2A_LONG_HW)
    FA.fused_qk_attention.launches = FL.flash_attention.launches = 0
    t0 = time.perf_counter()
    v2a, _ = sampler.generate_audio(foley_model, deps, frame_rate=CLIP_FPS, image=frames,
                                    force_offload=False, **kw)
    out["v2a_wall_s"] = time.perf_counter() - t0
    out["v2a_k1_launches"] = FA.fused_qk_attention.launches
    out["v2a_k2_launches"] = FL.flash_attention.launches
    check(out["v2a_k1_launches"] == per_k1 and out["v2a_k2_launches"]
          == video_encoders["siglip2"].cfg.num_hidden_layers,
          f"V2A node launches K1 {out['v2a_k1_launches']}, K2 {out['v2a_k2_launches']}")
    out["v2a_rms"] = check_audio(v2a["waveform"], 1, pipeline_cfg, DURATION_S)
    check(np.abs(v2a["waveform"] - runs[0]).max() > 0, "the video does not reach the audio")

    # a batch of 2, then one row of it
    _, batch2 = sampler.generate_audio(foley_model, deps, force_offload=False,
                                       **dict(kw, batch_size=2))
    check_audio(batch2["waveform"], 2, pipeline_cfg, DURATION_S)
    (row,) = nodes.SelectAudioFromBatch().select_audio(batch2, 1)
    check(row["waveform"].tobytes() == batch2["waveform"][1:2].tobytes(),
          "SelectAudioFromBatch picked another row")
    (clamped,) = nodes.SelectAudioFromBatch().select_audio(batch2, 5)
    check(clamped["waveform"].tobytes() == row["waveform"].tobytes(), "index not clamped")

    # the dependencies loaded at fp16, with fp16 video encoders, through the node's encode
    deps16.update(random_video_encoders(torch, dev, pipeline_cfg, torch.float16))
    reset_launches(FL.flash_attention)
    t0 = time.perf_counter()
    clip16, sync16 = nodes.HunyuanFoleySampler._encode_video(deps16, frames, CLIP_FPS,
                                                             DURATION_S, pipeline_cfg)
    torch.cuda.synchronize()
    out["fp16_encode_s"] = time.perf_counter() - t0
    out["fp16_k2_launches"] = FL.flash_attention.launches_by_dtype.get(torch.float16, 0)
    check(out["fp16_k2_launches"] == deps16["siglip2"].cfg.num_hidden_layers,
          f"fp16 dependencies: K2 launches {FL.flash_attention.launches_by_dtype}")
    check(bool(torch.isfinite(clip16).all() and torch.isfinite(sync16).all())
          and float(clip16.std()) > 0, "fp16 dependencies: non-finite or constant features")
    del deps, deps16, clip16, sync16
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)


def serving_phase(torch, dev, bundle, pipeline_cfg, clap_encoder, video_encoders):
    """The HTTP server at XXL on the main path's bundle: ``create_server`` on 127.0.0.1
    around a ``FoleyService`` (CLAP and the video encoders) warmed at 5 s, then over HTTP a
    5 s T2A request as WAV and as JSON (the same samples), a ``frames_b64`` V2A request (K2
    from the handler thread), the PCM16 stream (equal to the WAV), a 2 s continuation of a
    4 s context, ``/healthz`` and ``/metrics``. Per request: the client's wall, the
    generation inside it and the server's own share. Then a ``BatchingFoleyService``
    (``max_batch=2``): two concurrent requests coalesced into one batch-2 call, each row's
    latents within 1e-5 of its request served alone. Returns K1's and K2's launches over
    the served requests."""
    import base64
    import io
    import threading
    import urllib.request
    import wave
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from foley_tpu_torch.ops.kernels import flash_attention as FL
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.pipeline import generate as gen_mod
    from foley_tpu_torch.pipeline.features import encode_text
    from foley_tpu_torch.serving import server as srv_mod

    t_phase = time.perf_counter()
    cfg = pipeline_cfg.model
    sr = pipeline_cfg.dac.sample_rate
    per_k1 = STEPS * (cfg.depth_triple_blocks + cfg.depth_single_blocks)
    per_k2 = video_encoders["siglip2"].cfg.num_hidden_layers
    inner = {}

    def timing(name, fn):  # the seconds a wrapped call took, on the card's clock
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            inner[name] = inner.get(name, 0.0) + time.perf_counter() - t0
            return res
        return wrapped

    originals = {n: getattr(srv_mod, n) for n in ("generate_audio", "continue_audio",
                                                  "generate_audio_multi")}
    for n in ("generate_audio", "continue_audio"):
        setattr(srv_mod, n, timing("generate_s", originals[n]))
    service = srv_mod.FoleyService(bundle, clap_encoder, durations=(DURATION_S,),
                                   default_steps=STEPS, video_encoders=video_encoders,
                                   v2a_warmup_hw=V2A_LONG_HW)
    service._text = timing("clap_s", service._text)
    service._visual_features = timing("video_encode_s", service._visual_features)
    t0 = time.perf_counter()
    service.warmup()
    warm_s = time.perf_counter() - t0
    httpd = srv_mod.create_server(service, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    base = {"prompt": PROMPT, "negative_prompt": NEGATIVE_PROMPT, "duration": DURATION_S,
            "steps": STEPS, "cfg_scale": GUIDANCE, "seed": 11}
    results, k1_total, k2_total = [], 0, 0

    def post(name, body, host=url):
        nonlocal k1_total, k2_total
        inner.clear()
        FA.fused_qk_attention.launches = FL.flash_attention.launches = 0
        data = json.dumps(body).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(host + "/generate", data=data),
                                    timeout=600) as r:
            payload, headers = r.read(), dict(r.headers)
        wall = time.perf_counter() - t0
        k1, k2 = FA.fused_qk_attention.launches, FL.flash_attention.launches
        k1_total, k2_total = k1_total + k1, k2_total + k2
        rec = {"phase": "serving", "request": name, "client_wall_s": wall,
               "request_bytes": len(data), "response_bytes": len(payload), **inner,
               "server_share_s": wall - sum(inner.values()), "k1_launches": k1,
               "k2_launches": k2}
        emit(rec)
        results.append(rec)
        return payload, headers, rec

    def samples(wav_bytes, frames):
        with wave.open(io.BytesIO(wav_bytes)) as f:
            check((f.getframerate(), f.getnchannels(), f.getsampwidth(), f.getnframes())
                  == (sr, 1, 2, frames), f"WAV {f.getparams()}")
            return np.frombuffer(f.readframes(frames), "<i2")

    try:
        n = int(DURATION_S * sr)
        wav, headers, rec = post("t2a_wav", base)
        check(headers["Content-Type"] == "audio/wav", f"content type {headers['Content-Type']}")
        pcm = samples(wav, n)
        check(np.abs(pcm).max() > 0, "silent WAV")
        check(rec["k1_launches"] == per_k1, f"T2A request: K1 {rec['k1_launches']}")
        js, _, _ = post("t2a_json", dict(base, response="json"))
        check(base64.b64decode(json.loads(js)["audio_base64"]) == wav,
              "the JSON response's audio differs from the WAV")
        frames = make_clip(np, 1, DURATION_S, V2A_LONG_HW)
        buf = io.BytesIO()
        np.savez(buf, frames=frames)
        v2a_body = dict(base, frames_b64=base64.b64encode(buf.getvalue()).decode(),
                        frames_fps=float(CLIP_FPS))
        del buf
        v2a, _, rec = post("v2a_frames_b64", v2a_body)
        del v2a_body
        check(rec["k2_launches"] == per_k2 and rec["k1_launches"] == per_k1,
              f"V2A request: K1 {rec['k1_launches']}, K2 {rec['k2_launches']}")
        check(np.abs(samples(v2a, n).astype(np.int32) - pcm).max() > 0,
              "the V2A request's audio equals the T2A request's")
        stream, headers, _ = post("t2a_pcm16_stream", dict(base, response="pcm16_stream"))
        check(headers["X-Total-Samples"] == str(n) and stream == pcm.tobytes(),
              "the PCM16 stream differs from the WAV")
        cont, _, rec = post("continuation", dict(
            base, duration=CONT_SERVE_S, context_s=CONTEXT_S,
            continue_b64=base64.b64encode(wav).decode()))
        check(rec["k1_launches"] == per_k1, f"continuation: K1 {rec['k1_launches']}")
        check(np.abs(samples(cont, int(CONT_SERVE_S * sr))).max() > 0, "silent continuation")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        check(health["status"] == "ok" and health["warm_buckets"] == [[DURATION_S, 1, 77]],
              f"/healthz {health}")
        check(metrics["requests_total"] == len(results) and metrics["failures_total"] == 0
              and metrics["in_flight"] == 0, f"/metrics {metrics}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        for n_, fn in originals.items():
            setattr(srv_mod, n_, fn)

    # two concurrent requests coalesced into one batch-2 call, each row against its solo run;
    # the batch's rows come in the order the requests arrived, which the two clients race
    # for, so each request's row is the one that carries its seed
    multi = []

    def multi_latents(*a, **k):  # generate_audio_multi(bundle, text, uncond, duration, seeds)
        res = originals["generate_audio_multi"](*a, return_latents=True, **k)
        multi.append((list(k["seeds"] if "seeds" in k else a[4]), res))
        return res

    srv_mod.generate_audio_multi = multi_latents
    batching = srv_mod.BatchingFoleyService(bundle, clap_encoder, durations=(DURATION_S,),
                                            default_steps=STEPS, max_batch=2,
                                            batch_window_s=0.5)
    httpd = srv_mod.create_server(batching, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    burl = f"http://127.0.0.1:{httpd.server_address[1]}"
    pair = [dict(base, prompt=PROMPT, seed=21), dict(base, prompt="heavy footsteps on gravel",
                                                     seed=22)]
    try:
        FA.fused_qk_attention.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as ex:
            outs = list(ex.map(lambda b: urllib.request.urlopen(urllib.request.Request(
                burl + "/generate", data=json.dumps(b).encode()), timeout=600).read(), pair))
        coalesced_s = time.perf_counter() - t0
        k1 = FA.fused_qk_attention.launches
        k1_total += k1
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv_mod.generate_audio_multi = originals["generate_audio_multi"]
    check(len(multi) == 1 and multi[0][1].latents.shape[0] == 2,
          f"the two requests ran as {len(multi)} calls, not one batch of 2")
    row_seeds, batch = multi[0]
    check(sorted(row_seeds) == sorted(body["seed"] for body in pair),
          f"the batch's rows carry seeds {row_seeds}")
    check(k1 == per_k1, f"the coalesced call: K1 {k1}, expected {per_k1}")
    deps = {"clap": clap_encoder}
    rows = []
    for i, body in enumerate(pair):
        text, uncond = encode_text(deps, body["prompt"], body["negative_prompt"])
        solo = gen_mod.generate_audio(bundle, text, uncond, DURATION_S, guidance_scale=GUIDANCE,
                                      num_inference_steps=STEPS, seed=body["seed"],
                                      return_latents=True)
        diff = np.abs(batch.latents[row_seeds.index(body["seed"])] - solo.latents[0])
        ok = bool((diff <= 1e-5 + 1e-5 * np.abs(solo.latents[0])).all())
        rows.append(float(diff.max()))
        check(ok, f"coalesced row {i}: latents {float(diff.max())} from its solo run")
        check(samples(outs[i], n).shape == (n,), "coalesced WAV")
    solo_walls = [r["client_wall_s"] for r in results if r["request"] == "t2a_wav"]
    emit({"phase": "serving", "request": "coalesced_pair", "client_wall_s": coalesced_s,
          "solo_t2a_wall_s": solo_walls[0], "rows_max_abs_latent_diff": rows,
          "row_seeds": row_seeds,
          "k1_launches": k1, "warmup_s": warm_s,
          "phase_seconds": time.perf_counter() - t_phase})
    return k1_total, k2_total


# K1's fp16 / fp32 cases (names of ``k1_cases``), and K2's: (B, Lq, Lk, H, D)
K1_VARIANT_CASES = ("joint_5s", "single_5s", "ragged_1", "ragged_63", "ragged_65", "joint_30s",
                    "single_30s")
K2_VARIANT_CASES = {"fp16": {"siglip2_5s": (40, 1024, 1024, 12, 64),
                             "siglip2_24s": (192, 1024, 1024, 12, 64),
                             "ragged_1": (2, 1, 1, 12, 64), "ragged_65": (2, 65, 65, 12, 64),
                             "cross_250x77": (2, 250, 77, 12, 128)},
                    "fp32": {"siglip2_5s": (40, 1024, 1024, 12, 64),
                             "ragged_1": (2, 1, 1, 12, 64), "ragged_63": (2, 63, 63, 12, 64),
                             "ragged_65": (2, 65, 65, 12, 64),
                             "cross_250x77": (2, 250, 77, 12, 128)}}
# the fp32 cases at the paths' shapes, where the TF32 control must break the fp32 bound; it
# is recorded for the others, where cuBLAS may pick a CUDA-core kernel for the small ragged
# products and "high" then changes nothing (K1 at L 65 read 0.0 on an H100)
TF32_CONTROL_CASES = ("joint_5s", "single_5s", "joint_30s", "single_30s", "siglip2_5s")


def _rel_l2(got, ref) -> float:
    return float((got.float() - ref.float()).norm() / ref.float().norm())


def _tf32_control(torch, fn):
    """``fn()`` with TF32 let into every fp32 matmul: ``"high"`` matmul precision, outside
    ``true_fp32`` (the control that shows the fp32 bound can tell TF32 from fp32)."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        return fn()
    finally:
        torch.set_float32_matmul_precision(saved)


def _check_variant(torch, name, got, ref, dtype) -> dict:
    """A 16-bit kernel within the bf16 tolerances, an fp32 one within 1e-5 relative L2."""
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    err, rel = float((got.float() - ref.float()).abs().max()), _rel_l2(got, ref)
    if dtype == torch.float32:
        check(rel <= FP32_KERNEL_REL_TOL, f"{name}: relative L2 error {rel} > "
                                          f"{FP32_KERNEL_REL_TOL}")
        return {"max_abs_err": err, "rel_l2_err": rel, "rel_tol": FP32_KERNEL_REL_TOL}
    check(err <= KERNEL_TOL, f"{name}: max abs error {err} > {KERNEL_TOL}")
    check(rel <= KERNEL_REL_TOL, f"{name}: relative L2 error {rel} > {KERNEL_REL_TOL}")
    return {"max_abs_err": err, "tol": KERNEL_TOL, "rel_l2_err": rel, "rel_tol": KERNEL_REL_TOL}


def precision_kernel_phase(torch, dev, cfg):
    """K1 and K2 in fp16 and fp32 against their plain versions (fp32 inside ``true_fp32``),
    with each case's device time, the plain version's, the library call's in the same type
    (plain norm and RoPE then SDPA for K1, SDPA for K2; fp32 inside ``true_fp32``) and the
    bound and its share of the time (fp16 at the tensor cores' rate; fp32 at three TF32
    products a product, and beside it at the CUDA cores' fp32 rate). K1 at the 5 s and 30 s
    shapes and ragged lengths; K2 in fp16 at SigLIP2's 40 and 192 frames, in fp32 at 40
    frames (its plain version held in chunks of 8 frames), ragged and cross. For each fp32
    case with more than one key the control is the plain version with TF32 let in; at the
    paths' shapes (``TF32_CONTROL_CASES``) it must land outside the fp32 bound.
    Returns {(kernel, dtype name): {case: result}}."""
    from foley_tpu_torch.ops.kernels import flash_attention as FL
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.nn import exact_fp32

    results = {}
    b, h, d = 2, cfg.num_heads, cfg.head_dim
    for dtype, tname in ((torch.float16, "fp16"), (torch.float32, "fp32")):
        gen = torch.Generator(device=dev).manual_seed(10)
        cases = k1_cases(torch, dev, cfg, gen)
        out = results.setdefault(("fused_qk_attention", tname), {})
        long_iters = 10 if dtype == torch.float32 else 50
        for name in K1_VARIANT_CASES:
            length, streams, (wq, wk, cq, sq, ck, sk) = cases[name]
            q, k, v = (torch.randn(b, length, h, d, device=dev, generator=gen).to(dtype)
                       for _ in range(3))
            full = lambda w: w.expand(length, d)  # noqa: E731
            args = (q, k, v, wq, wk, cq, sq, ck, sk)

            def plain():
                with exact_fp32(dtype):
                    return FA.fused_qk_attention_plain(q, k, v, full(wq), full(wk), cq, sq, ck,
                                                       sk)

            def library_call():
                with exact_fp32(dtype):
                    qn = FA._norm_rope(q, full(wq), cq, sq, 1e-6).transpose(1, 2)
                    kn = FA._norm_rope(k, full(wk), ck, sk, 1e-6).transpose(1, 2)
                    return torch.nn.functional.scaled_dot_product_attention(
                        qn, kn, v.transpose(1, 2)).transpose(1, 2)

            got, ref = FA.fused_qk_attention(*args), plain()
            torch.cuda.synchronize()
            res = {"phase": "kernel", "kernel": "fused_qk_attention", "dtype": tname,
                   "case": name, "b": b, "l": length, "h": h, "d": d,
                   **_check_variant(torch, f"K1 {tname} {name}", got, ref, dtype)}
            if dtype == torch.float32 and length > 1:  # one key: p is 1 whatever the logits
                res["control_tf32_rel_l2_err"] = _rel_l2(_tf32_control(
                    torch, lambda: FA.fused_qk_attention_plain(
                        q, k, v, full(wq), full(wk), cq, sq, ck, sk)), ref)
                check(name not in TF32_CONTROL_CASES
                      or res["control_tf32_rel_l2_err"] > FP32_KERNEL_REL_TOL,
                      f"K1 fp32 {name}: the TF32 control reads {res['control_tf32_rel_l2_err']}"
                      f", within {FP32_KERNEL_REL_TOL}: the bound cannot tell TF32 from fp32")
            tables = {t.data_ptr(): t.numel() * 4 for t in (cq, sq, ck, sk)}
            n_bytes = (4 * q.numel() * q.element_size() + sum(tables.values())
                       + 2 * streams * d * 4)
            iters = long_iters if length > 1000 else 200
            res["kernel_ms"], res["host_ms"] = timed_ms(
                torch, lambda: FA.fused_qk_attention(*args), iters)
            res["plain_ms"] = gpu_ms(torch, plain, 10)
            res["library_ms"] = gpu_ms(torch, library_call, 10)
            flops = 4 * b * h * length * length * d
            res.update(fp32_bound(n_bytes, flops) if dtype == torch.float32
                       else kernel_bound(n_bytes, flops))
            emit(with_shares(res))
            out[name] = res
            del q, k, v, got, ref

    for tname, cases in K2_VARIANT_CASES.items():
        dtype = torch.float16 if tname == "fp16" else torch.float32
        gen = torch.Generator(device=dev).manual_seed(11)
        out = results.setdefault(("flash_attention", tname), {})
        for name, (bb, lq, lk, hh, dd) in cases.items():
            q = torch.randn(bb, lq, hh, dd, device=dev, generator=gen).to(dtype)
            k, v = (torch.randn(bb, lk, hh, dd, device=dev, generator=gen).to(dtype)
                    for _ in range(2))
            chunk = 8 if dtype == torch.float32 else bb  # frames a plain call holds

            def plain(fn=FL.flash_attention_plain):
                with exact_fp32(dtype):
                    return torch.cat([fn(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])
                                      for i in range(0, bb, chunk)])

            def library_call():
                with exact_fp32(dtype):
                    return torch.nn.functional.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)

            got, ref = FL.flash_attention(q, k, v), plain()
            torch.cuda.synchronize()
            res = {"phase": "kernel", "kernel": "flash_attention", "dtype": tname, "case": name,
                   "b": bb, "lq": lq, "lk": lk, "h": hh, "d": dd,
                   **_check_variant(torch, f"K2 {tname} {name}", got, ref, dtype)}
            if dtype == torch.float32 and lk > 1:  # one key: p is 1 whatever the logits
                res["control_tf32_rel_l2_err"] = _rel_l2(_tf32_control(
                    torch, lambda: torch.cat([FL.flash_attention_plain(
                        q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])
                        for i in range(0, bb, chunk)])), ref)
                check(name not in TF32_CONTROL_CASES
                      or res["control_tf32_rel_l2_err"] > FP32_KERNEL_REL_TOL,
                      f"K2 fp32 {name}: the TF32 control reads {res['control_tf32_rel_l2_err']}"
                      f", within {FP32_KERNEL_REL_TOL}: the bound cannot tell TF32 from fp32")
            del ref
            iters = 10 if dtype == torch.float32 and bb > 8 else 50
            res["kernel_ms"], res["host_ms"] = timed_ms(torch, lambda: FL.flash_attention(q, k, v),
                                                        iters)
            res["plain_ms"] = gpu_ms(torch, plain, 3 if bb > 8 else 10)
            res["library_ms"] = gpu_ms(torch, library_call, iters)
            n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
            flops = 4 * bb * hh * lq * lk * dd
            res.update(fp32_bound(n_bytes, flops) if dtype == torch.float32
                       else kernel_bound(n_bytes, flops))
            emit(with_shares(res))
            out[name] = res
            del q, k, v, got
    torch.cuda.empty_cache()
    return results


def precision_phase(torch, dev, pipeline_cfg, config="xxl"):
    """The denoiser and the visual encoders at full XXL width in fp16 and fp32, one precision
    at a time (fp32 holds 19.1 GiB of weights), freed before the next:
    ``HunyuanModelLoader.init_random("xxl", p, perturb=True)``, one forward at the 5 s shapes
    through the kernel against the same forward through the plain attention (fp16 within
    ``FORWARD_REL_TOL``, fp32 within ``FP32_MODEL_REL_TOL``), and for fp32 the forward again
    under ``"high"`` fp32 matmul precision, which must equal the default run within 1e-5 (the
    model runs in ``true_fp32``). Then SigLIP2 and Synchformer in the same precision at their
    real geometry: one 5 s encode of the 1280x720 clip through ``encode_video``, with 12 K2
    launches of that type, and SigLIP2's features against the same encode through the plain
    attention. Returns {dtype name: K2 launches in the counted encode}."""
    import numpy as np

    from foley_tpu_torch.api.nodes import HunyuanModelLoader
    from foley_tpu_torch.models import mmdit as mmdit_mod
    from foley_tpu_torch.models import siglip2 as siglip2_mod
    from foley_tpu_torch.ops.kernels import flash_attention as FL
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.kernels.common import reset_launches
    from foley_tpu_torch.pipeline.features import encode_video, resample_frames

    cfg = pipeline_cfg.model
    clip_len, sync_len = pipeline_cfg.t2a_lengths(DURATION_S)
    t_len = pipeline_cfg.latent_length(DURATION_S)
    frames = make_clip(np, 0)
    launches = {}
    for tname, dtype in (("fp16", torch.float16), ("fp32", torch.float32)):
        t0 = time.perf_counter()
        out = {"phase": "precision", "precision": tname, "config": config}
        fm = HunyuanModelLoader.init_random(config, tname, 0, perturb=True, device=dev)
        model = fm["params"]
        check(fm["dtype"] == dtype and next(model.parameters()).dtype == dtype,
              f"{tname}: the loader built {fm['dtype']}")
        out["init_s"] = time.perf_counter() - t0
        out["weights_gib"] = sum(p.numel() * p.element_size()
                                 for p in model.parameters()) / 2 ** 30
        gen = torch.Generator(device=dev).manual_seed(1)
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen).to(dtype)  # noqa: E731
        args = (rnd(2, t_len, cfg.audio_vae_latent_dim), torch.full((2,), 500.0, device=dev),
                rnd(2, cfg.text_length, cfg.condition_dim), rnd(2, clip_len, cfg.clip_dim),
                rnd(2, sync_len, cfg.sync_feat_dim))

        def plain_k1(q, k, v, wq, wk, *tabs, eps):
            lq, lk = q.shape[1], k.shape[1]
            return FA.fused_qk_attention_plain(q, k, v, wq.expand(lq, q.shape[-1]),
                                               wk.expand(lk, k.shape[-1]), *tabs, eps=eps)

        with torch.no_grad():
            reset_launches(FA.fused_qk_attention)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model(*args).float()
            torch.cuda.synchronize()
            out["forward_s"] = time.perf_counter() - t0
            out["forward_k1_launches"] = FA.fused_qk_attention.launches_by_dtype.get(dtype, 0)
            mmdit_mod.fused_qk_attention = plain_k1
            try:
                ref = model(*args).float()
            finally:
                mmdit_mod.fused_qk_attention = FA.fused_qk_attention
            if dtype == torch.float32:
                high = _tf32_control(torch, lambda: model(*args).float())
                out["high_vs_default_rel_l2"] = _rel_l2(high, got)
                check(out["high_vs_default_rel_l2"] <= 1e-5,
                      f"fp32 forward under \"high\" {out['high_vs_default_rel_l2']} from the "
                      "default run: TF32 reached the fp32 model")
                del high
        blocks = cfg.depth_triple_blocks + cfg.depth_single_blocks
        check(out["forward_k1_launches"] == blocks,
              f"{tname} forward: {out['forward_k1_launches']} K1 launches, expected {blocks}")
        check(bool(torch.isfinite(got).all()) and float(ref.std()) > 0,
              f"{tname}: non-finite or zero velocity")
        tol = FP32_MODEL_REL_TOL if dtype == torch.float32 else FORWARD_REL_TOL
        out.update(forward_rel_l2_err=_rel_l2(got, ref), forward_tol=tol,
                   velocity_std=float(ref.std()))
        check(out["forward_rel_l2_err"] <= tol,
              f"{tname} forward relative error {out['forward_rel_l2_err']} > {tol}")
        del fm, model, args, got, ref
        torch.cuda.empty_cache()

        encoders = random_video_encoders(torch, dev, pipeline_cfg, dtype)
        check(encoders["siglip2"].compute_dtype == dtype, f"{tname}: SigLIP2's type")
        reset_launches(FL.flash_attention)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip, sync = encode_video(encoders, frames, CLIP_FPS, DURATION_S, pipeline_cfg)
        torch.cuda.synchronize()
        out["encode_s"] = time.perf_counter() - t0
        launches[tname] = FL.flash_attention.launches_by_dtype.get(dtype, 0)
        out["encode_k2_launches"] = launches[tname]
        per_k2 = encoders["siglip2"].cfg.num_hidden_layers
        check(launches[tname] == per_k2 and FL.flash_attention.launches == per_k2,
              f"{tname} encode: K2 launches {FL.flash_attention.launches_by_dtype}, expected "
              f"{per_k2} of {tname}")
        check(tuple(clip.shape) == (1, clip_len, cfg.clip_dim)
              and tuple(sync.shape) == (1, sync_len, cfg.sync_feat_dim),
              f"{tname} features {tuple(clip.shape)}, {tuple(sync.shape)}")
        check(bool(torch.isfinite(clip).all() and torch.isfinite(sync).all())
              and float(clip.std()) > 0, f"{tname}: non-finite or constant features")
        siglip2_mod.flash_attention = FL.flash_attention_plain
        try:
            plain_clip = encoders["siglip2"].encode(resample_frames(
                frames, CLIP_FPS, DURATION_S, pipeline_cfg.siglip2_fps))
        finally:
            siglip2_mod.flash_attention = FL.flash_attention
        out.update(siglip2_rel_l2_err=_rel_l2(clip, plain_clip), siglip2_tol=tol)
        check(out["siglip2_rel_l2_err"] <= tol,
              f"{tname} SigLIP2: kernel against plain {out['siglip2_rel_l2_err']} > {tol}")
        del encoders, clip, sync, plain_clip
        torch.cuda.empty_cache()
        emit(out)
    return launches


def cli_phase(torch, dev, pipeline_cfg, config="xxl") -> dict:
    """``foley_tpu_torch.cli.main`` in this process, as a user runs it: XXL with random
    perturbed weights, 5 s, 50 Euler steps, CFG 4.5, in fp16 and then in fp32 (the model
    loaded anew each time, as the command does). Each WAV: 48,000 Hz, mono, 240,000 frames,
    a non-zero peak; each request: 2,700 K1 launches of its type. Returns {dtype name: K1
    launches}."""
    import os
    import wave

    import numpy as np

    from foley_tpu_torch import cli
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.kernels.common import reset_launches

    os.makedirs("build/chip_smoke", exist_ok=True)
    launches = {}
    for tname, dtype in (("fp16", torch.float16), ("fp32", torch.float32)):
        path = f"build/chip_smoke/cli_{tname}.wav"
        argv = ["--random_init", config, "--random_init_perturb", "--precision", tname,
                "--duration", str(DURATION_S), "--num_inference_steps", str(STEPS),
                "--guidance_scale", str(GUIDANCE), "--device", dev.type, "--output", path]
        reset_launches(FA.fused_qk_attention)
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli --precision {tname} exited {rc}")
        launches[tname] = FA.fused_qk_attention.launches_by_dtype.get(dtype, 0)
        with wave.open(path) as f:
            params = (f.getframerate(), f.getnchannels(), f.getsampwidth(), f.getnframes())
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        os.remove(path)
        n = int(DURATION_S * 48000)
        check(params == (48000, 1, 2, n), f"cli {tname} WAV {params}")
        peak = int(np.abs(pcm.astype(np.int32)).max())
        check(peak > 0, f"cli {tname}: silent WAV")
        model_cfg = pipeline_cfg.model
        per_request = STEPS * (model_cfg.depth_triple_blocks + model_cfg.depth_single_blocks)
        check(launches[tname] == per_request and FA.fused_qk_attention.launches == per_request,
              f"cli {tname}: K1 launches {FA.fused_qk_attention.launches_by_dtype}, expected "
              f"{per_request} of {tname}")
        emit({"phase": "cli", "precision": tname, "argv": " ".join(argv), "wall_s": wall,
              "k1_launches": launches[tname], "wav": list(params), "peak": peak,
              "rms": float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))})
        torch.cuda.empty_cache()
    return launches


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
    variants = precision_kernel_phase(torch, dev, cfg)
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
    text, uncond, clap_encoder = clap_phase(torch, dev)
    long_k1, long_k2 = longform_path_phase(torch, dev, bundle, XXL, text, uncond)
    video_encoders = random_video_encoders(torch, dev, XXL)
    nodes_phase(torch, dev, bundle, XXL, clap_encoder, video_encoders)
    serving_k1, serving_k2 = serving_phase(torch, dev, bundle, XXL, clap_encoder,
                                           video_encoders)
    del model, dac, bundle, clap_encoder, video_encoders, text, uncond, t2a_latents
    torch.cuda.empty_cache()
    encode_k2 = precision_phase(torch, dev, XXL)
    cli_k1 = cli_phase(torch, dev, XXL)

    # per-launch figures weighted by the main path's mix: each step runs one joint call per
    # triple block and one single call per single block
    mix = {"joint_5s": cfg.depth_triple_blocks, "single_5s": cfg.depth_single_blocks}

    def avg(key):
        return sum(kernel[c][key] * n for c, n in mix.items()) / sum(mix.values())

    k1_bound = kernel_bound(avg("bytes"), avg("flops"))

    def variant(kernel, tname, source, replaces, launches):
        """The row of K1's or K2's fp16 / fp32 kernel: K1 weighted as the main path mixes
        its shapes, K2 at SigLIP2's 5 s shape."""
        cases = variants[(kernel, tname)]
        if kernel == "fused_qk_attention":
            def mean(key):
                return sum(cases[c][key] * n for c, n in mix.items()) / sum(mix.values())
        else:
            def mean(key):
                return cases["siglip2_5s"][key]
        if tname == "fp32":  # the 3xTF32 bound, and the CUDA cores' beside it
            bound = fp32_bound(mean("bytes"), mean("flops"))
            extra = {"bound_cuda_core_ms": bound["bound_cuda_core_ms"]}
        else:
            bound, extra = kernel_bound(mean("bytes"), mean("flops")), {}
        return {"name": f"{kernel}_{'f16' if tname == 'fp16' else 'f32'}", "route": "cuda",
                "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
                "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": mean("library_ms"), **extra}

    k2 = flash["siglip2_5s"]  # the main V2A path's shape (the 24 s run's is siglip2_24s)
    k3_bound = gemm["probe_full"]  # the probe's shape: one sweep of the probe
    emit({"kernels": [{
        "name": "fused_qk_attention", "route": "cuda",
        "source": "foley_tpu_torch/csrc/fused_qk_attention.cu",
        "replaces": "foley_tpu/ops/pallas/fused_attention.py:82",
        "launches": launches, "launches_longform": long_k1,
        "launches_serving": serving_k1,
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
        "ms": avg("kernel_ms"), "plain_ms": avg("plain_ms"), "bound_ms": k1_bound["bound_ms"],
        "bound_by": k1_bound["bound_by"],
        "library_ms": avg("library_ms"),
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "foley_tpu_torch/csrc/flash_attention.cu",
        "replaces": "foley_tpu/ops/pallas/flash_attention.py:60",
        "launches": flash_launches, "launches_longform": long_k2,
        "launches_serving": serving_k2,
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
    },
        # the fp16 and fp32 kernels: K1's launches in the ``cli`` phase's request of that
        # type, K2's in the ``precision`` phase's encode of that type
        variant("fused_qk_attention", "fp16", "foley_tpu_torch/csrc/fused_qk_attention.cu",
                "foley_tpu/ops/pallas/fused_attention.py:82", cli_k1["fp16"]),
        variant("fused_qk_attention", "fp32", "foley_tpu_torch/csrc/attention_f32.cu",
                "foley_tpu/ops/pallas/fused_attention.py:82", cli_k1["fp32"]),
        variant("flash_attention", "fp16", "foley_tpu_torch/csrc/flash_attention.cu",
                "foley_tpu/ops/pallas/flash_attention.py:60", encode_k2["fp16"]),
        variant("flash_attention", "fp32", "foley_tpu_torch/csrc/attention_f32.cu",
                "foley_tpu/ops/pallas/flash_attention.py:60", encode_k2["fp32"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
