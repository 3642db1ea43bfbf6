#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``foley_tpu_torch``) on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA card: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``foley_tpu_torch/csrc`` (into
``build/torch_kernels/``), then prints one JSON line per phase:

- ``device``: the card (``nvidia-smi`` name and power limit, also printed raw on a line of
  its own), torch and CUDA versions;
- ``build``: the five kernel libraries (K1 and K2 in bf16 / fp16, their fp32 kernels, K1 at
  the other head widths, K3)
  and the frame codecs' host C++ (``csrc/jpeg_entropy.cpp``, ``tiff_lzw.cpp``,
  ``webp_lossless.cpp``, ``webp_vp8.cpp``), built in parallel: seconds per library and what
  ptxas reported;
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
  fp32 rate); then K1 at head widths other than 128 (``fused_qk_attention_mma.cu``) in
  bf16, fp16 and fp32, timed at TINY's calls (heads of 32) and at a 1536-wide denoiser's 5 s
  and 30 s calls with 24 heads of 64 and 16 of 96, and held at widths 18 to 256 at ragged
  lengths;
- ``probe_gemm``: K3's path, the GEMM sweep probe (``foley_tpu_torch.tools.probe_gemm``) at
  its full shape, 36 blocks of x [784, 1536] @ W_b[:, :1536] of [1536, 4608]: its record
  (each variant's time a sweep, eager and replayed from a CUDA graph, and rates, the
  kernel's error, the floors) and K3's launches, one a sweep;
- ``forward``: one XXL denoiser forward at the 5 s shapes through the kernel, against the
  same forward through the plain attention;
- ``main_path``: XXL text-to-audio, 5 s, 50 Euler steps, CFG 4.5, batch 1, bf16 denoiser,
  fp32 DAC, int16 PCM: a warm-up, three ``generate_audio`` requests and one
  ``generate_audio_multi`` request with two rows, with the kernel's launch count per request;
- ``profile``: one more request, at ``SURFACE_STEPS`` (10) steps, timed unprofiled, then one
  under ``torch.profiler`` tracing the card alone: its wall, the card's busy time and idle share within that run,
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
- from here on every request runs ``SURFACE_STEPS`` (10) Euler steps, 540 K1 launches a 5 s
  request at XXL (the paths above run the 50 of the main path);
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
- ``quant``: quantized storage at XXL, fp8_e4m3fn, int8, int8_dynamic and int4, each a copy
  of the ``main_path`` denoiser freed before the next: the denoiser's bytes on the card, the
  counts and GiB saved, one single and one triple block quantized on the card against the
  CPU's quantization of the same blocks (equal bit for bit), the 5 s forward's relative L2
  against the bf16 one, one XXL dense against the bf16 weight's (within the JAX tests'
  bounds: int8 1%, int8_dynamic 2%, int4 8% max-relative), and one 5 s request (wall, peak
  memory above the phase's start, 540 K1 launches);
- ``block_swap``: the ``main_path`` denoiser with its last 30 blocks in page-locked host
  memory (the block-swap node's default), and 54 at ``prefetch_blocks`` 0 and 1, then an
  int4 copy with 54: the 5 s velocity equal bit for bit to the resident model's, the
  partition report, the bytes on the card, one 5 s request (wall, peak memory, 540 K1
  launches), the host -> card GB a step, a timed pass of the copies alone and the request's
  copy rate;
- ``precision``: the XXL denoiser in fp16 and in fp32 (``HunyuanModelLoader.init_random``,
  one at a time): a 5 s forward through the kernels against the plain attention, fp32 also
  under ``"high"`` matmul precision (equal within 1e-5); SigLIP2 and Synchformer in the same
  type encoding the 5 s 1280x720 clip, 12 K2 launches of that type, SigLIP2's features
  against the plain attention;
- ``cli``: ``foley_tpu_torch.cli.main`` in this process, XXL 5 s T2A with 10 steps in fp16,
  in fp32, and in bf16 with ``--quantization int8 --blocks_to_swap 30 --prefetch_blocks
  1``: the WAV (48 kHz, mono, 240,000 frames, non-silent), 540 K1 launches of the type
  and the wall;
- ``configs``: the joint attention off K1's precondition at XXL bf16 (the exact interleave /
  decouple path; a ``use_attention_mask`` config with an all-true mask), through the plain
  attention, against the K1 forward on the same weights (relative L2);
- ``heads_path``: XXL's YAML with 24 heads of 64, read by ``configs.config_from_yaml``, on
  the same weights but the qk-norm vectors: one 5 s T2A request, 540 bf16 launches of
  ``fused_qk_attention_mma.cu``;
- ``video_ingest``: 125 PNG frames of the 1280x720 clip written with the standard library
  (every scanline filter) and read back equal (the decode's seconds and peak device
  memory); V2A from the directory
  through ``cli.main --single_video DIR`` (its WAV equal to the sampler node's on the same
  model, encoders, clip and seed), the server's ``frames_path`` and
  ``standalone.feature_process`` (the features equal to the clip's), 540 K1 and 12 K2
  launches a request; a ``.mp4`` raises, naming ffmpeg and PyAV;
- ``lora``: a rank-16 XXL adapter written by the port's writer, merged through the loader's
  code in-process (scale 0: the base latents; the card's merge of the first single block
  equal to the CPU's bit for bit), through ``cli.main --lora`` and the server's
  ``--lora`` (their weights equal to the in-process merge's), and an int8 request of the
  merged model: 540 K1 launches a request, the merge's seconds and the adapter's bytes;
- ``desync``: the real-width desync scorer (random reference-layout checkpoint) through
  ``cli.main --desync_score`` on the ``video_ingest`` frames and the ``lora`` request's WAV:
  the offset on the class grid, finite logits, the logits of the clip's first 2 s against
  the CPU;
- ``image_codecs``: the codecs without PIL on the ``video_ingest`` clip: its 125 frames
  encoded to JPEG at quality 95 on the card (the first three equal to the CPU's bytes; ms a
  frame, the card's transform and the host's Huffman pass apart), read back as a frames
  directory (equal to the CPU's decode; seconds on the host and the card, peak memory, the
  error against the clip); ``cli.main --single_video DIR --merge_video`` (the ``.avi``'s
  frames equal to its own JPEGs' decode, its PCM to the WAV) and one served request with
  ``mux_video`` and ``"response": "avi"`` (equal to ``build_avi_bytes``), 540 K1 and 12 K2
  launches each; the AST's content mask at its real width against the CPU; a 720p 16-bit
  Adam7 PNG and a 5-6-5 BMP, card against CPU;
- ``frame_formats``: the formats the JAX package reads through PIL, without it: the
  committed fixtures of ``tests/data/torch_frame_formats/`` (progressive JPEG in 4:2:0,
  4:4:4 and grey, optimised and with restarts, CMYK; 4:1:1, luma sampled below its chroma,
  a progressive file cut after its third scan (block smoothing), arithmetic-coded SOF9 with
  restarts, SOF10 whole and cut short; TIFF in LZW with predictor 2, Deflate,
  PackBits, a palette and 16-bit grey, at orientations 6 and 8, JPEG-in-TIFF in RGB and in
  YCbCr 4:2:0 and 4 x 4, LZW YCbCr at 2 x 2, CMYK; GIF, interlaced with a transparent index, a local
  table and a frame smaller than its screen, and Pillow's own, both named ``.png``; RLE8 and
  RLE4 BMP; lossless WebP with colour indexing and with the other three transforms; lossy
  WebP at quality 80, at quality 5 and method 6, with alpha, with bytes after its VP8L alpha
  stream, with the simple loop filter and 8 token partitions; two animations, one whose
  first frame lies inside the canvas) decoded on the card and on the CPU, equal to each
  other and to the SHA-256 of Pillow's RGB bytes recorded beside them, and a WebP whose VP8L
  alpha is corrupt and a JPEG of a 3 / 2 sampling ratio raising on both, as Pillow raises;
  125 frames of each format on the card (GIF, JPEG-in-TIFF, an arithmetic-coded, a cut
  progressive and a 4:1:1 JPEG among them; the host's and the card's seconds apart, equal to the
  CPU's); 125 copies of one 720p frame of the clip as TIFF, uncompressed, PackBits and LZW
  after predictor 2 (written here; the reader's two parts timed, their frames equal to the
  one written), and 125 copies of the same frame as a lossy WebP, as Pillow's GIF and as
  an arithmetic-coded progressive JPEG
  (``tests/data/torch_frame_formats_720p/``; the two parts timed, every frame against
  Pillow's digest); one XXL V2A request through ``cli.main --single_video`` from a directory
  mixing every fixture (540 K1 and 12 K2 launches); a PPM named ``.jpg`` refused; each
  part's seconds;
- ``train_grad``: the train step at the XXL width cut to 1 + 1 blocks in fp32, the loss and
  every parameter's and a rank-16 adapter's factors' gradients on the card against the CPU
  (also under ``"high"`` precision), and a control with ``true_fp32`` bypassed;
- ``train_lora``: LoRA training at XXL (bf16 base, rank-16 fp32 factors, 5 s, batch 1, remat):
  the first loss equal to the base's, gradients with and without remat, the loss falling
  over ten steps, no kernel launch in a step and K1 / K2 refusing grad-requiring operands,
  the base unchanged, an exact resume from a ``.safetensors`` checkpoint, the exported
  adapter merged at load against the runtime adapter, one 5 s request (540 K1 launches);
- ``train_full``: full training at XXL in bf16 (AdamW, bf16 moments, remat), a few steps,
  ``export_for_inference`` with latent statistics, the loader's directory route and one 5 s
  request from the export (540 K1 launches);
- ``train_data``: four 5 s WAV tones -> ``encode_corpus`` (XXL DAC) -> shards ->
  ``flow_match_batches`` -> ``PrefetchLoader`` -> ``train_lora``, then ``python -m
  foley_tpu_torch.tools.train_t2a`` (TINY) in a child process; each training phase prints
  ms a step, peak memory, the trainable, state and checkpoint bytes, beside the card's
  name and power limit;
- ``dac_train``: DAC-VAE GAN training at the real codec (371.6 M generator parameters)
  against the default discriminators (MPD, MRD), five D + G steps of
  ``make_dac_train_steps`` on one batch of eight seeded 0.4 s excerpts: ms a step, the D / G
  split, peak memory, one profiled step, the models' and the optimizer state's bytes, every
  loss part (finite, ``mel`` falling); the gradients of both losses on a 2-hop excerpt
  against the CPU's with the posterior noise injected, and a TF32 control that must break
  the bound;
- ``codec``: ``compress`` / ``decompress`` at full width of the ``main_path`` request's 5 s
  and of a 30 s signal (seconds, artifact bytes), equal to ``decode(encode(chunks).mode())``
  and chunk by chunk within 1e-4; the RVQ's ``apply``, ``from_codes`` and ``from_latents``
  agreeing on the card, an artifact of codes decoded;
- ``transforms``: ``eval_transforms`` and ``train_transforms`` over the V2A clip (125 frames
  of 1280x720, 5 s of 16 kHz audio) with their resizes and mel on the card and on the CPU:
  equal bit for bit (the mel within 1e-5), ms an item each way;
- ``pil_preprocess``: one 5 s XXL V2A request through ``cli.main --v2a_preprocess pil`` on
  the ``video_ingest`` frames (540 K1 and 12 K2 launches, the PIL-exact resize reached, the
  device resize not), ``ops/pil_resize.py`` on the card equal to the CPU's bit for bit at
  SigLIP2's and Synchformer's sizes (host seconds of each), and the PIL route's features
  against the device route's;
- ``mesh``: serving over a ("data", "model") mesh of ``torch.distributed`` ranks
  (``foley_tpu_torch/parallel/``) at XXL width, 9 + 18 blocks (the served mesh at the whole
  XXL), 5 s T2A at ``SURFACE_STEPS``: the one-card
  references first (the request, a control with the CFG pair run as two batch-1 forwards,
  the fp32 forward at 2 + 2 blocks; their models freed before any rank starts), then
  ``nccl_world1`` (one rank over NCCL: latents equal to one card's bit for bit),
  ``gloo_model2`` (two ranks on ``cuda:0``, 6 heads each: the fp32 forward within 1e-5 of
  one card's, the bf16 latents within 4x the control), ``gloo_data2`` (the CFG pair split
  over two ranks, held the same way), each with the request's wall on every rank, K1's
  launches by heads, the collectives a step (calls, bytes) and peak memory; then
  ``server_model2``: ``python -m foley_tpu_torch.serving.server --random_init xxl --mesh
  model=2 --device cuda:0 --port 0`` answering a 5 s and an 8 s long-form request over
  HTTP, exiting 0 on SIGTERM, and refusing ``--blocks_to_swap`` with ``--mesh``;
- ``train_longrun``, last and alone: the tool ``foley_tpu_torch.tools.train_longrun`` (TINY,
  batch 4, ``LONGRUN_STEPS`` steps): it returns 0, everything finite, the export deployed on
  the card with 48 fp32 launches of ``fused_qk_attention_mma.cu``; its wall, ``loss_drop_ratio`` and
  ``ok`` as measured;
- ``{"kernels": [...]}``: every ported kernel with its launches on its path (K1 in
  ``main_path`` and, as ``launches_longform``, in the 75 s request and, as
  ``launches_serving``, over the ``serving`` requests, and per request of ``quant``,
  ``block_swap``, the ``cli`` memory-mode run, ``lora``'s requests, ``video_ingest``'s
  and ``configs``' forwards, the requests on the trained models, ``pil_preprocess``'s and
  ``image_codecs``' (the CLI's ``--merge_video`` and the served ``mux_video``) and
  ``frame_formats``' (the mixed directory's request),
  none in a train step, and as ``launches_mesh_per_rank`` on each rank of the ``mesh``
  requests; K2 in ``v2a_path``, the 24 s V2A request, the served V2A
  requests and ``video_ingest``'s, ``pil_preprocess``'s, ``image_codecs``' and
  ``frame_formats``' (fp32 encoders in the fp32 row);
  K3 in one sweep of ``probe_gemm``;
  K3's times are the probe's graph-replayed device times), then the fp16 and fp32
  kernels of K1 (launches in the ``cli`` request of their type) and K2 (launches in the
  ``precision`` encode of their type), and K1 at other head widths (launches in
  ``heads_path``'s request, and in ``train_longrun``'s deployed request beside them);
- last, ``{"ok": true, "device": {...}}`` (the card's name and power limit are printed
  again just before the ``kernels`` line).

Any failed check raises, and the run exits non-zero. Without a CUDA card, or outside the
repository, it exits non-zero before printing anything.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

DURATION_S = 5.0
STEPS = 50
SURFACE_STEPS = 10  # Euler steps of every request after ``clap`` (long form, the surfaces,
                    # the memory modes, the CLI, ingest, LoRA, the trained models, the PIL
                    # route, the mesh): at 50 the whole script took 1,212.9 s of its 1,200 s
                    # limit, with long form alone at 50 1,055 s (PERF.md §4)
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
KERNEL_LIBS = (("fused_qk_attention", ""), ("flash_attention", ""), ("gemm_sweep", ""),
               ("attention_f32", ""), ("fused_qk_attention_mma", "K1_MMA_BF16"),
               ("fused_qk_attention_mma", "K1_MMA_F16"),
               ("fused_qk_attention_mma", "K1_MMA_F32"))  # (source, macro): build.library's
HOST_LIBS = ("jpeg_entropy", "tiff_lzw", "webp_lossless", "webp_vp8", "gif_lzw",
             "bmp_rle")  # the frame codecs' C++
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


T_START = time.perf_counter()  # a phase line's ``t_s``: seconds since the script started


def emit(obj) -> None:
    if "phase" in obj:  # the contract's lines (``kernels``, ``ok``) keep their own keys
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 1)}
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


K1_SHAPES = {  # K1's cases: (audio, visual) lengths of a joint call, (length,) of a single one
    "joint_5s": (250, 40), "single_5s": (250,), "ragged_1": (1,), "ragged_63": (63,),
    "ragged_64": (64,), "ragged_65": (65,), "ragged_128": (128,), "joint_30s": (1500, 240),
    "single_30s": (1500,), "joint_cont": (700, 112), "single_cont": (700,),
    "joint_v2a16": (800, 128), "single_v2a16": (800,)}


def k1_cases(torch, dev, cfg, gen, shapes=None) -> dict:
    """K1's cases at every shape a path gives it (``shapes``, ``K1_SHAPES`` unless given):
    {name: (length, streams, [wq, wk, cq, sq, ck, sk])}, the fp32 tables as the denoiser
    builds them (``streams``: the norm weights' [D] rows a call is made of)."""
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

    return {name: joint_case(*lengths) if len(lengths) == 2 else single_case(*lengths)
            for name, lengths in (shapes or K1_SHAPES).items()}


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
    shape, each compared with the first eager sweep bit for bit. The inputs are drawn on the
    card, scaled as ``probe_gemm.make_inputs`` scales them (its numpy draws took 6 s)."""
    from foley_tpu_torch.ops.kernels import gemm_sweep as GS
    from foley_tpu_torch.tools import probe_gemm as PG

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(PG.M, PG.K, device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn(PG.BLOCKS, PG.K, PG.N, device=dev, generator=gen)
         / PG.K ** 0.5).to(torch.bfloat16)
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


def forward_phase(torch, dev, model, pipeline_cfg):
    """One XXL forward at the 5 s CFG shapes through the kernel and through the plain
    attention; the velocities must agree."""
    from foley_tpu_torch.models import mmdit as mmdit_mod
    from foley_tpu_torch.ops.kernels import fused_attention as FA

    args = _forward_args(torch, dev, pipeline_cfg)

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
    kernel time of that run, and the idle share is taken against the same run's wall. The
    card's events are summed by name from the profiler's raw results: the figures
    ``key_averages`` gives (a kernel's self time is its duration), without the Python
    objects it builds for each of a request's hundreds of thousands of events, which took
    most of the phase's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    request()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall = time.perf_counter() - t0
    by_name = {}  # kernel name -> [ms, launches]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            acc = by_name.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
    busy_s = sum(ms for ms, _ in by_name.values()) / 1e3
    check(busy_s > 0, "the profiler saw no kernel time on the card")

    def group(name):
        low = name.lower()
        return next((g for g, keys in PROFILE_GROUPS if any(k in low for k in keys)), "other")

    groups = {}
    for name, (ms, count) in by_name.items():
        g = groups.setdefault(group(name), {"ms": 0.0, "launches": 0})
        g["ms"] += ms
        g["launches"] += count
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"unprofiled_wall_s": plain_wall, "wall_s": wall, "device_busy_s": busy_s,
            "idle_share": 1.0 - busy_s / wall,
            "launches": sum(count for _, count in by_name.values()), "groups": groups,
            "top": [{"name": name[:120], "ms": ms, "count": count}
                    for name, (ms, count) in heaviest]}


def profile_phase(torch, bundle) -> None:
    """One main-path request at ``SURFACE_STEPS`` Euler steps, profiled (``profiled``): at
    the main path's 50 the profiler's processing of the request's 254,000 kernel events took
    about 23 s of the phase's 33-38 (a cut: PERF.md §4)."""
    from foley_tpu_torch.pipeline.generate import generate_audio

    text = torch.zeros(1, 77, bundle.pipeline_cfg.model.condition_dim)

    def request():
        generate_audio(bundle, text, text, DURATION_S, guidance_scale=GUIDANCE,
                       num_inference_steps=SURFACE_STEPS, sampler="euler", seed=1)
        torch.cuda.synchronize()

    emit({"phase": "profile", "steps": SURFACE_STEPS, **profiled(torch, request)})


_CLIPS = {}  # make_clip's frames by its arguments: several phases take the same clip
HOST_THREADS = 8  # threads drawing a clip's frames or writing its PNGs (the card's host has 8)


def make_clip(np, seed: int, duration_s=DURATION_S, hw=CLIP_HW):
    """``duration_s`` of 25 fps RGB uint8 frames of ``hw`` (height, width) with smooth
    moving content: per-channel drifting sinusoidal gratings and a bright disc crossing the
    frame, drawn from ``seed``. Drawn once for each argument set; each call gets a copy."""
    key = (seed, duration_s, tuple(hw))
    if key not in _CLIPS:
        _CLIPS[key] = _draw_clip(np, seed, duration_s, hw)
    return _CLIPS[key].copy()


def _draw_clip(np, seed: int, duration_s, hw):
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

    def draw(t):
        s = t / CLIP_FPS
        cx, cy = (x0 + vx * s / duration_s) % 1.0, (y0 + vy * s / duration_s) % 1.0
        disc = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.01)
        for c in range(3):
            grating = np.sin(2 * np.pi * (freq[c, 0] * xx + freq[c, 1] * yy + speed[c] * s)
                             + phase[c])
            frames[t, :, :, c] = np.clip(127.5 + 90.0 * grating + 120.0 * disc, 0, 255)

    with ThreadPoolExecutor(HOST_THREADS) as pool:  # numpy's ufuncs release the GIL
        list(pool.map(draw, range(n)))
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
    latents within 1e-5 of its request served alone and each client's WAV nearer its own
    solo run's samples than the other client's (``AV_RMS_RATIO``).
    Returns K1's and K2's launches over the served requests."""
    import base64
    import io
    import threading
    import urllib.request
    import wave
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from foley_tpu_torch.io.native import float_to_pcm16
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
    rows, solo_pcm = [], []
    for i, body in enumerate(pair):
        text, uncond = encode_text(deps, body["prompt"], body["negative_prompt"])
        solo = gen_mod.generate_audio(bundle, text, uncond, DURATION_S, guidance_scale=GUIDANCE,
                                      num_inference_steps=STEPS, seed=body["seed"],
                                      return_latents=True)
        diff = np.abs(batch.latents[row_seeds.index(body["seed"])] - solo.latents[0])
        ok = bool((diff <= 1e-5 + 1e-5 * np.abs(solo.latents[0])).all())
        rows.append(float(diff.max()))
        check(ok, f"coalesced row {i}: latents {float(diff.max())} from its solo run")
        solo_pcm.append(float_to_pcm16(np.asarray(solo.audio_first)[0, 0]).astype(np.int32))
    # each client's WAV against its own solo run's samples and the other client's: its RMS
    # distance to its own must be under AV_RMS_RATIO of that to the other's, so a server that
    # swapped the two responses fails here (the decodes of a batch of 2 and of 1 sum in
    # another order, and the random DAC's gain turns that into PCM steps)
    wav_steps, wav_rms = [], []
    for i in range(len(pair)):
        got = samples(outs[i], n).astype(np.int32)
        own, other = (float(np.sqrt(np.mean((got - solo_pcm[j]).astype(np.float64) ** 2)))
                      for j in (i, 1 - i))
        wav_steps.append(int(np.abs(got - solo_pcm[i]).max()))
        wav_rms.append([own, other])
        check(own < AV_RMS_RATIO * other, f"coalesced client {i}: WAV at RMS {own} steps "
              f"from its solo run, {other} from the other client's")
    solo_walls = [r["client_wall_s"] for r in results if r["request"] == "t2a_wav"]
    emit({"phase": "serving", "request": "coalesced_pair", "client_wall_s": coalesced_s,
          "solo_t2a_wall_s": solo_walls[0], "rows_max_abs_latent_diff": rows,
          "clients_max_wav_steps_vs_solo": wav_steps,
          "clients_wav_rms_steps_own_other": wav_rms, "rms_ratio_limit": AV_RMS_RATIO,
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


ANY_K1_TINY = {"joint_1s": (50, 8), "single_1s": (50,)}  # TINY's calls in a 1 s request
ANY_K1_WIDE = {"joint_5s": (250, 40), "single_5s": (250,), "joint_30s": (1500, 240),
               "single_30s": (1500,)}  # a 1536-wide denoiser's calls at 5 s and in a 30 s window
ANY_K1_HEADS = (24, 16)  # 1536 wide: 24 heads of 64, 16 of 96
ANY_K1_WIDTHS = (18, 32, 48, 64, 80, 96, 160, 256)  # held at ragged lengths, 2 heads
ANY_K1_RAGGED = {"ragged_1": (1,), "ragged_33": (33,), "ragged_65": (65,), "ragged_129": (129,)}


def any_width_kernel_phase(torch, dev, tiny_cfg, wide_cfg):
    """K1 at head widths other than 128 (``csrc/fused_qk_attention_mma.cu``) against its
    plain version in bf16, fp16 and fp32 (fp32 inside ``true_fp32``): timed at TINY's calls
    (``tiny_cfg``, 2 heads of 32: a 1 s request's joint, audio 50 + visual 8, and single
    calls, with the CFG pair as the batch, as ``train_longrun``'s deployed request gives them)
    and at ``wide_cfg``'s width (1536) with 24 heads of 64 and 16 heads of 96, at the 5 s
    request's and the 30 s window's joint and single calls; held at every width of
    ``ANY_K1_WIDTHS`` at ragged lengths on both sides of its 64-key tiles and 128-row blocks.
    Each timed case with its device time, the plain version's, the library call's (plain norm
    and RoPE then SDPA, in the same type) and its bound (fp32: at three TF32 products a
    product, and at the CUDA cores' rate beside it). Returns {dtype name: {case: result}}."""
    import dataclasses

    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.nn import exact_fp32

    cases = [(tiny_cfg, ANY_K1_TINY, "", True)]
    cases += [(dataclasses.replace(wide_cfg, num_heads=h), ANY_K1_WIDE,
               f"_h{h}", True) for h in ANY_K1_HEADS]
    cases += [(dataclasses.replace(tiny_cfg, hidden_size=2 * d, num_heads=2), ANY_K1_RAGGED,
               f"_d{d}", False) for d in ANY_K1_WIDTHS]
    results = {}
    b = 2
    for dtype, tname in ((torch.bfloat16, "bf16"), (torch.float16, "fp16"),
                         (torch.float32, "fp32")):
        gen = torch.Generator(device=dev).manual_seed(13)
        out = results[tname] = {}
        for c, shapes, suffix, timed_case in cases:
            h, d = c.num_heads, c.head_dim
            check(d != FA.HEAD_DIM, f"K1 any width: head_dim {d} is the wgmma kernels'")
            for name, (length, streams, tabs) in k1_cases(torch, dev, c, gen, shapes).items():
                wq, wk, cq, sq, ck, sk = tabs
                q, k, v = (torch.randn(b, length, h, d, device=dev, generator=gen).to(dtype)
                           for _ in range(3))
                full = lambda w, length=length, d=d: w.expand(length, d)  # noqa: E731
                args = (q, k, v, wq, wk, cq, sq, ck, sk)
                check(FA.kernel_route(q, k, v)[0], f"K1 any width: {tuple(q.shape)} does not "
                      f"take fused_qk_attention_mma.cu")

                def plain():
                    with exact_fp32(dtype):
                        return FA.fused_qk_attention_plain(q, k, v, full(wq), full(wk), cq, sq,
                                                           ck, sk)

                def library_call():
                    with exact_fp32(dtype):
                        qn = FA._norm_rope(q, full(wq), cq, sq, 1e-6).transpose(1, 2)
                        kn = FA._norm_rope(k, full(wk), ck, sk, 1e-6).transpose(1, 2)
                        return torch.nn.functional.scaled_dot_product_attention(
                            qn, kn, v.transpose(1, 2)).transpose(1, 2)

                with exact_fp32(dtype):
                    got = FA.fused_qk_attention(*args)
                ref = plain()
                torch.cuda.synchronize()
                case = name + suffix
                res = {"phase": "kernel", "kernel": "fused_qk_attention_mma", "dtype": tname,
                       "case": case, "b": b, "l": length, "h": h, "d": d,
                       **_check_variant(torch, f"K1 any width {tname} {case}", got, ref,
                                        dtype)}
                if timed_case:
                    tables = {t.data_ptr(): t.numel() * 4 for t in (cq, sq, ck, sk)}
                    n_bytes = (4 * q.numel() * q.element_size() + sum(tables.values())
                               + 2 * streams * d * 4)
                    long = length > 1000
                    res["kernel_ms"], res["host_ms"] = timed_ms(
                        torch, lambda: FA.fused_qk_attention(*args), 50 if long else 200)
                    res["plain_ms"] = gpu_ms(torch, plain, 5 if long else 20)
                    res["library_ms"] = gpu_ms(torch, library_call, 10 if long else 20)
                    flops = 4 * b * h * length * length * d
                    res.update(fp32_bound(n_bytes, flops) if dtype == torch.float32
                               else kernel_bound(n_bytes, flops))
                    with_shares(res)
                emit(res)
                out[case] = res
    return results


HEADS_PATH = (24, 64)  # heads_path's denoiser: XXL's width and depth, 24 heads of 64


def heads_path_phase(torch, dev, model, dac, card: str) -> int:
    """A denoiser whose heads are not 128 wide, through the normal entry points: XXL's YAML
    (``configs/yaml/hunyuanvideo-foley-xxl.yaml``) with ``num_heads`` 24, written under
    ``build/chip_smoke/`` and read by ``configs.config_from_yaml`` (hidden 1536, 18 + 36
    blocks, heads of 64), and one 5 s T2A request of ``STEPS`` Euler steps through
    ``generate_audio``: every joint and single attention is a launch of
    ``fused_qk_attention_mma.cu``, 540 in bf16. Its weights' shapes are XXL's but for the
    qk-norm vectors ([64], not [128]), so the model shares ``model``'s bf16 tensors (the CLI's
    random XXL; sharing saves a second 9.6 GiB denoiser and its init) and draws only those
    vectors, seeded, in [0.5, 1.5]. Returns the request's K1 launches."""
    import os

    from foley_tpu_torch.configs import config_from_yaml
    from foley_tpu_torch.configs.model_configs import YAML_DIR
    from foley_tpu_torch.models.mmdit import MMDiT
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.pipeline.generate import ModelBundle

    t_phase = time.perf_counter()
    heads, head_dim = HEADS_PATH
    text = (YAML_DIR / "hunyuanvideo-foley-xxl.yaml").read_text()
    check(text.count("num_heads: 12\n") == 1, "heads_path: the XXL YAML's num_heads")
    os.makedirs("build/chip_smoke", exist_ok=True)
    path = f"build/chip_smoke/hunyuanvideo-foley-xxl-{heads}-heads.yaml"
    with open(path, "w") as f:
        f.write(text.replace("num_heads: 12\n", f"num_heads: {heads}\n"))
    pipeline_cfg = config_from_yaml(path)
    cfg = pipeline_cfg.model
    check((cfg.hidden_size, cfg.head_dim, cfg.depth_triple_blocks, cfg.depth_single_blocks)
          == (model.cfg.hidden_size, head_dim, model.cfg.depth_triple_blocks,
              model.cfg.depth_single_blocks), f"heads_path: config {cfg}")
    denoiser = MMDiT(cfg, dtype=torch.bfloat16, device="meta")
    shared = model.state_dict()
    gen = torch.Generator(device=dev).manual_seed(24)
    state, drawn = {}, []
    for name, t in denoiser.state_dict().items():
        if t.shape == shared[name].shape:
            state[name] = shared[name]
        else:
            drawn.append(name)
            state[name] = torch.empty(t.shape, device=dev).uniform_(
                0.5, 1.5, generator=gen).to(shared[name].dtype)
    norms = sum(type(m).__name__ == "RMSNorm" for m in denoiser.modules())
    check(all(n.endswith("norm.weight") and state[n].shape == (head_dim,) for n in drawn)
          and len(drawn) == norms, f"heads_path: {len(drawn)} tensors differ from XXL's, "
          f"{norms} qk-norm weights")
    denoiser.load_state_dict(state, assign=True)
    bundle = ModelBundle(denoiser, dac, pipeline_cfg, compute_dtype=torch.bfloat16)
    q = torch.empty(1, 1, heads, head_dim, dtype=torch.bfloat16, device=dev)
    check(FA.kernel_route(q, q, q)[0], "heads_path: heads of 64 do not take the mma kernel")
    k1, _ = _counts(torch)
    res, _ = _request(torch, dev, bundle, pipeline_cfg, seed=24)
    check(k1.launches_by_dtype == {torch.bfloat16: res["k1_launches"]},
          f"heads_path: K1 launches by dtype {k1.launches_by_dtype}")
    emit({"phase": "heads_path", "yaml": path, "heads": heads, "head_dim": head_dim,
          "tensors_drawn": len(drawn), "steps": STEPS, **res, "card": card,
          "seconds": time.perf_counter() - t_phase})
    return res["k1_launches"]


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
        args = _forward_args(torch, dev, pipeline_cfg, dtype)

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
    perturbed weights, 5 s, 50 Euler steps, CFG 4.5, in fp16, in fp32, and in bf16 with the
    memory modes (``--quantization int8 --blocks_to_swap 30 --prefetch_blocks 1``), the
    model loaded anew each time, as the command does. Each WAV: 48,000 Hz, mono, 240,000
    frames, a non-zero peak; each request: 2,700 K1 launches of its type. Returns {run name:
    K1 launches}."""
    import os
    import wave

    import numpy as np

    from foley_tpu_torch import cli
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.kernels.common import reset_launches

    os.makedirs("build/chip_smoke", exist_ok=True)
    launches = {}
    memory_modes = ["--quantization", "int8", "--blocks_to_swap", "30", "--prefetch_blocks", "1"]
    for tname, precision, dtype, extra in (
            ("fp16", "fp16", torch.float16, []), ("fp32", "fp32", torch.float32, []),
            ("int8_swap30", "bf16", torch.bfloat16, memory_modes)):
        path = f"build/chip_smoke/cli_{tname}.wav"
        argv = ["--random_init", config, "--random_init_perturb", "--precision", precision,
                "--duration", str(DURATION_S), "--num_inference_steps", str(STEPS),
                "--guidance_scale", str(GUIDANCE), "--device", dev.type, "--output",
                path] + extra
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
        emit({"phase": "cli", "run": tname, "precision": precision, "argv": " ".join(argv),
              "wall_s": wall,
              "k1_launches": launches[tname], "wav": list(params), "peak": peak,
              "rms": float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))})
        torch.cuda.empty_cache()
    return launches


QUANT_MODES = ("fp8_e4m3fn", "int8", "int8_dynamic", "int4")
QUANT_DENSE_TOL = {"int8": 0.01, "int8_dynamic": 0.02, "int4": 0.08}  # max-relative, fp32:
                           # the JAX package's own bounds (tests/test_io.py); fp8 has none there
SWAP_CASES = ((30, 0), (54, 0), (54, 1))  # (blocks_to_swap, prefetch_blocks) on the bf16 model


def _forward_args(torch, dev, pipeline_cfg, dtype=None):
    """The 5 s CFG forward's inputs (bf16 unless ``dtype``), from seed 1."""
    dtype = dtype or torch.bfloat16
    cfg = pipeline_cfg.model
    gen = torch.Generator(device=dev).manual_seed(1)
    clip_len, sync_len = pipeline_cfg.t2a_lengths(DURATION_S)
    t_len = pipeline_cfg.latent_length(DURATION_S)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen).to(dtype)  # noqa: E731
    return (rnd(2, t_len, cfg.audio_vae_latent_dim), torch.full((2,), 500.0, device=dev),
            rnd(2, cfg.text_length, cfg.condition_dim), rnd(2, clip_len, cfg.clip_dim),
            rnd(2, sync_len, cfg.sync_feat_dim))


def _device_bytes(model) -> int:
    """The denoiser's bytes on the card: its parameters and buffers there, and the block
    swap's device slots."""
    n = sum(t.numel() * t.element_size() for t in
            list(model.parameters()) + list(model.buffers()) if t.is_cuda)
    if model.block_swap is not None:
        n += sum(t.numel() * t.element_size() for fam in model.block_swap.families.values()
                 for slot in fam.slots for t in slot.values())
    return n


def _request(torch, dev, bundle, pipeline_cfg, seed=11, phase_base=None):
    """One 5 s T2A request (50 Euler steps, CFG 4.5) on ``bundle``: its wall, the card's peak
    memory in it (everything this process holds there), above what was allocated before it
    and, given ``phase_base`` (bytes allocated at its phase's start), above that; K1's
    launches, the audio and the latents."""
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.pipeline.generate import generate_audio

    cfg = pipeline_cfg.model
    text = torch.zeros(1, 77, cfg.condition_dim)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    FA.fused_qk_attention.launches = 0
    t0 = time.perf_counter()
    res = generate_audio(bundle, text, text, DURATION_S, guidance_scale=GUIDANCE,
                         num_inference_steps=STEPS, sampler="euler", seed=seed,
                         return_latents=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FA.fused_qk_attention.launches
    per_request = STEPS * (cfg.depth_triple_blocks + cfg.depth_single_blocks)
    check(launches == per_request, f"K1 launches {launches} in a request, expected "
          f"{per_request}")
    rms = check_audio(res.audio_batch, 1, pipeline_cfg, DURATION_S)
    check_latents(torch, dev, res.latents, seed, pipeline_cfg, DURATION_S)
    peak = torch.cuda.max_memory_allocated()
    out = {"wall_s": wall, "peak_gib": peak / 2 ** 30, "peak_above_gib": (peak - base) / 2 ** 30,
           "k1_launches": launches, "rms": rms}
    if phase_base is not None:
        out["peak_above_phase_gib"] = (peak - phase_base) / 2 ** 30
    return out, res


def quant_phase(torch, dev, model, dac, pipeline_cfg) -> dict:
    """Quantized storage at XXL, one mode at a time (each a copy of the ``main_path`` bf16
    denoiser, freed before the next): the denoiser's bytes on the card, the counts and GiB
    saved; one single and one triple block quantized on the card against the same blocks
    quantized on the CPU (codes and scales equal bit for bit); the 5 s forward against the
    bf16 one (relative L2, reported); one XXL dense (a triple block's qkv, 1536 -> 4608, 256
    rows in fp32) against the bf16 weight's, within the JAX tests' max-relative bounds; one
    5 s request with its wall, peak memory (also above what was allocated at the phase's
    start: the quantized copy and the request's own) and 2,700 K1 launches. Returns {mode: K1
    launches}."""
    import copy

    from torch import nn

    from foley_tpu_torch.core.params import param_bytes
    from foley_tpu_torch.io.quantize import quantize_params
    from foley_tpu_torch.ops.nn import dense
    from foley_tpu_torch.pipeline.generate import ModelBundle

    torch.cuda.synchronize()
    phase_base = torch.cuda.memory_allocated()
    args = _forward_args(torch, dev, pipeline_cfg)
    with torch.no_grad():
        ref = model(*args).float()
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(256, pipeline_cfg.model.hidden_size, device=dev, generator=gen)
    qkv = model.triple_blocks[0].audio_self_attn_qkv
    dense_ref = dense(x, qkv.weight.float(), qkv.bias.float())
    bf16_bytes = param_bytes(model)
    launches = {}
    for mode in QUANT_MODES:
        t0 = time.perf_counter()
        out = {"phase": "quant", "mode": mode, "config": "xxl", "bf16_gib": bf16_bytes / 2 ** 30}
        qmodel = copy.deepcopy(model)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts, saved = quantize_params(qmodel, mode)
        torch.cuda.synchronize()
        out.update(quantize_s=time.perf_counter() - t1, counts=counts,
                   saved_gib=saved / 2 ** 30, device_gib=_device_bytes(qmodel) / 2 ** 30)
        check(bf16_bytes - param_bytes(qmodel) == saved, f"{mode}: bytes saved {saved} but "
              f"the model shrank by {bf16_bytes - param_bytes(qmodel)}")
        # blocks quantized on the card against the same blocks quantized on the CPU
        for family in ("single_blocks", "triple_blocks"):
            holder = nn.Module()
            setattr(holder, family, nn.ModuleList([copy.deepcopy(
                getattr(model, family)[0]).cpu()]))
            quantize_params(holder, mode)
            cpu_state = getattr(holder, family)[0].state_dict()
            card_state = getattr(qmodel, family)[0].state_dict()
            check(sorted(cpu_state) == sorted(card_state) and all(
                card_state[k].dtype == cpu_state[k].dtype and torch.equal(
                    card_state[k].cpu().view(torch.uint8), cpu_state[k].view(torch.uint8))
                for k in cpu_state), f"{mode}: {family}[0] quantized on the card differs from "
                "the CPU's")
        out["blocks_equal_cpu"] = True
        with torch.no_grad():
            got = qmodel(*args).float()
        check(bool(torch.isfinite(got).all()), f"{mode}: non-finite velocity")
        out["forward_rel_l2_vs_bf16"] = float((got - ref).norm() / ref.norm())
        qqkv = qmodel.triple_blocks[0].audio_self_attn_qkv
        d = dense(x, qqkv.stored_weight(), qqkv.bias.float())
        out["dense_max_rel_vs_bf16"] = float((d - dense_ref).abs().max()
                                             / dense_ref.abs().max())
        tol = QUANT_DENSE_TOL.get(mode)
        out["dense_tol"] = tol
        check(tol is None or out["dense_max_rel_vs_bf16"] < tol,
              f"{mode}: XXL dense max-relative error {out['dense_max_rel_vs_bf16']} >= {tol}")
        del got, d
        bundle = ModelBundle(qmodel, dac, pipeline_cfg, compute_dtype=torch.bfloat16)
        req, _ = _request(torch, dev, bundle, pipeline_cfg, phase_base=phase_base)
        out["request"] = req
        launches[mode] = req["k1_launches"]
        del bundle, qmodel
        torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t0
        emit(out)
    return launches


def _copy_rates(torch, model, passes: int = 2) -> list:
    """GB/s of ``passes`` passes of page-locked host -> card copies of every swapped block
    into a slot of its family, on a side stream (each timed with CUDA events)."""
    from foley_tpu_torch.parallel import offload

    swap, side, rates = model.block_swap, torch.cuda.Stream(), []
    slots = {f: {n: torch.empty_like(t, device="cuda") for n, t in offload.block_tensors(
        getattr(model, f)[min(fam.host)]).items()} for f, fam in swap.families.items()
        if fam.host}
    for _ in range(passes):
        n_bytes = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            start.record(side)
            for family, slot in slots.items():
                for i in offload.swapped_blocks(model, family):
                    for n, t in offload.block_tensors(getattr(model, family)[i]).items():
                        slot[n].copy_(t, non_blocking=True)
                        n_bytes += t.numel() * t.element_size()
            end.record(side)
        torch.cuda.synchronize()
        rates.append(n_bytes / (start.elapsed_time(end) / 1e3) / 1e9)
    return rates


def block_swap_phase(torch, dev, model, dac, pipeline_cfg) -> dict:
    """Block swap at XXL: the ``main_path`` bf16 denoiser with 30 blocks swapped (the node's
    default) and with 54 at ``prefetch_blocks`` 0 and 1, then an int4 copy with 54. For each:
    the 5 s velocity against the resident model's, equal bit for bit; the partition report;
    the denoiser's bytes on the card (with the slots); one 5 s request's wall, peak memory
    and K1 launches; the host -> card GB a step (every swapped block once) and the rates: two
    timed passes of the copies alone, and the bytes of the request's steps over its wall. The
    bf16 model is merged back at the end. Returns {case: K1 launches}."""
    import copy

    from foley_tpu_torch.io.quantize import quantize_params
    from foley_tpu_torch.parallel import offload
    from foley_tpu_torch.pipeline.generate import ModelBundle

    args = _forward_args(torch, dev, pipeline_cfg)
    launches = {}
    resident = {}
    with torch.no_grad():
        resident["bf16"] = model(*args)
    int4 = None
    cases = [("bf16", n, p) for n, p in SWAP_CASES] + [("int4", 54, 0)]
    for precision, n, prefetch in cases:
        t0 = time.perf_counter()
        target = model
        if precision == "int4":
            offload.merge_block_suffix(model)  # the bf16 model back whole, then its int4 copy
            int4 = copy.deepcopy(model)
            quantize_params(int4, "int4")
            with torch.no_grad():
                resident["int4"] = int4(*args)
            target = int4
        name = f"{precision}_swap{n}_prefetch{prefetch}"
        out = {"phase": "block_swap", "case": name, "config": "xxl", "blocks_to_swap": n,
               "prefetch_blocks": prefetch}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        offload.offload_block_suffix(target, n)
        torch.cuda.synchronize()
        out["split_s"] = time.perf_counter() - t1
        out["partition"] = offload.partition_report(target)
        check(all(t.is_pinned() for family in offload.FAMILIES
                  for i in offload.swapped_blocks(target, family)
                  for t in offload.block_tensors(getattr(target, family)[i]).values()),
              f"{name}: a swapped block's tensors are not page-locked")
        with torch.no_grad():
            got = target(*args, offload_prefetch=prefetch + 1)
        check(torch.equal(got, resident[precision]),
              f"{name}: the swapped velocity differs from the resident one")
        out["velocity_equal"] = True
        out["device_gib"] = _device_bytes(target) / 2 ** 30
        bundle = ModelBundle(target, dac, pipeline_cfg, compute_dtype=torch.bfloat16,
                             offload_prefetch=prefetch + 1)
        req, _ = _request(torch, dev, bundle, pipeline_cfg)
        out["request"] = req
        launches[name] = req["k1_launches"]
        gb_step = out["partition"]["host_mb"] / 1e3
        out["h2d_gb_per_step"] = gb_step
        out["request_h2d_gb_per_s"] = gb_step * STEPS / req["wall_s"]
        out["copy_gb_per_s"] = _copy_rates(torch, target)
        out["seconds"] = time.perf_counter() - t0
        del bundle, got
        emit(out)
    del int4
    offload.merge_block_suffix(model)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------------
# The rest of inference: the denoiser configs off K1, video ingest, LoRA, the desync scorer
# ---------------------------------------------------------------------------------

LORA_RANK, LORA_META_SCALE = 16, 0.5
AV_RMS_RATIO = 0.1         # a coalesced client's WAV: RMS distance to its own solo run under
                           # this share of that to the other client's solo run
DESYNC_REL_TOL = 1e-4      # the scorer's logits on the card against the CPU, relative L2, both
                           # in true fp32 (sums in another order read ~1e-6)
DESYNC_CPU_S = 2.0         # the clip's first seconds the CPU scorer is held on (a cut)


def _counts(torch):
    """Reset and return K1's and K2's wrappers (their launch counters at 0)."""
    from foley_tpu_torch.ops.kernels import flash_attention as FL
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.kernels.common import reset_launches

    reset_launches(FA.fused_qk_attention)
    reset_launches(FL.flash_attention)
    return FA.fused_qk_attention, FL.flash_attention


def _write_png(path: str, rgb, zlib_level: int = 1, depth: int = 8,
               interlace: bool = False) -> None:
    """An RGB PNG of 8- or 16-bit samples (``rgb`` uint8 or uint16), plain or Adam7
    interlaced, with the standard library: scanline r of each pass filtered with type r % 5
    (None, Sub, Up, Average, Paeth), so every filter the reader undoes is in every frame."""
    import struct
    import zlib

    import numpy as np

    from foley_tpu_torch.io.png import ADAM7

    bpp = 3 * depth // 8
    body = []
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = rgb[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        img = np.frombuffer(sub.astype(">u2" if depth == 16 else np.uint8).tobytes(),
                            np.uint8).reshape(len(sub), -1).astype(np.int16)
        left, up, upleft = (np.zeros_like(img) for _ in range(3))
        left[:, bpp:], up[1:], upleft[1:, bpp:] = img[:, :-bpp], img[:-1], img[:-1, :-bpp]
        pa, pb = np.abs(up - upleft), np.abs(left - upleft)
        pc = np.abs(left + up - 2 * upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        preds = (np.zeros_like(img), left, up, (left + up) >> 1, paeth)
        rows = np.empty((len(img), 1 + img.shape[1]), np.uint8)
        for r in range(len(img)):
            rows[r, 0] = r % 5
            rows[r, 1:] = ((img[r] - preds[r % 5][r]) & 0xFF).astype(np.uint8)
        body.append(rows.tobytes())

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, int(interlace)))
                + chunk(b"IDAT", zlib.compress(b"".join(body), zlib_level))
                + chunk(b"IEND", b""))


def _random_xxl(torch, dev, config, perturb):
    """``HunyuanModelLoader.init_random`` in bf16 from seed 0: what the CLI
    (``--random_init_perturb``) and the server build."""
    from foley_tpu_torch.api import nodes

    return nodes.HunyuanModelLoader.init_random(config, "bf16", 0, perturb=perturb, device=dev)


def _stub_server(srv_mod, argv):
    """``serving.server.main(argv)`` with the HTTP server replaced: returns the service."""
    served = {}

    class NoServer:
        def serve_forever(self):
            pass

    original = srv_mod.create_server
    srv_mod.create_server = lambda service, host, port: served.setdefault("svc", service) and (
        NoServer())
    try:
        check(srv_mod.main(argv) == 0, f"server main {argv} failed")
    finally:
        srv_mod.create_server = original
    return served["svc"]


def _wav_samples(path):
    import wave

    import numpy as np

    with wave.open(path) as f:
        check((f.getframerate(), f.getnchannels(), f.getsampwidth()) == (48000, 1, 2),
              f"WAV {f.getparams()}")
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def configs_phase(torch, dev, model, pipeline_cfg):
    """The joint attention off K1's precondition at XXL bf16, 5 s shapes, on ``model``: the
    exact interleave / rotate / decouple path (the plain route's tables: K1's decomposed
    interleave tables dropped) and a ``use_attention_mask`` config with an all-true text
    mask, both through the plain ``sdpa``, each held against the decomposed K1 forward on the
    same weights and inputs (relative L2 within the forward's bf16 bound). K1 launches a
    forward: 54 fused, 36 (the single blocks) on the plain route."""
    import dataclasses

    from foley_tpu_torch.models import mmdit

    t_phase = time.perf_counter()
    cfg = pipeline_cfg.model
    args = _forward_args(torch, dev, pipeline_cfg)
    audio_len, visual_len, text_len = args[0].shape[1], args[3].shape[1], args[2].shape[1]
    k1, _ = _counts(torch)
    out, launches = {}, {}
    with torch.no_grad():
        fused = model(*args)
        launches["fused"] = k1.launches
        k1.launches = 0
        tables = model.attention_tables(audio_len, visual_len, text_len, dev)
        exact = model(*args, tables=mmdit.AttentionTables(
            ropes=tables.ropes._replace(audio_joint=None, visual_joint=None), joint_rope=None,
            triple_norms=None, single_norms=tables.single_norms))
        launches["exact_interleave"] = k1.launches
        k1.launches = 0
        model.cfg = dataclasses.replace(cfg, use_attention_mask=True)
        try:
            mask = torch.ones(args[2].shape[:2], dtype=torch.bool, device=dev)
            masked = model(*args, cond_mask=mask)
        finally:
            model.cfg = cfg
        launches["masked"] = k1.launches
    torch.cuda.synchronize()
    for name, got in (("exact_interleave", exact), ("masked_all_true", masked)):
        out[name] = _rel_l2(got, fused)
        check(bool(torch.isfinite(got).all()), f"configs {name}: non-finite velocity")
        check(out[name] <= FORWARD_REL_TOL, f"configs {name}: relative L2 {out[name]} from "
              f"the K1 forward, limit {FORWARD_REL_TOL}")
    n_single = cfg.depth_single_blocks
    check(launches == {"fused": n_single + cfg.depth_triple_blocks,
                       "exact_interleave": n_single, "masked": n_single},
          f"configs: K1 launches {launches}")
    emit({"phase": "configs", "rel_l2_vs_k1": out, "tol": FORWARD_REL_TOL,
          "k1_launches": launches, "seconds": time.perf_counter() - t_phase})
    return launches


def video_ingest_phase(torch, dev, foley_model, dac, pipeline_cfg, config="xxl"):
    """V2A from a directory of PNG frames: 125 frames of the 25 fps 1280x720 clip written with
    the standard library (every scanline filter in every frame), read back equal to the clip
    (the decode's seconds and peak device memory); then through ``cli.main --single_video
    DIR --frames_fps 25 --random_init xxl --random_init_perturb`` (its WAV equal to the sampler node's on the
    same model, encoders, clip and seed, bit for bit), the server's ``frames_path``
    (``--random_init xxl --enable_v2a``; its visual features equal to the same encoders' on
    the clip) and ``standalone.feature_process(DIR)`` (the features equal, then one
    ``denoise_process``): 2,700 K1 and 12 K2 launches a request. A ``.mp4`` raises, naming
    ffmpeg and PyAV (the card's machine has neither). Returns {surface: (K1, K2)}, the
    frames directory and its frames as read back."""
    import os
    import shutil

    import numpy as np

    from foley_tpu_torch import cli
    from foley_tpu_torch.api import nodes
    from foley_tpu_torch.configs import ClapTextConfig
    from foley_tpu_torch.io.native import float_to_pcm16
    from foley_tpu_torch.models import clap, siglip2, synchformer
    from foley_tpu_torch.pipeline import features, standalone, video
    from foley_tpu_torch.pipeline.manager import OffloadModelManager
    from foley_tpu_torch.serving import server as srv_mod

    t_phase = time.perf_counter()
    cfg = pipeline_cfg.model
    per_k1 = STEPS * (cfg.depth_triple_blocks + cfg.depth_single_blocks)
    frames_dir = "build/chip_smoke/frames_720p"
    shutil.rmtree(frames_dir, ignore_errors=True)
    os.makedirs(frames_dir)
    clip_u8 = make_clip(np, 1, DURATION_S, CLIP_HW)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(HOST_THREADS) as pool:  # numpy and zlib release the GIL
        list(pool.map(lambda i: _write_png(os.path.join(frames_dir, f"frame_{i + 1}.png"),
                                           clip_u8[i]), range(len(clip_u8))))
    write_s = time.perf_counter() - t0
    clip = clip_u8.astype(np.float32) / 255.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    frames, fps = video.read_frames_dir(frames_dir, fps=float(CLIP_FPS), device=dev)
    decode_s = time.perf_counter() - t0
    decode_peak_bytes = torch.cuda.max_memory_allocated() - resident
    check(fps == CLIP_FPS and np.array_equal(frames, clip),
          "the PNG frames read back differ from the clip")
    launches = {}

    # the command line, against the sampler node on the same model, encoders, clip and seed
    wav_path = "build/chip_smoke/video_cli.wav"
    k1, k2 = _counts(torch)
    t0 = time.perf_counter()
    rc = cli.main(["--random_init", config, "--random_init_perturb", "--single_video",
                   frames_dir, "--frames_fps", str(CLIP_FPS), "--duration", str(DURATION_S),
                   "--num_inference_steps", str(STEPS), "--guidance_scale", str(GUIDANCE),
                   "--device", dev.type, "--output", wav_path])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"cli --single_video exited {rc}")
    launches["cli"] = (k1.launches, k2.launches)
    deps = {"dac_params": dac, "dac_cfg": pipeline_cfg.dac,
            "siglip2": siglip2.init_random(2, cfg.clip_dim, device=dev),
            "synchformer": synchformer.init_random(3, cfg.sync_feat_dim, device=dev)}
    audio, _ = nodes.HunyuanFoleySampler().generate_audio(
        foley_model, deps, frame_rate=float(CLIP_FPS), image=clip, duration=DURATION_S,
        prompt="", negative_prompt="noisy, harsh", cfg_scale=GUIDANCE, steps=STEPS,
        sampler="euler", batch_size=1, seed=0, force_offload=False, allow_unconditioned=True)
    ref = float_to_pcm16(np.asarray(audio["waveform"])[0, 0])
    got = _wav_samples(wav_path)
    os.remove(wav_path)
    check(np.array_equal(got, ref), f"cli V2A WAV differs from the sampler node's: max "
          f"{int(np.abs(got.astype(np.int32) - ref).max())} steps")

    # the server's frames_path
    svc = _stub_server(srv_mod, ["--random_init", config, "--enable_v2a", "--device", dev.type,
                                 "--durations", str(DURATION_S), "--warmup_steps", "1"])
    body = {"frames_path": frames_dir, "frames_fps": float(CLIP_FPS), "duration": DURATION_S,
            "steps": STEPS, "cfg_scale": GUIDANCE, "seed": 0}
    path_feats = svc._visual_features(body, DURATION_S)
    clip_feats = features.encode_video(svc.video_encoders, clip, CLIP_FPS, DURATION_S,
                                       pipeline_cfg)
    check(all(torch.equal(a, b) for a, b in zip(path_feats, clip_feats)),
          "frames_path features differ from the clip's")
    k1, k2 = _counts(torch)
    t0 = time.perf_counter()
    served = svc.generate(dict(body))
    torch.cuda.synchronize()
    server_s = time.perf_counter() - t0
    launches["server"] = (k1.launches, k2.launches)
    check(np.abs(served["waveform"]).max() > 0, "silent frames_path response")
    del svc, served, path_feats, clip_feats
    torch.cuda.empty_cache()

    # standalone.feature_process on the directory, then denoise_process
    manager = OffloadModelManager(policy="drop")
    manager.pipeline_cfg, manager.device = pipeline_cfg, dev
    manager.register("foley", lambda: foley_model)
    manager.register("dac", lambda: {"params": dac, "cfg": pipeline_cfg.dac})
    manager.register("siglip2", lambda: deps["siglip2"])
    manager.register("synchformer", lambda: deps["synchformer"])
    ccfg = ClapTextConfig()
    manager.register("clap", lambda: clap.ClapTextEncoder(
        clap.init(ccfg, torch.Generator(device=dev).manual_seed(5), device=dev),
        SeededTokenizer(ccfg.vocab_size, ccfg.pad_token_id)))
    k1, k2 = _counts(torch)
    t0 = time.perf_counter()
    vis, text, length = standalone.feature_process(frames_dir, PROMPT, manager,
                                                   duration_s=DURATION_S)
    out, _ = standalone.denoise_process(vis, text, length, manager, guidance_scale=GUIDANCE,
                                        num_inference_steps=STEPS, seed=0)
    torch.cuda.synchronize()
    fp_s = time.perf_counter() - t0
    launches["feature_process"] = (k1.launches, k2.launches)
    # feature_process declares a directory's frames at 16 fps, as the JAX package does
    f8 = features.resample_frames(clip, 16.0, DURATION_S, pipeline_cfg.siglip2_fps)
    f25 = features.resample_frames(clip, 16.0, DURATION_S, pipeline_cfg.synchformer_fps)
    check(torch.equal(vis["siglip2_feat"], deps["siglip2"].encode(f8))
          and torch.equal(vis["syncformer_feat"],
                          synchformer.encode_segments(deps["synchformer"], f25)),
          "feature_process features differ from the clip's")
    check(np.abs(out).max() > 0 and out.shape == (1, 1, int(length * 48000)),
          f"feature_process audio {out.shape}")
    for name, (n1, n2) in launches.items():
        check(n1 == per_k1 and n2 == deps["siglip2"].cfg.num_hidden_layers,
              f"video_ingest {name}: K1 {n1}, K2 {n2}")
    try:
        video.read_video_frames("build/chip_smoke/clip.mp4", device=dev)
        raise AssertionError("unreachable")
    except RuntimeError as e:
        check("ffmpeg" in str(e) and "PyAV" in str(e), f".mp4 raised {e}")
        mp4_error = str(e)
    emit({"phase": "video_ingest", "frames": int(frames.shape[0]), "hw": list(CLIP_HW),
          "png_write_s": write_s, "png_bytes": sum(os.path.getsize(os.path.join(frames_dir, n))
                                                   for n in os.listdir(frames_dir)),
          "decode_s": decode_s, "decode_peak_bytes": decode_peak_bytes, "cli_wall_s": cli_s,
          "server_request_s": server_s,
          "feature_process_request_s": fp_s, "launches_k1_k2": launches,
          "mp4_error": mp4_error, "phase_seconds": time.perf_counter() - t_phase})
    return launches, frames_dir, frames


def _lora_adapter(torch, model, rank: int, seed: int) -> dict:
    """A rank-``rank`` adapter over ``models/lora.py::DEFAULT_TARGETS`` for ``model``'s
    blocks, in the JAX tree's flat names and layouts: ``a`` Kaiming-uniform over the fan-in
    (the JAX ``init_lora``'s), ``b`` normal(0.02), not zero, drawn on the CPU from ``seed``."""
    from foley_tpu_torch.models.lora import DEFAULT_TARGETS, FAMILIES
    from foley_tpu_torch.ops.nn import QuantizableWeight

    g = torch.Generator().manual_seed(seed)
    adapter = {}
    for family in FAMILIES:
        blocks = getattr(model, family)
        for path, m in blocks[0].named_modules():
            if not (isinstance(m, QuantizableWeight)
                    and any(p in DEFAULT_TARGETS for p in path.split("."))):
                continue
            n, w = len(blocks), m.weight
            taps = () if w.ndim == 2 else (w.shape[2],)
            fan_in = w.shape[1] * (taps[0] if taps else 1)
            a = (torch.rand(n, *taps, w.shape[1], rank, generator=g) * 2 - 1) * fan_in ** -0.5
            adapter[f"{family}.{path}.a"] = a
            adapter[f"{family}.{path}.b"] = torch.randn(n, *taps, rank, w.shape[0],
                                                        generator=g) * 0.02
    return adapter


def lora_phase(torch, dev, foley_model, dac, pipeline_cfg, config="xxl"):
    """LoRA merge at load at XXL: a rank-16 adapter over the default targets (``b`` not
    zero) written by ``models/lora.py::save_lora`` (meta scale 0.5). On ``foley_model`` (the
    CLI's ``--random_init xxl --random_init_perturb`` model): a 5 s T2A request on the base
    weights, the merge at scale 0 (the same latents), the merge at scale 0.5 (its seconds;
    one triple and one single block merged on the CPU equal the card's bit for bit) and a
    request; then ``cli.main --random_init xxl --random_init_perturb --lora`` and the
    server's ``main --random_init xxl --lora``, each one request: their merged weights equal
    the in-process merge's bit for bit (the server's model is not perturbed, which touches
    no adapted weight); last a request with the merged model in int8. 2,700 K1 launches a
    request. Returns the K1 launches by request and the WAV of the merged request."""
    import copy
    import os

    import numpy as np

    from foley_tpu_torch import cli
    from foley_tpu_torch.api import nodes
    from foley_tpu_torch.io.audio import write_wav
    from foley_tpu_torch.models import lora
    from foley_tpu_torch.pipeline.generate import ModelBundle
    from foley_tpu_torch.serving import server as srv_mod

    t_phase = time.perf_counter()
    model = foley_model["params"]
    adapter_dir = "build/chip_smoke/lora_xxl"
    t0 = time.perf_counter()
    lora.save_lora(adapter_dir, _lora_adapter(torch, model, LORA_RANK, 7), LORA_RANK,
                   LORA_META_SCALE)
    write_s = time.perf_counter() - t0
    adapter_bytes = sum(os.path.getsize(os.path.join(adapter_dir, n))
                        for n in os.listdir(adapter_dir))
    adapter, meta_scale = lora.load_lora(adapter_dir)
    check(meta_scale == LORA_META_SCALE, f"meta scale {meta_scale}")
    bundle = ModelBundle(model, dac, pipeline_cfg, compute_dtype=torch.bfloat16)
    k1_by_request = {}
    base, res_base = _request(torch, dev, bundle, pipeline_cfg)
    k1_by_request["base"] = base["k1_launches"]
    # the card's merge held against the CPU's on the first single block (a cut: the first
    # triple block's CPU merge took about 11 s more; PERF.md §4)
    cpu_blocks = torch.nn.Module()
    cpu_blocks.single_blocks = torch.nn.ModuleList([copy.deepcopy(model.single_blocks[0]).cpu()])
    cpu_blocks.block_swap = None
    lora.merge_lora(model, adapter, 0.0)
    zero, res_zero = _request(torch, dev, bundle, pipeline_cfg)
    k1_by_request["scale_0"] = zero["k1_launches"]
    check(torch.equal(torch.as_tensor(res_zero.latents), torch.as_tensor(res_base.latents)),
          "lora_scale 0: latents differ from the base model's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_merged = lora.merge_lora(model, adapter, meta_scale)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    lora.merge_lora(cpu_blocks, {k: v[:1] for k, v in adapter.items()
                                 if k.startswith("single_blocks.")}, meta_scale)
    card = model.single_blocks[0].state_dict()
    for k, v in cpu_blocks.single_blocks[0].state_dict().items():
        check(torch.equal(card[k].cpu(), v), f"single_blocks[0].{k}: card merge != CPU merge")
    merged, res_merged = _request(torch, dev, bundle, pipeline_cfg)
    k1_by_request["merged"] = merged["k1_launches"]
    check(_rel_l2(torch.as_tensor(res_merged.latents), torch.as_tensor(res_base.latents))
          > 0, "the adapter did not move the latents")
    wav_path = "build/chip_smoke/lora_t2a.wav"
    write_wav(wav_path, res_merged.audio_first[0], pipeline_cfg.dac.sample_rate)
    adapted = []  # "triple_blocks.<i>.<path>.weight" of every adapted weight
    for name in adapter:
        if name.endswith(".a"):
            fam, _, path = name[:-2].partition(".")
            adapted += [f"{fam}.{i}.{path}.weight" for i in range(len(getattr(model, fam)))]
    ref = model.state_dict()

    def same_merge(other, keys, name):
        got = other.state_dict()
        for k in keys:
            check(torch.equal(got[k], ref[k]), f"{name}: {k} differs from the in-process merge")

    # the command line: capture its model at the sampler
    seen = {}
    original = nodes.HunyuanFoleySampler.generate_audio

    def capture(self, fm, *a, **k):
        seen["model"] = fm["params"]
        return original(self, fm, *a, **k)

    nodes.HunyuanFoleySampler.generate_audio = capture
    k1, _ = _counts(torch)
    path = "build/chip_smoke/lora_cli.wav"
    try:
        t0 = time.perf_counter()
        rc = cli.main(["--random_init", config, "--random_init_perturb", "--lora", adapter_dir,
                       "--duration", str(DURATION_S), "--num_inference_steps", str(STEPS),
                       "--guidance_scale", str(GUIDANCE), "--device", dev.type, "--output", path])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        nodes.HunyuanFoleySampler.generate_audio = original
    check(rc == 0, f"cli --lora exited {rc}")
    k1_by_request["cli"] = k1.launches
    check(np.abs(_wav_samples(path)).max() > 0, "cli --lora: silent WAV")
    os.remove(path)
    same_merge(seen.pop("model"), ref.keys(), "cli --lora")
    torch.cuda.empty_cache()

    svc = _stub_server(srv_mod, ["--random_init", config, "--lora", adapter_dir, "--device",
                                 dev.type, "--durations", str(DURATION_S), "--warmup_steps", "1"])
    same_merge(svc.bundle.mmdit, adapted, "server --lora")
    k1, _ = _counts(torch)
    t0 = time.perf_counter()
    out = svc.generate({"duration": DURATION_S, "steps": STEPS, "cfg_scale": GUIDANCE,
                        "seed": 0})
    torch.cuda.synchronize()
    server_s = time.perf_counter() - t0
    k1_by_request["server"] = k1.launches
    check(out["waveform"].shape == (1, int(DURATION_S * 48000)), "server --lora response")
    del svc, out
    torch.cuda.empty_cache()

    nodes.quantize_model(model, "int8")
    int8, _ = _request(torch, dev, bundle, pipeline_cfg)
    k1_by_request["merged_int8"] = int8["k1_launches"]
    per_k1 = STEPS * (pipeline_cfg.model.depth_triple_blocks
                      + pipeline_cfg.model.depth_single_blocks)
    check(all(n == per_k1 for n in k1_by_request.values()), f"lora K1 {k1_by_request}")
    emit({"phase": "lora", "rank": LORA_RANK, "adapter_bytes": adapter_bytes,
          "adapter_write_s": write_s, "weights_merged": n_merged, "merge_s": merge_s,
          "scale": meta_scale, "request_wall_s": {"base": base["wall_s"],
                                                  "merged": merged["wall_s"],
                                                  "merged_int8": int8["wall_s"]},
          "cli_wall_s": cli_s, "server_request_s": server_s, "k1_launches": k1_by_request,
          "latent_rel_l2_merged_vs_base": _rel_l2(torch.as_tensor(res_merged.latents),
                                                  torch.as_tensor(res_base.latents)),
          "phase_seconds": time.perf_counter() - t_phase})
    return k1_by_request, wav_path


def desync_phase(torch, dev, frames_dir: str, frames, wav_path: str):
    """The AV desync scorer at its real widths (Synchformer ``divided_224_16x4``, AST base,
    the 3-layer head), random weights written as a reference-layout checkpoint
    (``sync_scorer.random_checkpoint``): ``cli.main --desync_score --single_video DIR
    --audio_input WAV`` on the ``video_ingest`` frames and the ``lora`` request's WAV (the
    offset on the 21-class grid, the seconds); the logits on the card of ``frames`` (the
    directory as ``video_ingest`` read it back) finite, and on the
    clip's first ``DESYNC_CPU_S`` within ``DESYNC_REL_TOL`` of the same scorer on the CPU."""
    import contextlib
    import io
    import os

    import numpy as np

    from foley_tpu_torch import cli
    from foley_tpu_torch.io.audio import read_wav
    from foley_tpu_torch.io.convert import save_safetensors
    from foley_tpu_torch.models import sync_scorer

    t_phase = time.perf_counter()
    ckpt_dir = "build/chip_smoke/desync"
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = os.path.join(ckpt_dir, "synchformer_state_dict.safetensors")
    t0 = time.perf_counter()
    save_safetensors(ckpt, sync_scorer.random_checkpoint(13))
    ckpt_s = time.perf_counter() - t0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["--desync_score", "--single_video", frames_dir, "--frames_fps",
                       str(CLIP_FPS), "--audio_input", wav_path, "--model_path", ckpt_dir,
                       "--device", dev.type])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    line = stdout.getvalue().strip().splitlines()[-1]
    check(rc == 0 and line.startswith("predicted AV offset: "), f"--desync_score: {rc} {line}")
    offset = float(line.split(": ")[1].split()[0])
    check(bool(np.isclose(sync_scorer.make_class_grid(), offset, atol=5e-3).any()),
          f"offset {offset} is not on the class grid")
    scorer = sync_scorer.load_desync_scorer(ckpt, dev)
    wav, _ = read_wav(wav_path, target_sr=16000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = scorer.logits(frames, wav)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (1, 21),
          f"logits {tuple(logits.shape)}")
    check(abs(float(sync_scorer.predicted_offset_seconds(logits)[0]) - offset) < 5e-3,
          "the CLI's offset differs from the scorer's")
    # the CPU reference on the clip's first DESYNC_CPU_S (a cut: the whole clip's CPU scorer
    # took 28 s; PERF.md §4), against the card's on the same prefix
    frames_cut = frames[:int(DESYNC_CPU_S * CLIP_FPS)]
    wav_cut = wav[..., :int(DESYNC_CPU_S * 16000)]
    card_cut = scorer.logits(frames_cut, wav_cut).cpu()
    del scorer
    t0 = time.perf_counter()
    cpu = sync_scorer.load_desync_scorer(ckpt, "cpu").logits(frames_cut, wav_cut)
    cpu_s = time.perf_counter() - t0
    rel = _rel_l2(card_cut, cpu)
    check(rel <= DESYNC_REL_TOL, f"desync logits {rel} from the CPU's, limit {DESYNC_REL_TOL}")
    os.remove(ckpt)
    emit({"phase": "desync", "offset_s": offset, "cli_wall_s": cli_s, "score_s": score_s,
          "checkpoint_write_s": ckpt_s, "logits": logits[0].tolist(),
          "rel_l2_vs_cpu": rel, "rel_tol": DESYNC_REL_TOL, "cpu_clip_s": DESYNC_CPU_S,
          "cpu_load_and_score_s": cpu_s,
          "phase_seconds": time.perf_counter() - t_phase})


IMAGE_QUALITY = 95          # the MJPEG writer's "high": the clip's JPEGs
IMAGE_CPU_FRAMES = 3        # frames also encoded and decoded on the CPU (equal bit for bit)
AST_MASK_REL_TOL = 1e-5     # the masked AST features on the card against the CPU, relative L2
                            # in true fp32 (the desync tests' real-width bound)


def _write_bmp565(path: str, rgb) -> None:
    """A bottom-up 16-bit BI_BITFIELDS (5-6-5) BMP with a V5 header."""
    import struct

    import numpy as np

    h, w, _ = rgb.shape
    px = ((rgb[..., 0].astype(np.uint16) >> 3) << 11 | (rgb[..., 1].astype(np.uint16) >> 2) << 5
          | rgb[..., 2].astype(np.uint16) >> 3).astype("<u2")
    stride = (w * 2 + 3) & ~3
    data = b"".join(r.tobytes().ljust(stride, b"\0") for r in px[::-1])
    info = struct.pack("<IiiHHIIiiII", 124, w, h, 1, 16, 3, len(data), 2835, 2835, 0, 0)
    info = (info + struct.pack("<4I", 0xF800, 0x7E0, 0x1F, 0)).ljust(124, b"\0")
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 14 + 124 + len(data), 0, 0, 14 + 124) + info + data)


def _ast_mask_check(torch, dev) -> dict:
    """The AST's content mask at the real width (768, 12 layers, 12 heads) in true fp32:
    ``extract_features`` with a ``cont_mask`` (scattered cells and one whole time step) on
    the card against the CPU, on seeded weights."""
    import copy

    import numpy as np

    from foley_tpu_torch.models import ast as ast_mod
    from foley_tpu_torch.models.synchformer import SpatialAgg
    from foley_tpu_torch.ops.nn import true_fp32

    cfg = ast_mod.ASTConfig()
    gen = torch.Generator().manual_seed(17)
    ast, agg = ast_mod.AST(cfg, device="cpu"), SpatialAgg(cfg.hidden_size, 3072, torch.float32,
                                                          torch.device("cpu"))
    with torch.no_grad():
        for name, p in list(ast.named_parameters()) + list(agg.named_parameters()):
            p.normal_(0.0, 0.02, generator=gen)
            if name.endswith("weight") and p.ndim == 1:  # LayerNorm scales
                p.add_(1.0)
    rng = np.random.default_rng(18)
    spec = torch.from_numpy(rng.normal(size=(4, 66, 128)).astype(np.float32))
    mask = np.ones((4, 66, 128), np.float32)
    mask[rng.random(mask.shape) < 2e-3] = 0.0
    mask[1, 20:30] = 0.0
    mask = torch.from_numpy(mask)
    kept = float(ast_mod.token_mask_from_cont_mask(mask, cfg).float().mean())
    with torch.no_grad(), true_fp32():
        ref = ast_mod.extract_features(ast, agg, spec, cont_mask=mask)
        plain = ast_mod.extract_features(ast, agg, spec)
        card_ast, card_agg = copy.deepcopy(ast).to(dev), copy.deepcopy(agg).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ast_mod.extract_features(card_ast, card_agg, spec.to(dev), cont_mask=mask.to(dev))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    rel = _rel_l2(got.cpu(), ref)
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (4, 6, 768),
          f"masked AST features {tuple(got.shape)}")
    check(rel <= AST_MASK_REL_TOL, f"masked AST {rel} from the CPU's, limit {AST_MASK_REL_TOL}")
    moved = _rel_l2(ref, plain)
    check(moved > 1e-3, f"the mask moved the features by only {moved}")
    return {"rel_l2_vs_cpu": rel, "rel_tol": AST_MASK_REL_TOL, "tokens_kept": kept,
            "mask_moves_features_rel": moved, "card_s": card_s}


def image_codecs_phase(torch, dev, pipeline_cfg, card: str, config="xxl") -> dict:
    """The image codecs without PIL on the card, on the ``video_ingest`` clip (125 frames of
    25 fps 1280x720, seed 1): the clip encoded to JPEG at quality 95 (``io/jpeg.py``: the
    transform on the card, the Huffman pass on the host; the bytes of the first
    ``IMAGE_CPU_FRAMES`` equal to the CPU's), written as a frames directory and read back
    through ``read_frames_dir`` (equal to the CPU's decode; seconds split into host and
    device, peak memory, the error against the source); ``cli.main --single_video DIR
    --merge_video`` at XXL (its ``.avi`` read back through ``read_video_frames``, the first
    frames equal to the CPU's decode of its own JPEG payloads, its PCM the WAV as the muxer
    reads it; 540 K1 and 12 K2 launches);
    one HTTP request with ``mux_video`` and ``"response": "avi"`` (its bytes equal to
    ``build_avi_bytes`` of the same frames and audio); the AST's content mask at the real
    width against the CPU; a 720p 16-bit Adam7 PNG and a 720p 5-6-5 BMP decoded on the card
    equal to the CPU's. Returns the K1 and K2 launches of the CLI and served requests."""
    import json
    import os
    import shutil
    import threading
    import urllib.request

    import numpy as np

    from foley_tpu_torch import cli
    from foley_tpu_torch.io import avi, bmp, jpeg, png
    from foley_tpu_torch.io.audio import read_wav
    from foley_tpu_torch.models import dac_vae
    from foley_tpu_torch.pipeline import video
    from foley_tpu_torch.pipeline.generate import ModelBundle
    from foley_tpu_torch.serving import server as srv_mod

    t_phase = time.perf_counter()
    work = "build/chip_smoke/image_codecs"
    shutil.rmtree(work, ignore_errors=True)
    frames_dir = os.path.join(work, "frames")
    os.makedirs(frames_dir)
    clip = make_clip(np, 1, DURATION_S, CLIP_HW)
    n = len(clip)
    out = {"phase": "image_codecs", "frames": n, "hw": list(CLIP_HW), "quality": IMAGE_QUALITY,
           "clip_s": time.perf_counter() - t_phase}

    # encode: the clip to JPEG on the card; three frames again on the CPU
    jpeg.encode_jpegs(clip[:1], IMAGE_QUALITY, dev)  # first launches of the ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jpegs = jpeg.encode_jpegs(clip, IMAGE_QUALITY, dev)
    enc_s = time.perf_counter() - t0
    check(jpeg.encode_jpegs(clip[:IMAGE_CPU_FRAMES], IMAGE_QUALITY, "cpu")
          == jpegs[:IMAGE_CPU_FRAMES], "the card's JPEG bytes differ from the CPU's")
    # encode_jpegs' two parts again, timed apart over its groups of frames: the card's
    # (encode_blocks, the copies included) and the host's Huffman pass
    h, w = CLIP_HW
    per = max(1, jpeg.CHUNK_BLOCKS // (6 * -(-w // 16) * -(-h // 16)))
    header, staged = jpeg.jpeg_header(w, h, IMAGE_QUALITY), []
    enc_dev_s = enc_host_s = 0.0
    for i0 in range(0, n, per):
        t0 = time.perf_counter()
        blocks = jpeg.encode_blocks(torch.from_numpy(clip[i0:i0 + per]).to(dev),
                                    IMAGE_QUALITY).cpu().numpy()
        t1 = time.perf_counter()
        staged.extend(header + jpeg.entropy_encode(b) + b"\xff\xd9" for b in blocks)
        enc_dev_s += t1 - t0
        enc_host_s += time.perf_counter() - t1
    check(staged == jpegs, "encode_blocks + entropy_encode differ from encode_jpegs")
    out.update(encode_ms_per_frame=enc_s / n * 1e3,
               encode_device_ms_per_frame=enc_dev_s / n * 1e3,
               encode_host_entropy_ms_per_frame=enc_host_s / n * 1e3,
               jpeg_bytes_per_frame=sum(map(len, jpegs)) / n)

    # decode: the frames directory through read_frames_dir
    paths = [os.path.join(frames_dir, f"frame_{i + 1}.jpg") for i in range(n)]
    for path, data in zip(paths, jpegs):
        with open(path, "wb") as f:
            f.write(data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    frames, fps = video.read_frames_dir(frames_dir, fps=float(CLIP_FPS), device=dev)
    dec_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - resident
    decoded = np.round(frames * 255.0).astype(np.uint8)  # exact: the frames are k / 255
    check(fps == CLIP_FPS, f"read_frames_dir gave {fps} fps")
    check(np.array_equal(jpeg.decode_jpegs(jpegs[:IMAGE_CPU_FRAMES], "cpu"),
                         decoded[:IMAGE_CPU_FRAMES]),
          "the card's JPEG decode differs from the CPU's")
    # the JPEG reader's two parts again, timed apart over its groups of frames: the host's
    # (the files read, the markers parsed, the Huffman decode) and the card's (reconstruct,
    # the copies included)
    t0 = time.perf_counter()
    parsed = []
    for path in paths:
        with open(path, "rb") as f:
            parsed.append(jpeg.parse_jpeg(f.read(), path))
    dec_host_s = time.perf_counter() - t0
    per = max(1, jpeg.CHUNK_BLOCKS // sum(c.shape[0] * c.shape[1] for c in parsed[0]["coefs"]))
    parts = []
    t0 = time.perf_counter()
    for i0 in range(0, n, per):
        group = parsed[i0:i0 + per]
        coefs = [torch.from_numpy(np.stack([p["coefs"][c] for p in group])).to(dev)
                 for c in range(len(group[0]["sampling"]))]
        quant = torch.from_numpy(np.stack([p["quant"] for p in group])).to(dev)
        parts.append(jpeg.reconstruct(coefs, quant, w, h, group[0]["sampling"],
                                      group[0]["color"]).cpu().numpy())
    dec_dev_s = time.perf_counter() - t0
    check(np.array_equal(np.concatenate(parts), decoded),
          "parse_jpeg + reconstruct differ from read_frames_dir")
    del parsed, parts, coefs, quant
    mae = float(np.abs(decoded.astype(np.int16) - clip).mean())
    check(mae < 3.0, f"the JPEG round trip is {mae} levels from the clip")
    out.update(decode_s=dec_s, decode_host_s=dec_host_s, decode_device_s=dec_dev_s,
               decode_peak_bytes=peak, mean_abs_err_vs_clip=mae)

    # the command line: V2A from the JPEG directory, muxed into an AVI
    per_k1 = STEPS * (pipeline_cfg.model.depth_triple_blocks
                      + pipeline_cfg.model.depth_single_blocks)
    wav_path = os.path.join(work, "v2a.wav")
    k1, k2 = _counts(torch)
    t0 = time.perf_counter()
    rc = cli.main(["--random_init", config, "--random_init_perturb", "--single_video",
                   frames_dir, "--frames_fps", str(CLIP_FPS), "--duration", str(DURATION_S),
                   "--num_inference_steps", str(STEPS), "--guidance_scale", str(GUIDANCE),
                   "--merge_video", "--device", dev.type, "--output", wav_path])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"cli": (k1.launches, k2.launches)}
    avi_path = os.path.join(work, "v2a.avi")
    check(rc == 0 and os.path.exists(avi_path), f"cli --merge_video exited {rc}")
    info = avi.read_avi_info(avi_path)
    back, back_fps = video.read_video_frames(avi_path, device=dev)
    own = jpeg.decode_jpegs(info["jpegs"][:IMAGE_CPU_FRAMES], "cpu").astype(np.float32) / 255.0
    check(back_fps == CLIP_FPS and back.shape == (n, *CLIP_HW, 3)
          and np.array_equal(back[:IMAGE_CPU_FRAMES], own),
          "the AVI's frames differ from the CPU's decode of its JPEG payloads")
    # the muxer reads the WAV as floats (int16 / 32768) and writes them back at 32767
    pcm = np.frombuffer(info["pcm"], "<i2").reshape(-1, 2)
    wav = avi._audio_to_stereo_i16(read_wav(wav_path)[0]).reshape(-1, 2)
    check(np.array_equal(pcm, wav) and int(np.abs(pcm[:, 0].astype(np.int32)
                                                  - _wav_samples(wav_path)).max()) <= 1,
          "the AVI's PCM differs from the WAV")
    out.update(cli_wall_s=cli_s, avi_bytes=os.path.getsize(avi_path))

    # the server: one V2A request muxed and answered as the AVI
    t0 = time.perf_counter()
    foley = _random_xxl(torch, dev, config, perturb=True)
    dac = dac_vae.init(pipeline_cfg.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    service = srv_mod.FoleyService(ModelBundle(foley["params"], dac, pipeline_cfg),
                                   durations=(DURATION_S,), default_steps=STEPS,
                                   video_encoders=random_video_encoders(torch, dev,
                                                                        pipeline_cfg))
    server_init_s = time.perf_counter() - t0
    httpd = srv_mod.create_server(service, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    body = {"frames_path": os.path.abspath(frames_dir), "frames_fps": float(CLIP_FPS),
            "duration": DURATION_S, "steps": STEPS, "cfg_scale": GUIDANCE, "seed": 0,
            "mux_video": True, "response": "avi"}
    k1, k2 = _counts(torch)
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate",
            data=json.dumps(body).encode()), timeout=600) as r:
        served, ctype = r.read(), r.headers["Content-Type"]
    serve_s = time.perf_counter() - t0
    launches["server"] = (k1.launches, k2.launches)
    httpd.shutdown()
    httpd.server_close()
    served_path = os.path.join(work, "served.avi")
    with open(served_path, "wb") as f:
        f.write(served)
    served_pcm = np.frombuffer(avi.read_avi_info(served_path)["pcm"], "<i2")[0::2]
    check(ctype == "video/x-msvideo" and np.abs(served_pcm).max() > 0,
          f"served {ctype}, peak {np.abs(served_pcm).max()}")
    t0 = time.perf_counter()
    expect = avi.build_avi_bytes(decoded, float(CLIP_FPS), served_pcm, 48000, device=dev)
    mux_s = time.perf_counter() - t0
    check(served == expect, "the served AVI differs from build_avi_bytes of its frames and audio")
    for name, (n1, n2) in launches.items():
        check(n1 == per_k1 and n2 == service.video_encoders["siglip2"].cfg.num_hidden_layers,
              f"image_codecs {name}: K1 {n1}, K2 {n2}")
    del service, foley, dac
    torch.cuda.empty_cache()
    out.update(server_init_s=server_init_s, server_request_s=serve_s,
               server_avi_bytes=len(served), build_avi_s=mux_s, launches_k1_k2=launches)

    # the AST's content mask at the real width
    t0 = time.perf_counter()
    out["ast_mask"] = dict(_ast_mask_check(torch, dev), seconds=time.perf_counter() - t0)

    # a 16-bit Adam7 PNG and a 5-6-5 BMP at 720p, card against CPU
    png_path, bmp_path = os.path.join(work, "adam7.png"), os.path.join(work, "f.bmp")
    t0 = time.perf_counter()
    # the high bytes frame 0 (what convert("RGB") keeps), the low bytes frame 2
    _write_png(png_path, clip[0].astype(np.uint16) << 8 | clip[2].astype(np.uint16), depth=16,
               interlace=True)
    _write_bmp565(bmp_path, clip[1])
    out["png_bmp_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_png = png.read_pngs([png_path], dev)
    png_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_bmp = bmp.read_bmps([bmp_path], dev)
    bmp_s = time.perf_counter() - t0
    check(np.array_equal(got_png, png.read_pngs([png_path], "cpu"))
          and np.array_equal(got_png[0], clip[0]), "the Adam7 16-bit PNG differs")
    check(np.array_equal(got_bmp, bmp.read_bmps([bmp_path], "cpu")),
          "the BMP differs from the CPU's")
    shutil.rmtree(work, ignore_errors=True)
    out.update(png_adam7_16bit_s=png_s, bmp_565_s=bmp_s, card=card,
               phase_seconds=time.perf_counter() - t_phase)
    emit(out)
    return launches


FRAME_FIXTURES = "tests/data/torch_frame_formats"  # small files Pillow wrote, and digests
FRAME_720P = "tests/data/torch_frame_formats_720p"  # the clip's first frame: lossy WebP, GIF
# the fixture of each format timed 125 times
FRAME_TIMED = {"jpeg": "prog_420.jpg", "tiff": "lzw_predictor.tif",
               "webp": "all_transforms.webp", "webp_lossy": "lossy_q80.webp",
               "gif": "gif_interlaced.png", "tiff_jpeg": "jpeg_ycbcr_420.tif",
               "jpeg_arith": "arith_prog.jpg", "jpeg_smooth": "prog_cut.jpg",
               "jpeg_411": "sampling_411.jpg"}


def _frame_parts(fmt: str, paths, dev):
    """The reader of ``fmt`` over ``paths`` in its two parts, each timed: the host's (the
    files read, parsed and entropy-decoded (Huffman or arithmetic), decompressed,
    LZW-decoded, or VP8-decoded into
    Y, U and V) and the device's (the rest, the copies to and from the device included; none
    for lossless WebP, read on the host alone) -> (RGB [T, H, W, 3] uint8, host s, device s)."""
    import numpy as np
    import torch

    from foley_tpu_torch.io import gif, jpeg, tiff, webp

    t0 = time.perf_counter()
    datas = []
    for path in paths:
        with open(path, "rb") as f:
            datas.append(f.read())
    if fmt.startswith("jpeg"):
        parsed = [jpeg.parse_jpeg(d) for d in datas]
    elif fmt.startswith("tiff"):
        parsed = [tiff.parse_tiff(d) for d in datas]
    elif fmt == "gif":
        parsed = [gif.parse_gif(d) for d in datas]
    elif fmt == "webp_lossy":  # stills: the picture is the canvas
        infos = [webp.parse_webp(d) for d in datas]
        parsed = [webp.decode_yuv(info) for info in infos]
    else:
        parsed = [webp.decode_argb(webp.parse_webp(d)) for d in datas]
    if fmt == "webp":  # every stage on the host
        rgb = np.stack(parsed)[..., 2::-1]
        return rgb, time.perf_counter() - t0, 0.0
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if fmt.startswith("jpeg"):  # the block smoothing (a cut progressive file) included
        rgb = jpeg.reconstruct_parsed(parsed, dev).cpu().numpy()
    elif fmt == "webp_lossy":
        rgb = webp.decode_lossy(parsed, infos[0]["width"], infos[0]["height"], dev)
    elif fmt == "gif":
        rgb = gif.decode(parsed, dev).cpu().numpy()
    else:
        rgb = tiff.decode(parsed, dev).cpu().numpy()
    return rgb, host_s, time.perf_counter() - t0


TIFF_720P = ("none", "packbits", "lzw_predictor")  # the 720p TIFFs timed 125 frames each


def _lzw_encode(data: bytes) -> bytes:
    """TIFF 6.0 LZW: 9- to 12-bit codes, MSB first, a clear first and when the table fills,
    the code width growing one code early, as libtiff's encoder writes it."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, n):
        nonlocal acc, nacc
        acc, nacc = (acc << n) | code, nacc + n
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    def fresh():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, nbits = fresh()
    put(256, 9)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], nbits)
        table[wc], nxt = nxt, nxt + 1
        if nxt == 4094:
            put(256, nbits)
            table, nxt, nbits = fresh()
        elif nxt == 1 << nbits:
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w], nbits)
        nxt += 1
        if nxt == 1 << nbits:
            nbits += 1
    put(257, nbits)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def _packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (257 - n, byte), the rest as literals of up to
    128 bytes."""
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_bytes(np, rgb, codec: str, rows: int = 16) -> bytes:
    """An RGB uint8 frame [H, W, 3] as a little-endian TIFF of ``rows``-row strips,
    uncompressed (``none``), ``packbits``, or ``lzw_predictor`` (each row differenced,
    predictor 2, then LZW), with numpy and the standard library (the card's machine has no
    PIL)."""
    import struct

    h, w, _ = rgb.shape
    strips = []
    for y in range(0, h, rows):
        part = rgb[y:y + rows]
        if codec == "lzw_predictor":
            diff = np.diff(part.astype(np.int16), axis=1, prepend=np.int16(0)) % 256
            strips.append(_lzw_encode(diff.astype(np.uint8).tobytes()))
        elif codec == "packbits":
            strips.append(_packbits_encode(part.tobytes()))
        else:
            strips.append(part.tobytes())
    offsets, at = [], 8
    for strip in strips:
        offsets.append(at)
        at += len(strip) + (len(strip) & 1)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
               (259, 3, [{"none": 1, "packbits": 32773, "lzw_predictor": 5}[codec]]),
               (262, 3, [2]), (273, 4, offsets), (277, 3, [3]), (278, 4, [rows]),
               (279, 4, [len(strip) for strip in strips]), (284, 3, [1])]
    if codec == "lzw_predictor":
        entries.append((317, 3, [2]))
    blob_at = at + 2 + 12 * len(entries) + 4
    ifd, blobs = bytearray(struct.pack("<H", len(entries))), bytearray()
    for tag, typ, vals in entries:
        raw = struct.pack("<" + ("H" if typ == 3 else "I") * len(vals), *vals)
        if len(raw) <= 4:
            value = raw.ljust(4, b"\0")
        else:
            value = struct.pack("<I", blob_at + len(blobs))
            blobs += raw
        ifd += struct.pack("<HHI", tag, typ, len(vals)) + value
    ifd += b"\0" * 4
    return (b"II*\0" + struct.pack("<I", at)
            + b"".join(strip + b"\0" * (len(strip) & 1) for strip in strips)
            + bytes(ifd) + bytes(blobs))


def frame_formats_phase(torch, dev, pipeline_cfg, card: str, config="xxl") -> dict:
    """The frame formats the JAX package reads through PIL, read without it on the card
    (``io/jpeg.py``'s progressive, CMYK, arithmetic-coded, cut short (smoothed) and every
    sampling, ``io/tiff.py`` with its turned, JPEG, YCbCr and
    CMYK kinds, ``io/gif.py``, ``io/bmp.py``'s RLE, ``io/webp.py`` with its VP8L alpha):
    each committed fixture of ``FRAME_FIXTURES`` (Pillow wrote them, or Pillow read them;
    this machine has no PIL) decoded on the card and on the CPU, equal in every byte and to
    the SHA-256 of Pillow's RGB bytes recorded beside them; each fixture Pillow raises on (a
    corrupt VP8L alpha plane) raising on both; 125 frames of each format of ``FRAME_TIMED``
    decoded on the card, the host's and the card's seconds apart, equal to the CPU's decode;
    125 copies of one 720p frame of the clip (``CLIP_HW``, the size the main path ingests)
    as TIFF in each of ``TIFF_720P``, the reader's two parts timed, equal to the frame
    written, and as the lossy WebP, the GIF and the arithmetic-coded progressive JPEG of
    ``FRAME_720P``, the two parts timed, each frame equal to Pillow's recorded digest; one
    ``SURFACE_STEPS`` XXL V2A request through
    ``cli.main --single_video`` from a directory mixing every fixture (a GIF named ``.png``
    among them), every fifth under another format's name and PNGs named ``.jpg`` (read by
    their bytes: 540 K1 and 12 K2 launches); a PPM named ``.jpg`` refused, naming PPM. Each
    part's seconds (``section_s``). Returns the request's (K1, K2) launches."""
    import hashlib
    import os
    import shutil

    import numpy as np

    from foley_tpu_torch import cli
    from foley_tpu_torch.io import webp
    from foley_tpu_torch.pipeline import video

    t_phase = time.perf_counter()
    with open(os.path.join(FRAME_FIXTURES, "digests.json")) as f:
        record = json.load(f)
    digests, hw = record["sha256_of_pil_rgb"], tuple(record["hw"])
    work = "build/chip_smoke/frame_formats"
    shutil.rmtree(work, ignore_errors=True)
    out = {"phase": "frame_formats", "fixtures": len(digests), "hw": list(hw), "card": card}
    sections, t_mark = {}, time.perf_counter()  # each part's seconds, on the phase's clock

    def section(name: str) -> None:
        nonlocal t_mark
        now = time.perf_counter()
        sections[name] = now - t_mark
        t_mark = now

    # every fixture: card == CPU == Pillow's digest
    video.read_frames_dir(FRAME_FIXTURES, device=dev, max_frames=1)  # first launches
    fixture_s = {}
    for name, digest in sorted(digests.items()):
        one = os.path.join(work, "one", name)
        os.makedirs(one)
        shutil.copy(os.path.join(FRAME_FIXTURES, name), one)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = video.read_frames_dir(one, device=dev)[0]
        fixture_s[name] = time.perf_counter() - t0
        cpu = video.read_frames_dir(one, device="cpu")[0]
        rgb = np.round(got[0] * 255.0).astype(np.uint8)
        check(got.shape == (1, *hw, 3) and np.array_equal(got, cpu),
              f"{name}: the card's decode differs from the CPU's")
        check(hashlib.sha256(rgb.tobytes()).hexdigest() == digest,
              f"{name}: the decode differs from Pillow's (its recorded digest)")
    out["fixture_decode_s"] = fixture_s
    section("fixtures")
    # the fixtures Pillow raises on (a corrupt VP8L alpha plane): each device raises too
    refused = {}
    for name in record.get("pil_raises", []):
        one = os.path.join(work, "one", name)
        os.makedirs(one)
        shutil.copy(os.path.join(FRAME_FIXTURES, name), one)
        for where in (dev, "cpu"):
            try:
                video.read_frames_dir(one, device=where)
                refused[f"{name}@{where}"] = None
            except ValueError as e:
                refused[f"{name}@{where}"] = str(e)
            check(refused[f"{name}@{where}"] is not None,
                  f"{name}: read on {where}, where Pillow raises")
    out["pil_raises_refused"] = refused
    section("refused")

    # 125 frames of each format on the card, the host's and the card's parts apart
    n = int(DURATION_S * CLIP_FPS)
    timed = {}
    for fmt, name in FRAME_TIMED.items():
        d = os.path.join(work, fmt)
        os.makedirs(d)
        paths = [os.path.join(d, f"frame_{i + 1}{os.path.splitext(name)[1]}") for i in range(n)]
        for path in paths:
            shutil.copy(os.path.join(FRAME_FIXTURES, name), path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = video.read_frames_dir(d, fps=float(CLIP_FPS), device=dev)[0]
        wall = time.perf_counter() - t0
        rgb, host_s, dev_s = _frame_parts(fmt, paths, dev)
        check(np.array_equal(np.round(frames * 255.0).astype(np.uint8), rgb),
              f"{fmt}: the reader's two parts differ from read_frames_dir")
        t0 = time.perf_counter()
        cpu = video.read_frames_dir(d, fps=float(CLIP_FPS), device="cpu")[0]
        cpu_s = time.perf_counter() - t0
        check(np.array_equal(frames, cpu), f"{fmt}: 125 frames on the card differ from the CPU's")
        timed[fmt] = {"fixture": name, "frames": n, "read_frames_dir_s": wall,
                      "host_s": host_s, "device_s": dev_s, "cpu_read_frames_dir_s": cpu_s,
                      "host_ms_per_frame": host_s / n * 1e3,
                      "device_ms_per_frame": dev_s / n * 1e3}
        section(f"decode_125_{fmt}")
    out["decode_125"] = timed

    # 125 frames of 720p TIFF, the size the main path ingests: one frame of the clip written
    # uncompressed, in PackBits and in LZW after predictor 2, 125 copies of each
    frame = make_clip(np, 1, 1.0 / CLIP_FPS, CLIP_HW)[0]
    timed_720p = {}
    for codec in TIFF_720P:
        t0 = time.perf_counter()
        data = _tiff_bytes(np, frame, codec)
        encode_s = time.perf_counter() - t0
        d = os.path.join(work, f"tiff_720p_{codec}")
        os.makedirs(d)
        paths = [os.path.join(d, f"frame_{i + 1}.tif") for i in range(n)]
        for path in paths:
            with open(path, "wb") as f:
                f.write(data)
        torch.cuda.synchronize()
        rgb, host_s, dev_s = _frame_parts("tiff", paths, dev)
        check(rgb.shape == (n, *CLIP_HW, 3) and bool((rgb == frame).all()),
              f"720p TIFF ({codec}): the decode differs from the frame written")
        del rgb
        shutil.rmtree(d)
        timed_720p[codec] = {"frames": n, "hw": list(CLIP_HW), "file_bytes": len(data),
                             "encode_s": encode_s, "host_s": host_s, "device_s": dev_s,
                             "host_ms_per_frame": host_s / n * 1e3}
    out["decode_125_tiff_720p"] = timed_720p
    section("tiff_720p")

    # 125 copies of the same frame as a lossy WebP (Pillow wrote it at quality 80, this
    # machine has no PIL), as Pillow's GIF (a screen capture's format) and as an
    # arithmetic-coded progressive JPEG (libjpeg's encoder): the reader's two parts timed,
    # every frame Pillow's (its digest)
    with open(os.path.join(FRAME_720P, "digests.json")) as f:
        digests_720p = json.load(f)["sha256_of_pil_rgb"]
    for fmt, name_720p, ext in (("webp_lossy", "clip_q80.webp", ".webp"),
                                ("gif", "clip.gif", ".png"),
                                ("jpeg", "clip_arith_prog.jpg", ".jpg")):
        d = os.path.join(work, f"{fmt}_720p")
        os.makedirs(d)
        paths = [os.path.join(d, f"frame_{i + 1}{ext}") for i in range(n)]
        for path in paths:
            shutil.copy(os.path.join(FRAME_720P, name_720p), path)
        torch.cuda.synchronize()
        rgb, host_s, dev_s = _frame_parts(fmt, paths, dev)
        check(rgb.shape == (n, *CLIP_HW, 3) and bool((rgb == rgb[0]).all())
              and hashlib.sha256(rgb[0].tobytes()).hexdigest() == digests_720p[name_720p],
              f"720p {name_720p}: a frame differs from Pillow's (its recorded digest)")
        del rgb
        shutil.rmtree(d)
        out[f"decode_125_{fmt}_720p"] = {
            "frames": n, "hw": list(CLIP_HW), "file_bytes": os.path.getsize(
                os.path.join(FRAME_720P, name_720p)), "host_s": host_s, "device_s": dev_s,
            "host_ms_per_frame": host_s / n * 1e3, "device_ms_per_frame": dev_s / n * 1e3}
        section(f"{fmt}_720p")

    # V2A through the command line from a directory mixing every fixture, every fifth under
    # another format's name (read by its bytes, as PIL reads it), and PNGs named .jpg
    mixed = os.path.join(work, "mixed")
    os.makedirs(mixed)
    names = sorted(digests)
    png_rgb = webp.read_webps([os.path.join(FRAME_FIXTURES, "lossy_q80.webp")], "cpu")[0]
    misnamed = {".jpg": ".png", ".webp": ".jpg", ".tif": ".bmp", ".png": ".tif",
                ".bmp": ".webp"}  # a GIF named .tif, an RLE BMP named .webp, ...
    for i in range(n):
        name = names[i % len(names)]
        ext = os.path.splitext(name)[1]
        if i % 25 == 24:
            _write_png(os.path.join(mixed, f"frame_{i + 1}.jpg"), png_rgb)
            continue
        shutil.copy(os.path.join(FRAME_FIXTURES, name), os.path.join(
            mixed, f"frame_{i + 1}{misnamed[ext] if i % 5 == 4 else ext}"))
    mixed_frames = video.read_frames_dir(mixed, fps=float(CLIP_FPS), device=dev)[0]
    check(np.array_equal(mixed_frames,
                         video.read_frames_dir(mixed, fps=float(CLIP_FPS), device="cpu")[0]),
          "the mixed directory on the card differs from the CPU's")
    check(np.array_equal(np.round(mixed_frames[24] * 255.0).astype(np.uint8), png_rgb),
          "a PNG named .jpg in the mixed directory")
    ppm = os.path.join(work, "ppm")
    os.makedirs(ppm)
    with open(os.path.join(ppm, "frame_1.jpg"), "wb") as f:  # a PPM named .jpg
        f.write(b"P6\n2 1\n255\n" + bytes(6))
    try:
        video.read_frames_dir(ppm, device=dev)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "a PPM file" in refused, f"a PPM named .jpg: {refused}")
    out["ppm_refused"] = refused
    section("mixed_directory")
    per_k1 = STEPS * (pipeline_cfg.model.depth_triple_blocks
                      + pipeline_cfg.model.depth_single_blocks)
    wav_path = os.path.join(work, "v2a.wav")
    k1, k2 = _counts(torch)
    t0 = time.perf_counter()
    rc = cli.main(["--random_init", config, "--random_init_perturb", "--single_video", mixed,
                   "--frames_fps", str(CLIP_FPS), "--duration", str(DURATION_S),
                   "--num_inference_steps", str(STEPS), "--guidance_scale", str(GUIDANCE),
                   "--device", dev.type, "--output", wav_path])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = (k1.launches, k2.launches)
    pcm = _wav_samples(wav_path) if rc == 0 else np.zeros(1)
    check(rc == 0 and len(pcm) == int(DURATION_S * 48000) and np.abs(pcm).max() > 0,
          f"cli --single_video on the mixed directory exited {rc}")
    check(launches == (per_k1, 12), f"frame_formats cli: K1 {launches[0]}, K2 {launches[1]}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    section("cli")
    out.update(mixed_frames=n, mixed_kinds=names, cli_wall_s=cli_s, launches_k1_k2=launches,
               section_s=sections, phase_seconds=time.perf_counter() - t_phase)
    emit(out)
    return launches


LONGRUN_STEPS = 100  # train_longrun's steps here (the tool's default is 600: see below)


def train_longrun_phase(torch, dev, card: str) -> dict:
    """``foley_tpu_torch.tools.train_longrun`` as a user runs it (``main``, TINY, batch 4, 1 s
    clips, ``LONGRUN_STEPS`` steps), alone, after every other phase: it returns 0, its
    trajectory and final parameters finite, its export deployed on the card: the loader's
    model in fp32 generates finite audio in 8 steps, each through K1's kernel for widths
    other than 128 (``fused_qk_attention_mma.cu``) in every block (TINY's heads are 32 wide;
    8 x 6 fp32 launches, none in a train step, no K2). The tool's ``ok`` (the tail's loss under 0.7 of the head's) and ``loss_drop_ratio``
    are reported as measured, not checked: at its 600 steps the JAX tool itself reads ``ok``
    false on the CPU (a ratio of 1.133; the port 1.12 on the card), and the 600 steps take
    two minutes of host-bound TINY steps on an H100. Returns (the record, K1's launches)."""
    import contextlib
    import io

    from foley_tpu_torch.configs import TINY
    from foley_tpu_torch.tools import train_longrun

    k1, k2 = _counts(torch)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_longrun.main(["--num_steps", str(LONGRUN_STEPS), "--device", dev.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (k1.launches, k1.launches_by_dtype.get(torch.float32, 0), k2.launches)
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and res["finite"] and res["deploy_ok"] and res["num_steps"] == LONGRUN_STEPS,
          f"train_longrun: {res}")
    per_request = 8 * (TINY.model.depth_triple_blocks + TINY.model.depth_single_blocks)
    check(launches == (per_request, per_request, 0),
          f"train_longrun: K1 {launches[0]} (fp32 {launches[1]}), K2 {launches[2]}; "
          f"{per_request} fp32 K1 expected")
    emit(dict({k: v for k, v in res.items() if k != "trajectory"}, phase="train_longrun",
              trajectory=res["trajectory"], wall_s=wall, launches_k1_k2=launches[::2],
              card=card))
    return res, launches[0]


# ---------------------------------------------------------------------------------
# Training (the denoiser's flow-matching steps, the loop, the data pipeline, the handoff)
# ---------------------------------------------------------------------------------

TRAIN_GRAD_REL_TOL = 1e-5  # the card's fp32 loss and gradients against the CPU's, relative L2
                           # per leaf, both in true fp32 (sums in another order); the control,
                           # TF32 let in, must break it
TRAIN_LR = 1e-3            # Adam's rate in the LoRA phases: at the step's default 1e-4 ten steps
                           # move a bf16 merged weight by less than its rounding step (~1.5e-4
                           # at |w| ~ 0.02), and the loss on a fixed batch could not fall
TRAIN_FALL_STEPS = 10      # steps on one fixed batch over which the LoRA loss must fall
TRAIN_FULL_STEPS = 3
TRAIN_DATA_STEPS = 3
TRAIN_TONES_HZ = (220.0, 330.0, 440.0, 550.0)


def _train_batch(torch, dev, pipeline_cfg, seed: int):
    """One flow-matching batch of one 5 s clip (latents, text, clip and sync features, all
    random), its noise and its sigma, from ``seed``, on ``dev``."""
    cfg = pipeline_cfg.model
    gen = torch.Generator(device=dev).manual_seed(seed)
    clip_len, sync_len = pipeline_cfg.t2a_lengths(DURATION_S)
    t_len = pipeline_cfg.latent_length(DURATION_S)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    batch = {"latents": rnd(1, t_len, cfg.audio_vae_latent_dim),
             "cond": rnd(1, cfg.text_length, cfg.condition_dim),
             "clip_feat": rnd(1, clip_len, cfg.clip_dim),
             "sync_feat": rnd(1, sync_len, cfg.sync_feat_dim)}
    return batch, rnd(1, t_len, cfg.audio_vae_latent_dim), torch.rand(1, device=dev,
                                                                       generator=gen)


def _loss_grads(torch, model, batch, noise, sigma, leaves, lora=None, remat=True,
                compute_dtype=None):
    """The flow-matching loss and its gradients with respect to ``leaves`` (the model's
    parameters, or the adapter's factors with ``lora``) through ``training/train.py``'s
    ``value_and_grad``; ``remat`` False runs ``flow_match_loss``'s arithmetic with the blocks
    not checkpointed."""
    from foley_tpu_torch.training import train

    dtype = compute_dtype or torch.bfloat16

    def loss_fn():
        if remat:
            return train.flow_match_loss(model, batch, compute_dtype=dtype, lora=lora,
                                         noise=noise, sigma=sigma)
        x1 = batch["latents"].float()
        x = (1.0 - sigma)[:, None, None] * x1 + sigma[:, None, None] * noise
        pred = model(x.to(dtype), sigma * 1000, *(batch[k].to(dtype) for k in (
            "cond", "clip_feat", "sync_feat")), attn_impl="xla", remat=False, lora=lora)
        return (pred.float() - (noise - x1)).square().mean()

    for t in leaves.values():
        t.requires_grad_(True)
    try:
        return train.value_and_grad(loss_fn, leaves)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)


def _worst_rel(torch, got: dict, ref: dict) -> float:
    """The largest relative L2 error over the leaves ``ref`` gives a gradient; a leaf the
    loss does not reach is None or zero on both sides."""
    worst = 0.0
    for name, r in ref.items():
        g = got[name]
        if r is None or not r.any():
            check(g is None or not g.any(), f"{name}: a gradient where the reference has none")
            continue
        check(g is not None and bool(torch.isfinite(g).all()), f"{name}: no finite gradient")
        worst = max(worst, _rel_l2(g.cpu(), r.cpu()))
    return worst


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def train_grad_phase(torch, dev, pipeline_cfg, card: str):
    """The link JAX <-> CPU <-> card of the train step: the XXL width cut to 1 triple and 1
    single block, fp32, perturbed from a seed; the loss and every parameter's gradient, then
    a rank-16 adapter's (``b`` not zero) loss and factor gradients, on the card (at the
    default matmul precision and at ``"high"``) against the same step on the CPU in this
    process (the CPU step is held against ``jax.grad`` by ``tests/test_torch_train.py``):
    within ``TRAIN_GRAD_REL_TOL`` per leaf. The control: the card's step with ``true_fp32``
    bypassed under ``"high"`` must break the bound."""
    import contextlib
    import copy
    import dataclasses

    from foley_tpu_torch.core.params import perturb_zero_leaves
    from foley_tpu_torch.models import lora as lora_mod
    from foley_tpu_torch.models import mmdit
    from foley_tpu_torch.ops import nn as nn_mod
    from foley_tpu_torch.training import train

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(pipeline_cfg.model, depth_triple_blocks=1, depth_single_blocks=1)
    gen = torch.Generator().manual_seed(21)
    cpu = perturb_zero_leaves(mmdit.init(cfg, gen, device="cpu"), gen)
    on_card = copy.deepcopy(cpu).to(dev)
    batch, noise, sigma = _train_batch(torch, "cpu", pipeline_cfg, 22)
    adapter = _lora_adapter(torch, cpu, LORA_RANK, 23)

    def step(model, d):
        b = {k: v.to(d) for k, v in batch.items()}
        lora = {k: v.to(d) for k, v in adapter.items()}
        args = (b, noise.to(d), sigma.to(d))
        full = _loss_grads(torch, model, *args, dict(model.named_parameters()),
                           compute_dtype=torch.float32)
        return full, _loss_grads(torch, model, *args, lora, lora=lora,
                                 compute_dtype=torch.float32)

    def rel(got, ref):
        (fl, fg), (ll, lg) = got
        (rfl, rfg), (rll, rlg) = ref
        return {"full_loss": _rel_l2(fl.cpu(), rfl), "full_grads": _worst_rel(torch, fg, rfg),
                "lora_loss": _rel_l2(ll.cpu(), rll), "lora_grads": _worst_rel(torch, lg, rlg)}

    t0 = time.perf_counter()
    ref = step(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    saved = torch.get_float32_matmul_precision()
    results, walls = {}, []
    try:
        for precision in ("highest", "high"):
            torch.set_float32_matmul_precision(precision)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[precision] = rel(step(on_card, dev), ref)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(max(results[precision].values()) <= TRAIN_GRAD_REL_TOL,
                  f"train step on the card ({precision}) against the CPU: "
                  f"{results[precision]}, limit {TRAIN_GRAD_REL_TOL}")
        bypass = (train, "true_fp32", contextlib.nullcontext), (
            lora_mod, "true_fp32", contextlib.nullcontext), (
            mmdit, "exact_fp32", lambda dtype: contextlib.nullcontext())
        try:
            for mod, name, stub in bypass:
                setattr(mod, name, stub)
            results["tf32_control"] = rel(step(on_card, dev), ref)
        finally:
            train.true_fp32 = lora_mod.true_fp32 = nn_mod.true_fp32
            mmdit.exact_fp32 = nn_mod.exact_fp32
    finally:
        torch.set_float32_matmul_precision(saved)
    check(max(results["tf32_control"].values()) > TRAIN_GRAD_REL_TOL,
          f"control: the step with TF32 reads {results['tf32_control']} from the CPU, within "
          f"the limit {TRAIN_GRAD_REL_TOL}: the bound cannot tell TF32 from fp32")
    emit({"phase": "train_grad", "card": card, "config": "xxl width, 1 + 1 blocks, fp32",
          "params": sum(p.numel() for p in cpu.parameters()), "lora_rank": LORA_RANK,
          "rel_l2_vs_cpu": results["highest"], "rel_l2_vs_cpu_high": results["high"],
          "control_tf32_rel_l2_vs_cpu": results["tf32_control"],
          "rel_tol": TRAIN_GRAD_REL_TOL, "card_walls_s": walls, "cpu_s": cpu_s,
          "phase_seconds": time.perf_counter() - t_phase})


def train_lora_phase(torch, dev, dac, pipeline_cfg, card: str, config="xxl"):
    """LoRA fine-tuning at XXL: a bf16 base (perturbed, from a seed), rank-16 fp32 factors,
    5 s clips (250 latent frames), batch 1, every block checkpointed, Adam at ``TRAIN_LR``.

    Checks: the first step's loss with fresh factors equals the bare base's bit for bit (the
    same x0 and sigma); every factor gradient finite, ``b``'s not zero, and equal with the
    blocks checkpointed and not; the loss falls over ``TRAIN_FALL_STEPS`` steps on one
    fixed batch; no K1 or K2 launch in any step, and a direct K1 or K2 call on operands that
    require a gradient raises; the base's weights unchanged bit for bit; 2 steps, a
    checkpoint, a restore and 2 steps equal 4 steps bit for bit (``training/loop.py``); the
    adapter exported (``export_lora``) and the base exported (``export_for_inference``),
    then loaded through ``HunyuanModelLoader`` with the adapter as ``lora_path``: its
    velocity within ``FORWARD_REL_TOL`` of the runtime adapter's; one 5 s request on the
    loaded model, 2,700 K1 launches. Returns K1's launches in that request and in the steps."""
    import os
    import shutil

    import numpy as np

    from foley_tpu_torch.api import nodes
    from foley_tpu_torch.core.params import perturb_zero_leaves
    from foley_tpu_torch.models import lora as lora_mod
    from foley_tpu_torch.models import mmdit
    from foley_tpu_torch.pipeline.generate import ModelBundle
    from foley_tpu_torch.training import loop, optim, train

    t_phase = time.perf_counter()
    phase_base = torch.cuda.memory_allocated()  # what earlier phases still hold
    cfg = pipeline_cfg.model
    gen = torch.Generator(device=dev).manual_seed(31)
    model = perturb_zero_leaves(mmdit.init(cfg, gen, device=dev, dtype=torch.bfloat16), gen)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    lora0 = lora_mod.init_lora(model, torch.Generator(device=dev).manual_seed(32), LORA_RANK)
    batch, noise, sigma = _train_batch(torch, dev, pipeline_cfg, 33)

    def adam():
        return optim.adam(TRAIN_LR, b1=0.9, b2=0.95)

    k1, k2 = _counts(torch)
    with torch.no_grad(), train.step_context():
        base_loss = train.flow_match_loss(model, batch, noise=noise, sigma=sigma)
    grads = {}
    for remat in (True, False):
        factors = {k: v.clone() for k, v in lora0.items()}
        loss, grads[remat] = _loss_grads(torch, model, batch, noise, sigma, factors,
                                         lora=factors, remat=remat)
        check(torch.equal(loss, base_loss), f"fresh factors (remat {remat}): loss "
              f"{float(loss)} != the base model's {float(base_loss)}")
    for name, g in grads[True].items():
        check(g is not None and bool(torch.isfinite(g).all()), f"{name}: no finite gradient")
        if name.endswith(".b"):
            check(bool(g.any()), f"{name}: zero gradient")
    remat_equal = all(torch.equal(g, grads[False][k]) for k, g in grads[True].items())
    remat_rel = _worst_rel(torch, grads[False], grads[True])
    check(remat_equal, f"factor gradients differ with the blocks checkpointed and not: "
          f"worst relative L2 {remat_rel}")
    del grads

    init_state, step = train.make_lora_train_step(model, optimizer=adam())
    state = init_state(lora0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_FALL_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batch, noise=noise, sigma=sigma)
        losses.append(loss)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        step(state, batch, noise=noise, sigma=sigma)
        torch.cuda.synchronize()

    profile = profiled(torch, one_step)  # two more steps: where a step's time goes
    check(torch.equal(losses[0], base_loss), "the first step's loss differs from the base's")
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"LoRA losses {losses}")
    step_launches = k1.launches + k2.launches
    check(step_launches == 0, f"{k1.launches} K1 and {k2.launches} K2 launches in the steps")
    raised = _kernels_refuse_grad(torch, dev)
    check(k1.launches + k2.launches == 0, "a refused call launched a kernel")
    for k, v in model.state_dict().items():
        check(torch.equal(v, base[k]), f"the base's {k} changed in training")
    del base

    batches = [_train_batch(torch, dev, pipeline_cfg, 40 + i)[0] for i in range(4)]
    kw = dict(compute_dtype=torch.bfloat16, seed=5, log_every=0)
    straight = loop.train_lora(model, lora0, iter(batches), 4, optimizer=adam(), **kw)
    ckpt = "build/chip_smoke/train_lora_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    loop.train_lora(model, lora0, iter(batches[:2]), 2, ckpt_dir=ckpt, optimizer=adam(), **kw)
    resumed = loop.train_lora(model, lora0, iter(batches[2:]), 4, ckpt_dir=ckpt,
                              optimizer=adam(), **kw)
    check(resumed.step == straight.step == 4, f"steps {resumed.step}, {straight.step}")
    for name, t in straight.lora.items():
        check(torch.equal(t, resumed.lora[name]) and torch.equal(
            straight.opt_state.mu[name], resumed.opt_state.mu[name]) and torch.equal(
            straight.opt_state.nu[name], resumed.opt_state.nu[name]),
            f"resumed {name} differs from the uninterrupted run's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = loop.save_checkpoint(ckpt, straight)
    save_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(os.path.join(path, loop.STATE_FILE))
    t0 = time.perf_counter()
    loop.restore_checkpoint(path, straight)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckpt)

    adapter_dir = "build/chip_smoke/train_lora_adapter"
    base_dir = "build/chip_smoke/train_lora_base"
    t0 = time.perf_counter()
    loop.export_lora(resumed, adapter_dir, rank=LORA_RANK)
    export_s = time.perf_counter() - t0
    # the base as an export directory, for the loader: the deployed model is the base with
    # the adapter merged at load (``lora_path``)
    loop.export_for_inference(train.TrainState(dict(model.named_parameters()), None, 0),
                              base_dir)
    t0 = time.perf_counter()
    (fm,) = nodes.HunyuanModelLoader().load_model(base_dir, config=config,
                                                  lora_path=adapter_dir, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(base_dir)
    shutil.rmtree(adapter_dir)
    args = _forward_args(torch, dev, pipeline_cfg)
    with torch.no_grad():
        runtime = model(*args, lora=resumed.lora).float()
        merged = fm["params"](*args).float()
    rel = _rel_l2(merged, runtime)
    check(rel <= FORWARD_REL_TOL, f"exported adapter merged at load: velocity {rel} from the "
          f"runtime adapter's, limit {FORWARD_REL_TOL}")
    del model, runtime, merged
    torch.cuda.empty_cache()
    req, _ = _request(torch, dev, ModelBundle(fm["params"], dac, pipeline_cfg), pipeline_cfg)
    trainable = _bytes(lora0.values())
    emit({"phase": "train_lora", "card": card, "config": config, "base_dtype": "bf16",
          "rank": LORA_RANK, "latent_frames": pipeline_cfg.latent_length(DURATION_S),
          "batch": 1, "remat": True, "lr": TRAIN_LR, "losses": losses,
          "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
          "peak_mem_gib": peak / 2 ** 30, "peak_above_phase_gib": (peak - phase_base) / 2 ** 30,
          "trainable_bytes": trainable,
          "state_bytes": 3 * trainable, "checkpoint_bytes": ckpt_bytes,
          "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
          "resume_bit_exact": True, "remat_grads_bit_exact": remat_equal,
          "kernel_launches_in_steps": step_launches, "grad_guard_raised": raised,
          "export_lora_s": export_s, "load_with_lora_path_s": load_s,
          "merged_vs_runtime_rel_l2": rel, "request": req, "step_profile": profile,
          "phase_seconds": time.perf_counter() - t_phase})
    return req["k1_launches"], step_launches


def _kernels_refuse_grad(torch, dev) -> dict:
    """K1 and K2 called directly on bf16 operands that require a gradient: each must raise
    (``ops/kernels/common.py::refuse_grad``). Returns each one's message."""
    from foley_tpu_torch.ops.kernels import flash_attention as FL
    from foley_tpu_torch.ops.kernels import fused_attention as FA

    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(1, 64, 2, 128, device=dev, generator=gen, dtype=torch.bfloat16)
    q.requires_grad_(True)
    tab = torch.ones(64, 128, device=dev)
    calls = {"fused_qk_attention": lambda: FA.fused_qk_attention(q, q, q, tab, tab, tab, tab,
                                                                 tab, tab),
             "flash_attention": lambda: FL.flash_attention(q, q, q)}
    out = {}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            out[name] = str(e)
        check("no backward" in out.get(name, ""), f"{name} on grad-requiring operands did not "
              "raise")
    return out


def train_full_phase(torch, dev, dac, pipeline_cfg, card: str, config="xxl"):
    """Full training at XXL: bf16 parameters and bf16 moments (the state four times 9.56
    GiB with the gradients), ``make_train_step``'s defaults (AdamW 1e-4, b1 0.9, b2 0.95,
    weight decay 0.01), every block checkpointed, 5 s, batch 1, ``TRAIN_FULL_STEPS`` steps
    (finite losses, no K1 launch); then ``export_for_inference`` with latent statistics,
    the loader's directory route (the weights and the statistics equal to what was
    exported) and one 5 s request, 2,700 K1 launches. fp32 full training at XXL is out: its
    parameters, gradients and moments alone take 4 x 19.13 GiB. Returns the loaded model
    and K1's launches in the request and in the steps."""
    import os
    import shutil

    import numpy as np

    from foley_tpu_torch.api import nodes
    from foley_tpu_torch.core.params import perturb_zero_leaves
    from foley_tpu_torch.models import mmdit
    from foley_tpu_torch.pipeline.generate import ModelBundle
    from foley_tpu_torch.training import loop, train

    t_phase = time.perf_counter()
    phase_base = torch.cuda.memory_allocated()
    cfg = pipeline_cfg.model
    gen = torch.Generator(device=dev).manual_seed(51)
    model = perturb_zero_leaves(mmdit.init(cfg, gen, device=dev, dtype=torch.bfloat16), gen)
    batch, _, _ = _train_batch(torch, dev, pipeline_cfg, 52)
    init_state, step = train.make_train_step(model)
    state = init_state(model)
    state_bytes = _bytes(list(state.params.values()) + list(state.opt_state.mu.values())
                         + list(state.opt_state.nu.values()))
    k1, k2 = _counts(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(TRAIN_FULL_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batch, loop.step_generator(53, i, dev))
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    profile = profiled(torch, lambda: (step(state, batch, loop.step_generator(53, 9, dev)),
                                       torch.cuda.synchronize()))  # two more steps
    check(all(np.isfinite(losses)), f"full-training losses {losses}")
    step_launches = k1.launches + k2.launches
    check(step_launches == 0, f"{k1.launches} K1 and {k2.launches} K2 launches in the steps")

    c = cfg.audio_vae_latent_dim
    stats_gen = np.random.default_rng(54)
    stats = (stats_gen.normal(size=c).astype(np.float32),
             stats_gen.uniform(0.5, 2.0, c).astype(np.float32))
    export_dir = "build/chip_smoke/train_full_export"
    shutil.rmtree(export_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.export_for_inference(state, export_dir, latent_stats=stats)
    export_s = time.perf_counter() - t0
    export_bytes = sum(os.path.getsize(os.path.join(export_dir, n))
                       for n in os.listdir(export_dir))
    trained = {k: v.detach() for k, v in state.params.items()}
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (fm,) = nodes.HunyuanModelLoader().load_model(export_dir, config=config, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(export_dir)
    check(fm["dtype"] == torch.bfloat16, f"the export loaded as {fm['dtype']}")
    for got, want in zip(fm["latent_stats"], stats):
        check(np.array_equal(got.cpu().numpy(), want), "latent stats differ from the export's")
    for k, v in fm["params"].state_dict().items():
        check(torch.equal(v, trained[k]), f"loaded {k} differs from the trained weight")
    del model, trained
    torch.cuda.empty_cache()
    bundle = ModelBundle(fm["params"], dac, pipeline_cfg, latent_stats=fm["latent_stats"])
    req, _ = _request(torch, dev, bundle, pipeline_cfg)
    emit({"phase": "train_full", "card": card, "config": config, "dtype": "bf16",
          "optimizer": "adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.01)",
          "latent_frames": pipeline_cfg.latent_length(DURATION_S), "batch": 1, "remat": True,
          "losses": losses, "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
          "peak_mem_gib": peak / 2 ** 30, "peak_above_phase_gib": (peak - phase_base) / 2 ** 30,
          "trainable_bytes": state_bytes // 3,
          "state_bytes": state_bytes, "export_bytes": export_bytes, "export_s": export_s,
          "load_s": load_s, "kernel_launches_in_steps": step_launches, "request": req,
          "step_profile": profile, "phase_seconds": time.perf_counter() - t_phase})
    return fm["params"], req["k1_launches"], step_launches


def _write_tone(path: str, hz: float, seconds: float, rate: int = 48000) -> None:
    """A decaying sine as 16-bit mono PCM, with the standard library's ``wave``."""
    import wave

    import numpy as np

    t = np.arange(int(rate * seconds)) / rate
    pcm = np.round(0.3 * np.sin(2 * np.pi * hz * t) * np.exp(-0.4 * t) * 32767)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.astype("<i2").tobytes())


def train_data_phase(torch, dev, model, dac, pipeline_cfg, card: str):
    """The training data path at XXL: four 5 s tones written as WAV files, ``encode_corpus``
    with the XXL DAC on the card into ``.npz`` shards, then ``NpzShardDataset`` ->
    ``flow_match_batches`` (standardized by ``latent_stats_from_shards``) ->
    ``PrefetchLoader`` (page-locked batches copied on a side stream) -> ``loop.train_lora``
    for ``TRAIN_DATA_STEPS`` steps over ``model``; last ``python -m
    foley_tpu_torch.tools.train_t2a`` at its defaults (TINY) in a child process."""
    import os
    import shutil

    import numpy as np

    from foley_tpu_torch.models import lora as lora_mod
    from foley_tpu_torch.training import data, loop, optim

    t_phase = time.perf_counter()
    root = "build/chip_smoke/train_data"
    shutil.rmtree(root, ignore_errors=True)
    wav_dir, shard_dir = os.path.join(root, "wavs"), os.path.join(root, "shards")
    os.makedirs(wav_dir)
    for i, hz in enumerate(TRAIN_TONES_HZ):
        _write_tone(os.path.join(wav_dir, f"tone_{i}.wav"), hz, DURATION_S)
    sr = pipeline_cfg.dac.sample_rate
    dataset = data.AudioFolderDataset(wav_dir, DURATION_S, sr, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards = data.encode_corpus(dac, dataset, shard_dir, num_clips=len(TRAIN_TONES_HZ),
                                batch_size=2)
    encode_s = time.perf_counter() - t0
    with np.load(shards[0]) as z:
        lat = z["latents"]
    t_len = pipeline_cfg.latent_length(DURATION_S)
    check(lat.shape == (len(TRAIN_TONES_HZ), t_len, pipeline_cfg.model.audio_vae_latent_dim)
          and bool(np.isfinite(lat).all()), f"shard latents {lat.shape}")
    stats = data.latent_stats_from_shards(shard_dir)
    loader = data.PrefetchLoader(data.flow_match_batches(
        iter(data.NpzShardDataset(shard_dir)), model, pipeline_cfg, batch_size=1,
        latent_stats=stats), depth=2, device=dev)
    devices, stamps = set(), []

    def batches():
        for b in loader:
            devices.update(t.device.type for t in b.values())
            yield b

    k1, k2 = _counts(torch)
    lora0 = lora_mod.init_lora(model, torch.Generator(device=dev).manual_seed(61), LORA_RANK)
    torch.cuda.synchronize()
    phase_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state = loop.train_lora(model, lora0, batches(), TRAIN_DATA_STEPS,
                                compute_dtype=torch.bfloat16,
                                optimizer=optim.adam(TRAIN_LR, b1=0.9, b2=0.95), log_every=1,
                                metrics_fn=lambda s, v: stamps.append((time.perf_counter(), v)))
    finally:
        loader.close()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_launches = k1.launches + k2.launches
    check(state.step == TRAIN_DATA_STEPS and devices == {dev.type} and step_launches == 0
          and all(np.isfinite(v) for _, v in stamps),
          f"steps {state.step}, batches on {devices}, {step_launches} kernel launches")
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(stamps, stamps[1:])]
    shard_bytes = sum(os.path.getsize(s) for s in shards)
    shutil.rmtree(root)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "foley_tpu_torch.tools.train_t2a"],
                         capture_output=True, text=True, timeout=600)
    tool_s = time.perf_counter() - t0
    check(out.returncode == 0 and "done: 10 steps" in out.stdout,
          f"train_t2a exited {out.returncode}: {out.stdout[-500:]} {out.stderr[-2000:]}")
    emit({"phase": "train_data", "card": card, "clips": len(TRAIN_TONES_HZ),
          "clip_s": DURATION_S, "encode_s": encode_s, "shard_bytes": shard_bytes,
          "latent_mean_abs": float(np.abs(stats[0]).mean()), "steps": state.step,
          "train_s": train_s, "step_ms": step_ms, "losses": [v for _, v in stamps],
          "peak_mem_gib": peak / 2 ** 30, "peak_above_phase_gib": (peak - phase_base) / 2 ** 30,
          "trainable_bytes": _bytes(lora0.values()),
          "kernel_launches_in_steps": step_launches, "train_t2a_s": tool_s,
          "train_t2a_tail": out.stdout.strip().splitlines()[-1],
          "phase_seconds": time.perf_counter() - t_phase})
    return step_launches


DAC_TRAIN_BATCH = 8         # excerpts a step
DAC_TRAIN_HOPS = 20         # 20 hops of 960 samples: 0.4 s at 48 kHz, the recipe's sub-second excerpts
DAC_TRAIN_STEPS = 5         # D + G steps on one batch (the mel loss must fall over them)
DAC_GRAD_HOPS = 2           # the card-vs-CPU gradient check's excerpt
DAC_GRAD_REL_TOL = 3e-2     # the card's fp32 gradients against the CPU's, relative L2 of the
                            # worst leaf, both in true fp32 (sums in another order through the
                            # FFTs and 40+ conv layers; a leaf whose gradient is small, as an
                            # MRD band with little energy, reads its rounding: 9.2e-3 in my
                            # first run); the control, TF32 let in (0.19 there), must break it
CODEC_CHUNK_REL = 1e-4      # a chunk encoded and decoded alone against the batched round trip
                            # (cuDNN's algorithms may change with the batch size)
CODEC_LONG_S = 30.0
TRANSFORM_SPEC_ATOL = 1e-5  # the normalised log-mel on the card against the CPU's: cuFFT's
                            # bins differ from the CPU FFT's in the last places, most in a
                            # quiet bin (1.8e-6 read in my first run; 1e-6 was too tight)
TRANSFORM_CROP_S = 5.0
PIL_CPU_FRAMES = 8          # frames of each resize also run on the CPU (each frame's bytes are
                            # its own: a subset holds the card to the CPU; 40 + 125 frames took
                            # 31 s there)


def _dac_audio(torch, dev, batch: int, hops: int, hop: int, seed: int):
    """[batch, hops * hop, 1] seeded excerpts: three tones with a decay and noise, on dev."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(hops * hop, device=dev, dtype=torch.float32) / 48000.0
    hz = 110.0 + 880.0 * torch.rand(batch, 3, 1, device=dev, generator=gen)
    tones = torch.sin(2 * torch.pi * hz * t).sum(dim=1) / 3.0
    noise = 0.02 * torch.randn(batch, hops * hop, device=dev, generator=gen)
    return (0.4 * tones * torch.exp(-2.0 * t) + noise)[..., None]


def _dac_grads(torch, gen, disc, audio, noise_d, noise_g):
    """The discriminators' and the generator's loss gradients (one step's, before any
    update) through ``training/dac_train.py``, the posterior noise injected."""
    from foley_tpu_torch.training import dac_train

    _, d_grads = dac_train.loss_and_grads(
        lambda: dac_train.discriminator_loss(gen, disc, audio, noise=noise_d),
        dict(disc.named_parameters()))
    _, g_grads = dac_train.loss_and_grads(
        lambda: dac_train.generator_loss(gen, disc, audio, noise=noise_g)[0],
        dict(gen.named_parameters()))
    return {**{"d." + k: v for k, v in d_grads.items()},
            **{"g." + k: v for k, v in g_grads.items()}}


def _condition_codec(torch, gen, audio, mean_rms: float = 0.5, out_rms: float = 0.1):
    """Scale ``gen``'s encoder conv weights, then its decoder's, each by one factor found by
    geometric bisection, so that the posterior mean of ``audio`` has RMS ``mean_rms`` and its
    decode ``out_rms``. A random init's activations grow through the codec's unnormalised
    layers to latents of ~1e4 and log-variances clipped at 20, where ``exp(logvar)`` in the
    KL's gradient magnifies fp32 rounding a hundred-million-fold and the clip's edges switch
    gradients on and off: no two fp32 implementations agree there. Returns the factors."""
    from foley_tpu_torch.models import dac_vae

    def weights(prefix):
        return [p for n, p in gen.named_parameters()
                if n.startswith(prefix) and n.endswith("weight")]

    def mean():
        return dac_vae.encode(gen, audio).mean

    def rms(x):
        return float(x.square().mean().sqrt())

    factors = []
    for group, measure, target in ((weights("encoder."), lambda: rms(mean()), mean_rms),
                                   (weights("decoder."),
                                    lambda: rms(dac_vae.decode(gen, mean())), out_rms)):
        base = [p.detach().clone() for p in group]
        lo, hi = 0.2, 1.5

        def scale(f):
            with torch.no_grad():
                for p, b in zip(group, base):
                    p.copy_(b * f)

        for _ in range(12):
            mid = (lo * hi) ** 0.5
            scale(mid)
            lo, hi = (lo, mid) if measure() > target else (mid, hi)
        factors.append((lo * hi) ** 0.5)
        scale(factors[-1])
    return factors


def dac_train_phase(torch, dev, pipeline_cfg, card: str):
    """DAC-VAE GAN training at the real codec (``DACConfig``: 371.6 M generator parameters)
    against the default discriminators (MPD periods 2, 3, 5, 7, 11; MRD FFT sizes 2048,
    1024, 512), through ``training/dac_train.py::make_dac_train_steps``: ``DAC_TRAIN_STEPS``
    D + G steps on one batch of ``DAC_TRAIN_BATCH`` seeded 0.4 s excerpts (the step's
    defaults: the DAC recipe's loss weights, AdamW at 1e-4), the noise from ``loop.step_generator``, the random init conditioned
    by ``_condition_codec`` (unconditioned, its KL grows from 5.6e11 to 1.4e27 in five
    steps, and fp32 overflows a few steps later). Reports ms a step (median),
    the D / G split, peak memory, one profiled step (launches, busy time, idle share), the
    bytes of both models and their optimizer state, every loss part (all finite, ``mel``
    falling). Then (``dac_train_grad``) the gradients of both losses on a
    ``DAC_GRAD_HOPS``-hop excerpt with the posterior noise injected, of a fresh init
    conditioned by ``_condition_codec``, on the card against a copy on the CPU (within
    ``DAC_GRAD_REL_TOL`` per leaf), and the control: ``"high"`` matmul precision, cuDNN's
    TF32 on and ``true_fp32`` bypassed must break the bound. No kernel of the port runs in
    the step (K1 / K2 / K3 serve the denoiser and the encoders)."""
    import contextlib
    import copy

    from foley_tpu_torch.models import dac_discriminator, dac_losses, dac_vae
    from foley_tpu_torch.ops import audio_dsp
    from foley_tpu_torch.ops import nn as nn_mod
    from foley_tpu_torch.training import dac_train, loop
    from foley_tpu_torch.training import train as train_mod

    t_phase = time.perf_counter()
    cfg = pipeline_cfg.dac
    dcfg = dac_discriminator.DiscriminatorConfig(sample_rate=cfg.sample_rate)
    gen = dac_vae.init(cfg, torch.Generator(device=dev).manual_seed(71), device=dev)
    disc = dac_discriminator.init(dcfg, torch.Generator(device=dev).manual_seed(72), device=dev)
    audio = _dac_audio(torch, dev, DAC_TRAIN_BATCH, DAC_TRAIN_HOPS, cfg.hop_length, 73)
    factors = _condition_codec(torch, gen, audio[:1])
    init_state, train_step = dac_train.make_dac_train_steps(gen, disc)
    state = init_state()
    marks = []
    real_loss_and_grads = dac_train.loss_and_grads

    def marked(fn, leaves):  # the D / G split: a mark at each half's start
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return real_loss_and_grads(fn, leaves)

    k1, k2 = _counts(torch)
    torch.cuda.synchronize()
    phase_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    history, step_ms, d_ms, g_ms = [], [], [], []
    dac_train.loss_and_grads = marked
    try:
        for i in range(DAC_TRAIN_STEPS):
            marks.clear()
            t0 = time.perf_counter()
            state, metrics = train_step(state, audio, loop.step_generator(0, i, dev))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step_ms.append((t1 - t0) * 1e3)
            d_ms.append((marks[1] - t0) * 1e3)
            g_ms.append((t1 - marks[1]) * 1e3)
            history.append({k: float(v) for k, v in metrics.items()})
    finally:
        dac_train.loss_and_grads = real_loss_and_grads
    peak = torch.cuda.max_memory_allocated()
    launches = k1.launches + k2.launches
    check(all(math.isfinite(v) for h in history for v in h.values()),
          f"dac_train: a loss is not finite: {history}")
    check(history[-1]["mel"] < history[0]["mel"],
          f"dac_train: mel did not fall over {DAC_TRAIN_STEPS} steps: "
          f"{[h['mel'] for h in history]}")
    check(launches == 0 and not any(p.requires_grad for p in (*gen.parameters(),
                                                              *disc.parameters())),
          f"dac_train: {launches} kernel launches in the steps, or gradients left on")

    def one_step():
        nonlocal state
        state, _ = train_step(state, audio, loop.step_generator(0, state.step, dev))
        torch.cuda.synchronize()

    prof = profiled(torch, one_step)
    opt_bytes = _bytes([*state.gen_opt.mu.values(), *state.gen_opt.nu.values(),
                        *state.disc_opt.mu.values(), *state.disc_opt.nu.values()])
    sizes = {"gen_params": sum(p.numel() for p in gen.parameters()),
             "disc_params": sum(p.numel() for p in disc.parameters()),
             "gen_bytes": _bytes(gen.parameters()), "disc_bytes": _bytes(disc.parameters()),
             "optimizer_state_bytes": opt_bytes}
    del state, init_state, train_step, gen, disc
    torch.cuda.empty_cache()
    emit({"phase": "dac_train", "card": card, "codec": "DACConfig (full width)",
          "discriminators": {"periods": list(dcfg.periods), "fft_sizes": list(dcfg.fft_sizes),
                             "rates": list(dcfg.rates)},
          "batch": DAC_TRAIN_BATCH, "excerpt_samples": DAC_TRAIN_HOPS * cfg.hop_length,
          "lr": 1e-4, "conditioning_factors": factors, "steps": DAC_TRAIN_STEPS,
          "step_ms": step_ms,
          "step_ms_median": statistics.median(step_ms[1:]), "d_ms": d_ms, "g_ms": g_ms,
          "peak_mem_gib": peak / 2 ** 30, "peak_above_phase_gib": (peak - phase_base) / 2 ** 30,
          **sizes, "losses": history, "profiled_step": prof,
          "kernel_launches_in_steps": launches, "phase_seconds": time.perf_counter() - t_phase})

    # the card's gradients against the CPU's, on a conditioned fresh init copied to the CPU
    t_grad = time.perf_counter()
    gen_card = dac_vae.init(cfg, torch.Generator(device=dev).manual_seed(74), device=dev)
    disc_card = dac_discriminator.init(dcfg, torch.Generator(device=dev).manual_seed(75),
                                       device=dev)
    small = _dac_audio(torch, "cpu", 1, DAC_GRAD_HOPS, cfg.hop_length, 76)
    factors = _condition_codec(torch, gen_card, small.to(dev))
    gen_cpu, disc_cpu = copy.deepcopy(gen_card).cpu(), copy.deepcopy(disc_card).cpu()
    lat = (1, DAC_GRAD_HOPS, cfg.latent_dim)
    ng = torch.Generator().manual_seed(77)
    noise_d, noise_g = torch.randn(lat, generator=ng), torch.randn(lat, generator=ng)
    t0 = time.perf_counter()
    ref = _dac_grads(torch, gen_cpu, disc_cpu, small, noise_d, noise_g)
    cpu_s = time.perf_counter() - t0

    def card_rel():
        """(worst leaf's relative L2, its name, all leaves' relative L2 together)."""
        got = _dac_grads(torch, gen_card, disc_card, small.to(dev), noise_d.to(dev),
                         noise_g.to(dev))
        worst = _worst_rel(torch, got, ref)
        name = max(ref, key=lambda k: _rel_l2(got[k].cpu(), ref[k]) if ref[k] is not None
                   and ref[k].any() else -1.0)
        flat = lambda d: torch.cat([d[k].cpu().reshape(-1) for k in ref  # noqa: E731
                                    if ref[k] is not None])
        return worst, name, _rel_l2(flat(got), flat(ref))

    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    bypass = [(m, "true_fp32") for m in (train_mod, dac_vae, dac_discriminator, dac_losses,
                                         audio_dsp)]
    try:
        rel = {"highest": card_rel()}
        torch.set_float32_matmul_precision("high")
        rel["high"] = card_rel()
        torch.backends.cudnn.allow_tf32 = True
        for mod, name in bypass:
            setattr(mod, name, contextlib.nullcontext)
        rel["tf32_control"] = card_rel()
    finally:
        for mod, name in bypass:
            setattr(mod, name, nn_mod.true_fp32)
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    del gen_card, disc_card, gen_cpu, disc_cpu
    torch.cuda.empty_cache()
    emit({"phase": "dac_train_grad", "card": card,
          "excerpt_samples": DAC_GRAD_HOPS * cfg.hop_length,
          "conditioning_factors": {"encoder": factors[0], "decoder": factors[1]},
          "worst_leaf_rel_l2": rel["highest"][0], "worst_leaf": rel["highest"][1],
          "all_leaves_rel_l2": rel["highest"][2], "under_high": rel["high"],
          "tf32_control": rel["tf32_control"], "rel_tol": DAC_GRAD_REL_TOL, "cpu_s": cpu_s,
          "phase_seconds": time.perf_counter() - t_grad})
    check(max(rel["highest"][0], rel["high"][0]) <= DAC_GRAD_REL_TOL,
          f"dac_train: the card's gradients read {rel} from the CPU's, limit {DAC_GRAD_REL_TOL}")
    check(rel["tf32_control"][0] > DAC_GRAD_REL_TOL,
          f"control: the step with TF32 reads {rel['tf32_control']} from the CPU, within the "
          f"limit {DAC_GRAD_REL_TOL}: the bound cannot tell TF32 from fp32")


def codec_phase(torch, dev, pipeline_cfg, t2a_latents, card: str):
    """The codec's chunked artifacts at full width (``models/dac_codec.py``) with the main
    path's DAC (seed 1): ``compress`` / ``decompress`` of the T2A request's 5 s (its latents
    decoded) and of a seeded 30 s signal, in 5 s chunks; seconds and artifact bytes; the
    latents equal to ``encode(chunks).mode()`` and the audio to its decode, and each chunk
    alone within ``CODEC_CHUNK_REL``. Then the RVQ (9 x 1024 x 8, random) on the 30 s
    latents on the card: ``from_codes(apply(z).codes)`` equal to ``apply``'s ``z_q`` and
    ``from_latents`` giving ``apply``'s codes (the latents standardized per channel); an
    artifact of codes decompressed."""
    import os

    import numpy as np

    from foley_tpu_torch.models import dac_codec, dac_vae, quantize

    t_phase = time.perf_counter()
    cfg = pipeline_cfg.dac
    dac = dac_vae.init(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    t2a = dac_vae.decode(dac, torch.from_numpy(np.asarray(t2a_latents, np.float32)).to(dev))
    t2a = t2a[0, :, 0].cpu().numpy()
    rng = np.random.default_rng(81)
    t = np.arange(int(CODEC_LONG_S * cfg.sample_rate)) / cfg.sample_rate
    long = (0.3 * np.sin(2 * np.pi * 330 * t) * np.sin(2 * np.pi * 0.5 * t)
            + 0.05 * rng.normal(size=t.shape)).astype(np.float32)
    os.makedirs("build/chip_smoke", exist_ok=True)
    out, rel_chunks = {}, []
    for name, wav in (("t2a_5s", t2a), ("signal_30s", long)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art = dac_codec.compress(dac, wav)
        torch.cuda.synchronize()
        compress_s = time.perf_counter() - t0
        path = art.save(f"build/chip_smoke/{name}.dac.npz")
        t0 = time.perf_counter()
        back = dac_codec.decompress(dac, dac_codec.DACFile.load(path))
        torch.cuda.synchronize()
        decompress_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(path)
        os.remove(path)
        check(back.shape == wav.shape and bool(np.isfinite(back).all()),
              f"codec {name}: {back.shape} from {wav.shape}")
        chunk = art.chunk_samples
        padded = np.zeros((art.payload.shape[0] * chunk,), np.float32)
        padded[:wav.shape[0]] = wav
        chunks = torch.from_numpy(padded.reshape(-1, chunk, 1)).to(dev)
        z = dac_vae.encode(dac, chunks).mode()
        check(np.array_equal(z.cpu().numpy(), art.payload),
              f"codec {name}: the latents differ from encode(chunks).mode()")
        dec = dac_vae.decode(dac, z).reshape(-1).cpu().numpy()[:wav.shape[0]]
        check(np.array_equal(dec, back), f"codec {name}: the audio differs from the decode")
        for i in range(chunks.shape[0]):
            zi = dac_vae.encode(dac, chunks[i:i + 1]).mode()
            n = min(chunk, wav.shape[0] - i * chunk)
            rel_chunks.append(max(_rel_l2(zi[0].cpu(), torch.from_numpy(art.payload[i])),
                                  _rel_l2(dac_vae.decode(dac, zi)[0, :n, 0].cpu(),
                                          torch.from_numpy(back[i * chunk:i * chunk + n]))))
        out[name] = {"samples": int(wav.shape[0]), "chunks": int(art.payload.shape[0]),
                     "compress_s": compress_s, "decompress_s": decompress_s,
                     "artifact_bytes": n_bytes, "wav_bytes_fp32": int(wav.nbytes),
                     "round_trip_rel_l2": _rel_l2(torch.from_numpy(back),
                                                  torch.from_numpy(wav))}
    check(max(rel_chunks) <= CODEC_CHUNK_REL,
          f"codec: a chunk alone reads {max(rel_chunks)} from the batch, limit {CODEC_CHUNK_REL}")
    # the discrete branch on the 30 s latents
    rcfg = quantize.RVQConfig(input_dim=cfg.latent_dim)
    rvq = quantize.init(rcfg, torch.Generator(device=dev).manual_seed(82), device=dev)
    # standardized per channel: the random codec's latents reach 1e4, where the
    # straight-through sum z_e + (z_q - z_e) rounds a code by |z_e|'s last place
    zc = torch.from_numpy(art.payload).to(dev)
    zc = (zc - zc.mean(dim=(0, 1))) / zc.std(dim=(0, 1))
    with torch.no_grad():
        q = quantize.apply(rvq, zc)
        z_codes = quantize.from_codes(rvq, q.codes)
        _, codes_l = quantize.from_latents(rvq, q.latents)
    rvq_rel = _rel_l2(z_codes.cpu(), q.z_q.cpu())
    check(rvq_rel <= 1e-5 and torch.equal(codes_l, q.codes),
          f"rvq: from_codes reads {rvq_rel} from apply, codes equal {torch.equal(codes_l, q.codes)}")
    coded = dac_codec.DACFile(q.codes.cpu().numpy().astype(np.int16), True, cfg.sample_rate,
                              int(long.shape[0]), art.chunk_samples)
    t0 = time.perf_counter()
    wav_codes = dac_codec.decompress(dac, coded, rvq=rvq)
    torch.cuda.synchronize()
    codes_s = time.perf_counter() - t0
    check(wav_codes.shape == long.shape and bool(np.isfinite(wav_codes).all()),
          f"rvq artifact decode {wav_codes.shape}")
    del dac, rvq
    torch.cuda.empty_cache()
    emit({"phase": "codec", "card": card, **out, "chunk_alone_worst_rel_l2": max(rel_chunks),
          "chunk_rel_tol": CODEC_CHUNK_REL,
          "rvq": {"codebooks": rcfg.n_codebooks, "codebook_size": rcfg.codebook_size,
                  "from_codes_rel_l2": rvq_rel, "codes_bytes": int(coded.payload.nbytes),
                  "commitment_loss": float(q.commitment_loss), "decompress_codes_s": codes_s},
          "phase_seconds": time.perf_counter() - t_phase})


def _items_equal(np, got: dict, ref: dict, spec_atol: float) -> float:
    """Check two transformed items equal (``a_spec`` within ``spec_atol``); returns a_spec's
    max abs difference (0 without one)."""
    check(set(got) == set(ref), f"transform keys {sorted(got)} vs {sorted(ref)}")
    spec = 0.0
    for key, r in ref.items():
        g = got[key]
        if isinstance(r, np.ndarray):
            check(g.dtype == r.dtype and g.shape == r.shape, f"transform {key}: {g.shape}")
            if key == "a_spec":
                spec = float(np.abs(g - r).max())
                check(spec <= spec_atol, f"transform a_spec: card vs CPU {spec} > {spec_atol}")
            else:
                check(np.array_equal(g, r), f"transform {key}: the card's differs from the CPU's")
        else:
            check(g == r, f"transform {key}: {g} vs {r}")
    return spec


def transforms_phase(torch, dev, card: str):
    """The Synchformer transform suite (``pipeline/transforms.py``) on the V2A phase's clip:
    125 frames of 25 fps 1280x720 and 5 s of seeded 16 kHz audio. ``eval_transforms`` and
    ``train_transforms`` (seed 0) with their torch steps
    (the PIL-exact resizes, the mel) on the card, then the same on the CPU in this process:
    every output equal bit for bit, ``a_spec`` within ``TRANSFORM_SPEC_ATOL``. Reports ms an
    item each way (host work: the numpy augmentations)."""
    import copy

    import numpy as np

    from foley_tpu_torch.pipeline import transforms as tr

    t_phase = time.perf_counter()
    frames = make_clip(np, 1, DURATION_S, CLIP_HW).astype(np.float32) / 255.0
    rng = np.random.default_rng(91)
    n = int(16000 * DURATION_S)
    t = np.arange(n) / 16000.0
    audio = (0.2 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=n)).astype(np.float32)
    item = {"frames": frames, "audio": audio}
    res = {}
    for name, build, n_items in (
            ("eval", lambda d: tr.eval_transforms(TRANSFORM_CROP_S, device=d), 1),
            ("train", lambda d: tr.train_transforms(TRANSFORM_CROP_S, seed=0, device=d), 1)):
        outs, ms = {}, {}
        for d in (dev, "cpu"):
            pipe = build(d)
            results, times = [], []
            for _ in range(n_items):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results.append(pipe(copy.copy(item)))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            outs[str(d)], ms[str(d)] = results, times
        spec = max(_items_equal(np, g, r, TRANSFORM_SPEC_ATOL)
                   for g, r in zip(outs[str(dev)], outs["cpu"]))
        first = outs["cpu"][0]
        res[name] = {"items": n_items, "ms_per_item_card": ms[str(dev)],
                     "ms_per_item_cpu": ms["cpu"], "a_spec_max_abs_card_vs_cpu": spec,
                     "v_segments": list(first["v_segments"].shape),
                     "a_spec": list(first["a_spec"].shape),
                     "offset_targets": [int(o.get("offset_target", -1)) for o in outs["cpu"]]}
        del outs
    emit({"phase": "transforms", "card": card, "clip": [int(frames.shape[0]), *CLIP_HW],
          **res, "spec_atol": TRANSFORM_SPEC_ATOL,
          "phase_seconds": time.perf_counter() - t_phase})


def pil_preprocess_phase(torch, dev, pipeline_cfg, frames_dir: str, card: str) -> dict:
    """The encoders' PIL route: ``cli.main --random_init xxl --single_video DIR
    --v2a_preprocess pil`` on the ``video_ingest`` frames (5 s, 50 steps): its WAV, 2,700 K1
    and 12 K2 launches, ``ops/pil_resize.py`` reached and the device resize not. Then on the
    clip: ``pil_resize`` on the card equal to the CPU's bit for bit at SigLIP2's and
    Synchformer's sizes (the host seconds of each resize on the card, and of its first
    ``PIL_CPU_FRAMES`` frames both ways), and the PIL route's features against the device
    route's on the same random encoders (relative L2). Returns
    {"k1": ..., "k2": ...} launches of the request."""
    import os
    import wave

    import numpy as np

    from foley_tpu_torch import cli
    from foley_tpu_torch.models import siglip2, synchformer
    from foley_tpu_torch.ops import pil_resize
    from foley_tpu_torch.pipeline import features

    t_phase = time.perf_counter()
    cfg = pipeline_cfg.model
    calls = {"pil_resize": 0, "device_resize": 0}
    real = (pil_resize.resize, siglip2.preprocess_frames_device,
            synchformer.preprocess_frames_device)

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    wav_path = "build/chip_smoke/pil_cli.wav"
    k1, k2 = _counts(torch)
    pil_resize.resize = counted("pil_resize", real[0])
    siglip2.preprocess_frames_device = counted("device_resize", real[1])
    synchformer.preprocess_frames_device = counted("device_resize", real[2])
    try:
        t0 = time.perf_counter()
        rc = cli.main(["--random_init", "xxl", "--random_init_perturb", "--single_video",
                       frames_dir, "--frames_fps", str(CLIP_FPS), "--duration",
                       str(DURATION_S), "--num_inference_steps", str(STEPS),
                       "--guidance_scale", str(GUIDANCE), "--v2a_preprocess", "pil",
                       "--device", dev.type, "--output", wav_path])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        pil_resize.resize, siglip2.preprocess_frames_device = real[0], real[1]
        synchformer.preprocess_frames_device = real[2]
    launches = {"k1": k1.launches, "k2": k2.launches,
                "k2_fp32": k2.launches_by_dtype.get(torch.float32, 0)}
    check(rc == 0, f"cli --v2a_preprocess pil exited {rc}")
    per_k1 = STEPS * (cfg.depth_triple_blocks + cfg.depth_single_blocks)
    check(launches["k1"] == per_k1 and launches["k2"] == 12,
          f"pil_preprocess: K1 {launches['k1']}, K2 {launches['k2']} (expected {per_k1}, 12)")
    check(calls["pil_resize"] > 0 and calls["device_resize"] == 0,
          f"pil_preprocess: the request took the wrong resize: {calls}")
    with wave.open(wav_path) as f:
        params = (f.getframerate(), f.getnchannels(), f.getnframes())
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
    os.remove(wav_path)
    check(params == (48000, 1, int(DURATION_S * 48000)) and np.abs(pcm).max() > 0,
          f"pil_preprocess WAV {params}")

    clip = make_clip(np, 1, DURATION_S, CLIP_HW).astype(np.float32) / 255.0
    f8 = features.resample_frames(clip, CLIP_FPS, DURATION_S, pipeline_cfg.siglip2_fps)
    resize = {}
    for name, fn, frames in (("siglip2_512", siglip2.preprocess_frames, f8),
                             ("synchformer_224", synchformer.preprocess_frames, clip)):
        out = {}
        for key, d, x_in in (("card", dev, frames), ("card_subset", dev, frames[:PIL_CPU_FRAMES]),
                             ("cpu_subset", "cpu", frames[:PIL_CPU_FRAMES])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = fn(x_in, device=d)
            torch.cuda.synchronize()
            out[key] = (x.cpu(), time.perf_counter() - t0)
        check(torch.equal(out["card"][0][:PIL_CPU_FRAMES], out["cpu_subset"][0])
              and torch.equal(out["card_subset"][0], out["cpu_subset"][0]),
              f"pil_resize on the card differs from the CPU's ({name})")
        resize[name] = {"frames": int(frames.shape[0]), "card_s": out["card"][1],
                        "subset_frames": PIL_CPU_FRAMES,
                        "subset_card_s": out["card_subset"][1],
                        "subset_cpu_s": out["cpu_subset"][1]}
    encoders = {"siglip2": siglip2.init_random(2, cfg.clip_dim, device=dev),
                "synchformer": synchformer.init_random(3, cfg.sync_feat_dim, device=dev)}
    feats = {}
    for route in ("device", "pil"):
        for enc in encoders.values():
            enc.preprocess = route
        feats[route] = features.encode_video(encoders, clip, CLIP_FPS, DURATION_S,
                                             pipeline_cfg)
    rel = {k: _rel_l2(p.cpu(), d.cpu()) for k, p, d in zip(("clip_feat", "sync_feat"),
                                                            feats["pil"], feats["device"])}
    del encoders, feats
    torch.cuda.empty_cache()
    emit({"phase": "pil_preprocess", "card": card, "cli_wall_s": cli_s, "launches": launches,
          "resize_calls": calls, "wav": list(params), "resize_s": resize,
          "pil_vs_device_features_rel_l2": rel,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------------
# mesh: serving over a ("data", "model") mesh of torch.distributed ranks
# ---------------------------------------------------------------------------------

MESH_SEED = 7                # the mesh requests' seed
MESH_DEPTH = (9, 18)         # the mesh requests' triple and single blocks, at XXL width: half
                             # of XXL's, cut to keep the whole script within 1,000 s
                             # (PERF.md §4); the served mesh runs the whole XXL
MESH_FORWARD_DEPTH = (2, 2)  # the fp32 forward's triple and single blocks, at XXL width
MESH_FORWARD_REL_TOL = 1e-5  # the fp32 forward on two model ranks against one card, relative
                             # L2: the row-parallel sums add the same products in another
                             # order (JAX's own test allows atol 2e-4 / rtol 1e-3)
MESH_CONTROL_FACTOR = 4.0    # a bf16 request's latents on the mesh, relative L2 from one
                             # card's, within this many times the control's (one card with
                             # the CFG pair run as two batch-1 forwards), measured in the run
MESH_LONG_S = 8.0            # the served long-form request: two 5 s windows
MESH_LONG_STEPS = 4
MESH_SERVER_TIMEOUT_S = 240
MESH_SERVER_ARGS = ("--random_init", "xxl", "--mesh", "model=2", "--device", "cuda:0",
                    "--port", "0", "--warmup_steps", "1")


class _SplitCFG:
    """The control of the mesh's bf16 requests: the one-card denoiser with the CFG pair run
    as two batch-1 forwards, each half with its own text K/V and visual projections (what
    two ``data`` ranks compute, on one card)."""

    def __init__(self, model):
        self.model = model

    def __getattr__(self, name):
        return getattr(self.model, name)

    def precompute_text_kv(self, cond):
        return [self.model.precompute_text_kv(c) for c in cond.chunk(2)]

    def __call__(self, x, t, cond, clip_feat, sync_feat, *, text_kv, visual_rows_shared, **kw):
        import torch

        halves = zip(*(a.chunk(2) for a in (x, t, cond, clip_feat, sync_feat)), text_kv)
        return torch.cat([self.model(*h[:5], text_kv=h[5], **kw) for h in halves])


def _mesh_forward_model(torch, dev):
    """The fp32 denoiser of the mesh's forward check: XXL width, ``MESH_FORWARD_DEPTH``
    blocks, seeded, its zero-initialized leaves perturbed."""
    import dataclasses

    from foley_tpu_torch.configs import XXL
    from foley_tpu_torch.core.params import perturb_zero_leaves
    from foley_tpu_torch.models import mmdit

    cfg = dataclasses.replace(XXL.model, depth_triple_blocks=MESH_FORWARD_DEPTH[0],
                              depth_single_blocks=MESH_FORWARD_DEPTH[1])
    model = mmdit.init(cfg, torch.Generator(device=dev).manual_seed(3), device=dev,
                       dtype=torch.float32)
    return perturb_zero_leaves(model, torch.Generator(device=dev).manual_seed(4))


def _mesh_bundle(torch, dev):
    """The bf16 bundle of the mesh's requests: the denoiser at XXL width and
    ``MESH_DEPTH``, drawn as ``HunyuanModelLoader.init_random(..., perturb=True)`` draws
    XXL's (seeds 0 and 1), and the XXL DAC of seed 1."""
    import dataclasses

    from foley_tpu_torch.configs import XXL
    from foley_tpu_torch.core.params import perturb_zero_leaves
    from foley_tpu_torch.models import dac_vae, mmdit
    from foley_tpu_torch.pipeline.generate import ModelBundle

    cfg = dataclasses.replace(XXL.model, depth_triple_blocks=MESH_DEPTH[0],
                              depth_single_blocks=MESH_DEPTH[1])
    model = perturb_zero_leaves(
        mmdit.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                   dtype=torch.bfloat16), torch.Generator(device=dev).manual_seed(1))
    dac = dac_vae.init(XXL.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    return ModelBundle(model, dac, dataclasses.replace(XXL, model=cfg),
                       compute_dtype=torch.bfloat16)


def _mesh_text(np, cfg):
    """Seeded text and negative-text features of a request (77 tokens)."""
    rng = np.random.default_rng(MESH_SEED)
    return tuple(rng.standard_normal((1, 77, cfg.condition_dim)).astype(np.float32)
                 for _ in range(2))


def mesh_rank_program(mesh, plan: dict) -> dict:
    """One rank of a ``mesh`` check (``parallel/launch.py`` runs it in a process of its own):
    ``plan["forward"]``, the fp32 forward of ``_mesh_forward_model`` on the 5 s CFG inputs;
    ``plan["request"]``, a 1-step warm-up then the 5 s bf16 request of ``plan["steps"]``
    steps through ``sharded_generate``. Returns rank 0's velocity and latents, and every
    rank's K1 launches (by head count), collectives a step, peak memory and wall."""
    import collections

    import torch

    from foley_tpu_torch.configs import XXL
    from foley_tpu_torch.models import mmdit
    from foley_tpu_torch.ops.kernels import fused_attention as FA
    from foley_tpu_torch.ops.kernels.common import reset_launches
    from foley_tpu_torch.parallel.inference import place_denoiser, shard_bundle, sharded_generate

    dev = mesh.device
    heads = collections.Counter()
    k1 = mmdit.fused_qk_attention

    def by_heads(q, *args, **kw):  # the heads of each call (each a launch on the card)
        heads[q.shape[2]] += 1
        return k1(q, *args, **kw)

    mmdit.fused_qk_attention = by_heads
    out, mine = {}, {}
    if plan.get("forward"):
        denoiser = place_denoiser(_mesh_forward_model(torch, dev), mesh)
        with torch.no_grad():
            out["forward"] = denoiser(*_forward_args(torch, dev, XXL, torch.float32)).cpu()
        del denoiser
        torch.cuda.empty_cache()
    if plan.get("request"):
        bundle = shard_bundle(_mesh_bundle(torch, dev), mesh)
        text, uncond = plan["text"]
        kw = dict(guidance_scale=GUIDANCE, seed=MESH_SEED, return_latents=True)
        mesh.reset_counts()
        sharded_generate(bundle, mesh, text, uncond, DURATION_S, num_inference_steps=1, **kw)
        one_step = mesh.counts()
        torch.cuda.synchronize(dev)
        reset_launches(FA.fused_qk_attention)
        heads.clear()
        mesh.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = sharded_generate(bundle, mesh, text, uncond, DURATION_S,
                               num_inference_steps=plan["steps"], **kw)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = mesh.counts()
        steps = plan["steps"] - 1  # the 1-step warm-up's collectives, set-up included, off
        mine = {"wall_s": wall, "k1_launches": FA.fused_qk_attention.launches,
                "k1_heads": dict(heads),
                "collectives_per_step": {
                    op: {k: (c[k] - one_step.get(op, {}).get(k, 0)) / steps for k in c}
                    for op, c in counts.items() if op != "broadcast"},
                "collectives_per_request": counts,
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        out["latents"] = res.latents
        out["audio_rms"] = float((res.audio_batch ** 2).mean() ** 0.5)
    out["ranks"] = mesh.gather_object(mine)
    return out


def _mesh_references(torch, dev, text, uncond) -> dict:
    """The one-card references of the ``mesh`` phase, in this process: the 5 s bf16
    request's latents and wall, the control's latents (``_SplitCFG``) and the fp32
    forward's velocity. Every model is freed before it returns."""
    from foley_tpu_torch.configs import XXL
    from foley_tpu_torch.pipeline.generate import generate_audio

    bundle = _mesh_bundle(torch, dev)
    kw = dict(guidance_scale=GUIDANCE, seed=MESH_SEED, return_latents=True)
    generate_audio(bundle, text, uncond, DURATION_S, num_inference_steps=1, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = generate_audio(bundle, text, uncond, DURATION_S, num_inference_steps=STEPS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    control = generate_audio(bundle._replace(mmdit=_SplitCFG(bundle.mmdit)), text, uncond,
                             DURATION_S, num_inference_steps=STEPS, **kw)
    del bundle
    model = _mesh_forward_model(torch, dev)
    with torch.no_grad():
        forward = model(*_forward_args(torch, dev, XXL, torch.float32)).cpu()
    del model
    torch.cuda.empty_cache()
    return {"latents": ref.latents, "wall_s": wall, "control": control.latents,
            "forward": forward}


def _latents_rel(np, got, ref) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _mesh_server(torch, card: str) -> dict:
    """``python -m foley_tpu_torch.serving.server --random_init xxl --mesh model=2 --device
    cuda:0 --port 0`` as a user starts it (warmed at 1 step): one 5 s T2A request and one
    ``MESH_LONG_S`` long-form request over HTTP, each WAV's length and level, then SIGTERM
    and its exit code 0; and ``--blocks_to_swap`` refused with ``--mesh`` (exit code 2)."""
    import io
    import os
    import re
    import signal
    import threading
    import urllib.request
    import wave

    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "foley_tpu_torch.serving.server", *MESH_SERVER_ARGS]
    device = MESH_SERVER_ARGS[MESH_SERVER_ARGS.index("--device") + 1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    lines, bound = [], threading.Event()
    url = {}

    def read():
        for line in proc.stderr:
            lines.append(line)
            m = re.search(r"serving on (http://[\d.]+:\d+)", line)
            if m:
                url["base"] = m.group(1)
                bound.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()

    def post(body):
        req = urllib.request.Request(url["base"] + "/generate", data=json.dumps(body).encode())
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=MESH_SERVER_TIMEOUT_S) as r:
            raw = r.read()
        with wave.open(io.BytesIO(raw)) as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        return pcm, time.perf_counter() - t

    try:
        # the refusal runs while the server starts: it exits before it touches the card
        refused = subprocess.run(argv + ["--blocks_to_swap", "4"], cwd=root,
                                 capture_output=True, text=True, timeout=120)
        check(refused.returncode == 2 and "drop --mesh" in refused.stderr,
              f"--mesh with --blocks_to_swap: exit {refused.returncode}, "
              f"{refused.stderr[-500:]}")
        ok = bound.wait(MESH_SERVER_TIMEOUT_S)
        check(ok, "the mesh server did not bind: " + "".join(lines)[-3000:])
        start_s = time.perf_counter() - t0
        t2a, t2a_s = post({"prompt": "x", "duration": DURATION_S, "steps": STEPS, "seed": 3})
        long, long_s = post({"prompt": "x", "duration": MESH_LONG_S, "steps": MESH_LONG_STEPS,
                             "seed": 4})
        check(t2a.shape == (int(DURATION_S * 48000),) and np.abs(t2a).max() > 0,
              f"served T2A: {t2a.shape}")
        check(long.shape == (int(MESH_LONG_S * 48000),) and np.abs(long).max() > 0,
              f"served long form: {long.shape}")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(120)
        check(code == 0, f"the mesh server exited {code} on SIGTERM: " + "".join(lines)[-3000:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(10)
    log = "".join(lines)
    check(all(f"as rank {r} (gloo, {device})" in log for r in range(2)),
          "the server's ranks did not both place their bundle: " + log[-3000:])
    return {"phase": "mesh", "check": "server_model2", "backend": "gloo",
            "start_s": start_s, "t2a_wall_s": t2a_s, "t2a_steps": STEPS,
            "long_wall_s": long_s, "long_s": MESH_LONG_S, "long_steps": MESH_LONG_STEPS,
            "sigterm_exit_code": code, "blocks_to_swap_refused": True,
            "seconds": time.perf_counter() - t0, "card": card}


def mesh_phase(torch, dev, pipeline_cfg, card: str) -> dict:
    """Serving over a ("data", "model") mesh at XXL width and ``MESH_DEPTH``, ``STEPS`` steps
    a request (``foley_tpu_torch/parallel/``): the one-card references first (their models freed
    before any rank starts; the kernels are built), then ``nccl_world1`` (one rank on the
    card over NCCL: the request's latents equal one card's bit for bit), ``gloo_model2`` (two
    ranks on ``cuda:0``, the heads split: the fp32 forward within ``MESH_FORWARD_REL_TOL``,
    the bf16 request within ``MESH_CONTROL_FACTOR`` x the control, 6 heads a K1 launch),
    ``gloo_data2`` (the CFG pair split over two ranks) and ``server_model2`` (the HTTP server
    over two model ranks). Returns K1's launches on each rank of each mesh."""
    import numpy as np

    from foley_tpu_torch.parallel.launch import launch
    from foley_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    cfg = pipeline_cfg.model
    text, uncond = _mesh_text(np, cfg)
    refs = _mesh_references(torch, dev, text, uncond)
    control = _latents_rel(np, refs["control"], refs["latents"])
    emit({"phase": "mesh", "check": "references", "request_wall_s": refs["wall_s"],
          "control_rel_l2": control, "seconds": time.perf_counter() - t_phase, "card": card})
    per_request = STEPS * sum(MESH_DEPTH)
    plan = {"request": True, "text": (text, uncond), "steps": STEPS}
    launches = {}
    for name, (data, model), forward in (("nccl_world1", (1, 1), False),
                                         ("gloo_model2", (1, 2), True),
                                         ("gloo_data2", (2, 1), False)):
        t0 = time.perf_counter()
        mesh = make_mesh(data, model, ["cuda:0"] * (data * model))
        out = launch(mesh, mesh_rank_program, dict(plan, forward=forward), timeout=300)
        ranks = out["ranks"]
        launches[name] = [r["k1_launches"] for r in ranks]
        heads = cfg.num_heads // model
        check(all(r["k1_launches"] == per_request and r["k1_heads"] == {heads: per_request}
                  for r in ranks),
              f"{name}: K1 launches by heads {[r['k1_heads'] for r in ranks]}, expected "
              f"{per_request} at {heads} heads on every rank")
        rel = _latents_rel(np, out["latents"], refs["latents"])
        line = {"phase": "mesh", "check": name, "backend": mesh.backend,
                "devices": list(mesh.devices), "request_latents_rel_l2": rel,
                "request_wall_s": [r["wall_s"] for r in ranks],
                "one_card_wall_s": refs["wall_s"], "k1_launches": launches[name],
                "k1_heads": heads, "collectives_per_step": [r["collectives_per_step"]
                                                          for r in ranks],
                "peak_gib": [r["peak_gib"] for r in ranks], "audio_rms": out["audio_rms"]}
        if name == "nccl_world1":
            check(mesh.backend == "nccl", f"one rank on its own card takes {mesh.backend}")
            same = bool(np.array_equal(out["latents"], refs["latents"]))
            check(same, f"nccl_world1: latents {rel} from one card's, expected bit for bit")
            line["bit_for_bit"] = same
        else:
            bound = MESH_CONTROL_FACTOR * control
            check(rel <= bound, f"{name}: latents {rel} from one card's, bound {bound} "
                  f"({MESH_CONTROL_FACTOR} x the control's {control})")
            line.update(control_rel_l2=control, bound=bound)
        if forward:
            f_rel = _rel_l2(out["forward"], refs["forward"])
            check(f_rel <= MESH_FORWARD_REL_TOL, f"{name}: fp32 forward {f_rel} from one "
                  f"card's, bound {MESH_FORWARD_REL_TOL}")
            line.update(forward_fp32_rel_l2=f_rel, forward_bound=MESH_FORWARD_REL_TOL,
                        forward_depth=list(MESH_FORWARD_DEPTH))
        line.update(seconds=time.perf_counter() - t0, card=card)
        emit(line)
    emit(_mesh_server(torch, card))
    emit({"phase": "mesh", "check": "done", "seconds": time.perf_counter() - t_phase,
          "card": card})
    return launches


# ---------------------------------------------------------------------------------
# mesh_train: denoiser training over a ("data", "model") mesh of torch.distributed ranks
# ---------------------------------------------------------------------------------

MESH_TRAIN_SEED = 61
MESH_TRAIN_DEPTH = (1, 1)       # the steps', checkpoints' and export's triple and single
                                # blocks at XXL width; cut from MESH_DEPTH (2.6 B parameters,
                                # a full bf16 state of 21 GB) for time: on an H100 the phase
                                # took 158.6 s at 2 + 4 blocks, 89.5-129.5 s at 1 + 2
                                # (PERF.md §4)
MESH_TRAIN_REL_TOL = 1e-5       # the fp32 step's gathered gradients against one card's,
                                # relative L2 per leaf (the same products summed in another
                                # order)
MESH_TRAIN_ROWS = 2             # the global batch: two 5 s clips, one a rank at data=2
MESH_TRAIN_CONFIG = "xxl_mesh_train"  # the export's config name, registered for the loader


def _mesh_train_model(torch, dev, depth, dtype):
    """The seeded denoiser of the ``mesh_train`` phase: XXL width, ``depth`` blocks, its
    zero-initialized leaves perturbed (as JAX's LoRA mesh test does)."""
    import dataclasses

    from foley_tpu_torch.configs import XXL
    from foley_tpu_torch.core.params import perturb_zero_leaves
    from foley_tpu_torch.models import mmdit

    cfg = dataclasses.replace(XXL.model, depth_triple_blocks=depth[0],
                              depth_single_blocks=depth[1])
    model = mmdit.init(cfg, torch.Generator(device=dev).manual_seed(MESH_TRAIN_SEED),
                       device=dev, dtype=dtype)
    return perturb_zero_leaves(model, torch.Generator(device=dev).manual_seed(
        MESH_TRAIN_SEED + 1))


def _mesh_train_batches(np, pipeline_cfg, n: int) -> list:
    """``n`` seeded global batches of ``MESH_TRAIN_ROWS`` 5 s clips (latents, text, clip and
    sync features), numpy."""
    cfg = pipeline_cfg.model
    clip_len, sync_len = pipeline_cfg.t2a_lengths(DURATION_S)
    shapes = {"latents": (pipeline_cfg.latent_length(DURATION_S), cfg.audio_vae_latent_dim),
              "cond": (cfg.text_length, cfg.condition_dim), "clip_feat": (clip_len, cfg.clip_dim),
              "sync_feat": (sync_len, cfg.sync_feat_dim)}
    rng = np.random.default_rng(MESH_TRAIN_SEED)
    return [{k: rng.standard_normal((MESH_TRAIN_ROWS,) + s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(n)]


def _mesh_train_draws(torch, batch, dev):
    """The global batch's noise and sigma of step 0, as ``flow_match_loss`` draws them from
    the step's generator."""
    from foley_tpu_torch.training import loop

    gen = loop.step_generator(MESH_TRAIN_SEED, 0, dev)
    x1 = batch["latents"]
    return torch.randn(x1.shape, generator=gen, device=dev), torch.rand(
        (x1.shape[0],), generator=gen, device=dev)


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items() if v is not None}


def _timed(torch, dev, fn):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _sha(torch, tensors: dict) -> dict:
    """The SHA-256 of each tensor's bytes."""
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest() for k, v in tensors.items()}


def _held(torch, mesh, tensors: dict, ref: dict, lora: bool = False):
    """Every leaf of ``tensors`` (this rank's slices; None: not reached) gathered whole,
    leaf by leaf (every rank joins), and held on rank 0 against the one-card ``ref`` (the
    leaves it reaches): the tree's relative L2, the worst leaf's, and whether every leaf
    equals its reference bit for bit. None on the other ranks."""
    from foley_tpu_torch.parallel import training as pt
    from foley_tpu_torch.parallel.sharding import REPLICATED, partition_spec_for

    reached = {k: v for k, v in tensors.items() if v is not None}
    num = den = worst = 0.0
    equal = set(reached) == set(ref)
    for name, t in reached.items():
        whole = pt.gather_leaf(t, REPLICATED if lora else partition_spec_for(name, t), mesh)
        if mesh.rank:
            continue
        r = ref[name].to(whole.device)
        equal = equal and torch.equal(whole, r)
        d2 = float((whole.double() - r.double()).square().sum())
        r2 = float(r.double().square().sum())
        check(bool(torch.isfinite(whole).all()), f"{name}: not finite on the mesh")
        check(r2 > 0 or d2 == 0, f"{name}: a gradient where one card has none")
        num, den = num + d2, den + r2
        worst = max(worst, math.sqrt(d2 / r2) if r2 else 0.0)
    if mesh.rank:
        return None
    return {"rel_l2": math.sqrt(num / den), "worst_leaf_rel_l2": worst, "bit_for_bit": equal}


def mesh_train_checks(mesh, plan: dict, refs: dict, fp32: bool, loops: bool):
    """The checks of one mesh on its rank, every model at ``MESH_TRAIN_DEPTH``: with
    ``fp32``, the fp32 gradients; the bf16 LoRA and full gradients (step 0's draws of the
    global batch), then one LoRA and one full step, each timed and its
    collectives counted; with ``loops``, ``_mesh_train_loops``. Each gradient and updated
    leaf is gathered and held against the one-card ``refs`` (``_held``). Returns rank 0's
    results (None elsewhere) and this rank's times, collectives, peak memory and digests of
    the replicated leaves."""
    import torch

    from foley_tpu_torch.parallel import training as pt
    from foley_tpu_torch.parallel.sharding import partition_spec_for, shard_params
    from foley_tpu_torch.training import loop

    dev = mesh.device
    rows = {k: torch.from_numpy(v).to(dev) for k, v in next(pt.data_rows(
        iter(plan["batches"][:1]), mesh)).items()}

    def gen():
        return loop.step_generator(MESH_TRAIN_SEED, 0, dev)

    def grads_of(model, leaves, reductions, ref, **kw):
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            (loss, grads), ms = _timed(torch, dev, lambda: pt.sharded_value_and_grad(
                model, mesh, rows, leaves, reductions, gen(), **kw))
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
        return {"loss": float(loss), "held": _held(torch, mesh, grads, ref, "lora" in kw),
                "ms": ms}

    out, mine = {}, {}
    if fp32:
        model = shard_params(_mesh_train_model(torch, dev, MESH_TRAIN_DEPTH,
                                               torch.float32), mesh)
        params = dict(model.named_parameters())
        out["fp32"] = grads_of(model, params, {n: pt.param_reduction(n, p, mesh)
                                               for n, p in params.items()}, refs["fp32"][1],
                               compute_dtype=torch.float32)
        del model, params
        torch.cuda.empty_cache()
    model = _mesh_train_model(torch, dev, MESH_TRAIN_DEPTH, torch.bfloat16)
    adapter = {k: v.to(dev) for k, v in _lora_adapter(torch, model, LORA_RANK,
                                                      MESH_TRAIN_SEED + 2).items()}
    shard_params(model, mesh)  # the adapter is drawn from the whole model first
    lora = {k: v.clone() for k, v in adapter.items()}
    out["lora"] = grads_of(model, lora, {n: pt.lora_reduction(n, mesh) for n in lora},
                           refs["lora"][1], lora=lora)
    params = dict(model.named_parameters())
    out["full"] = grads_of(model, params, {n: pt.param_reduction(n, p, mesh)
                                           for n, p in params.items()}, refs["full"][1])
    mine["grads_ms"] = {k: out[k]["ms"] for k in ("lora", "full")}

    torch.cuda.reset_peak_memory_stats(dev)
    for kind in ("lora", "full"):
        if kind == "lora":
            init_state, step = pt.make_sharded_lora_train_step(model, mesh)
            state = init_state(adapter)
        else:
            init_state, step = pt.make_sharded_train_step(model, mesh)
            state = init_state(model)
        mesh.reset_counts()
        (state, loss), ms = _timed(torch, dev, lambda: step(state, rows, gen()))
        mine[f"{kind}_step"] = {"ms": ms, "collectives": mesh.counts()}
        leaves = state.lora if kind == "lora" else state.params
        out[f"{kind}_step"] = {"loss": float(loss), "held": _held(
            torch, mesh, leaves, refs[f"{kind}_step"][1], kind == "lora")}
        if mesh.world > 1:  # the replicated leaves' bytes, to be compared across the ranks
            mine[f"{kind}_digests"] = _sha(torch, {
                k: v for k, v in leaves.items() if kind == "lora" or mesh.model == 1
                or partition_spec_for(k, v).axis is None})
    mine["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    mine["params"] = sum(p.numel() for p in model.parameters())
    del model, state, leaves, adapter, lora, params
    torch.cuda.empty_cache()
    if loops:
        mine.update(_mesh_train_loops(torch, mesh, plan))
    return (out if mesh.rank == 0 else None), mine


def mesh_train_rank_program(mesh, plan: dict) -> dict:
    """One rank of the ``mesh_train`` checks (``parallel/launch.py`` runs it in a process of
    its own): ``mesh_train_checks`` on each mesh of ``plan["meshes"]`` in turn, every mesh
    over this launch's ranks (the launch's own, then the others joined in the same
    processes). The one-card references are read from ``plan["refs"]``. Returns, by mesh,
    rank 0's results and every rank's."""
    import torch

    from foley_tpu_torch.parallel.mesh import Mesh

    refs = torch.load(plan["refs"], mmap=True)
    results = {}
    for name, (data, model), opts in plan["meshes"]:
        t0 = time.perf_counter()
        m = mesh if (data, model) == (mesh.data, mesh.model) else Mesh(
            data, model, mesh.mesh.devices, mesh.mesh.backend).join(mesh.rank)
        out, mine = mesh_train_checks(m, plan, refs, **opts)
        mine["seconds"] = time.perf_counter() - t0
        results[name] = {"out": out, "ranks": m.gather_object(mine), "backend": m.mesh.backend,
                         "devices": list(m.mesh.devices)}
    return results


def _mesh_train_loops(torch, mesh, plan) -> dict:
    """``train_sharded`` at bf16 on the rank's rows of ``plan["batches"]`` (staged by the
    unchanged ``PrefetchLoader``): two steps straight; one step with a checkpoint, then a
    resume to two in a fresh model, equal bit for bit on this rank; the resumed model
    exported to ``plan["export_dir"]``."""
    from foley_tpu_torch.parallel import training as pt
    from foley_tpu_torch.training.data import PrefetchLoader

    dev = mesh.device

    def run(steps, skip=0, ckpt=None):
        loader = PrefetchLoader(pt.data_rows(iter(plan["batches"][skip:]), mesh), device=dev)
        try:
            model = _mesh_train_model(torch, dev, MESH_TRAIN_DEPTH, torch.bfloat16)
            return pt.train_sharded(model, mesh, loader, steps, ckpt_dir=ckpt, ckpt_every=10,
                                    log_every=0, seed=MESH_TRAIN_SEED,
                                    compute_dtype=torch.bfloat16)
        finally:
            loader.close()

    straight = run(2)
    (_, ckpt_ms) = _timed(torch, dev, lambda: run(1, ckpt=plan["ckpt_dir"]))
    resumed = run(2, skip=1, ckpt=plan["ckpt_dir"])
    same = all(torch.equal(a[k], b[k]) for a, b in (
        (straight.params, resumed.params), (straight.opt_state.mu, resumed.opt_state.mu),
        (straight.opt_state.nu, resumed.opt_state.nu)) for k in a)
    same = same and (straight.step, straight.opt_state.count) == (
        resumed.step, resumed.opt_state.count) == (2, 2)
    del straight
    (_, export_ms) = _timed(torch, dev, lambda: pt.export_for_inference_sharded(
        resumed, plan["export_dir"], mesh))
    return {"resume_bit_for_bit": same, "one_step_and_checkpoint_ms": ckpt_ms,
            "export_ms": export_ms}


def _tree_rel(torch, dev, got: dict, ref: dict) -> float:
    """Relative L2 of a whole gradient tree (every leaf at once, on ``dev``); a leaf the loss
    does not reach is zero."""
    num = den = 0.0
    for name, r in ref.items():
        r = r.to(dev).double()
        g = got.get(name)
        g = torch.zeros_like(r) if g is None else g.to(dev).double()
        num += float((g - r).square().sum())
        den += float(r.square().sum())
    return math.sqrt(num / den)


def _mesh_train_references(torch, dev, batch_np) -> dict:
    """The one-card references of the ``mesh_train`` phase, in this process: the fp32
    gradients; the bf16 LoRA and full losses and gradients and, as the control, the same
    model's in fp32; one card's LoRA and full steps (``nccl_world1`` must equal them bit for
    bit), the full gradients computed twice (they must repeat bit for bit: the resize's
    backward of the sync path once added with atomics, ``ops/interp.py``). Every model is
    freed before it returns; the tensors are on the host."""
    from foley_tpu_torch.training import loop, train

    rows = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    noise, sigma = _mesh_train_draws(torch, rows, dev)

    def grads(model, leaves, lora=None, dtype=torch.bfloat16):
        loss, g = _loss_grads(torch, model, rows, noise, sigma, leaves, lora=lora,
                              compute_dtype=dtype)
        return float(loss), _host(g)

    refs = {}
    model = _mesh_train_model(torch, dev, MESH_TRAIN_DEPTH, torch.float32)
    refs["fp32"] = grads(model, dict(model.named_parameters()), dtype=torch.float32)
    del model
    model = _mesh_train_model(torch, dev, MESH_TRAIN_DEPTH, torch.bfloat16)
    adapter = {k: v.to(dev) for k, v in _lora_adapter(torch, model, LORA_RANK,
                                                      MESH_TRAIN_SEED + 2).items()}
    lora = {k: v.clone() for k, v in adapter.items()}
    refs["lora"] = grads(model, lora, lora=lora)
    refs["full"] = grads(model, dict(model.named_parameters()))
    again = grads(model, dict(model.named_parameters()))  # the sync path's atomics, fixed
    check(again[0] == refs["full"][0] and all(torch.equal(again[1][k], v)
                                              for k, v in refs["full"][1].items()),
          "one card's full bf16 gradients do not repeat bit for bit")
    control = _mesh_train_model(torch, dev, MESH_TRAIN_DEPTH, torch.bfloat16).float()
    refs["lora_fp32"] = grads(control, lora, lora=lora, dtype=torch.float32)
    refs["full_fp32"] = grads(control, dict(control.named_parameters()), dtype=torch.float32)
    del control
    torch.cuda.empty_cache()
    init_state, step = train.make_lora_train_step(model)
    state, loss = step(init_state(adapter), rows, loop.step_generator(MESH_TRAIN_SEED, 0, dev))
    refs["lora_step"] = (float(loss), _host(state.lora))
    init_state, step = train.make_train_step(model)
    state, loss = step(init_state(model), rows, loop.step_generator(MESH_TRAIN_SEED, 0, dev))
    refs["full_step"] = (float(loss), _host(state.params))
    refs["params"] = sum(p.numel() for p in model.parameters())
    del model, state, adapter, lora
    torch.cuda.empty_cache()
    return refs


def _mesh_train_line(name: str, result: dict, refs: dict, controls: dict, card: str) -> dict:
    """The checks of one mesh's results against the references and the controls (the
    module's bounds), as the phase's line for it."""
    out, ranks = result["out"], result["ranks"]
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    line = {"phase": "mesh_train", "check": name, "backend": result["backend"],
            "devices": result["devices"], "params_per_rank": [r["params"] for r in ranks],
            "step_ms": {k: [r[f"{k}_step"]["ms"] for r in ranks] for k in ("lora", "full")},
            "grads_ms": [r["grads_ms"] for r in ranks],
            "collectives_per_step": {k: [r[f"{k}_step"]["collectives"] for r in ranks]
                                     for k in ("lora", "full")},
            "peak_gib": [r["peak_gib"] for r in ranks],
            "grads_rel_l2": {k: out[k]["held"]["rel_l2"] for k in ("lora", "full")},
            "loss_rel": {k: rel(out[k]["loss"], refs[k][0]) for k in ("lora", "full")},
            "step_loss_rel": {k: rel(out[f"{k}_step"]["loss"], refs[f"{k}_step"][0])
                              for k in ("lora", "full")},
            "step_leaves_rel_l2": {k: out[f"{k}_step"]["held"]["rel_l2"]
                                   for k in ("lora", "full")}}
    if name == "nccl_world1":
        check(result["backend"] == "nccl", f"one rank on its own card takes {result['backend']}")
        for kind in ("lora", "full"):
            same = out[kind]["loss"] == refs[kind][0] and out[kind]["held"]["bit_for_bit"] \
                and out[f"{kind}_step"]["loss"] == refs[f"{kind}_step"][0] \
                and out[f"{kind}_step"]["held"]["bit_for_bit"]
            check(same, f"nccl_world1: the {kind} gradients, or its step's loss or updated "
                  "leaves, differ from one card's")
        line["bit_for_bit"] = True
    else:
        bounds = {k: MESH_CONTROL_FACTOR * v for k, v in controls["grads"].items()}
        loss_bounds = {k: MESH_CONTROL_FACTOR * v for k, v in controls["loss"].items()}
        for k in ("lora", "full"):
            check(line["grads_rel_l2"][k] <= bounds[k], f"{name}: {k} gradients "
                  f"{line['grads_rel_l2'][k]} from one card's, bound {bounds[k]} "
                  f"({MESH_CONTROL_FACTOR} x the control's {controls['grads'][k]})")
            check(line["loss_rel"][k] <= loss_bounds[k], f"{name}: {k} loss "
                  f"{line['loss_rel'][k]} from one card's, bound {loss_bounds[k]} "
                  f"({MESH_CONTROL_FACTOR} x the control's {controls['loss'][k]})")
        worst = out["fp32"]["held"]["worst_leaf_rel_l2"]
        check(worst <= MESH_TRAIN_REL_TOL, f"{name}: fp32 gradients {worst} from one card's "
              f"(worst leaf), bound {MESH_TRAIN_REL_TOL}")
        for kind in ("lora", "full"):
            digests = [r[f"{kind}_digests"] for r in ranks]
            check(digests[0] and all(d == digests[0] for d in digests),
                  f"{name}: replicated {kind} leaves differ across the ranks after a step")
        line.update(control_grads_rel_l2=controls["grads"], bound=bounds,
                    control_loss_rel=controls["loss"], loss_bound=loss_bounds,
                    fp32_worst_leaf_rel_l2=worst, fp32_bound=MESH_TRAIN_REL_TOL,
                    fp32_loss_rel=rel(out["fp32"]["loss"], refs["fp32"][0]),
                    replicated_bit_identical=True)
    if "resume_bit_for_bit" in ranks[0]:
        check(all(r["resume_bit_for_bit"] for r in ranks),
              f"{name}: the resumed run differs from the straight one")
        line.update(resume_bit_for_bit=True,
                    one_step_and_checkpoint_ms=[r["one_step_and_checkpoint_ms"] for r in ranks],
                    export_ms=[r["export_ms"] for r in ranks])
    line.update(seconds=[r["seconds"] for r in ranks], card=card)
    return line


def mesh_train_phase(torch, dev, pipeline_cfg, card: str) -> int:
    """Denoiser training over a ("data", "model") mesh at XXL width
    (``foley_tpu_torch/parallel/training.py``): the one-card references first (their models
    freed before any rank starts), then ``nccl_world1`` (one rank on the card over NCCL: the
    LoRA and full bf16 gradients and steps' losses and updated leaves equal one card's bit
    for bit), then ``gloo_model2`` and ``gloo_data2`` (two ranks on ``cuda:0``, both meshes
    in one launch: the fp32 gradients within ``MESH_TRAIN_REL_TOL`` per leaf, the bf16
    losses and gradients within ``MESH_CONTROL_FACTOR`` x the control, bf16 against fp32
    on one card, measured in this run; the replicated leaves bit-identical across the
    ranks after the steps; per rank ms a step, collectives a step and peak memory), on
    ``gloo_model2`` the loop's checkpoint and resume bit for bit, the mesh checkpoint read
    by the one-card ``restore_checkpoint``, and the mesh's export loaded by the one-card
    loader and serving a 5 s request. Returns K1's launches in that request."""
    import dataclasses
    import os
    import shutil

    import numpy as np

    from foley_tpu_torch.api import nodes
    from foley_tpu_torch.configs import model_configs
    from foley_tpu_torch.models import dac_vae
    from foley_tpu_torch.parallel.launch import launch
    from foley_tpu_torch.parallel.mesh import make_mesh
    from foley_tpu_torch.pipeline.generate import ModelBundle
    from foley_tpu_torch.training import loop, train

    t_phase = time.perf_counter()
    batches = _mesh_train_batches(np, pipeline_cfg, 2)
    refs = _mesh_train_references(torch, dev, batches[0])
    controls = {"grads": {k: _tree_rel(torch, dev, refs[k][1], refs[f"{k}_fp32"][1])
                          for k in ("lora", "full")},
                "loss": {k: abs(refs[k][0] - refs[f"{k}_fp32"][0]) / abs(refs[f"{k}_fp32"][0])
                         for k in ("lora", "full")}}
    work = os.path.join("build", "chip_smoke", "mesh_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    plan = {"batches": batches, "ckpt_dir": os.path.join(work, "ckpt"),
            "export_dir": os.path.join(work, "export"), "refs": os.path.join(work, "refs.pt")}
    torch.save({k: refs[k] for k in ("fp32", "lora", "full", "lora_step", "full_step")},
               plan["refs"])
    emit({"phase": "mesh_train", "check": "references", "params": refs["params"],
          "depth": list(MESH_TRAIN_DEPTH),
          "rows": MESH_TRAIN_ROWS, "control_grads_rel_l2": controls["grads"],
          "control_loss_rel": controls["loss"], "full_grads_repeat_bit_for_bit": True,
          "seconds": time.perf_counter() - t_phase,
          "card": card})
    for (data, model), meshes in (
            ((1, 1), [("nccl_world1", (1, 1), dict(fp32=False, loops=False))]),
            ((1, 2), [("gloo_model2", (1, 2), dict(fp32=True, loops=True)),
                      ("gloo_data2", (2, 1), dict(fp32=True, loops=False))])):
        t0 = time.perf_counter()
        mesh = make_mesh(data, model, ["cuda:0"] * (data * model))
        results = launch(mesh, mesh_train_rank_program, dict(plan, meshes=meshes),
                         timeout=600)
        for name, _, _ in meshes:
            emit(_mesh_train_line(name, results[name], refs, controls, card))
        emit({"phase": "mesh_train", "check": "launch", "meshes": [m[0] for m in meshes],
              "seconds": time.perf_counter() - t0, "card": card})

    # the mesh's checkpoint on one card, and its export through the one-card loader
    t0 = time.perf_counter()
    model = _mesh_train_model(torch, dev, MESH_TRAIN_DEPTH, torch.bfloat16)
    cut = dataclasses.replace(pipeline_cfg, model=model.cfg)
    init_state, _ = train.make_train_step(model)
    restored = loop.restore_checkpoint(loop.latest_checkpoint(plan["ckpt_dir"]),
                                       init_state(model))
    check(restored.step == restored.opt_state.count == 2,
          f"the mesh checkpoint restored at step {restored.step}")
    model_configs._PRESETS[MESH_TRAIN_CONFIG] = cut
    try:
        (fm,) = nodes.HunyuanModelLoader().load_model(plan["export_dir"],
                                                      config=MESH_TRAIN_CONFIG, device=dev)
    finally:
        del model_configs._PRESETS[MESH_TRAIN_CONFIG]
    for k, v in fm["params"].state_dict().items():
        check(torch.equal(v, restored.params[k]), f"the export's {k} differs from the mesh "
              "checkpoint's")
    del model, restored, init_state
    torch.cuda.empty_cache()
    dac = dac_vae.init(pipeline_cfg.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    req, _ = _request(torch, dev, ModelBundle(fm["params"], dac, cut), cut)
    shutil.rmtree(work, ignore_errors=True)
    del fm, dac
    torch.cuda.empty_cache()
    emit({"phase": "mesh_train", "check": "one_card", "restored_step": 2,
          "export_equals_checkpoint": True, "request": req,
          "seconds": time.perf_counter() - t0, "card": card})
    emit({"phase": "mesh_train", "check": "done", "seconds": time.perf_counter() - t_phase,
          "card": card})
    return req["k1_launches"]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on a card",
              file=sys.stderr)
        return 2
    from foley_tpu_torch.configs import TINY, XXL
    from foley_tpu_torch.core.params import param_count, perturb_zero_leaves
    from foley_tpu_torch.models import dac_vae, mmdit
    from foley_tpu_torch.ops.kernels import build
    from foley_tpu_torch.pipeline.generate import ModelBundle

    dev = torch.device("cuda", 0)
    smi_line = card_line()
    print(smi_line, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi_line,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_LIBS) + len(HOST_LIBS)) as pool:  # one compiler a source
        host = [pool.submit(build.host_library, name) for name in HOST_LIBS]
        list(pool.map(lambda lib: build.library(*lib), KERNEL_LIBS))
        for h in host:
            h.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": build.build_info})

    cfg = XXL.model
    kernel = kernel_phase(torch, dev, cfg)
    flash = flash_kernel_phase(torch, dev)
    variants = precision_kernel_phase(torch, dev, cfg)
    any_width = any_width_kernel_phase(torch, dev, TINY.model, cfg)
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
    forward_phase(torch, dev, model, XXL)
    bundle = ModelBundle(model, dac, XXL, compute_dtype=torch.bfloat16)
    launches, t2a_latents = main_path_phase(torch, dev, bundle, XXL)
    profile_phase(torch, bundle)
    flash_launches = v2a_path_phase(torch, dev, bundle, XXL, t2a_latents)
    text, uncond, clap_encoder = clap_phase(torch, dev)
    global STEPS
    STEPS = SURFACE_STEPS  # the phases below read it at call time
    long_k1, long_k2 = longform_path_phase(torch, dev, bundle, XXL, text, uncond)
    video_encoders = random_video_encoders(torch, dev, XXL)
    nodes_phase(torch, dev, bundle, XXL, clap_encoder, video_encoders)
    serving_k1, serving_k2 = serving_phase(torch, dev, bundle, XXL, clap_encoder,
                                           video_encoders)
    t2a_clip_latents = t2a_latents[1]  # the codec phase compresses this request's audio
    del bundle, clap_encoder, video_encoders, text, uncond, t2a_latents
    torch.cuda.empty_cache()
    quant_k1 = quant_phase(torch, dev, model, dac, XXL)
    swap_k1 = block_swap_phase(torch, dev, model, dac, XXL)
    del model, dac
    torch.cuda.empty_cache()
    encode_k2 = precision_phase(torch, dev, XXL)
    cli_k1 = cli_phase(torch, dev, XXL)

    t_new = time.perf_counter()
    foley_model = _random_xxl(torch, dev, "xxl", perturb=True)  # the CLI's model, seed 0
    dac = dac_vae.init(XXL.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    configs_k1 = configs_phase(torch, dev, foley_model["params"], XXL)
    heads_k1 = heads_path_phase(torch, dev, foley_model["params"], dac, card_line())
    video_launches, frames_dir, frames = video_ingest_phase(torch, dev, foley_model, dac, XXL)
    lora_k1, lora_wav = lora_phase(torch, dev, foley_model, dac, XXL)
    del foley_model, dac
    torch.cuda.empty_cache()
    desync_phase(torch, dev, frames_dir, frames, lora_wav)
    del frames
    codec_launches = image_codecs_phase(torch, dev, XXL, card_line())
    format_launches = frame_formats_phase(torch, dev, XXL, card_line())
    emit({"phase": "rest_of_inference", "seconds": time.perf_counter() - t_new})

    t_train = time.perf_counter()
    train_card = card_line()
    train_grad_phase(torch, dev, XXL, train_card)
    dac = dac_vae.init(XXL.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
    lora_trained_k1, lora_step_k1 = train_lora_phase(torch, dev, dac, XXL, train_card)
    torch.cuda.empty_cache()
    trained, full_trained_k1, full_step_k1 = train_full_phase(torch, dev, dac, XXL, train_card)
    data_step_k1 = train_data_phase(torch, dev, trained, dac, XXL, train_card)
    del trained, dac
    torch.cuda.empty_cache()
    emit({"phase": "training", "seconds": time.perf_counter() - t_train})

    t_slice = time.perf_counter()
    slice_card = card_line()
    dac_train_phase(torch, dev, XXL, slice_card)
    codec_phase(torch, dev, XXL, t2a_clip_latents, slice_card)
    transforms_phase(torch, dev, slice_card)
    pil_launches = pil_preprocess_phase(torch, dev, XXL, frames_dir, slice_card)
    emit({"phase": "codec_training_transforms", "seconds": time.perf_counter() - t_slice})
    torch.cuda.empty_cache()
    mesh_k1 = mesh_phase(torch, dev, XXL, card_line())
    torch.cuda.empty_cache()
    mesh_trained_k1 = mesh_train_phase(torch, dev, XXL, card_line())
    torch.cuda.empty_cache()
    _, longrun_k1 = train_longrun_phase(torch, dev, card_line())

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

    # K1 at other head widths: bf16 at the heads_path request's width (24 heads of 64),
    # weighted as its 5 s step mixes the shapes; its launches are that request's (every one
    # at head_dim 64), and train_longrun's deploy (TINY, fp32) beside them
    mma_mix = {f"joint_5s_h{HEADS_PATH[0]}": cfg.depth_triple_blocks,
               f"single_5s_h{HEADS_PATH[0]}": cfg.depth_single_blocks}

    def mma_mean(key, tname="bf16"):
        return (sum(any_width[tname][c][key] * n for c, n in mma_mix.items())
                / sum(mma_mix.values()))

    mma_bound = kernel_bound(mma_mean("bytes"), mma_mean("flops"))
    mma_row = {
        "name": "fused_qk_attention_mma", "route": "cuda",
        "source": "foley_tpu_torch/csrc/fused_qk_attention_mma.cu",
        "replaces": "foley_tpu/ops/pallas/fused_attention.py:82", "dtype": "bf16",
        "launches": heads_k1, "launches_train_longrun_fp32": longrun_k1,
        "max_abs_err": max(r["max_abs_err"] for r in any_width["bf16"].values()),
        "max_abs_err_fp16": max(r["max_abs_err"] for r in any_width["fp16"].values()),
        "max_rel_l2_err_fp32": max(r["rel_l2_err"] for r in any_width["fp32"].values()),
        "ms": mma_mean("kernel_ms"), "plain_ms": mma_mean("plain_ms"),
        "bound_ms": mma_bound["bound_ms"], "bound_by": mma_bound["bound_by"],
        "library_ms": mma_mean("library_ms"),
    }

    print(card_line(), flush=True)  # again near the end, where a cut log still shows it
    k2 = flash["siglip2_5s"]  # the main V2A path's shape (the 24 s run's is siglip2_24s)
    k3_bound = gemm["probe_full"]  # the probe's shape: one sweep of the probe
    emit({"kernels": [{
        "name": "fused_qk_attention", "route": "cuda",
        "source": "foley_tpu_torch/csrc/fused_qk_attention.cu",
        "replaces": "foley_tpu/ops/pallas/fused_attention.py:82",
        "launches": launches, "launches_longform": long_k1,
        "launches_serving": serving_k1, "launches_quant": quant_k1,
        "launches_block_swap": swap_k1, "launches_cli_int8_swap30": cli_k1["int8_swap30"],
        "launches_lora": lora_k1,
        "launches_video_ingest": {k: v[0] for k, v in video_launches.items()},
        "launches_configs_forward": configs_k1,
        "launches_trained": {"lora_merged": lora_trained_k1, "full_export": full_trained_k1},
        "launches_in_train_steps": lora_step_k1 + full_step_k1 + data_step_k1,
        "launches_pil_preprocess": pil_launches["k1"],
        "launches_image_codecs": {k: v[0] for k, v in codec_launches.items()},
        "launches_frame_formats": format_launches[0],
        "launches_mesh_per_rank": mesh_k1,
        "launches_mesh_trained": mesh_trained_k1,
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
        "launches_video_ingest_server": video_launches["server"][1],
        "launches_image_codecs_server": codec_launches["server"][1],
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
        dict(variant("flash_attention", "fp32", "foley_tpu_torch/csrc/attention_f32.cu",
                     "foley_tpu/ops/pallas/flash_attention.py:60", encode_k2["fp32"]),
             # the CLI's and feature_process's random-init encoders are fp32, as in the JAX
             # package
             launches_video_ingest={k: v[1] for k, v in video_launches.items()
                                    if k != "server"},
             launches_pil_preprocess=pil_launches["k2_fp32"],
             launches_image_codecs_cli=codec_launches["cli"][1],
             launches_frame_formats_cli=format_launches[1]),
        mma_row,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
