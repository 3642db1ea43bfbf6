"""The command line on the port (``foley_tpu/cli.py`` counterpart): ``python -m
foley_tpu_torch.cli``. The same flags as the JAX package's, plus ``--device`` (``cuda`` unless
given), so a command line runs on either package.

Examples:
    # Text-to-audio with a checkpoint directory, on the card
    python -m foley_tpu_torch.cli --model_path ckpts/ --single_prompt "glass shattering" \\
        --duration 5 --num_inference_steps 50 --guidance_scale 4.5 --output out.wav

    # Smoke test with random weights, on the CPU
    python -m foley_tpu_torch.cli --device cpu --random_init tiny --single_prompt "test" \\
        --duration 1 --num_inference_steps 10 --precision fp32 --output /tmp/t2a.wav

Routes: text-to-audio through the sampler node (``--duration`` past the config's cap runs in
windows), video-to-audio (``--single_video``: a directory of PNG, JPEG or BMP frames, read
without PIL, an MJPEG AVI, or a video file through ffmpeg; ``--merge_video`` muxes the
result onto a video file with ffmpeg, or onto a frames directory as an MJPEG AVI with no
external tool), SDEdit (``--audio_input``), continuation (``--continue_audio``), the PCM stream
(``--stream_pcm``: T2A, V2A and continuation, ``--first_window``), ``--csv_path`` batches,
the AV desync score of a video's audio (``--desync_score``) and ``--gradio`` (the HTTP
server, ``serving/server.py``; ``--gradio --mesh data=D,model=M`` serves over a mesh of
ranks, and ``--mesh`` without ``--gradio`` is ignored, as in the JAX package).
``--lora DIR`` merges an adapter in the port's format (``models/lora.py``;
``tools/lora_to_safetensors.py`` converts the JAX package's orbax adapters) into the
denoiser at load, before any ``--quantization``. ``--precision`` takes bf16, fp16 and
fp32 on the card (each has its K1 / K2 kernels); with ``--model_path``, bf16 means the
checkpoint's own dtype (``auto``), as in the JAX package.

Memory modes: ``--quantization`` (fp8_e4m3fn, fp8_e5m2, int8, int8_dynamic, int4; ``auto``
takes a checkpoint's fp8 type) stores the denoiser's weights quantized
(``io/quantize.py``), and ``--blocks_to_swap N`` keeps its last N blocks in page-locked
host memory, streamed through ``--prefetch_blocks + 1`` device slots a block family
(``parallel/offload.py``), on every route. E.g., on the card:

    python -m foley_tpu_torch.cli --random_init xxl --random_init_perturb \
        --quantization int8 --blocks_to_swap 30 --prefetch_blocks 1 --output out.wav

``--v2a_preprocess`` picks the encoders' frame resize: ``device`` (the default) or ``pil``
(PIL's BICUBIC resize of the reference, byte for byte through ``ops/pil_resize.py``, on the
device; no PIL needed).

Refused, exit code 2 and a message saying why: ``--prefetch_blocks`` without
``--blocks_to_swap``. A video file other than an MJPEG AVI needs ffmpeg on ``PATH`` (the JAX
package's PyAV route is not ported); PNG, JPEG, BMP, TIFF and WebP frames (lossless, lossy,
an animation's first frame) are read without PIL (``pipeline/video.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional

logger = logging.getLogger("foley_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("foley-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, default=None,
                   help="Directory with hunyuanvideo_foley / vae / synchformer checkpoints")
    p.add_argument("--config", type=str, default="xxl", choices=["xxl", "xl", "tiny"])
    p.add_argument("--random_init", type=str, default=None, metavar="CONFIG",
                   help="Skip checkpoints; random-init the given config (smoke tests)")
    p.add_argument("--random_init_perturb", action="store_true",
                   help="with --random_init: perturb the zero-init leaves so the model "
                        "emits real velocity")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the models run on (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--single_prompt", type=str, default="")
    p.add_argument("--neg_prompt", type=str, default="noisy, harsh")
    p.add_argument("--single_video", type=str, default=None,
                   help="Video file (ffmpeg) or directory of PNG frames for V2A")
    p.add_argument("--frames_fps", type=float, default=16.0,
                   help="Frame rate declared for --single_video when it is a frames directory")
    p.add_argument("--csv_path", type=str, default=None,
                   help="Batch CSV: video_path,prompt")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--guidance_scale", type=float, default=4.5)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--sampler", type=str, default="euler",
                   choices=["euler", "heun-2", "midpoint-2", "kutta-4"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "fp16", "fp32"])
    p.add_argument("--quantization", type=str, default="none",
                   choices=["none", "auto", "fp8_e4m3fn", "fp8_e5m2", "int8", "int8_dynamic",
                            "int4"],
                   help="weight storage of the denoiser (io/quantize.py); auto: the "
                        "checkpoint's fp8 type, else fp8_e4m3fn")
    p.add_argument("--blocks_to_swap", type=int, default=0,
                   help="keep the LAST N of the 54 blocks in page-locked host memory, "
                        "streamed to the card each step (parallel/offload.py); composes "
                        "with --quantization")
    p.add_argument("--prefetch_blocks", type=int, default=0,
                   help="extra swapped-block copies in flight (device window = N+1)")
    p.add_argument("--lora", type=str, default=None, metavar="DIR",
                   help="LoRA adapter directory (lora.safetensors + lora_meta.json) merged "
                        "into the denoiser at load (before any --quantization)")
    p.add_argument("--lora_scale", type=float, default=1.0,
                   help="multiplier on the adapter's own recommended scale; 0 disables")
    p.add_argument("--output", type=str, default="output.wav")
    p.add_argument("--merge_video", action="store_true",
                   help="Mux generated audio onto --single_video with ffmpeg (a frames "
                        "directory: an MJPEG AVI, no ffmpeg needed)")
    p.add_argument("--desync_score", action="store_true",
                   help="Score AV sync of --single_video's own audio (Synchformer offset head)")
    p.add_argument("--audio_input", type=str, default=None,
                   help="Edit an existing 48 kHz 16-bit WAV toward the prompt (SDEdit-style "
                        "partial denoise); with --desync_score, the audio track to score "
                        "against (no ffmpeg needed; required when --single_video is a frames "
                        "dir)")
    p.add_argument("--v2a_preprocess", type=str, default="device", choices=["device", "pil"],
                   help="V2A frame resize: device (antialiased bicubic) or pil (PIL's "
                        "BICUBIC bytes, computed on the device)")
    p.add_argument("--strength", type=float, default=0.6,
                   help="Edit strength in (0, 1]: fraction of the schedule to re-run")
    p.add_argument("--continue_audio", type=str, default=None, metavar="WAV",
                   help="Continue an existing 48 kHz WAV by --duration seconds toward the "
                        "prompt (the encoded tail is the first window's known prefix); writes "
                        "the NEW audio to --output")
    p.add_argument("--context_s", type=float, default=4.0,
                   help="--continue_audio: seconds of the source's tail to condition on")
    p.add_argument("--stream_pcm", action="store_true",
                   help="stream raw int16 mono PCM to stdout chunk by chunk as long-form "
                        "windows finalize (pipe to `aplay -f S16_LE -r 48000 -c 1`); T2A "
                        "prompts and --continue_audio; logs go to stderr")
    p.add_argument("--first_window", type=float, default=None,
                   help="--stream_pcm latency ramp: denoise and emit this many seconds first")
    p.add_argument("--progress", action="store_true",
                   help="log a line per denoise step (the reference's ProgressBar)")
    p.add_argument("--allow_unconditioned", action="store_true",
                   help="Permit generation with zero text features when CLAP is not loaded")
    p.add_argument("--gradio", action="store_true",
                   help="Launch the HTTP server (GET / plus the JSON/WAV API) instead of "
                        "one-shot generation")
    p.add_argument("--host", type=str, default="127.0.0.1", help="--gradio bind host")
    p.add_argument("--port", type=int, default=8321, help="--gradio bind port")
    p.add_argument("--max_batch", type=int, default=1,
                   help="--gradio only: >1 enables request coalescing in the server")
    p.add_argument("--mesh", type=str, default="",
                   help='--gradio only: multi-card serving mesh, e.g. "data=2,model=2"')
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(asctime)s %(message)s")

    if args.prefetch_blocks and not args.blocks_to_swap:
        print("error: --prefetch_blocks only applies with --blocks_to_swap > 0",
              file=sys.stderr)
        return 2
    if args.stream_pcm and (args.audio_input or args.csv_path
                            or args.desync_score or args.gradio):
        print("error: --stream_pcm supports prompt (T2A), --single_video (V2A) and "
              "--continue_audio runs", file=sys.stderr)
        return 2
    if args.stream_pcm and args.single_video and args.continue_audio:
        print("error: audio continuation is text-conditioned only; drop --single_video",
              file=sys.stderr)
        return 2

    if args.gradio:
        # the HTTP server, with the JAX package's argv mapping (and the device)
        from foley_tpu_torch.serving import server as serving_server

        serve_argv = ["--host", args.host, "--port", str(args.port),
                      "--precision", args.precision,
                      "--quantization", args.quantization,
                      "--config", args.config,
                      "--durations", str(args.duration),
                      "--warmup_steps", str(args.num_inference_steps),
                      "--max_batch", str(args.max_batch),
                      "--v2a_preprocess", args.v2a_preprocess]
        if args.blocks_to_swap:
            serve_argv += ["--blocks_to_swap", str(args.blocks_to_swap)]
            if args.prefetch_blocks:
                serve_argv += ["--prefetch_blocks", str(args.prefetch_blocks)]
        if args.mesh:
            serve_argv += ["--mesh", args.mesh]
        if args.lora:
            serve_argv += ["--lora", args.lora, "--lora_scale", str(args.lora_scale)]
        serve_argv += ["--device", args.device]
        if args.random_init:
            serve_argv += ["--random_init", args.random_init]
        elif args.model_path:
            serve_argv += ["--model_path", args.model_path]
        else:
            print("error: --gradio needs --model_path or --random_init", file=sys.stderr)
            return 2
        return serving_server.main(serve_argv)

    if args.desync_score:
        return _desync_score(args)

    if args.csv_path:
        return _process_batch(args)

    try:
        import numpy as np

        from foley_tpu_torch.api.nodes import (
            HunyuanDependenciesLoader,
            HunyuanFoleySampler,
            HunyuanModelLoader,
            adapt_random_model,
        )
        from foley_tpu_torch.core.device import resolve_device
        from foley_tpu_torch.io.audio import write_wav

        dev = resolve_device(args.device)
        if args.random_init:
            import torch

            from foley_tpu_torch.configs import get_config
            from foley_tpu_torch.models import dac_vae

            foley_model = HunyuanModelLoader.init_random(
                args.random_init, args.precision, args.seed, perturb=args.random_init_perturb,
                device=dev)
            adapt_random_model(foley_model["params"], args.lora, args.lora_scale,
                               args.quantization)
            cfg = get_config(args.random_init)
            dac = dac_vae.init(cfg.dac, torch.Generator(device=dev).manual_seed(args.seed + 1),
                               device=dev)
            dependencies = {"dac_params": dac, "dac_cfg": cfg.dac}
            if args.single_video:
                # checkpoint-free V2A: random-weight encoders matched to the model's widths,
                # fp32 as in the JAX CLI
                from foley_tpu_torch.models import siglip2, synchformer

                dependencies["siglip2"] = siglip2.init_random(
                    args.seed + 2, cfg.model.clip_dim, device=dev)
                dependencies["synchformer"] = synchformer.init_random(
                    args.seed + 3, cfg.model.sync_feat_dim, device=dev)
        else:
            if not args.model_path:
                print("error: provide --model_path or --random_init", file=sys.stderr)
                return 2
            mp = args.model_path
            (foley_model,) = HunyuanModelLoader().load_model(
                os.path.join(mp, "hunyuanvideo_foley.safetensors"),
                precision="auto" if args.precision == "bf16" else args.precision,
                quantization=args.quantization, config=args.config,
                lora_path=args.lora or "", lora_scale=args.lora_scale, device=dev)
            # encoders colocated under the model dir load automatically (clap/, siglip2/:
            # the layout pipeline/standalone.py uses); absent dirs are skipped
            clap_dir, siglip_dir = os.path.join(mp, "clap"), os.path.join(mp, "siglip2")
            (dependencies,) = HunyuanDependenciesLoader().load_dependencies(
                os.path.join(mp, "vae_128d_48k.safetensors"),
                os.path.join(mp, "synchformer_state_dict.safetensors"),
                siglip2_model=siglip_dir if os.path.isdir(siglip_dir) else "",
                clap_model=clap_dir if os.path.isdir(clap_dir) else "", device=dev)
        for key in ("siglip2", "synchformer"):
            if key in dependencies:
                dependencies[key].preprocess = args.v2a_preprocess

        if args.stream_pcm:
            return _stream_pcm(args, foley_model, dependencies)
        if args.first_window is not None:
            print("error: --first_window is a --stream_pcm latency ramp (batch outputs "
                  "gain nothing from it)", file=sys.stderr)
            return 2
        if args.continue_audio:
            return _continue_audio(args, foley_model, dependencies)
        if args.audio_input:
            return _edit_audio(args, foley_model, dependencies)

        image, fps = None, 16.0
        if args.single_video:
            from foley_tpu_torch.pipeline.video import read_video_frames

            t_read = time.perf_counter()
            image, fps = read_video_frames(args.single_video, dir_fps=args.frames_fps,
                                           device=dev)
            logger.info(f"read {image.shape[0]} frames @ {fps} fps in "
                        f"{time.perf_counter() - t_read:.2f}s")

        swap_args = ({"blocks_to_swap": args.blocks_to_swap,
                      "prefetch_blocks": args.prefetch_blocks}
                     if args.blocks_to_swap > 0 else None)
        t0 = time.perf_counter()
        audio_first, _ = HunyuanFoleySampler().generate_audio(
            foley_model, dependencies, block_swap_args=swap_args, frame_rate=fps,
            image=image, duration=args.duration,
            prompt=args.single_prompt, negative_prompt=args.neg_prompt,
            cfg_scale=args.guidance_scale, steps=args.num_inference_steps,
            sampler=args.sampler, batch_size=args.batch_size, seed=args.seed,
            force_offload=False,
            # --random_init smoke runs have no text encoder by construction
            allow_unconditioned=args.allow_unconditioned or bool(args.random_init),
            progress=args.progress)
        dt = time.perf_counter() - t0
        wf = np.asarray(audio_first["waveform"])[0]  # [C, T]
        write_wav(args.output, wf, audio_first["sample_rate"])
        logger.info(f"wrote {args.output}: {wf.shape[-1] / audio_first['sample_rate']:.2f}s "
                    f"audio in {dt:.2f}s wall")
        if args.merge_video and args.single_video:
            from foley_tpu_torch.io.audio import merge_audio_video

            # a frames directory muxes to an .avi without ffmpeg: the callee returns its path
            out_video = merge_audio_video(args.single_video, args.output,
                                          os.path.splitext(args.output)[0] + ".mp4",
                                          frames_fps=args.frames_fps, device=args.device)
            logger.info(f"muxed {out_video}")
        return 0
    except ImportError as e:
        print(f"missing dependency: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        if _looks_like_oom(e):
            print("hint: the models and their workspace exceeded the card's memory. fp32 "
                  "weights take twice bf16's: retry with --precision bf16, "
                  "--quantization int8 or int4, --blocks_to_swap N, or a shorter "
                  "--duration (past the config's cap, windows bound the memory).",
                  file=sys.stderr)
        return 1


def _looks_like_oom(e: Exception) -> bool:
    import torch

    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e).lower()


def _read_wav_mono(path: str):
    """48 kHz 16-bit WAV -> mono float32 [-1, 1] (stdlib reader; mixes channels down)."""
    import wave as wave_mod

    import numpy as np

    with wave_mod.open(path) as f:
        # ValueError, not assert (which python -O drops): a 24/8-bit or non-48 kHz WAV read
        # as '<i2' would decode to garbage and condition the request on noise
        if f.getframerate() != 48000:
            raise ValueError(f"input WAV must be 48 kHz, got {f.getframerate()} Hz")
        if f.getsampwidth() != 2:
            raise ValueError(f"input WAV must be 16-bit PCM, got {8 * f.getsampwidth()}-bit")
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2").astype(np.float32) / 32767.0
        return pcm.reshape(-1, f.getnchannels()).mean(axis=1)


def _bundle_and_text(args, foley_model, dependencies):
    """The ModelBundle and the (text, uncond) features the edit, continuation and stream
    routes take: CLAP's when it is loaded, zeros (with a warning) when not. ``--blocks_to_swap``
    splits the denoiser here, as the sampler node does on the T2A route."""
    import torch

    from foley_tpu_torch.parallel.offload import offload_block_suffix
    from foley_tpu_torch.pipeline.features import encode_text
    from foley_tpu_torch.pipeline.generate import ModelBundle

    cfg = foley_model["cfg"]
    if args.blocks_to_swap > 0:
        offload_block_suffix(foley_model["params"], args.blocks_to_swap)
    bundle = ModelBundle(foley_model["params"], dependencies["dac_params"], cfg,
                         compute_dtype=foley_model.get("dtype", torch.bfloat16),
                         latent_stats=foley_model.get("latent_stats"), progress=args.progress,
                         offload_prefetch=args.prefetch_blocks + 1)
    if "clap" in dependencies:
        text, uncond = encode_text(dependencies, args.single_prompt, args.neg_prompt)
    else:
        text = uncond = torch.zeros((1, cfg.model.text_length, cfg.model.condition_dim))
        logger.warning("CLAP unavailable; using zero text features")
    return bundle, text, uncond


def _edit_audio(args, foley_model, dependencies) -> int:
    """SDEdit-style re-prompting of an existing WAV (``pipeline/edit.py``)."""
    from foley_tpu_torch.io.audio import write_wav
    from foley_tpu_torch.pipeline.edit import edit_audio

    wav = _read_wav_mono(args.audio_input)
    bundle, text, uncond = _bundle_and_text(args, foley_model, dependencies)
    result = edit_audio(bundle, wav, text, uncond, strength=args.strength,
                        guidance_scale=args.guidance_scale,
                        num_inference_steps=args.num_inference_steps, sampler=args.sampler,
                        seed=args.seed)
    write_wav(args.output, result.audio_first[0], result.sample_rate)
    logger.info(f"edited {args.audio_input} -> {args.output} (strength {args.strength})")
    return 0


def _continue_audio(args, foley_model, dependencies) -> int:
    """Continue an existing WAV by --duration seconds (``pipeline/longform.py``)."""
    from foley_tpu_torch.io.audio import write_wav
    from foley_tpu_torch.pipeline.longform import continue_audio

    wav = _read_wav_mono(args.continue_audio)
    bundle, text, uncond = _bundle_and_text(args, foley_model, dependencies)
    result = continue_audio(bundle, wav, text, uncond, args.duration, context_s=args.context_s,
                            guidance_scale=args.guidance_scale,
                            num_inference_steps=args.num_inference_steps,
                            sampler=args.sampler, seed=args.seed, batch_size=args.batch_size)
    write_wav(args.output, result.audio_first[0], result.sample_rate)
    logger.info(f"continued {args.continue_audio} by {args.duration:.2f}s "
                f"(context {args.context_s}s) -> {args.output}")
    return 0


def _stream_pcm(args, foley_model, dependencies, out=None) -> int:
    """--stream_pcm: raw int16 mono PCM to stdout chunk by chunk as long-form windows
    finalize (the CLI analog of the server's ``response=pcm16_stream``). Logs go to stderr,
    so a pipe stays clean. T2A prompts, V2A (--single_video: the whole video's features,
    encoded once at ``plan_v2a_long``'s duration, each window taking its slice) and
    --continue_audio runs."""
    from foley_tpu_torch.pipeline.longform import (
        continue_audio_stream,
        default_window_s,
        generate_audio_long_stream,
    )

    # incompatible flags were refused in main() before any model load
    bundle, text, uncond = _bundle_and_text(args, foley_model, dependencies)
    common = dict(guidance_scale=args.guidance_scale,
                  num_inference_steps=args.num_inference_steps, sampler=args.sampler,
                  batch_size=args.batch_size, seed=args.seed,
                  window_s=default_window_s(bundle.pipeline_cfg),
                  first_window_s=args.first_window)
    if args.continue_audio:
        chunks = continue_audio_stream(bundle, _read_wav_mono(args.continue_audio), text,
                                       uncond, args.duration, context_s=args.context_s,
                                       **common)
    elif args.single_video:
        from foley_tpu_torch.pipeline.features import encode_video
        from foley_tpu_torch.pipeline.longform import plan_v2a_long
        from foley_tpu_torch.pipeline.video import read_video_frames

        frames, fps = read_video_frames(args.single_video, dir_fps=args.frames_fps,
                                        device=bundle.mmdit.device)
        logger.info(f"read {frames.shape[0]} frames @ {fps} fps")
        feat_dur, _, _ = plan_v2a_long(bundle.pipeline_cfg, args.duration,
                                       window_s=common["window_s"])
        clip_feat, sync_feat = encode_video(dependencies, frames, fps, feat_dur,
                                            bundle.pipeline_cfg)
        chunks = generate_audio_long_stream(bundle, text, uncond, args.duration,
                                            clip_feat=clip_feat, sync_feat=sync_feat, **common)
    else:
        chunks = generate_audio_long_stream(bundle, text, uncond, args.duration, **common)
    out = out if out is not None else sys.stdout.buffer
    t0 = time.perf_counter()
    total = 0
    for ch in chunks:
        if total == 0:
            logger.info(f"first audio after {time.perf_counter() - t0:.2f}s")
        out.write(ch.pcm16[0].tobytes())
        out.flush()
        total += ch.pcm16.shape[-1]
    logger.info(f"streamed {total / 48000:.2f}s of audio ({total} samples) in "
                f"{time.perf_counter() - t0:.2f}s wall")
    return 0


def _process_batch(args) -> int:
    """CSV batch mode: rows of ``video_path,prompt`` (the reference's ``cli.py:126-137``
    contract, run in this process). A row that fails is logged and the batch goes on; the
    batch returns 1 when any row failed."""
    import csv

    rows = []
    with open(args.csv_path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append((row[0].strip(), row[1].strip() if len(row) > 1 else ""))
    logger.info(f"batch: {len(rows)} rows from {args.csv_path}")
    failures = 0
    out_base, out_ext = os.path.splitext(args.output)
    for i, (video, prompt) in enumerate(rows):
        sub = argparse.Namespace(**vars(args))
        sub.csv_path = None
        sub.single_video = video or None
        sub.single_prompt = prompt
        sub.output = f"{out_base}_{i:03d}{out_ext}"
        rc = main_single(sub)
        if rc != 0:
            logger.warning(f"row {i} ({video!r}) failed with rc={rc}")
            failures += 1
    return 1 if failures else 0


def _desync_waveform(video: str, audio_input) -> "Optional[np.ndarray]":
    """The 16 kHz mono waveform ``--desync_score`` scores, by the JAX CLI's three routes in
    order: ``--audio_input`` (a WAV, resampled linearly), the PCM track of an MJPEG AVI, else
    ffmpeg's extraction at 16 kHz mono f32le (the JAX argv). None when ffmpeg is needed and
    missing."""
    import shutil
    import subprocess

    import numpy as np

    if audio_input:
        from foley_tpu_torch.io.audio import read_wav

        return read_wav(audio_input, target_sr=16000)[0]
    if not os.path.isdir(video):
        from foley_tpu_torch.io.avi import is_mjpeg_avi, read_avi_audio

        if is_mjpeg_avi(video):
            try:
                audio, sr = read_avi_audio(video)
            except ValueError:
                audio = None
            if audio is not None:
                from foley_tpu_torch.io.native import resample_linear

                return resample_linear(audio, sr, 16000) if sr != 16000 else audio
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return None
    raw = subprocess.run([ffmpeg, "-v", "quiet", "-i", video, "-ac", "1", "-ar", "16000",
                          "-f", "f32le", "pipe:1"], capture_output=True, check=True).stdout
    return np.frombuffer(raw, np.float32)


def _desync_score(args) -> int:
    """``--desync_score``: the predicted AV offset of ``--single_video``'s frames (25 fps)
    against its audio (``_desync_waveform``), from the Synchformer checkpoint under
    ``--model_path`` (``models/sync_scorer.py``, frames resized on the device)."""
    try:
        if not args.single_video:
            print("error: --desync_score requires --single_video", file=sys.stderr)
            return 2
        from foley_tpu_torch.core.device import resolve_device
        from foley_tpu_torch.models.sync_scorer import load_desync_scorer
        from foley_tpu_torch.pipeline.video import read_video_frames

        dev = resolve_device(args.device)
        scorer = load_desync_scorer(
            os.path.join(args.model_path or ".", "synchformer_state_dict.safetensors"),
            device=dev)
        frames, _ = read_video_frames(args.single_video, target_fps=25,
                                      dir_fps=args.frames_fps, device=dev)
        waveform = _desync_waveform(args.single_video, args.audio_input)
        if waveform is None:
            print("error: ffmpeg required for audio extraction "
                  "(or pass the audio as --audio_input x.wav)", file=sys.stderr)
            return 1
        offset = scorer.score(frames, waveform)
        print(f"predicted AV offset: {float(offset[0]):+.2f} s")
        return 0
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def main_single(args) -> int:
    """Run one generation with a pre-built namespace (the batch mode's rows)."""
    return main(_namespace_to_argv(args))


def _namespace_to_argv(ns) -> list:
    argv = []
    for key, value in vars(ns).items():
        # identity checks: `0 == False` in Python, so `value in (None, False)` would drop
        # explicit zero-valued flags (e.g. --seed 0) from the rows
        if value is None or value is False:
            continue
        flag = f"--{key}"
        if value is True:
            argv.append(flag)
        else:
            argv += [flag, str(value)]
    return argv


if __name__ == "__main__":
    sys.exit(main())
