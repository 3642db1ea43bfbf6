"""The reference's ComfyUI nodes on the port (``foley_tpu/api/nodes.py`` counterpart).

The same public surface as the JAX package's nodes (INPUT_TYPES widget schemas,
RETURN_TYPES, FUNCTION, CATEGORY, NODE_CLASS_MAPPINGS), so a graph runtime drives either
package the same way. AUDIO values are plain dicts ``{"waveform": np.ndarray [B, C, T],
"sample_rate": int}``. FOLEY_MODEL is ``{"params": MMDiT, "cfg": PipelineConfig, "dtype":
torch.dtype}`` and FOLEY_DEPS holds the DAC as ``"dac_params"``: the JAX package's keys, with
modules where it holds parameter trees.

The loaders put the models on ``cuda`` unless given ``device``. Every precision the widgets
offer runs on the card: K1 (every attention of the denoiser) and K2 (SigLIP2's encoder) have
a kernel for each of bf16, fp16 (``csrc/fused_qk_attention.cu``, ``csrc/flash_attention.cu``)
and fp32 (``csrc/attention_f32.cu``, true fp32; the fp32 models run their products inside
``ops/nn.py::true_fp32``). On the CPU every precision runs through the plain versions.

Mapping of the JAX package's mechanisms:
- ``force_offload`` parks the denoiser in page-locked host memory after a run
  (``pipeline/manager.py::park``, the buffers allocated once) and the next run restores it;
- the compile config warms the declared buckets with one generation each (the port compiles
  nothing per shape; the first run of a bucket pays cuDNN's algorithm search, the
  allocator's growth and the kernels' build);
- quantization, LoRA and block swap raise (ROADMAP item 12), and so does the orbax
  directory route, which is JAX only.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from foley_tpu_torch.configs import PipelineConfig, get_config
from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.core.params import param_bytes, perturb_zero_leaves
from foley_tpu_torch.io.convert import (
    convert_dac_state_dict,
    convert_mmdit_state_dict,
    detect_ckpt_major_precision,
    infer_dac_config,
    load_torch_state_dict,
    module_from_state_dict,
    refuse_fp8,
)
from foley_tpu_torch.models import mmdit
from foley_tpu_torch.models.dac_vae import DAC
from foley_tpu_torch.pipeline import features
from foley_tpu_torch.pipeline.generate import (
    ModelBundle,
    generate_audio,
    select_audio_from_batch,
)
from foley_tpu_torch.pipeline.manager import module_device, park, restore

logger = logging.getLogger("foley_tpu_torch")

SOLVERS = ["euler", "heun-2", "midpoint-2", "kutta-4"]
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}
_ITEM12 = "not ported yet (ROADMAP item 12, the memory modes)"


def resolve_dtype(precision: str) -> torch.dtype:
    if precision not in DTYPES:
        raise ValueError(f"precision {precision!r}: expected one of {sorted(DTYPES)}")
    return DTYPES[precision]


class HunyuanModelLoader:
    """Loads the main MMDiT checkpoint (reference ``nodes.py:57-151``)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model_name": ("STRING", {"default": "hunyuanvideo_foley.safetensors"}),
                "precision": (["auto", "bf16", "fp16", "fp32"], {"default": "auto"}),
                "quantization": (["none", "auto", "fp8_e4m3fn", "fp8_e5m2", "int8",
                                  "int8_dynamic", "int4"], {"default": "none"}),
            },
            "optional": {
                "config": (["xxl", "xl", "tiny"], {"default": "xxl"}),
                "lora_path": ("STRING", {"default": ""}),
                "lora_scale": ("FLOAT", {"default": 1.0, "min": -4.0, "max": 4.0}),
            },
        }

    RETURN_TYPES = ("FOLEY_MODEL",)
    FUNCTION = "load_model"
    CATEGORY = "HunyuanVideoFoley-TPU"

    def load_model(self, model_name: str, precision: str = "auto",
                   quantization: str = "none", config: str = "xxl",
                   lora_path: str = "", lora_scale: float = 1.0,
                   device: DeviceLike = None):
        if quantization != "none":
            raise NotImplementedError(f"quantization={quantization!r}: {_ITEM12}")
        if lora_path:
            raise NotImplementedError(f"LoRA merge at load: {_ITEM12}")
        if os.path.isdir(model_name):
            raise NotImplementedError(
                f"{model_name} is a directory: the pre-converted orbax route is the JAX "
                "package's own; pass the reference .safetensors / .pth checkpoint")
        dev = resolve_device(device)
        cfg = get_config(config)
        if precision != "auto":  # a bad name raises before the minutes-long read
            resolve_dtype(precision)
        sd = load_torch_state_dict(model_name)
        refuse_fp8(sd, "HunyuanModelLoader")
        if precision == "auto":
            precision = detect_ckpt_major_precision(sd)
        dtype = resolve_dtype(precision)
        state = convert_mmdit_state_dict(sd, cfg.model, consume=True)
        model = module_from_state_dict(mmdit.MMDiT, state, cfg.model, dev, dtype)
        logger.info(f"MMDiT loaded: {param_bytes(model) / 2**30:.2f} GiB ({precision})")
        return ({"params": model, "cfg": cfg, "dtype": dtype},)

    @staticmethod
    def init_random(config: str = "tiny", precision: str = "bf16", seed: int = 0,
                    perturb: bool = False, device: DeviceLike = None):
        """A randomly initialized FOLEY_MODEL (tests and benchmarks, no checkpoint).
        ``perturb`` gives the zero-initialized leaves small random values, so the model
        emits a real velocity (``core/params.py::perturb_zero_leaves``)."""
        dev = resolve_device(device)
        cfg = get_config(config)
        dtype = resolve_dtype(precision)
        model = mmdit.init(cfg.model, torch.Generator(device=dev).manual_seed(int(seed)),
                           device=dev, dtype=dtype)
        if perturb:
            perturb_zero_leaves(model, torch.Generator(device=dev).manual_seed(int(seed) + 1))
        return {"params": model, "cfg": cfg, "dtype": dtype}


class HunyuanDependenciesLoader:
    """Loads DAC-VAE + Synchformer + SigLIP2 + CLAP (reference ``nodes.py:156-206``) from
    local paths; an empty path skips the encoder (the sampler then needs
    ``allow_unconditioned=True`` to run without text features). A missing Synchformer file
    disables the sync features with a warning, as in the JAX package; a given but broken
    SigLIP2 or CLAP path raises."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "vae_model": ("STRING", {"default": "vae_128d_48k.safetensors"}),
                "synchformer_model": ("STRING",
                                      {"default": "synchformer_state_dict.safetensors"}),
                "precision": (["fp32", "fp16", "bf16"], {"default": "bf16"}),
            },
            "optional": {
                "siglip2_model": ("STRING", {"default": ""}),
                "clap_model": ("STRING", {"default": ""}),
                "clap_tokenizer": ("STRING", {"default": ""}),
                "video_preprocess": (["device", "pil"], {
                    "default": "device",
                    "tooltip": "V2A frame resize on the card (the port's only route; PIL's "
                               "waits for ROADMAP item 13)"}),
            },
        }

    RETURN_TYPES = ("FOLEY_DEPS",)
    FUNCTION = "load_dependencies"
    CATEGORY = "HunyuanVideoFoley-TPU"

    def load_dependencies(self, vae_model: str, synchformer_model: Optional[str] = None,
                          precision: str = "bf16", siglip2_model: str = "",
                          clap_model: str = "", clap_tokenizer: str = "",
                          video_preprocess: str = "device", device: DeviceLike = None):
        from foley_tpu_torch.models import clap as clap_mod
        from foley_tpu_torch.models import siglip2 as siglip_mod
        from foley_tpu_torch.models import synchformer as sync_mod

        if video_preprocess != "device":
            raise NotImplementedError(
                f"video_preprocess={video_preprocess!r}: the PIL route needs PIL (ROADMAP "
                "item 13); the port resizes frames on the device")
        dev = resolve_device(device)
        dtype = resolve_dtype(precision)
        sd = load_torch_state_dict(vae_model)
        refuse_fp8(sd, "HunyuanDependenciesLoader")
        dac_cfg = infer_dac_config(sd)  # DACConfig() for vae_128d_48k
        dac = module_from_state_dict(DAC, convert_dac_state_dict(sd, dac_cfg, consume=True),
                                     dac_cfg, dev, torch.float32)
        deps: Dict[str, Any] = {"dac_params": dac, "dac_cfg": dac_cfg}
        if synchformer_model:
            try:
                deps["synchformer"] = sync_mod.load(synchformer_model, device=dev, dtype=dtype)
            except FileNotFoundError as e:
                logger.warning(f"Synchformer unavailable ({e}); V2A sync features disabled")
        if siglip2_model:
            deps["siglip2"] = siglip_mod.load(siglip2_model, device=dev, dtype=dtype)
            logger.info(f"SigLIP2 loaded from {siglip2_model}")
        if clap_model:
            deps["clap"] = clap_mod.load(clap_model, tokenizer_path=clap_tokenizer or None,
                                         device=dev)
            logger.info(f"CLAP loaded from {clap_model}")
        return (deps,)


class HunyuanCompileConfig:
    """The warm-up config, the torch.compile node's role (reference ``nodes.py:433-607``):
    the (duration, batch, text-bucket) buckets to run once before the first timed
    generation."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "durations": ("STRING", {"default": "5"}),
                "batch_sizes": ("STRING", {"default": "1"}),
                "text_buckets": ("STRING", {"default": "77"}),
            }
        }

    RETURN_TYPES = ("COMPILE_CFG",)
    FUNCTION = "make_config"
    CATEGORY = "HunyuanVideoFoley-TPU"

    def make_config(self, durations: str = "5", batch_sizes: str = "1",
                    text_buckets: str = "77"):
        def parse(s):
            return tuple(int(float(x)) for x in str(s).split(",") if str(x).strip())

        return ({"durations": parse(durations), "batch_sizes": parse(batch_sizes),
                 "text_buckets": parse(text_buckets)},)


class HunyuanBlockSwap:
    """Host-offload knobs (reference ``nodes.py:609-631``). The sampler refuses
    ``blocks_to_swap > 0``: block swap is ROADMAP item 12."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "blocks_to_swap": ("INT", {"default": 30, "min": 0, "max": 57}),
                "use_non_blocking": ("BOOLEAN", {"default": True}),
                "prefetch_blocks": ("INT", {"default": 0, "min": 0, "max": 57}),
                "block_swap_debug": ("BOOLEAN", {"default": False}),
            }
        }

    RETURN_TYPES = ("BLOCKSWAPARGS",)
    FUNCTION = "set_args"
    CATEGORY = "HunyuanVideoFoley-TPU"

    def set_args(self, blocks_to_swap=30, use_non_blocking=True, prefetch_blocks=0,
                 block_swap_debug=False):
        return ({"blocks_to_swap": blocks_to_swap, "use_non_blocking": use_non_blocking,
                 "prefetch_blocks": prefetch_blocks, "block_swap_debug": block_swap_debug},)


def _resident_params(foley_model: Dict) -> mmdit.MMDiT:
    """The denoiser, on its device: restored there first when the last run parked it
    (``force_offload``). Records the restore's seconds as ``_restore_s``."""
    model = foley_model["params"]
    if foley_model.get("_offloaded"):
        t0 = time.perf_counter()
        restore(model, foley_model["_device"])
        foley_model["_restore_s"] = time.perf_counter() - t0
        foley_model["_offloaded"] = False
    return model


def _offload(foley_model: Dict) -> None:
    """Park the denoiser in host memory until the next run (the reference moves its models
    back to the CPU after a run, ``nodes.py:407-415``), in buffers allocated at the first
    park. Records the park's seconds as ``_park_s``."""
    model = foley_model["params"]
    t0 = time.perf_counter()
    foley_model["_device"] = module_device(model)
    foley_model["_host"] = park(model, foley_model.get("_host"))
    foley_model["_park_s"] = time.perf_counter() - t0
    foley_model["_offloaded"] = True


class HunyuanFoleySampler:
    """The main generation node (reference ``nodes.py:211-427``)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "foley_model": ("FOLEY_MODEL",),
                "dependencies": ("FOLEY_DEPS",),
                "frame_rate": ("INT", {"default": 16, "min": 1, "max": 120}),
                # the reference caps at 60 s (nodes.py:219); longer runs go long-form
                "duration": ("FLOAT", {"default": 5.0, "min": 1.0, "max": 600.0}),
                "prompt": ("STRING", {"default": ""}),
                "negative_prompt": ("STRING", {"default": "noisy, harsh"}),
                "cfg_scale": ("FLOAT", {"default": 4.5, "min": 1.0, "max": 10.0}),
                "steps": ("INT", {"default": 50, "min": 10, "max": 100}),
                "sampler": (SOLVERS, {"default": "euler"}),
                "batch_size": ("INT", {"default": 1, "min": 1, "max": 6}),
                "seed": ("INT", {"default": 0, "min": 0, "max": 2**63 - 1}),
                "force_offload": ("BOOLEAN", {"default": True}),
            },
            "optional": {
                "image": ("IMAGE",),
                "torch_compile_cfg": ("COMPILE_CFG",),
                "block_swap_args": ("BLOCKSWAPARGS",),
                "allow_unconditioned": ("BOOLEAN", {"default": False}),
                "progress": ("BOOLEAN", {"default": False}),
            },
        }

    RETURN_TYPES = ("AUDIO", "AUDIO")
    RETURN_NAMES = ("audio_first", "audio_batch")
    FUNCTION = "generate_audio"
    CATEGORY = "HunyuanVideoFoley-TPU"

    def generate_audio(self, foley_model: Dict, dependencies: Dict, frame_rate: int = 16,
                       duration: float = 5.0, prompt: str = "",
                       negative_prompt: str = "noisy, harsh", cfg_scale: float = 4.5,
                       steps: int = 50, sampler: str = "euler", batch_size: int = 1,
                       seed: int = 0, force_offload: bool = True,
                       image: Optional[np.ndarray] = None,
                       torch_compile_cfg: Optional[Dict] = None,
                       block_swap_args: Optional[Dict] = None,
                       allow_unconditioned: bool = False, progress: bool = False):
        if block_swap_args and block_swap_args.get("blocks_to_swap", 0) > 0:
            raise NotImplementedError(f"block swap (blocks_to_swap > 0): {_ITEM12}")
        model = _resident_params(foley_model)
        cfg: PipelineConfig = foley_model["cfg"]

        # phase 1: features
        text_feat, uncond_text_feat = self._encode_text(dependencies, prompt, negative_prompt,
                                                        cfg, allow_unconditioned)
        clip_feat = sync_feat = None
        if image is not None:
            encode_duration = duration
            if duration > cfg.max_duration_s:
                # long-form V2A: the windows slice the whole video's features, encoded at
                # the plan's snapped duration (pipeline/longform.py)
                from foley_tpu_torch.pipeline.longform import default_window_s, plan_v2a_long

                encode_duration, _, _ = plan_v2a_long(cfg, duration,
                                                      window_s=default_window_s(cfg))
            clip_feat, sync_feat = self._encode_video(dependencies, image, frame_rate,
                                                      encode_duration, cfg)

        bundle = ModelBundle(model, dependencies["dac_params"], cfg, encoders=dependencies,
                             compute_dtype=foley_model.get("dtype", torch.bfloat16),
                             latent_stats=foley_model.get("latent_stats"), progress=progress)
        if torch_compile_cfg:
            self._warmup_compile(foley_model, bundle, torch_compile_cfg, cfg_scale, steps,
                                 sampler)

        # phase 2: denoise + decode
        result = self._generate(bundle, text_feat, uncond_text_feat, duration, clip_feat,
                                sync_feat, cfg_scale, steps, sampler, batch_size, seed)
        if force_offload:
            _offload(foley_model)
        sr = result.sample_rate
        return ({"waveform": result.audio_first, "sample_rate": sr},
                {"waveform": result.audio_batch, "sample_rate": sr})

    @staticmethod
    def _generate(bundle, text_feat, uncond_text_feat, duration, clip_feat, sync_feat,
                  cfg_scale, steps, sampler, batch_size, seed):
        cfg = bundle.pipeline_cfg
        if duration > cfg.max_duration_s:
            # past the reference's 60 s cap: windowed flow-match inpainting, memory bounded
            # by the window (V2A windows slice the features encoded above)
            from foley_tpu_torch.pipeline.longform import default_window_s, generate_audio_long

            return generate_audio_long(
                bundle, text_feat, uncond_text_feat, duration, clip_feat=clip_feat,
                sync_feat=sync_feat, window_s=default_window_s(cfg),
                guidance_scale=cfg_scale, num_inference_steps=steps, sampler=sampler,
                batch_size=batch_size, seed=seed)
        return generate_audio(bundle, text_feat, uncond_text_feat, duration,
                              clip_feat=clip_feat, sync_feat=sync_feat,
                              guidance_scale=cfg_scale, num_inference_steps=steps,
                              sampler=sampler, batch_size=batch_size, seed=seed)

    @staticmethod
    def _warmup_compile(foley_model: Dict, bundle: ModelBundle, compile_cfg: Dict,
                        cfg_scale: float, steps: int, sampler: str) -> None:
        """Run each declared (duration, batch, text-bucket) bucket once before the timed
        generation. The warmed keys are remembered on the model dict, so later calls skip
        them."""
        warmed = foley_model.setdefault("_warm_buckets", set())
        dim = bundle.pipeline_cfg.model.condition_dim
        use_cfg = cfg_scale > 1.0
        for d in compile_cfg.get("durations", (5,)):
            for b in compile_cfg.get("batch_sizes", (1,)):
                for tb in compile_cfg.get("text_buckets", (77,)):
                    key = (float(d), int(b), int(tb), int(steps), sampler, use_cfg)
                    if key in warmed:
                        continue
                    t0 = time.perf_counter()
                    z = torch.zeros((1, int(tb), dim))
                    generate_audio(bundle, z, z, float(d), guidance_scale=cfg_scale,
                                   num_inference_steps=steps, sampler=sampler,
                                   batch_size=int(b), seed=0, text_bucket=int(tb))
                    logger.info(f"warm-up: duration={d}s batch={b} text_bucket={tb} "
                                f"steps={steps} sampler={sampler} in "
                                f"{time.perf_counter() - t0:.1f}s")
                    warmed.add(key)

    @staticmethod
    def _encode_text(deps: Dict, prompt: str, negative_prompt: str, cfg: PipelineConfig,
                     allow_unconditioned: bool = False):
        if "clap" in deps:
            return features.encode_text(deps, prompt, negative_prompt)
        # without a text encoder, zero text features are opt-in: running unconditioned
        # silently would degrade the default graph against the reference, which always
        # loads CLAP (nodes.py:200-201)
        if not allow_unconditioned:
            raise ValueError(
                "No CLAP text encoder in dependencies: pass clap_model/clap_tokenizer to "
                "HunyuanDependenciesLoader, or set allow_unconditioned=True to generate "
                "with zero text features.")
        z = torch.zeros((1, cfg.model.text_length, cfg.model.condition_dim))
        logger.warning("CLAP unavailable; using zero text features (allow_unconditioned)")
        return z, z

    @staticmethod
    def _encode_video(deps: Dict, image: np.ndarray, frame_rate: float, duration: float,
                      cfg: PipelineConfig):
        """[T, H, W, C] frames in [0, 1] -> (clip_feat, sync_feat) through the loaded visual
        encoders (``pipeline/features.py::encode_video``, the device route)."""
        return features.encode_video(deps, np.asarray(image), frame_rate, duration, cfg)


class HunyuanFoleyContinuation:
    """Continue an AUDIO by ``duration`` seconds toward the prompt: the DAC-encoded tail of
    the input is window 0's known prefix (``pipeline/longform.py::continue_audio``).
    Outputs the new audio only."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "foley_model": ("FOLEY_MODEL",),
                "dependencies": ("FOLEY_DEPS",),
                "audio": ("AUDIO",),
                "duration": ("FLOAT", {"default": 5.0, "min": 1.0, "max": 600.0,
                                       "tooltip": "seconds of NEW audio to generate"}),
                "prompt": ("STRING", {"default": ""}),
                "negative_prompt": ("STRING", {"default": "noisy, harsh"}),
                "context_s": ("FLOAT", {"default": 4.0, "min": 0.1, "max": 29.0,
                                        "tooltip": "seconds of the source's tail to "
                                                   "condition on (must fit the window)"}),
                "cfg_scale": ("FLOAT", {"default": 4.5, "min": 1.0, "max": 10.0}),
                "steps": ("INT", {"default": 50, "min": 10, "max": 100}),
                "sampler": (SOLVERS, {"default": "euler"}),
                "batch_size": ("INT", {"default": 1, "min": 1, "max": 6}),
                "seed": ("INT", {"default": 0, "min": 0, "max": 2**63 - 1}),
                "force_offload": ("BOOLEAN", {"default": True}),
            },
            "optional": {
                "allow_unconditioned": ("BOOLEAN", {"default": False}),
            },
        }

    RETURN_TYPES = ("AUDIO", "AUDIO")
    RETURN_NAMES = ("audio_first", "audio_batch")
    FUNCTION = "continue_audio"
    CATEGORY = "HunyuanVideoFoley-TPU"

    def continue_audio(self, foley_model: Dict, dependencies: Dict, audio: Dict,
                       duration: float = 5.0, prompt: str = "",
                       negative_prompt: str = "noisy, harsh", context_s: float = 4.0,
                       cfg_scale: float = 4.5, steps: int = 50, sampler: str = "euler",
                       batch_size: int = 1, seed: int = 0, force_offload: bool = True,
                       allow_unconditioned: bool = False):
        from foley_tpu_torch.pipeline.longform import continue_audio as continue_fn

        model = _resident_params(foley_model)
        cfg: PipelineConfig = foley_model["cfg"]
        sr = int(audio["sample_rate"])
        if sr != cfg.dac.sample_rate:
            raise ValueError(f"continuation input must be {cfg.dac.sample_rate} Hz (got {sr}); "
                             "resample first")
        wav = np.asarray(audio["waveform"], np.float32)
        if wav.ndim != 3:
            raise ValueError(f"AUDIO waveform must be [B, C, T], got {wav.shape}")
        mono = wav.mean(axis=1)[:1]  # first batch row, mono mixdown
        text_feat, uncond_text_feat = HunyuanFoleySampler._encode_text(
            dependencies, prompt, negative_prompt, cfg, allow_unconditioned)
        bundle = ModelBundle(model, dependencies["dac_params"], cfg, encoders=dependencies,
                             compute_dtype=foley_model.get("dtype", torch.bfloat16),
                             latent_stats=foley_model.get("latent_stats"))
        result = continue_fn(bundle, mono, text_feat, uncond_text_feat, duration,
                             context_s=context_s, guidance_scale=cfg_scale,
                             num_inference_steps=steps, sampler=sampler, batch_size=batch_size,
                             seed=seed)
        if force_offload:
            _offload(foley_model)
        return ({"waveform": result.audio_first, "sample_rate": result.sample_rate},
                {"waveform": result.audio_batch, "sample_rate": result.sample_rate})


class SelectAudioFromBatch:
    """Pick one AUDIO from a batch, clamping an index out of range (reference
    ``nodes.py:636-663``)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio_batch": ("AUDIO",),
                             "index": ("INT", {"default": 0, "min": 0, "max": 5})}}

    RETURN_TYPES = ("AUDIO",)
    FUNCTION = "select_audio"
    CATEGORY = "HunyuanVideoFoley-TPU"

    def select_audio(self, audio_batch: Dict, index: int = 0):
        wf = np.asarray(audio_batch["waveform"])
        return ({"waveform": select_audio_from_batch(wf, index),
                 "sample_rate": audio_batch["sample_rate"]},)


NODE_CLASS_MAPPINGS = {
    "HunyuanModelLoader": HunyuanModelLoader,
    "HunyuanDependenciesLoader": HunyuanDependenciesLoader,
    "HunyuanFoleySampler": HunyuanFoleySampler,
    "HunyuanFoleyTorchCompile": HunyuanCompileConfig,
    "HunyuanBlockSwap": HunyuanBlockSwap,
    "HunyuanFoleyContinuation": HunyuanFoleyContinuation,
    "SelectAudioFromBatch": SelectAudioFromBatch,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "HunyuanModelLoader": "Hunyuan Foley Model Loader (H100)",
    "HunyuanDependenciesLoader": "Hunyuan Foley Dependencies Loader (H100)",
    "HunyuanFoleySampler": "Hunyuan Foley Sampler (H100)",
    "HunyuanFoleyTorchCompile": "Hunyuan Foley Warm-up (H100)",
    "HunyuanBlockSwap": "Hunyuan Foley Block Swap (H100)",
    "HunyuanFoleyContinuation": "Hunyuan Foley Audio Continuation (H100)",
    "SelectAudioFromBatch": "Select Audio From Batch",
}
