"""The standalone library surface (``foley_tpu/pipeline/standalone.py`` counterpart): the
reference's ``load_model`` / ``feature_process`` / ``denoise_process`` (reference
``model_utils.py:17-487``, ``feature_utils.py:20-164``). ``load_model`` puts the five models
of a checkpoint directory behind the lazy ``OffloadModelManager`` (the server's checkpoint
route too); the other two run a text-to-audio or, from ``feature_process``'s
``video_path`` (a video file through ffmpeg or a directory of PNG frames,
``pipeline/video.py``), a video-to-audio request on them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from foley_tpu_torch.configs import PipelineConfig, get_config
from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.pipeline.manager import OffloadModelManager

_CKPT_FILES = {
    "foley": ("hunyuanvideo_foley.safetensors", "hunyuanvideo_foley.pth"),
    "dac": ("vae_128d_48k.safetensors", "vae_128d_48k.pth"),
    "synchformer": ("synchformer_state_dict.safetensors", "synchformer_state_dict.pth"),
}


def _find(model_path: str, names) -> str:
    for n in names:
        p = os.path.join(model_path, n)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"None of {names} under {model_path}")


def load_model(model_path: str, config: str = "xxl", precision: str = "auto",
               quantization: str = "none", enable_offload: bool = True, lora_path: str = "",
               lora_scale: float = 1.0, device: DeviceLike = None,
               encoder_precision: str = "bf16") -> OffloadModelManager:
    """The lazily loaded five-model dict of ``model_path`` (reference
    ``model_utils.load_model``): ``foley`` (a FOLEY_MODEL), ``dac`` (``{"params": DAC,
    "cfg": DACConfig}``), ``synchformer``, ``clap`` (``<model_path>/clap``) and ``siglip2``
    (``<model_path>/siglip2``), each on ``device`` (``cuda`` unless given) at its first
    access. The visual encoders run in ``encoder_precision``; ``quantization``,
    ``lora_path`` and ``lora_scale`` are the model loader's (``io/quantize.py`` modes,
    ``auto`` the checkpoint's fp8 type; an adapter directory of ``models/lora.py``)."""
    from foley_tpu_torch.api.nodes import resolve_dtype

    dev = resolve_device(device)
    cfg = get_config(config)
    enc_dtype = resolve_dtype(encoder_precision)
    if precision != "auto":  # a bad name raises now, not at the first access
        resolve_dtype(precision)
    manager = OffloadModelManager(policy="host" if enable_offload else "drop")
    manager.pipeline_cfg = cfg  # type: ignore[attr-defined]
    manager.device = dev  # type: ignore[attr-defined]  (frame directories unfilter there)

    def load_foley():
        from foley_tpu_torch.api.nodes import HunyuanModelLoader

        (fm,) = HunyuanModelLoader().load_model(
            _find(model_path, _CKPT_FILES["foley"]), precision, quantization, config,
            lora_path=lora_path, lora_scale=lora_scale, device=dev)
        return fm

    def load_dac():
        from foley_tpu_torch.io.convert import (
            convert_dac_state_dict,
            load_torch_state_dict,
            module_from_state_dict,
        )
        from foley_tpu_torch.models.dac_vae import DAC

        sd = load_torch_state_dict(_find(model_path, _CKPT_FILES["dac"]))
        state = convert_dac_state_dict(sd, cfg.dac, consume=True)
        return {"params": module_from_state_dict(DAC, state, cfg.dac, dev), "cfg": cfg.dac}

    def load_synchformer():
        from foley_tpu_torch.models import synchformer

        return synchformer.load(_find(model_path, _CKPT_FILES["synchformer"]), device=dev,
                                dtype=enc_dtype)

    def load_clap():
        from foley_tpu_torch.models import clap

        return clap.load(os.path.join(model_path, "clap"), device=dev)

    def load_siglip2():
        from foley_tpu_torch.models import siglip2

        return siglip2.load(os.path.join(model_path, "siglip2"), device=dev, dtype=enc_dtype)

    manager.register("foley", load_foley)
    manager.register("dac", load_dac)
    manager.register("synchformer", load_synchformer)
    manager.register("clap", load_clap)
    manager.register("siglip2", load_siglip2)
    return manager


def feature_process(video_path: Optional[str], prompt: str, model_dict: OffloadModelManager,
                    neg_prompt: str = "noisy, harsh",
                    duration_s: Optional[float] = None) -> Tuple[Dict, Dict, float]:
    """Conditioning features (reference ``feature_utils.feature_process``): returns
    (visual_feats, text_feats, audio_len_in_s). ``video_path`` (a video file or a directory
    of PNG frames at 16 fps) gives SigLIP2's and Synchformer's features (the JAX package's
    ``encode_frames`` and ``encode_segments``, on the encoders' ``preprocess`` routes) and an audio length of
    the 25 fps stream's; ``video_path=None`` is the T2A path, whose empty learned visual
    sequences the denoise substitutes, of ``duration_s`` (5 s unless given). The text
    features are CLAP's ``[neg_prompt, prompt]`` rows."""
    cfg: PipelineConfig = model_dict.pipeline_cfg  # type: ignore[attr-defined]
    visual_feats: Dict = {}
    if video_path is not None:
        from foley_tpu_torch.models import synchformer
        from foley_tpu_torch.pipeline.features import resample_frames
        from foley_tpu_torch.pipeline.video import read_video_frames

        frames, fps = read_video_frames(video_path,
                                        device=getattr(model_dict, "device", None))
        audio_len = duration_s or frames.shape[0] / fps
        f8 = resample_frames(frames, fps, audio_len, cfg.siglip2_fps)
        f25 = resample_frames(frames, fps, audio_len, cfg.synchformer_fps)
        visual_feats["siglip2_feat"] = model_dict.siglip2.encode(f8)
        visual_feats["syncformer_feat"] = synchformer.encode_segments(model_dict.synchformer,
                                                                      f25)
        audio_len = f25.shape[0] / cfg.synchformer_fps  # reference utils.py:281
    else:
        audio_len = duration_s or 5.0
    from foley_tpu_torch.models import clap as clap_mod

    text = clap_mod.encode_text(model_dict.clap, [neg_prompt, prompt])
    text_feats = {"text_feat": text[1:2], "uncond_text_feat": text[0:1]}
    return visual_feats, text_feats, audio_len


def denoise_process(visual_feats: Dict, text_feats: Dict, audio_len_in_s: float,
                    model_dict: OffloadModelManager, guidance_scale: float = 4.5,
                    num_inference_steps: int = 50, batch_size: int = 1, sampler: str = "euler",
                    seed: int = 0) -> Tuple[np.ndarray, int]:
    """CFG denoise and decode (reference ``denoise_process``): returns (audio [B, C, T],
    sample rate)."""
    from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio

    foley = model_dict.foley
    cfg: PipelineConfig = model_dict.pipeline_cfg  # type: ignore[attr-defined]
    bundle = ModelBundle(foley["params"], model_dict.dac["params"], cfg,
                         compute_dtype=foley["dtype"])
    result = generate_audio(bundle, text_feats["text_feat"], text_feats["uncond_text_feat"],
                            audio_len_in_s, clip_feat=visual_feats.get("siglip2_feat"),
                            sync_feat=visual_feats.get("syncformer_feat"),
                            guidance_scale=guidance_scale,
                            num_inference_steps=num_inference_steps, sampler=sampler,
                            batch_size=batch_size, seed=seed)
    return result.audio_batch, result.sample_rate
