"""The ComfyUI node pack on the port (``comfyui_adapter/__init__.py`` counterpart): a drop-in
replacement for the reference node pack that runs on the card.

Link this directory into ComfyUI's ``custom_nodes/`` with the repository root on the
``PYTHONPATH``::

    ln -s /path/to/repo/foley_tpu_torch/comfyui ComfyUI/custom_nodes/foley_tpu_torch
    PYTHONPATH=/path/to/repo python ComfyUI/main.py

It exposes the reference's node class names (``nodes.py:668-683`` NODE_CLASS_MAPPINGS), so
existing workflow JSONs load unchanged. It converts ComfyUI's torch tensors at the boundary
(IMAGE [B, H, W, C] float in [0, 1] -> numpy frames; the nodes' numpy AUDIO waveform ->
torch) and resolves checkpoint names through ComfyUI's ``folder_paths`` (with the
``models/foley/`` registration the reference adds at ``nodes.py:25-27``) when it is there.
It imports nothing of the JAX package or its adapter.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from foley_tpu_torch.api import nodes as _nodes


def _resolve_model_path(name: str) -> str:
    """A checkpoint name through ComfyUI's ``folder_paths`` when it is there, else as given."""
    try:
        import folder_paths  # the ComfyUI runtime
    except ImportError:
        return name
    foley_dir = os.path.join(folder_paths.models_dir, "foley")
    if "foley" not in folder_paths.folder_names_and_paths:
        folder_paths.folder_names_and_paths["foley"] = (
            [foley_dir], folder_paths.supported_pt_extensions)
    return folder_paths.get_full_path("foley", name) or name


def _image_to_numpy(image):
    """ComfyUI IMAGE (torch [B, H, W, C] float in [0, 1]) -> numpy [T, H, W, C]."""
    if image is None:
        return None
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().float().numpy()
    return np.asarray(image, np.float32)


def _audio_to_numpy(audio: dict) -> dict:
    """ComfyUI AUDIO (torch waveform [B, C, T]) -> the nodes' AUDIO (numpy waveform)."""
    wf = audio["waveform"]
    if isinstance(wf, torch.Tensor):
        return {"waveform": wf.detach().cpu().float().numpy(),
                "sample_rate": audio["sample_rate"]}
    return audio


def _audio_to_torch(audio: dict) -> dict:
    """The nodes' AUDIO (numpy waveform [B, C, T]) -> ComfyUI AUDIO (torch waveform)."""
    return {"waveform": torch.from_numpy(np.array(audio["waveform"], copy=True)),
            "sample_rate": audio["sample_rate"]}


class HunyuanModelLoader(_nodes.HunyuanModelLoader):
    def load_model(self, model_name, precision="auto", quantization="none", config="xxl",
                   lora_path="", lora_scale=1.0, device=None):
        return super().load_model(_resolve_model_path(model_name), precision, quantization,
                                  config, lora_path=lora_path, lora_scale=lora_scale,
                                  device=device)


class HunyuanDependenciesLoader(_nodes.HunyuanDependenciesLoader):
    def load_dependencies(self, vae_model, synchformer_model=None, precision="fp16",
                          siglip2_model="", clap_model="", clap_tokenizer="",
                          video_preprocess="device", device=None):
        return super().load_dependencies(
            _resolve_model_path(vae_model),
            _resolve_model_path(synchformer_model) if synchformer_model else None,
            precision,
            siglip2_model=_resolve_model_path(siglip2_model) if siglip2_model else "",
            clap_model=_resolve_model_path(clap_model) if clap_model else "",
            clap_tokenizer=_resolve_model_path(clap_tokenizer) if clap_tokenizer else "",
            video_preprocess=video_preprocess, device=device)


class HunyuanFoleySampler(_nodes.HunyuanFoleySampler):
    def generate_audio(self, *args, image=None, **kwargs):
        first, batch = super().generate_audio(*args, image=_image_to_numpy(image), **kwargs)
        return _audio_to_torch(first), _audio_to_torch(batch)


class HunyuanFoleyContinuation(_nodes.HunyuanFoleyContinuation):
    def continue_audio(self, foley_model, dependencies, audio, **kwargs):
        first, batch = super().continue_audio(foley_model, dependencies,
                                              _audio_to_numpy(audio), **kwargs)
        return _audio_to_torch(first), _audio_to_torch(batch)


class SelectAudioFromBatch(_nodes.SelectAudioFromBatch):
    def select_audio(self, audio_batch, index=0):
        (out,) = super().select_audio(_audio_to_numpy(audio_batch), index)
        return (_audio_to_torch(out),)


NODE_CLASS_MAPPINGS = {
    "HunyuanModelLoader": HunyuanModelLoader,
    "HunyuanDependenciesLoader": HunyuanDependenciesLoader,
    "HunyuanFoleySampler": HunyuanFoleySampler,
    "HunyuanFoleyTorchCompile": _nodes.HunyuanCompileConfig,
    "HunyuanBlockSwap": _nodes.HunyuanBlockSwap,
    "HunyuanFoleyContinuation": HunyuanFoleyContinuation,
    "SelectAudioFromBatch": SelectAudioFromBatch,
}

NODE_DISPLAY_NAME_MAPPINGS = dict(_nodes.NODE_DISPLAY_NAME_MAPPINGS)

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
