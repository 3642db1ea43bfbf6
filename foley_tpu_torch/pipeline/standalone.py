"""The standalone library surface's ``load_model`` (``foley_tpu/pipeline/standalone.py``
counterpart): the five models of a checkpoint directory behind the lazy
``OffloadModelManager``, the server's checkpoint route. ``feature_process`` and
``denoise_process`` are not ported yet (ROADMAP item 11, with the CLI).
"""

from __future__ import annotations

import os

from foley_tpu_torch.configs import get_config
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
    access. The visual encoders run in ``encoder_precision``."""
    from foley_tpu_torch.api.nodes import check_card_precision, resolve_dtype

    dev = resolve_device(device)
    cfg = get_config(config)
    enc_dtype = resolve_dtype(encoder_precision)
    check_card_precision(dev, enc_dtype, "visual encoders")
    if precision != "auto":
        check_card_precision(dev, resolve_dtype(precision), "denoiser")
    manager = OffloadModelManager(policy="host" if enable_offload else "drop")
    manager.pipeline_cfg = cfg  # type: ignore[attr-defined]

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
