"""foley-tpu-torch: the PyTorch / CUDA port of ``foley_tpu`` for one NVIDIA H100.

The JAX package ``foley_tpu`` stays the reference; this package keeps its names and module
layout (``configs``, ``models.mmdit``, ``sampling.denoise``, ``pipeline.generate``, ...) so
each function has an obvious counterpart. It imports ``torch``, numpy and the standard
library only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; without a card and
without a device they raise. Every TPU kernel of the JAX package has a hand-written Hopper
counterpart under ``csrc/`` (built with ``nvcc`` at first use, ``ops/kernels/build.py``):
the fused qk-norm + RoPE attention (``ops/kernels/fused_attention.py``) and the flash
attention (``ops/kernels/flash_attention.py``), each in bf16, fp16 and fp32, and the GEMM
sweep probe's kernel (``ops/kernels/gemm_sweep.py``).

The public surface mirrors the JAX package's lazy exports (the reference's re-exports,
``hunyuanvideo_foley/__init__.py:15-18``): ``load_model`` / ``feature_process`` /
``denoise_process`` (``pipeline/standalone.py``), ``AttributeDict``
(``utils/config_utils.py``) and the nodes' ``NODE_CLASS_MAPPINGS`` /
``NODE_DISPLAY_NAME_MAPPINGS``. ``merge_audio_video`` (``io/audio.py``) raises: muxing needs
ffmpeg (ROADMAP item 13). The command line is ``python -m foley_tpu_torch.cli``; the ComfyUI
node pack is ``foley_tpu_torch/comfyui``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy exports: ``import foley_tpu_torch`` imports no model code.
    if name in ("load_model", "denoise_process", "feature_process"):
        from foley_tpu_torch.pipeline import standalone

        return getattr(standalone, name)
    if name == "merge_audio_video":
        from foley_tpu_torch.io.audio import merge_audio_video

        return merge_audio_video
    if name == "AttributeDict":
        from foley_tpu_torch.utils.config_utils import AttributeDict

        return AttributeDict
    if name in ("NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"):
        from foley_tpu_torch.api import nodes

        return getattr(nodes, name)
    raise AttributeError(f"module 'foley_tpu_torch' has no attribute {name!r}")


__all__ = [
    "__version__",
    "load_model",
    "denoise_process",
    "feature_process",
    "merge_audio_video",
    "AttributeDict",
    "NODE_CLASS_MAPPINGS",
    "NODE_DISPLAY_NAME_MAPPINGS",
]
