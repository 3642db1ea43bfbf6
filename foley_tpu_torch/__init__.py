"""foley-tpu-torch: the PyTorch / CUDA port of ``foley_tpu`` for one NVIDIA H100.

The JAX package ``foley_tpu`` stays the reference; this package keeps its names and module
layout (``configs``, ``models.mmdit``, ``sampling.denoise``, ``pipeline.generate``, ...) so
each function has an obvious counterpart. It imports ``torch``, numpy and the standard
library only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; without a card and
without a device they raise. The one hand-written kernel so far is the fused qk-norm + RoPE
attention (``ops/kernels/fused_attention.py``, source ``csrc/fused_qk_attention.cu``), which
is built with ``nvcc`` at first use.
"""
