"""Dense / conv primitives and the parameter modules that hold their weights
(``foley_tpu/ops/nn.py`` counterpart).

Sequences are channel-last ``[B, T, C]`` at every public function, as in the JAX package.
Weights use torch's layouts; ``io/from_jax.py`` converts the JAX ones:
- dense:            [out, in]        (JAX: [in, out])
- conv1d:           [out, in, K]     (JAX: [K, in, out])
- conv_transpose1d: [in, out, K]     (JAX: [K, in, out])

bf16, fp16 and fp32. fp32 means true fp32: ``true_fp32()`` turns TF32 off for matmuls and
cuDNN convolutions, whose default would otherwise run fp32 convs in TF32, and which a
caller's ``torch.set_float32_matmul_precision("high")`` would turn on for matmuls; every fp32
model of the port runs inside it (``exact_fp32``), as the JAX package runs every fp32
contraction at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from foley_tpu_torch.ops.norms import layer_norm


def _match(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cast a weight to the activation dtype (quantized storage is not ported yet)."""
    return w if w.dtype == x.dtype else w.to(x.dtype)


_fp32_lock = threading.Lock()
_fp32_depth = 0
_fp32_saved = (False, True)


@contextlib.contextmanager
def true_fp32():
    """Run fp32 matmuls and convolutions in full fp32 (no TF32) inside the block.

    The two TF32 flags are process-global, and the server's request threads enter this
    block concurrently: so the holders are counted under a lock, the flags are saved by the
    first to enter and restored by the last to leave. (Each thread saving and restoring its
    own copy would let two interleaved requests restore each other's saved state and leave
    TF32 on.)"""
    global _fp32_depth, _fp32_saved
    with _fp32_lock:
        if _fp32_depth == 0:
            _fp32_saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _fp32_depth += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = (
                    _fp32_saved)


def exact_fp32(dtype: torch.dtype):
    """``true_fp32()`` for fp32 work, no context for the 16-bit types (whose products no
    TF32 flag touches)."""
    return true_fp32() if dtype == torch.float32 else contextlib.nullcontext()


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] @ w[out, in]^T (+ b [out])."""
    return F.linear(x, _match(w, x), None if b is None else _match(b, x))


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """Channel-last 1-D convolution. x [B, T, Cin], w [Cout, Cin, K] -> [B, T', Cout]."""
    out = F.conv1d(x.transpose(1, 2), _match(w, x), None if b is None else _match(b, x),
                   stride=stride, padding=padding, dilation=dilation)
    return out.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     stride: int = 1, padding: int = 0, output_padding: int = 0,
                     dilation: int = 1) -> torch.Tensor:
    """Channel-last transposed 1-D convolution. x [B, T, Cin], w [Cin, Cout, K] ->
    [B, (T-1)*stride - 2*padding + dilation*(K-1) + output_padding + 1, Cout]."""
    out = F.conv_transpose1d(x.transpose(1, 2), _match(w, x),
                             None if b is None else _match(b, x), stride=stride,
                             padding=padding, output_padding=output_padding, dilation=dilation)
    return out.transpose(1, 2)


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Fold torch's ``weight_norm`` parametrization into a plain weight, w = g * v / ||v||,
    the norm over every axis but ``dim``, in fp32, returned in ``v``'s dtype (the DAC's
    WNConv layers, reference ``dac_vae/nn/layers.py:9-15``)."""
    axes = tuple(i for i in range(v.ndim) if i != dim)
    v32 = v.float()
    norm = v32.square().sum(dim=axes, keepdim=True).sqrt()
    return (g.float() * v32 / norm).to(v.dtype)


# ---------------------------------------------------------------------------------
# Parameter modules. Construction allocates without initializing; ``init_`` draws the
# JAX package's schemes (``foley_tpu/ops/nn.py::init_dense`` / ``init_conv1d``) from a
# torch generator, on whatever device the parameters live.
# ---------------------------------------------------------------------------------

def empty_parameter(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device), requires_grad=False)


class Dense(nn.Module):
    """``scheme``: ``torch`` (nn.Linear's Kaiming-uniform fan_in), ``zeros`` (adaLN and final
    layers), ``normal02`` (timestep MLP) or ``normal02_zero_bias`` (the vision encoders)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, scheme: str = "torch",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.scheme = scheme
        self.weight = empty_parameter(out_dim, in_dim, dtype=dtype, device=device)
        self.bias = empty_parameter(out_dim, dtype=dtype, device=device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        out_dim, in_dim = self.weight.shape
        limit = 1.0 / math.sqrt(in_dim)
        if self.scheme == "zeros":
            self.weight.zero_()
        elif self.scheme in ("normal02", "normal02_zero_bias"):
            self.weight.normal_(0.0, 0.02, generator=g)
        else:
            self.weight.uniform_(-limit, limit, generator=g)
        if self.bias is not None:
            if self.scheme in ("zeros", "normal02_zero_bias"):
                self.bias.zero_()
            else:
                self.bias.uniform_(-limit, limit, generator=g)


class Conv1d(nn.Module):
    """Channel-last conv; weight [out, in, K]; torch's default Kaiming-uniform init."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = empty_parameter(out_dim, in_dim, kernel_size, dtype=dtype, device=device)
        self.bias = empty_parameter(out_dim, dtype=dtype, device=device) if bias else None

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, **kw)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        _, cin, k = self.weight.shape
        limit = 1.0 / math.sqrt(cin * k)
        self.weight.uniform_(-limit, limit, generator=g)
        if self.bias is not None:
            self.bias.uniform_(-limit, limit, generator=g)


class LayerNorm(nn.Module):
    """Affine LayerNorm (``ops.norms.layer_norm``); weight ones and bias zeros at init."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.weight = empty_parameter(dim, dtype=dtype, device=device)
        self.bias = empty_parameter(dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


def init_parameters(module: nn.Module, g: torch.Generator) -> None:
    """Initialize every parameter module below ``module`` in registration order."""
    for m in module.modules():
        init = getattr(m, "init_", None)
        if init is not None:
            init(g)
