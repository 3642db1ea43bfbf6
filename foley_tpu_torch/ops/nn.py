"""Dense / conv primitives and the parameter modules that hold their weights
(``foley_tpu/ops/nn.py`` counterpart).

Sequences are channel-last ``[B, T, C]`` at every public function, as in the JAX package.
Weights use torch's layouts; ``io/from_jax.py`` converts the JAX ones:
- dense:            [out, in]        (JAX: [in, out])
- conv1d:           [out, in, K]     (JAX: [K, in, out])
- conv_transpose1d: [in, out, K]     (JAX: [K, in, out])
- conv2d:           [out, in, Kh, Kw] (JAX: [Kh, Kw, in, out])

A ``Dense`` or ``Conv1d`` weight may be held in quantized storage (``io/quantize.py``): fp8
in the ``weight`` parameter itself, or codes and scales in the buffers ``weight_<kind>`` and
``weight_scale`` (``QuantizedWeight``). Every op dequantizes at use, in the activation dtype,
in the JAX package's order (``_match``); a dense of an ``int8_dyn`` weight runs an exact
int8 x int8 -> int32 product instead (``dense``).

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
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from foley_tpu_torch.ops.norms import layer_norm


QUANT_KINDS = ("int8", "int8_dyn", "int4")


class QuantizedWeight(NamedTuple):
    """A weight in integer storage (``io/quantize.py``), the JAX package's ``{kind, "scale"}``
    leaf in the port's layouts:

    - ``int8`` / ``int8_dyn``: ``q`` int8 codes in the weight's layout, ``scale`` fp32 per
      output channel: ``[out, 1]`` (dense), ``[out, 1, 1]`` (a block's conv) or
      ``[out, 1, K]`` (a conv outside the blocks, one scale per tap);
    - ``int4``: ``q`` uint8 ``[out, in/2(, K)]``, split-half along the input axis (byte i
      holds input row i in its low nibble and row i + in/2 in its high one, each biased by
      +8), ``scale`` fp32 ``[out, n_groups, 1(, K)]`` over groups of input rows."""

    kind: str
    q: torch.Tensor
    scale: torch.Tensor


def _match(w, x: torch.Tensor) -> torch.Tensor:
    """The weight in the activation dtype: a cast, or the dequant of integer storage in the
    JAX package's order (``foley_tpu/ops/nn.py::_match``): the codes and the scale each cast
    to ``x.dtype``, then multiplied (int4: unpacked by shift and mask, the halves
    concatenated, then grouped). fp8 casts exactly to bf16, fp16 and fp32."""
    if isinstance(w, QuantizedWeight):
        if w.kind == "int4":
            lo = (w.q & 0xF).to(torch.int8) - 8  # input rows [0, in/2)
            hi = (w.q >> 4).to(torch.int8) - 8   # input rows [in/2, in)
            q = torch.cat([lo, hi], dim=1).to(x.dtype)
            grouped = q.unflatten(1, (w.scale.shape[1], -1)) * w.scale.to(x.dtype)
            return grouped.flatten(1, 2)
        return w.q.to(x.dtype) * w.scale.to(x.dtype)
    return w if w.dtype == x.dtype else w.to(x.dtype)


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, correctly rounded on every device. On CUDA, ``x / 127.0`` multiplies by a
    rounded reciprocal (a Python number is a CPU scalar, which the division kernel inverts
    once), one place off the CPU's and the JAX package's quotient; a divisor on the tensor's
    own device takes the true division."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def quantize_act(x: torch.Tensor):
    """Per-token symmetric int8 quantization (``foley_tpu/ops/nn.py::_quantize_act``):
    (codes int8 [..., in], scale fp32 [..., 1])."""
    xf = x.float()
    s = torch.clamp_min(divide(xf.abs().amax(dim=-1, keepdim=True), 127.0), 1e-12)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 ``a [M, K] @ w[N, K]^T`` -> int32 ``[M, N]`` through ``torch._int_mm``.

    On the card ``_int_mm`` takes more than 16 rows and inner and outer sizes that are
    multiples of 8, and the timestep MLP and adaLN inputs have one or two rows: the operands
    are padded with zero rows and columns, which add nothing to any sum, and the product is
    cut back. (A float product would not be exact above 2^24.)"""
    m, k = a.shape
    n = w.shape[0]
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    return torch._int_mm(a, w.t())[:m, :n]


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


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] @ w[out, in]^T (+ b [out]).

    An ``int8_dyn`` weight takes the integer path (``foley_tpu/ops/nn.py::dense``): the
    activations quantized per token, an exact int32 product, ``(acc * sx) * scale`` in fp32,
    cast to the activation dtype, then the bias added."""
    if isinstance(w, QuantizedWeight) and w.kind == "int8_dyn":
        xq, sx = quantize_act(x)
        acc = int_mm(xq.reshape(-1, xq.shape[-1]), w.q).reshape(*x.shape[:-1], -1)
        out = (acc.float() * sx * w.scale.reshape(-1)).to(x.dtype)
        return out if b is None else out + _match(b, x)
    return F.linear(x, _match(w, x), None if b is None else _match(b, x))


def conv1d(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """Channel-last 1-D convolution. x [B, T, Cin], w [Cout, Cin/groups, K] -> [B, T', Cout].
    An ``int8_dyn`` weight is dequantized like ``int8`` (as in the JAX package)."""
    out = F.conv1d(x.transpose(1, 2), _match(w, x), None if b is None else _match(b, x),
                   stride=stride, padding=padding, dilation=dilation, groups=groups)
    return out.transpose(1, 2)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """Channel-last 2-D convolution (``foley_tpu/ops/nn.py::conv2d``). x [B, H, W, Cin],
    w [Cout, Cin/groups, Kh, Kw] (JAX: [Kh, Kw, Cin/groups, Cout]) -> [B, H', W', Cout]. The
    DAC's discriminators hold their maps channels-first and call ``F.conv2d`` directly."""
    out = F.conv2d(x.permute(0, 3, 1, 2), _match(w, x), None if b is None else _match(b, x),
                   stride=stride, padding=padding, dilation=dilation, groups=groups)
    return out.permute(0, 2, 3, 1)


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


class QuantizableWeight(nn.Module):
    """A module with a ``weight`` that ``io/quantize.py`` may put in quantized storage.

    ``lora_weight``: the effective weight of a runtime LoRA adapter, ``w + scale * a @ b``,
    set only while ``models/lora.py::block_lora`` holds one block's adapter; ops read it in
    place of ``weight``."""

    lora_weight: Optional[torch.Tensor] = None

    def stored_weight(self):
        """``lora_weight`` while an adapter is applied, else ``weight``, or its
        ``QuantizedWeight`` when the codes replaced it."""
        if self.lora_weight is not None:
            return self.lora_weight
        for kind in QUANT_KINDS:
            q = self._buffers.get("weight_" + kind)
            if q is not None:
                return QuantizedWeight(kind, q, self._buffers["weight_scale"])
        return self.weight

    def set_quantized(self, kind: str, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Replace the ``weight`` parameter with the buffers ``weight_<kind>`` and
        ``weight_scale``, so ``state_dict``, ``param_bytes``, ``park`` and the block swap
        see them."""
        if kind not in QUANT_KINDS:
            raise ValueError(f"quantized kind {kind!r}: expected one of {QUANT_KINDS}")
        del self.weight
        self.register_buffer("weight_" + kind, q)
        self.register_buffer("weight_scale", scale)

    def set_weight(self, w: torch.Tensor) -> None:
        """Hold ``w`` (an fp8 weight) as the ``weight`` parameter, in its own dtype."""
        self.weight = nn.Parameter(w, requires_grad=False)


class Dense(QuantizableWeight):
    """``scheme``: ``torch`` (nn.Linear's Kaiming-uniform fan_in), ``zeros`` (adaLN and final
    layers), ``normal02`` (timestep MLP) or ``normal02_zero_bias`` (the vision encoders)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, scheme: str = "torch",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.scheme = scheme
        self.weight = empty_parameter(out_dim, in_dim, dtype=dtype, device=device)
        self.bias = empty_parameter(out_dim, dtype=dtype, device=device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.stored_weight(), self.bias)

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


class Conv1d(QuantizableWeight):
    """Channel-last conv; weight [out, in, K]; torch's default Kaiming-uniform init."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = empty_parameter(out_dim, in_dim, kernel_size, dtype=dtype, device=device)
        self.bias = empty_parameter(out_dim, dtype=dtype, device=device) if bias else None

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return conv1d(x, self.stored_weight(), self.bias, **kw)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        _, cin, k = self.weight.shape
        limit = 1.0 / math.sqrt(cin * k)
        self.weight.uniform_(-limit, limit, generator=g)
        if self.bias is not None:
            self.bias.uniform_(-limit, limit, generator=g)


class Conv2d(nn.Module):
    """A 2-D conv's weight [out, in/groups, Kh, Kw] and bias, drawn as the JAX package's
    discriminators draw theirs: both uniform in +-1/sqrt(in/groups * Kh * Kw)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size, groups: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        kh, kw = kernel_size
        self.weight = empty_parameter(out_dim, in_dim // groups, kh, kw, dtype=dtype,
                                      device=device)
        self.bias = empty_parameter(out_dim, dtype=dtype, device=device)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        limit = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.uniform_(-limit, limit, generator=g)
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
