"""The fp32 kernels' 3xTF32 arithmetic on the CPU (``ops/kernels/common.py``: ``split_tf32``,
``attention_tf32``), against the JAX package's fp32 arithmetic at ``Precision.HIGHEST``.

The fp32 K1 and K2 kernels (``csrc/attention_f32.cu``) split every fp32 operand into tf32
hi and lo and form each product as a_lo b_hi + a_hi b_lo + a_hi b_hi on the tensor cores.
These tests hold that design before any card sees it:
- the split: hi and lo carry no bits below tf32's 10 mantissa bits, hi is x rounded to
  nearest with ties away from zero (against an independent frexp rounding), and hi + lo gives
  back x within 2^-22 of it;
- the 3xTF32 model of K1 (qk-norm and RoPE in fp32, then attention) and of K2, at
  ``test_torch_precision.py``'s shapes, against ``_sdpa_xla`` after norm + RoPE and SigLIP2's
  ``_mha``, within the 1e-5 relative L2 the kernels are held to on the card
  (``chip_smoke.py``'s ``FP32_KERNEL_REL_TOL``);
- the control: the same model with a single TF32 pass lands above 1e-5, so the bound tells
  the two designs apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.models import siglip2 as jsig
from foley_tpu.ops.attention import _sdpa_xla
from foley_tpu.ops.norms import rms_norm as j_rms_norm
from foley_tpu.ops.rope import apply_rotary_emb as j_rope
from foley_tpu_torch.ops.kernels import fused_attention as FA
from foley_tpu_torch.ops.kernels.common import attention_tf32, split_tf32
from test_torch_precision import K1_SHAPES, K2_SHAPES, _k1_inputs, _rel
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

FP32_KERNEL_REL_TOL = 1e-5  # the card's bound on the fp32 kernels, relative L2


def _rna_tf32_reference(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits, to nearest with ties away from zero, in float64
    through frexp: an independent statement of the rounding ``split_tf32`` does on bits."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    m = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return np.ldexp(m, e).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.0, 1e30])
def test_split_tf32_hi_lo_bits_and_sum(scale):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) * scale).astype(np.float32)
    x[:3] = 0.0, -0.0, scale
    hi, lo = split_tf32(torch.from_numpy(x))
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    np.testing.assert_array_equal(hi.numpy(), _rna_tf32_reference(x))
    np.testing.assert_array_equal(lo.numpy(), _rna_tf32_reference(x - hi.numpy()))
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - x)
    assert np.all(err <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


def test_split_tf32_rounds_ties_away_from_zero():
    """A value half-way between two tf32 neighbours goes to the larger magnitude, on both
    signs: the kernels' rounding, not the tensor cores' truncation."""
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11],
                   dtype=np.float32)
    hi, lo = split_tf32(torch.from_numpy(tie))
    np.testing.assert_array_equal(hi.numpy(), [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                               1.0 + 2.0 ** -9])
    np.testing.assert_array_equal((hi + lo).numpy(), tie)


def _k1_reference_and_operands(b, lq, lk, h):
    """``test_torch_precision``'s fp32 K1 case: the JAX reference (qk-norm, RoPE, then
    ``_sdpa_xla`` at HIGHEST) and the port's normalised, rotated q and k in fp32."""
    q, k, v, wq, wk, cq, sq, ck, sk = _k1_inputs(b, lq, lk, h, seed=3)

    def norm_rope(x, w, c, s):
        x = j_rms_norm(jnp.asarray(x), eps=1e-6) * jnp.asarray(w)[None, :, None, :]
        return j_rope(x, jnp.asarray(c), jnp.asarray(s))

    ref = np.asarray(_sdpa_xla(norm_rope(q, wq, cq, sq), norm_rope(k, wk, ck, sk),
                               jnp.asarray(v), None))
    qn = FA._norm_rope(*map(torch.from_numpy, (q, wq, cq, sq)), 1e-6)
    kn = FA._norm_rope(*map(torch.from_numpy, (k, wk, ck, sk)), 1e-6)
    return ref, qn, kn, torch.from_numpy(v)


def _k2_reference_and_operands(b, lq, lk, h, d):
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for n in (lq, lk, lk))
    ref = np.asarray(jsig._mha(*(jnp.asarray(x.reshape(b, x.shape[1], h * d)) for x in (q, k, v)),
                               h, impl="xla")).reshape(b, lq, h, d)
    return ref, *map(torch.from_numpy, (q, k, v))


@pytest.mark.parametrize("b,lq,lk,h", K1_SHAPES)
def test_k1_3xtf32_model_matches_jax_highest(b, lq, lk, h):
    ref, qn, kn, v = _k1_reference_and_operands(b, lq, lk, h)
    got = attention_tf32(qn, kn, v)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= FP32_KERNEL_REL_TOL


@pytest.mark.parametrize("b,lq,lk,h,d", K2_SHAPES)
def test_k2_3xtf32_model_matches_siglip2_mha_highest(b, lq, lk, h, d):
    ref, q, k, v = _k2_reference_and_operands(b, lq, lk, h, d)
    got = attention_tf32(q, k, v)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= FP32_KERNEL_REL_TOL


@pytest.mark.parametrize("b,lq,lk,h", K1_SHAPES)
def test_k1_single_tf32_pass_breaks_the_bound(b, lq, lk, h):
    """The control: one TF32 pass (a_hi b_hi) lands outside the fp32 bound."""
    ref, qn, kn, v = _k1_reference_and_operands(b, lq, lk, h)
    assert _rel(attention_tf32(qn, kn, v, passes=1).numpy(), ref) > FP32_KERNEL_REL_TOL


@pytest.mark.parametrize("b,lq,lk,h,d", K2_SHAPES)
def test_k2_single_tf32_pass_breaks_the_bound(b, lq, lk, h, d):
    ref, q, k, v = _k2_reference_and_operands(b, lq, lk, h, d)
    assert _rel(attention_tf32(q, k, v, passes=1).numpy(), ref) > FP32_KERNEL_REL_TOL


def test_tf32_model_refuses_other_pass_counts():
    q = torch.zeros(1, 2, 1, 64)
    with pytest.raises(ValueError):
        attention_tf32(q, q, q, passes=2)
