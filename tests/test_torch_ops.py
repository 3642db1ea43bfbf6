"""The port's plain ops against the JAX package's, on the CPU.

Same numpy inputs through both; fp32 atol 1e-5 / rtol 1e-4 (the two frameworks' fp32
kernels sum in different orders). bf16 cases compare to one bf16 rounding step.
"""

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from foley_tpu.ops import activations as j_act
from foley_tpu.ops import interp as j_interp
from foley_tpu.ops import nn as j_nn
from foley_tpu.ops import norms as j_norms
from foley_tpu.ops import rope as j_rope
from foley_tpu_torch.io.from_jax import to_tensor
from foley_tpu_torch.ops import activations as t_act
from foley_tpu_torch.ops import interp as t_interp
from foley_tpu_torch.ops import modulate as t_mod
from foley_tpu_torch.ops import nn as t_nn
from foley_tpu_torch.ops import norms as t_norms
from foley_tpu_torch.ops import rope as t_rope
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

# ``foley_tpu.ops`` re-exports the function ``modulate`` under the module's name.
j_mod = importlib.import_module("foley_tpu.ops.modulate")

TOL = dict(atol=1e-5, rtol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, ref, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **(tol or TOL))


@pytest.mark.parametrize("with_weight", [False, True])
def test_rms_norm(with_weight):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 7, 3, 32), _rand(rng, 32)
    ref = j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w) if with_weight else None)
    _close(t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w) if with_weight else None),
           ref)


def test_rms_norm_bf16_casts_before_weight():
    """The normalised value is rounded to bf16 before the weight multiply, as in JAX."""
    rng = np.random.default_rng(1)
    x = _rand(rng, 4, 64).astype(ml_dtypes.bfloat16)
    w = rng.uniform(0.5, 1.5, 64).astype(ml_dtypes.bfloat16)
    ref = np.asarray(j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w))).astype(np.float32)
    got = t_norms.rms_norm(to_tensor(x), to_tensor(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_layer_norm():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 9, 48, scale=3.0) + 1.0
    _close(t_norms.layer_norm(torch.from_numpy(x)), j_norms.layer_norm(jnp.asarray(x)))


@pytest.mark.parametrize("length,dim,scaling", [(50, 64, 1.0), (7, 128, 2.5)])
def test_rope_table(length, dim, scaling):
    cos_j, sin_j = j_rope.rope_table(length, dim, freq_scaling=scaling)
    cos_t, sin_t = t_rope.rope_table(length, dim, freq_scaling=scaling)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)


def test_rotate_half_is_pair_adjacent():
    x = torch.arange(8, dtype=torch.float32)
    assert t_rope._rotate_half(x).tolist() == [-1, 0, -3, 2, -5, 4, -7, 6]


@pytest.mark.parametrize("length,dim", [(11, 32), (290, 128)])
def test_apply_rotary_emb(length, dim):
    x = _rand(np.random.default_rng(3), 2, length, 3, dim, scale=2.0)
    cos, sin = j_rope.rope_table(length, dim)
    ref = j_rope.apply_rotary_emb(jnp.asarray(x), cos, sin)
    _close(t_rope.apply_rotary_emb(torch.from_numpy(x), *t_rope.rope_table(length, dim)), ref)


@pytest.mark.parametrize("in_len,out_len", [(4, 20), (20, 4), (112, 250), (40, 250), (7, 7)])
def test_nearest_exact_resize(in_len, out_len):
    x = np.random.default_rng(5).normal(size=(2, in_len, 3)).astype(np.float32)
    ref = j_interp.nearest_exact_resize(jnp.asarray(x), out_len, axis=1)
    np.testing.assert_array_equal(
        t_interp.nearest_exact_resize(torch.from_numpy(x), out_len, dim=1).numpy(),
        np.asarray(ref))


@pytest.mark.parametrize("shift_nd,scale_nd", [(2, 2), (3, 3), (2, None), (None, 2)])
def test_modulate_and_modulate_ref(shift_nd, scale_nd):
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 5, 16)
    mk = {2: lambda: _rand(rng, 2, 16), 3: lambda: _rand(rng, 2, 5, 16), None: lambda: None}
    shift, scale = mk[shift_nd](), mk[scale_nd]()
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    for j_fn, t_fn in ((j_mod.modulate, t_mod.modulate), (j_mod.modulate_ref, t_mod.modulate_ref)):
        ref = j_fn(jnp.asarray(x), opt(shift, jnp.asarray), opt(scale, jnp.asarray))
        got = t_fn(torch.from_numpy(x), opt(shift, torch.from_numpy), opt(scale, torch.from_numpy))
        _close(got, ref)


def test_modulate_ref_drops_per_token_modulation():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rand(rng, 2, 5, 16))
    shift, scale = (torch.from_numpy(_rand(rng, 2, 5, 16)) for _ in range(2))
    assert torch.equal(t_mod.modulate_ref(x, shift, scale), x)


@pytest.mark.parametrize("gate_nd", [2, 3])
def test_apply_gate(gate_nd):
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 5, 16)
    gate = _rand(rng, 2, 16) if gate_nd == 2 else _rand(rng, 2, 5, 16)
    _close(t_mod.apply_gate(torch.from_numpy(x), torch.from_numpy(gate)),
           j_mod.apply_gate(jnp.asarray(x), jnp.asarray(gate)))


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "silu", "relu"])
def test_activations(name):
    x = _rand(np.random.default_rng(9), 3, 40, scale=3.0)
    _close(t_act.get_activation(name)(torch.from_numpy(x)),
           j_act.get_activation(name)(jnp.asarray(x)))


def test_swiglu_and_snake():
    rng = np.random.default_rng(10)
    a, b = _rand(rng, 2, 6, 16), _rand(rng, 2, 6, 16)
    alpha = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    _close(t_act.swiglu(torch.from_numpy(a), torch.from_numpy(b)),
           j_act.swiglu(jnp.asarray(a), jnp.asarray(b)))
    _close(t_act.snake(torch.from_numpy(a), torch.from_numpy(alpha)),
           j_act.snake(jnp.asarray(a), jnp.asarray(alpha)))


def test_dense():
    rng = np.random.default_rng(11)
    x, w, b = _rand(rng, 2, 5, 24), _rand(rng, 24, 40, scale=0.2), _rand(rng, 40)
    ref = j_nn.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(t_nn.dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b)),
           ref)


@pytest.mark.parametrize("k,stride,padding,dilation", [
    (3, 1, 1, 1), (7, 1, 9, 3), (1, 1, 0, 1), (4, 4, 0, 1), (7, 1, 27, 9),
])
def test_conv1d(k, stride, padding, dilation):
    rng = np.random.default_rng(12)
    x, w, b = _rand(rng, 2, 33, 12), _rand(rng, k, 12, 20, scale=0.2), _rand(rng, 20)
    ref = j_nn.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                      padding=padding, dilation=dilation)
    got = t_nn.conv1d(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                      torch.from_numpy(b), stride=stride, padding=padding, dilation=dilation)
    _close(got, ref)


@pytest.mark.parametrize("stride", [8, 5, 4, 3, 2])
def test_conv_transpose1d(stride):
    """The DAC upsampling geometry: k = 2s, padding ceil(s/2), output_padding s % 2."""
    rng = np.random.default_rng(13)
    k, pad, opad = 2 * stride, -(-stride // 2), stride % 2
    x, w, b = _rand(rng, 2, 9, 12), _rand(rng, k, 12, 6, scale=0.2), _rand(rng, 6)
    ref = j_nn.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                                padding=pad, output_padding=opad)
    got = t_nn.conv_transpose1d(torch.from_numpy(x),
                                torch.from_numpy(w.transpose(1, 2, 0).copy()),
                                torch.from_numpy(b), stride=stride, padding=pad,
                                output_padding=opad)
    assert got.shape == ref.shape
    _close(got, ref)


def test_true_fp32_restores_flags():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with t_nn.true_fp32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved


def test_bf16_leaf_bridge_keeps_bits():
    a = np.random.default_rng(14).normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
