"""Fused qk-RMSNorm + RoPE + attention: the port's plain version against the JAX Pallas
kernel run in interpret mode, on the CPU. The CUDA kernel's own tests, which need a card,
are in ``test_torch_cuda.py``.

Tolerances: fp32 atol 2e-5 / rtol 1e-4 (the Pallas kernel's tolerance against the composed
path). bf16, atol 4e-3: both sides round the normalised q/k and p to bf16, but at
different places, so an output element below 2 may differ by two bf16 steps (a step is
2^-8 = 3.9e-3 at 1, half that below 1).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from foley_tpu.ops.pallas.fused_attention import fused_qk_attention as jax_fused
from foley_tpu.ops.rope import rope_table as jax_rope_table
from foley_tpu_torch.io.from_jax import to_tensor
from foley_tpu_torch.ops.kernels import fused_attention as FA
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [
    (2, 37, 53, 2, 128),    # ragged q and k lengths
    (1, 50, 50, 2, 64),     # tiny self-attention
    (2, 290, 290, 2, 128),  # joint [visual; audio] length at 5 s
    (1, 300, 300, 1, 128),  # not a multiple of any tile
]
F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=4e-3, rtol=0)


def _inputs(b, lq, lk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for n in (lq, lk, lk))
    wq = rng.uniform(0.5, 1.5, (lq, d)).astype(np.float32)
    wk = rng.uniform(0.5, 1.5, (lk, d)).astype(np.float32)
    cq, sq = (np.array(t) for t in jax_rope_table(lq, d))
    ck, sk = (np.array(t) for t in jax_rope_table(lk, d))
    return q, k, v, wq, wk, cq, sq, ck, sk


def _jax_ref(arrays, dtype):
    q, k, v, *tables = arrays
    ops = [jnp.asarray(x.astype(dtype)) for x in (q, k, v)] + [jnp.asarray(t) for t in tables]
    return np.asarray(jax_fused(*ops, interpret=True)).astype(np.float32)


@pytest.mark.parametrize("b,lq,lk,h,d", SHAPES)
def test_plain_matches_pallas_fp32(b, lq, lk, h, d):
    arrays = _inputs(b, lq, lk, h, d)
    got = FA.fused_qk_attention_plain(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got.numpy(), _jax_ref(arrays, np.float32), **F32_TOL)


@pytest.mark.parametrize("b,lq,lk,h,d", SHAPES[:1] + SHAPES[2:3])
def test_plain_matches_pallas_bf16(b, lq, lk, h, d):
    arrays = _inputs(b, lq, lk, h, d, seed=1)
    q, k, v = (to_tensor(x.astype(ml_dtypes.bfloat16)) for x in arrays[:3])
    got = FA.fused_qk_attention_plain(q, k, v, *map(torch.from_numpy, arrays[3:]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _jax_ref(arrays, ml_dtypes.bfloat16),
                               **BF16_TOL)


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    arrays = [torch.from_numpy(x) for x in _inputs(1, 9, 9, 2, 128)]
    q, k, v, wq, wk, *tabs = arrays
    before = FA.fused_qk_attention.launches
    # a [D] weight broadcasts over the positions, as the single blocks pass it
    got = FA.fused_qk_attention(q, k, v, wq[0], wk[0], *tabs)
    ref = FA.fused_qk_attention_plain(q, k, v, wq[0].expand(9, 128), wk[0].expand(9, 128), *tabs)
    assert torch.equal(got, ref)
    assert FA.fused_qk_attention.launches == before
