"""K2's plain version and the flash-attention wrapper's CPU and mask paths against the JAX
package's Pallas kernel (interpret mode) and its ``_sdpa_xla``.

fp32 tolerance atol 2e-5 / rtol 1e-4, as ``tests/test_pallas.py`` holds the kernel against
XLA: both sides sum the same fp32 products in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.ops.attention import _sdpa_xla
from foley_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from foley_tpu_torch.ops.kernels import flash_attention as FL
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(b, lq, lk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, lq, h, d)).astype(np.float32),
            rng.normal(size=(b, lk, h, d)).astype(np.float32),
            rng.normal(size=(b, lk, h, d)).astype(np.float32))


@pytest.mark.parametrize("b,lq,lk,h,d", [
    (1, 50, 50, 2, 64),      # tiny self-attention
    (2, 290, 290, 2, 128),   # joint [visual; audio] 5 s shape
    (1, 250, 77, 2, 128),    # Lq != Lk
    (1, 300, 300, 1, 128),   # past one 256-row q tile, keys padded on the TPU
])
def test_plain_matches_pallas_interpret(b, lq, lk, h, d):
    q, k, v = _qkv(b, lq, lk, h, d)
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), interpret=True))
    got = FL.flash_attention(*map(torch.from_numpy, (q, k, v)))  # CPU: the plain version
    assert got.shape == (b, lq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_plain_rounds_p_to_bf16_as_the_kernel_does():
    """bf16 operands: fp32 logits and softmax, p cast to bf16 before p @ v, bf16 out."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(2, 33, 47, 3, 64, seed=1))
    got = FL.flash_attention_plain(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / 8.0
    p = torch.softmax(logits, -1).to(torch.bfloat16)
    ref = torch.einsum("bhqk,bkhd->bqhd", p.double(), v.double())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.double(), ref, atol=1e-2, rtol=0)


def test_mask_takes_the_masked_plain_path():
    q, k, v = _qkv(2, 16, 24, 2, 32, seed=2)
    mask = np.ones((2, 1, 16, 24), bool)
    mask[0, ..., 10:] = False
    mask[1, :, 3, :5] = False
    ref = np.asarray(_sdpa_xla(*map(jnp.asarray, (q, k, v, mask))))
    before = FL.flash_attention.launches
    got = FL.flash_attention(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert FL.flash_attention.launches == before  # no kernel on the plain paths
    np.testing.assert_allclose(np.asarray(j_flash(*map(jnp.asarray, (q, k, v)),
                                                  mask=jnp.asarray(mask))), ref, atol=1e-6)


def test_wrapper_refuses_other_devices():
    q = torch.zeros(1, 4, 1, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        FL.flash_attention(q, q, q)
