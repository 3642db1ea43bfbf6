"""K1 at head widths other than 128, on the CPU: the port's plain version against the JAX
Pallas kernel in interpret mode at even widths from 18 to 256, the wrapper's width rule
(which C entry each width takes, read from the operands without a card), and the port's
MMDiT with heads of 48 against the JAX ``apply``. The CUDA kernel at these widths
(``csrc/fused_qk_attention_mma.cu``) is held against the plain version on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: fp32 atol 1e-5 (both sides compute in fp32; they agree to about 1e-6), bf16
atol 4e-3 (both round the normalised q / k and p to bf16 at different places:
``test_torch_fused_attention.py`` says why), the MMDiT's fp32 velocity atol 1e-5 / rtol 1e-4
(``test_torch_mmdit.py``'s).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import foley_tpu.ops.pallas.fused_attention as JFA
from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import mmdit as jmm
from foley_tpu.ops.rope import rope_table as jax_rope_table
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.core.params import perturb_zero_leaves
from foley_tpu_torch.io.from_jax import to_tensor
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.ops.kernels import fused_attention as FA
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

WIDTHS = (18, 48, 80, 96, 160, 256)
LENGTHS = [(1, 63, 65, 2), (2, 70, 50, 1)]  # (b, lq, lk, h): both sides of a 64-key tile
F32_TOL = dict(atol=1e-5, rtol=0)
BF16_TOL = dict(atol=4e-3, rtol=0)


def _inputs(b, lq, lk, h, d, seed):
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
    return np.asarray(JFA.fused_qk_attention(*ops, interpret=True)).astype(np.float32)


@pytest.mark.parametrize("b,lq,lk,h", LENGTHS)
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_matches_pallas_fp32(d, b, lq, lk, h):
    arrays = _inputs(b, lq, lk, h, d, seed=d)
    got = FA.fused_qk_attention_plain(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got.numpy(), _jax_ref(arrays, np.float32), **F32_TOL)


@pytest.mark.parametrize("b,lq,lk,h", LENGTHS)
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_matches_pallas_bf16(d, b, lq, lk, h):
    arrays = _inputs(b, lq, lk, h, d, seed=d + 1)
    q, k, v = (to_tensor(x.astype(ml_dtypes.bfloat16)) for x in arrays[:3])
    got = FA.fused_qk_attention_plain(q, k, v, *map(torch.from_numpy, arrays[3:]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _jax_ref(arrays, ml_dtypes.bfloat16),
                               **BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_every_even_width_up_to_256_has_a_kernel(dtype):
    """D 128 takes the wgmma kernels, every other even D from 2 to 256 the mma.sync kernel;
    odd widths and widths past 256 raise, naming the limit."""
    for d in range(2, FA.MMA_MAX_HEAD_DIM + 1, 2):
        x = torch.zeros(1, 3, 2, d, dtype=dtype)
        mma, extra = FA.kernel_route(x, x, x)
        assert mma == (d != FA.HEAD_DIM), d
        if mma:
            row = d * x.element_size()
            assert extra[0] == d and extra[1] in (4, 8, 16) and row % extra[1] == 0, (d, extra)
            assert extra[1] == max(c for c in (4, 8, 16) if row % c == 0), (d, extra)
    for d in (3, 127, 258, 320, 512):
        x = torch.zeros(1, 3, 2, d, dtype=dtype)
        with pytest.raises(ValueError, match="256"):
            FA.kernel_route(x, x, x)


def test_width_route_reads_strided_views():
    """q, k and v as views of one qkv tensor (the denoiser's split): an 18-wide bf16 head
    loads in 4-byte chunks, a 96-wide one in 16-byte chunks; rows that are not 4-byte aligned
    raise."""
    for d, chunk in ((18, 4), (20, 8), (96, 16)):
        q, k, v = torch.zeros(2, 5, 3, 4, d, dtype=torch.bfloat16).unbind(2)
        assert FA.kernel_route(q, k, v) == (True, (d, chunk))
    odd = torch.zeros(2 * 5 * 4 * 18 + 1, dtype=torch.bfloat16)[1:].view(2, 5, 4, 18)
    with pytest.raises(ValueError, match="4-byte"):
        FA.kernel_route(odd, odd, odd)


CFG48 = dataclasses.replace(TINY.model, hidden_size=96, num_heads=2)
J_CFG48 = dataclasses.replace(J_TINY.model, hidden_size=96, num_heads=2)


@pytest.fixture(scope="module")
def models48():
    assert CFG48.head_dim == 48
    model = tmm.init(CFG48, torch.Generator().manual_seed(0), device="cpu")
    perturb_zero_leaves(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(2)
        for name, p in model.named_parameters():
            if "norm" in name:  # the qk-norm weights: ones at init
                p.uniform_(0.5, 1.5, generator=gen)
    return jax_tree_from_port(model, jmm.init, J_CFG48), model


def test_mmdit_with_heads_of_48_matches_jax(models48, monkeypatch):
    """A denoiser whose heads are 48 wide (hidden 96, 2 heads): every triple and single
    block's fused attention at that width, against the JAX ``apply`` with the Pallas kernel
    in interpret mode and with XLA's attention."""
    monkeypatch.setattr(JFA, "fused_qk_attention",
                        functools.partial(JFA.fused_qk_attention, interpret=True))
    params, model = models48
    rng = np.random.default_rng(4)
    b, t = 2, 20
    arrays = (rng.normal(size=(b, t, CFG48.audio_vae_latent_dim)).astype(np.float32),
              np.asarray([500.0, 100.0], np.float32),
              rng.normal(size=(b, 8, CFG48.condition_dim)).astype(np.float32),
              rng.normal(size=(b, 4, CFG48.clip_dim)).astype(np.float32),
              rng.normal(size=(b, 8, CFG48.sync_feat_dim)).astype(np.float32))
    ref = {impl: np.asarray(jmm.apply(params, *map(jnp.asarray, arrays), J_CFG48,
                                      attn_impl=impl))
           for impl in ("pallas_fused", "xla")}
    with torch.no_grad():
        got = model(*map(torch.from_numpy, arrays)).numpy()
    assert float(np.std(ref["xla"])) > 0.1  # signal flows
    np.testing.assert_allclose(got, ref["pallas_fused"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, ref["xla"], atol=1e-5, rtol=1e-4)
