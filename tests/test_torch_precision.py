"""K1 and K2 in fp16 and fp32, and the denoiser around them, against the JAX package on the
CPU; the wrappers' dispatch of the three element types to their C entries (a stub library
stands in for the built one); and ``true_fp32`` across threads.

On the CPU the wrappers take the kernels' plain versions, so these tests hold the arithmetic
the CUDA kernels are held to on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``):
- fp16: the plain versions against the Pallas kernels in interpret mode, both rounding the
  normalised q/k and p to fp16 at their own places: atol 2e-3, two fp16 steps at 1;
- fp32: against the JAX package's fp32 arithmetic at ``Precision.HIGHEST`` (K1: qk-norm,
  RoPE and ``_sdpa_xla``, the composed path the denoiser takes below 1000 tokens; K2:
  SigLIP2's ``_mha``), not against the Pallas kernels, which pass no precision: relative L2
  1e-6, fp32 sums in another order.
- The TINY denoiser: fp32 atol 1e-5 / rtol 1e-4 (``tests/test_torch_mmdit.py``'s); fp16
  relative L2 2e-3 and atol 5e-3 on a velocity of std ~0.44 (it reads 5e-4 and 1e-3: fp16
  rounds at other places in the two frameworks, as bf16 does, with three more bits).
"""

import ctypes
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import mmdit as jmm
from foley_tpu.models import siglip2 as jsig
from foley_tpu.ops.attention import _sdpa_xla
from foley_tpu.ops.norms import rms_norm as j_rms_norm
from foley_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from foley_tpu.ops.pallas.fused_attention import fused_qk_attention as j_fused
from foley_tpu.ops.rope import apply_rotary_emb as j_rope
from foley_tpu.ops.rope import rope_table as j_rope_table
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import mmdit_from_jax
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.ops import nn as tnn
from foley_tpu_torch.ops.kernels import build, common
from foley_tpu_torch.ops.kernels import flash_attention as FL
from foley_tpu_torch.ops.kernels import fused_attention as FA
from test_torch_mmdit import seeded_tree
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

FP16_TOL = dict(atol=2e-3, rtol=0)
FP32_REL = 1e-6


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def _k1_inputs(b, lq, lk, h, d=128, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for n in (lq, lk, lk))
    wq = rng.uniform(0.5, 1.5, (lq, d)).astype(np.float32)
    wk = rng.uniform(0.5, 1.5, (lk, d)).astype(np.float32)
    cq, sq = (np.array(t) for t in j_rope_table(lq, d))
    ck, sk = (np.array(t) for t in j_rope_table(lk, d))
    return q, k, v, wq, wk, cq, sq, ck, sk


K1_SHAPES = [(2, 37, 53, 2), (1, 290, 290, 2), (1, 65, 1, 3)]
K2_SHAPES = [(2, 37, 53, 2, 64), (1, 100, 100, 2, 64), (2, 65, 77, 2, 128)]


@pytest.mark.parametrize("b,lq,lk,h", K1_SHAPES)
def test_k1_plain_fp16_matches_pallas(b, lq, lk, h):
    arrays = _k1_inputs(b, lq, lk, h, seed=1)
    q, k, v = (x.astype(np.float16) for x in arrays[:3])
    ref = j_fused(*map(jnp.asarray, (q, k, v, *arrays[3:])), interpret=True)
    got = FA.fused_qk_attention(*map(torch.from_numpy, (q, k, v, *arrays[3:])))
    assert got.dtype == torch.float16 and ref.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **FP16_TOL)


@pytest.mark.parametrize("b,lq,lk,h,d", K2_SHAPES)
def test_k2_plain_fp16_matches_pallas(b, lq, lk, h, d):
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float16) for n in (lq, lk, lk))
    ref = j_flash(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = FL.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float16 and ref.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **FP16_TOL)


@pytest.mark.parametrize("b,lq,lk,h", K1_SHAPES)
def test_k1_plain_fp32_matches_jax_highest(b, lq, lk, h):
    """fp32 qk-norm (per-position weights), RoPE, then ``_sdpa_xla`` (HIGHEST in fp32)."""
    q, k, v, wq, wk, cq, sq, ck, sk = _k1_inputs(b, lq, lk, h, seed=3)

    def norm_rope(x, w, c, s):
        x = j_rms_norm(jnp.asarray(x), eps=1e-6) * jnp.asarray(w)[None, :, None, :]
        return j_rope(x, jnp.asarray(c), jnp.asarray(s))

    ref = np.asarray(_sdpa_xla(norm_rope(q, wq, cq, sq), norm_rope(k, wk, ck, sk),
                               jnp.asarray(v), None))
    got = FA.fused_qk_attention(*map(torch.from_numpy, (q, k, v, wq, wk, cq, sq, ck, sk)))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= FP32_REL


@pytest.mark.parametrize("b,lq,lk,h,d", K2_SHAPES)
def test_k2_plain_fp32_matches_siglip2_mha_highest(b, lq, lk, h, d):
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for n in (lq, lk, lk))
    ref = np.asarray(jsig._mha(*(jnp.asarray(x.reshape(b, x.shape[1], h * d)) for x in (q, k, v)),
                               h, impl="xla")).reshape(b, lq, h, d)
    got = FL.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= FP32_REL


@pytest.fixture(scope="module")
def tiny_params():
    return seeded_tree(jax_tree_from_port(tmm.init(TINY.model, torch.Generator().manual_seed(0),
                                                   device="cpu"), jmm.init, J_TINY.model),
                       seed=7)


@pytest.mark.parametrize("precision", ["fp16", "fp32"])
def test_tiny_denoiser_matches_jax(tiny_params, precision):
    """The TINY denoiser with every weight and activation in ``precision`` on both sides,
    against ``mmdit.apply`` with the composed attention (HIGHEST in fp32)."""
    np_dtype, t_dtype = {"fp16": (np.float16, torch.float16),
                         "fp32": (np.float32, torch.float32)}[precision]
    params = jax.tree.map(lambda x: np.asarray(x, np_dtype), tiny_params)
    model = mmdit_from_jax(params, TINY.model, device="cpu")
    assert next(model.parameters()).dtype == t_dtype
    rng = np.random.default_rng(8)
    arrays = [rng.normal(size=(2, 20, TINY.model.audio_vae_latent_dim)),
              np.asarray([500.0, 100.0]), rng.normal(size=(2, 8, TINY.model.condition_dim)),
              rng.normal(size=(2, 4, TINY.model.clip_dim)),
              rng.normal(size=(2, 8, TINY.model.sync_feat_dim))]
    arrays = [a.astype(np.float32 if a.ndim == 1 else np_dtype) for a in arrays]
    ref = np.asarray(jmm.apply(params, *map(jnp.asarray, arrays), J_TINY.model,
                               attn_impl="xla"), np.float32)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, arrays))
    assert got.dtype == t_dtype
    got = got.float().numpy()
    assert float(np.std(ref)) > 0.1
    if precision == "fp32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    else:
        assert _rel(got, ref) < 2e-3
        np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)


class _StubLibrary:
    """Stands in for a built kernel library: every C entry records its call and returns
    0 (success) without touching the pointers."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, entry):
        def fn(*args):
            self.calls.append((self.name, entry, args))
            return 0

        return fn


@pytest.fixture
def stub_library(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "library", lambda name: _StubLibrary(name, calls))
    monkeypatch.setattr(FA, "_fns", {})
    monkeypatch.setattr(FL, "_fns", {})

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    return calls


@pytest.mark.parametrize("dtype,lib,entry", [
    (torch.bfloat16, "fused_qk_attention", "fused_qk_attention_bf16"),
    (torch.float16, "fused_qk_attention", "fused_qk_attention_f16"),
    (torch.float32, "attention_f32", "fused_qk_attention_f32")])
def test_k1_wrapper_dispatches_each_dtype_to_its_entry(stub_library, dtype, lib, entry):
    """The launch path of a CUDA tensor, run on CPU tensors against the stub: the entry of
    the operands' type, the kernel's operand layout, and one count in all and for the type."""
    arrays = _k1_inputs(2, 9, 9, 3)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in arrays[:3])
    tabs = [torch.from_numpy(t) for t in arrays[3:]]
    common.reset_launches(FA.fused_qk_attention)
    out = FA._launch(q, k, v, *tabs, 1e-6)
    assert out.shape == q.shape and out.dtype == dtype
    ((name, called, args),) = stub_library
    assert (name, called) == (lib, entry)
    assert args[0] == q.data_ptr() and args[3] == out.data_ptr()
    assert list(args[11:15]) == [2, 3, 9, 9] and args[15] == pytest.approx(1e-6)
    assert list(args[10][:3]) == list(q.stride()[:3])
    assert FA.fused_qk_attention.launches == 1
    assert FA.fused_qk_attention.launches_by_dtype == {dtype: 1}


@pytest.mark.parametrize("dtype,lib,entry", [
    (torch.bfloat16, "flash_attention", "flash_attention_bf16"),
    (torch.float16, "flash_attention", "flash_attention_f16"),
    (torch.float32, "attention_f32", "flash_attention_f32")])
def test_k2_wrapper_dispatches_each_dtype_to_its_entry(stub_library, dtype, lib, entry):
    q, k, v = (torch.zeros(2, n, 3, 64, dtype=dtype) for n in (5, 7, 7))
    common.reset_launches(FL.flash_attention)
    out = FL._launch(q, k, v)
    ((name, called, args),) = stub_library
    assert (name, called) == (lib, entry)
    assert list(args[5:10]) == [2, 3, 5, 7, 64] and out.dtype == dtype
    assert FL.flash_attention.launches_by_dtype == {dtype: 1}


def test_entries_take_one_argument_list(monkeypatch):
    """The fp32 entries share the 16-bit entries' ctypes signature, so one call serves all
    three element types."""
    monkeypatch.setattr(build, "library", lambda name: _StubLibrary(name, []))
    for mod in (FA, FL):
        monkeypatch.setattr(mod, "_fns", {})
        fns = [mod._kernel_fn(dtype) for dtype in common.ATTENTION_DTYPES]
        assert len({tuple(f.argtypes) for f in fns}) == 1
        assert all(f.restype is ctypes.c_int for f in fns)


@pytest.mark.parametrize("case", ["fp64", "head_dim_96", "mixed_types", "no_keys"])
def test_kernels_refuse_what_they_do_not_take(case):
    """What a CUDA tensor would be refused for, before any launch: fp64, a head size without
    a kernel (K2's at 96; K1 takes 96 on ``fused_qk_attention_mma.cu`` and refuses widths
    past 256), operands of two types, no keys (the wrappers' checks run on CPU tensors
    here)."""
    d = 96 if case == "head_dim_96" else 128
    dtype = torch.float64 if case == "fp64" else torch.float32
    arrays = _k1_inputs(1, 9, 0 if case == "no_keys" else 9, 2, d=d)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in arrays[:3])
    if case == "mixed_types":
        k = k.half()
    tabs = [torch.from_numpy(t) for t in arrays[3:]]
    error = ValueError if case in ("head_dim_96", "no_keys") else TypeError
    if case == "head_dim_96":
        assert FA.kernel_route(q, k, v) == (True, (96, 16))
        wide = [torch.from_numpy(x) for x in _k1_inputs(1, 9, 9, 2, d=258)]
        with pytest.raises(error, match="256"):
            FA._launch(*wide, 1e-6)
    else:
        with pytest.raises(error):
            FA._launch(q, k, v, *tabs, 1e-6)
    with pytest.raises(error):
        FL._launch(q, k, v)


def test_check_operand_takes_each_dtypes_alignment():
    """16-byte rows: strides multiples of 8 elements in 16 bits, of 4 in fp32."""
    f32 = torch.zeros(2, 8, 4, 68)[..., :64]  # a row of 68 floats: 272 bytes
    assert common.check_operand("x", f32, common.ATTENTION_DTYPES) is None
    with pytest.raises(ValueError):
        common.check_operand("x", torch.zeros(2, 8, 4, 66)[..., :64], common.ATTENTION_DTYPES)
    with pytest.raises(ValueError):
        common.check_operand("x", torch.zeros(2, 8, 4, 68, dtype=torch.half)[..., :64],
                             common.ATTENTION_DTYPES)
    with pytest.raises(TypeError):  # K3's operands stay bf16
        common.check_operand("x", f32)


def test_true_fp32_holds_across_threads(monkeypatch):
    """Two threads enter and leave ``true_fp32`` interleaved (A in, B in, A out, B out): TF32
    stays off while either is inside, and both flags come back as they were only when the
    last one leaves. (Each thread saving its own copy would leave them as B saw them.)"""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    state = lambda: (torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.allow_tf32)
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with tnn.true_fp32():
            a_in.set()
            b_in.wait(10)
        seen["after_a"] = state()
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with tnn.true_fp32():
            b_in.set()
            a_out.wait(10)
            seen["b_after_a_left"] = state()

    threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads)
    assert seen["after_a"] == (False, False)  # B still inside
    assert seen["b_after_a_left"] == (False, False)
    assert state() == (True, True)
    assert tnn._fp32_depth == 0


def test_fp32_models_run_inside_true_fp32(monkeypatch):
    """The fp32 denoiser's forward and hoists run with TF32 off; a bf16 one's leave the
    flags alone."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    real = tmm.fused_qk_attention
    monkeypatch.setattr(tmm, "fused_qk_attention", lambda *a, **k: (
        seen.append(torch.backends.cuda.matmul.allow_tf32), real(*a, **k))[1])
    for dtype in (torch.float32, torch.bfloat16):
        model = tmm.init(TINY.model, torch.Generator().manual_seed(0), device="cpu",
                         dtype=dtype)
        rng = np.random.default_rng(9)
        x = torch.from_numpy(rng.normal(size=(1, 10, TINY.model.audio_vae_latent_dim))).to(dtype)
        cond = torch.zeros(1, 8, TINY.model.condition_dim, dtype=dtype)
        clip = torch.zeros(1, 4, TINY.model.clip_dim, dtype=dtype)
        sync = torch.zeros(1, 8, TINY.model.sync_feat_dim, dtype=dtype)
        with torch.no_grad():
            model(x, torch.tensor([500.0]), cond, clip, sync)
        blocks = TINY.model.depth_triple_blocks + TINY.model.depth_single_blocks
        assert seen == [dtype != torch.float32] * blocks, dtype
        seen.clear()
    assert torch.backends.cuda.matmul.allow_tf32
