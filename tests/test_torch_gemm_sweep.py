"""K3's plain version and the GEMM sweep probe against the TPU tool ``tools/probe_gemm_pallas.py``.

The tool builds both of its variants inside ``main()`` for a TPU, so they are restated here
in ``jnp`` with the line each follows: the Pallas body (fp32 products, tanh, one rounding to
bf16), also run as a copy of the body under ``pallas_call(interpret=True)``, and
``xla_sweep`` (a bf16 product, then tanh). Inputs are drawn with numpy from a seed.

Tolerances. bf16, a few chained blocks: max abs 2e-2 (the tool's own limit at :122; tanh
bounds every output by 1) and relative L2 1e-2, because the two sides sum the same fp32
products in another order and a flipped bf16 rounding carries forward through the chain.
fp32 end to end: atol 1e-5, the same products summed in another order.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from foley_tpu_torch.ops.kernels import gemm_sweep as GS
from foley_tpu_torch.tools import bench_kernels, probe_gemm
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
MAX_ABS, REL_L2 = 2e-2, 1e-2
K, N, BLOCKS = 64, 192, 3  # three 64-column tiles a block, of which the chain uses the first


def _draw(m, k=K, n=N, blocks=BLOCKS, seed=0):
    """The tool's draw (probe_gemm_pallas.py:50-54), at a small size, in float64."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, k)), rng.normal(size=(blocks, k, n)) / np.sqrt(k)


def pallas_body_sweep(x, w):
    k = x.shape[1]
    for b in range(w.shape[0]):
        y = jnp.dot(x, w[b, :, :k], preferred_element_type=jnp.float32)  # :79, head tiles :81
        x = jnp.tanh(y).astype(x.dtype)  # :83
    return x


def pallas_interpret_sweep(x, w, tile_n=64):
    """The Pallas body (:70-91) as written, without its memory spaces and compiler params."""
    m, k = x.shape
    blocks, _, n = w.shape
    n_tiles, head_tiles = n // tile_n, k // tile_n  # :67-68

    def kernel(xin_ref, w_ref, o_ref, x_ref, head_ref):
        b, j = pl.program_id(0), pl.program_id(1)

        @pl.when((b == 0) & (j == 0))
        def _():
            x_ref[:] = xin_ref[:]

        y = jnp.dot(x_ref[:], w_ref[0], preferred_element_type=jnp.float32)

        @pl.when(j < head_tiles)
        def _():
            head_ref[:, pl.ds(j * tile_n, tile_n)] = jnp.tanh(y).astype(jnp.bfloat16)

        @pl.when(j == n_tiles - 1)
        def _():
            x_ref[:] = head_ref[:]

        @pl.when((b == blocks - 1) & (j == n_tiles - 1))
        def _():
            o_ref[:] = head_ref[:]

    return pl.pallas_call(
        kernel, grid=(blocks, n_tiles),
        in_specs=[pl.BlockSpec((m, k), lambda b, j: (0, 0)),
                  pl.BlockSpec((1, k, tile_n), lambda b, j: (b, 0, j))],
        out_specs=pl.BlockSpec((m, k), lambda b, j: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((m, k), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((m, k), jnp.bfloat16), pltpu.VMEM((m, k), jnp.bfloat16)],
        interpret=True)(x, w)


def xla_sweep(x, w):
    k = x.shape[1]
    for b in range(w.shape[0]):
        y = jnp.dot(x, w[b], preferred_element_type=jnp.bfloat16)  # :62
        x = jnp.tanh(y[:, :k]).astype(jnp.bfloat16)  # chain, :57
    return x


def _bf16_pair(m, seed=0):
    x, w = _draw(m, seed=seed)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    return (jx, jw), (tx, tw)


def _assert_close(got: torch.Tensor, ref) -> None:
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    diff = got.float() - ref
    assert float(diff.abs().max()) <= MAX_ABS
    assert float(diff.norm()) <= REL_L2 * float(ref.norm())


@pytest.mark.parametrize("m", [40, 1])
def test_plain_matches_pallas_body(m):
    (jx, jw), (tx, tw) = _bf16_pair(m)
    _assert_close(GS.gemm_sweep(tx, tw), pallas_body_sweep(jx, jw))  # CPU: the plain version


@pytest.mark.parametrize("m", [40, 1])
def test_plain_matches_pallas_interpret(m):
    (jx, jw), (tx, tw) = _bf16_pair(m, seed=1)
    _assert_close(GS.gemm_sweep_plain(tx, tw), pallas_interpret_sweep(jx, jw))


def test_plain_fp32_matches_pallas_body():
    x, w = _draw(24, seed=2)
    x, w = x.astype(np.float32), w.astype(np.float32)
    ref = pallas_body_sweep(jnp.asarray(x), jnp.asarray(w))
    got = GS.gemm_sweep(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_plain_sums_in_fp64_when_asked():
    """The drift reference: the same chain with fp64 sums, rounded to x's type per block."""
    x, w = (a.astype(np.float32) for a in _draw(24, seed=6))
    ref = x
    for b in range(BLOCKS):
        ref = np.tanh(ref.astype(np.float64) @ w[b, :, :K].astype(np.float64)).astype(np.float32)
    got = GS.gemm_sweep_plain(torch.from_numpy(x), torch.from_numpy(w), torch.float64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("m", [40, 1])
def test_library_sweep_matches_xla_sweep(m):
    (jx, jw), (tx, tw) = _bf16_pair(m, seed=3)
    _assert_close(probe_gemm.library_sweep(tx, tw), xla_sweep(jx, jw))


def test_library_sweep_full_matches_xla_sweep():
    (jx, jw), (tx, tw) = _bf16_pair(40, seed=4)
    _assert_close(probe_gemm.library_sweep_full(tx, tw), xla_sweep(jx, jw))


def test_cpu_call_launches_nothing():
    _, (tx, tw) = _bf16_pair(8, seed=5)
    before = GS.gemm_sweep.launches
    GS.gemm_sweep(tx, tw)
    assert GS.gemm_sweep.launches == before


def test_wrapper_refuses_other_devices():
    x, w = torch.zeros(4, 64, device="meta"), torch.zeros(2, 64, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        GS.gemm_sweep(x, w)


@pytest.mark.parametrize("x_shape,w_shape", [((4, 64), (2, 32, 128)), ((4, 64), (2, 64, 32)),
                                             ((4, 64, 1), (2, 64, 128)), ((4, 64), (64, 128))])
def test_shapes_the_sweep_does_not_take_raise(x_shape, w_shape):
    with pytest.raises(ValueError):
        GS.gemm_sweep(torch.zeros(x_shape), torch.zeros(w_shape))


@pytest.mark.parametrize("case,error", [
    ("fp32", TypeError), ("fp16", TypeError), ("k_48", ValueError), ("w_transposed", ValueError),
    ("x_row_stride_68", ValueError), ("x_pointer_2_bytes_off", ValueError),
    ("m_0", ValueError), ("blocks_0", ValueError),
])
def test_kernel_preconditions_raise_before_any_launch(case, error):
    """What the CUDA kernel does not take raises in the wrapper, before the library is built
    or called: checked here on CPU tensors through the launch path itself."""
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.zeros(2, 64, 128, dtype=torch.bfloat16)
    if case in ("fp32", "fp16"):
        dtype = torch.float32 if case == "fp32" else torch.float16
        x, w = x.to(dtype), w.to(dtype)
    elif case == "k_48":
        x, w = x[:, :48].contiguous(), w[:, :48].contiguous()
    elif case == "w_transposed":
        w = torch.zeros(2, 128, 64, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "x_row_stride_68":
        x = torch.zeros(4, 68, dtype=torch.bfloat16)[:, :64]
    elif case == "m_0":
        x = x[:0]
    elif case == "blocks_0":
        w = w[:0]
    else:
        x = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:].view(4, 64)
    before = GS.gemm_sweep.launches
    with pytest.raises(error):
        GS._launch(x, w)
    assert GS.gemm_sweep.launches == before


def test_constants_match_the_tool():
    spec = importlib.util.spec_from_file_location("probe_gemm_pallas",
                                                  ROOT / "tools" / "probe_gemm_pallas.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)  # its top level imports json, sys, time and numpy only
    assert (probe_gemm.M, probe_gemm.K, probe_gemm.N, probe_gemm.BLOCKS) == (
        tool.M, tool.K, tool.N, tool.BLOCKS)


def test_bench_times_k3_at_the_probe_shape():
    """The kernels' bench times K3 at the probe's shape, the full sweep last of its cuts."""
    assert bench_kernels.K3_SHAPE == (probe_gemm.M, probe_gemm.K, probe_gemm.N,
                                      probe_gemm.BLOCKS)
    assert bench_kernels.K3_BLOCKS[-1] == probe_gemm.BLOCKS
    assert list(bench_kernels.K3_BLOCKS) == sorted(set(bench_kernels.K3_BLOCKS))


@pytest.fixture
def small_probe(monkeypatch):
    for name, value in dict(M=16, K=32, N=96, BLOCKS=2, ITERS=1, PLAIN_ITERS=1).items():
        monkeypatch.setattr(probe_gemm, name, value)


def test_make_inputs_draws_as_the_tool(small_probe):
    x, w = probe_gemm.make_inputs("cpu", seed=7)
    rx, rw = _draw(16, 32, 96, 2, seed=7)
    for got, ref in ((x, rx), (w, rw)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jnp.asarray(ref, jnp.bfloat16), np.float32))


def test_floors_at_the_probe_shape():
    head = probe_gemm.floors(2 * 36 * 784 * 1536 * 1536, 36 * 1536 * 1536 * 2)
    assert head["flops"] == 133_177_540_608
    assert head["compute_floor_ms"] == pytest.approx(0.13466, abs=1e-5)
    assert head["weight_stream_floor_ms"] == pytest.approx(0.050707, abs=1e-5)
    full = probe_gemm.floors(2 * 36 * 784 * 1536 * 4608, 36 * 1536 * 4608 * 2)
    assert full["compute_floor_ms"] == pytest.approx(0.40398, abs=1e-5)


def test_measure_on_the_cpu(small_probe):
    rec = probe_gemm.measure("cpu")
    assert rec["device"] == "cpu" and rec["launches_per_sweep"] == 0  # the plain path
    assert rec["max_abs_err"] == 0.0 and rec["rel_l2_err"] == 0.0
    assert rec["flops"] == 2 * 2 * 16 * 32 * 32 and rec["full_width"]["flops"] == 3 * rec["flops"]
    for name in ("kernel", "library_sweep", "library_sweep_full", "plain"):
        assert rec[name]["ms_per_sweep"] > 0 and rec[name]["tflops"] > 0
    assert rec["kernel_speedup"] > 0
    assert rec["kernel"]["graph_ms_per_sweep"] is None and rec["kernel_speedup_graph"] is None
    assert rec["kernel_sweeps"] == 3  # the checked sweep, the warm-up, one timed


def test_main_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the probe runs there by default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_gemm.main([])
