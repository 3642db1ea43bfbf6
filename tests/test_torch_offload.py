"""The port's block swap (``parallel/offload.py``) on the CPU at the TINY config (2 triple +
4 single blocks), mirroring the JAX package's tests (``tests/test_aux.py``), which skip here
for want of a ``pinned_host`` memory kind.

On the CPU host and device are one, so the swapped blocks are copied into the device slots
with plain copies and no streams: what is held is the split, the slot bookkeeping and the
window. A swapped forward must equal the port's resident forward exactly (``torch.equal``:
the same ops on the same bits), and the JAX package's unsplit forward within the fp32
tolerance of ``tests/test_torch_mmdit.py`` (atol 1e-5 / rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import mmdit as jmm
from foley_tpu_torch.api import nodes as tnodes
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.core.params import perturb_zero_leaves
from foley_tpu_torch.io.quantize import quantize_params
from foley_tpu_torch.models import dac_vae, mmdit
from foley_tpu_torch.parallel import offload
from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
CFG = TINY.model


def _model():
    g = torch.Generator().manual_seed(0)
    return perturb_zero_leaves(mmdit.init(CFG, g, device="cpu"), g)


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(2, 20, CFG.audio_vae_latent_dim)).astype(np.float32),
            np.asarray([500.0, 200.0], np.float32),
            rng.normal(size=(2, 8, CFG.condition_dim)).astype(np.float32),
            rng.normal(size=(2, 4, CFG.clip_dim)).astype(np.float32),
            rng.normal(size=(2, 8, CFG.sync_feat_dim)).astype(np.float32))


def _forward(model, **kw):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in _inputs()), **kw)


@pytest.fixture(scope="module")
def reference():
    """(resident port velocity, JAX unsplit velocity) of ``_model()``."""
    model = _model()
    tree = jax_tree_from_port(model, jmm.init, J_TINY.model)
    ref = np.asarray(jmm.apply(tree, *(jnp.asarray(a) for a in _inputs()), J_TINY.model,
                               attn_impl="xla"))
    return _forward(model), ref


def _data_ptrs(block):
    return [t.data_ptr() for t in offload.block_tensors(block).values()]


def test_splits_take_the_suffix_singles_first(reference):
    resident, ref = reference
    model = _model()
    offload.offload_block_suffix(model, 3)
    assert offload.swapped_blocks(model, "triple_blocks") == []
    assert offload.swapped_blocks(model, "single_blocks") == [1, 2, 3]
    assert torch.equal(_forward(model), resident)
    offload.offload_block_suffix(model, 5)  # past the single stack: the triple tail too
    assert offload.swapped_blocks(model, "triple_blocks") == [1]
    assert offload.swapped_blocks(model, "single_blocks") == [0, 1, 2, 3]
    got = _forward(model)
    assert torch.equal(got, resident)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    offload.offload_block_suffix(model, 99)  # clamped to the 6 blocks
    assert offload.partition_report(model)["host_blocks"] == 6
    assert torch.equal(_forward(model), resident)


def test_changing_n_moves_only_the_blocks_that_change_place(reference):
    resident, _ = reference
    model = _model()
    offload.offload_block_suffix(model, 5)
    kept = {i: _data_ptrs(model.single_blocks[i]) for i in (2, 3)}
    triple0 = _data_ptrs(model.triple_blocks[0])
    offload.offload_block_suffix(model, 2)  # shrink in place
    assert offload.swapped_blocks(model, "triple_blocks") == []
    assert offload.swapped_blocks(model, "single_blocks") == [2, 3]
    assert all(_data_ptrs(model.single_blocks[i]) == kept[i] for i in (2, 3))
    assert _data_ptrs(model.triple_blocks[0]) == triple0
    assert torch.equal(_forward(model), resident)
    offload.offload_block_suffix(model, 4)  # grow in place
    assert offload.swapped_blocks(model, "single_blocks") == [0, 1, 2, 3]
    assert all(_data_ptrs(model.single_blocks[i]) == kept[i] for i in (2, 3))
    assert torch.equal(_forward(model), resident)


def test_merge_block_suffix(reference):
    resident, _ = reference
    model = _model()
    offload.offload_block_suffix(model, 5)
    assert offload.merge_block_suffix(model) is model and model.block_swap is None
    assert offload.partition_report(model)["host_blocks"] == 0
    assert torch.equal(_forward(model), resident)
    offload.offload_block_suffix(model, 3)
    offload.offload_block_suffix(model, 0)  # 0 merges too
    assert model.block_swap is None


@pytest.mark.parametrize("n", [3, 5, 6])
@pytest.mark.parametrize("window", [1, 2, 3, 99])
def test_windows_are_exact(reference, n, window):
    resident, ref = reference
    model = _model()
    offload.offload_block_suffix(model, n)
    got = _forward(model, offload_prefetch=window)
    assert torch.equal(got, resident)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    for family in offload.FAMILIES:
        swapped = offload.swapped_blocks(model, family)
        slots = model.block_swap.families[family].slots
        assert len(slots) == (min(window, len(swapped)) if swapped else 0)


def test_hoists_are_none_when_the_triple_stack_is_split():
    model = _model()
    cond = torch.from_numpy(_inputs()[2])
    ts = torch.tensor([900.0, 500.0])
    offload.offload_block_suffix(model, 4)  # singles only: the hoists stay
    assert model.precompute_text_kv(cond) is not None
    assert model.precompute_triple_mods(ts, torch.float32) is not None
    offload.offload_block_suffix(model, 5)
    assert model.precompute_text_kv(cond) is None
    assert model.precompute_triple_mods(ts, torch.float32) is None


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_swap_composes_with_quantized_storage(mode):
    model = _model()
    quantize_params(model, mode)
    resident = _forward(model)
    full = offload.partition_report(model)
    offload.offload_block_suffix(model, 5)
    rep = offload.partition_report(model)
    assert rep["host_blocks"] == 5 and rep["host_mb"] > 0
    np.testing.assert_allclose(rep["host_mb"] + rep["device_mb"], full["device_mb"], rtol=1e-9)
    host = model.single_blocks[3]
    assert any("weight_" in n for n, _ in host.named_buffers())
    for window in (1, 2):
        assert torch.equal(_forward(model, offload_prefetch=window), resident)


def _deps():
    return {"dac_params": dac_vae.init(TINY.dac, torch.Generator().manual_seed(1),
                                       device="cpu"), "dac_cfg": TINY.dac}


SAMPLER_KW = dict(duration=1.0, prompt="x", steps=2, batch_size=1, seed=0,
                  allow_unconditioned=True)


def test_sampler_split_persists_and_zero_merges():
    fm = tnodes.HunyuanModelLoader.init_random("tiny", "fp32", 0, perturb=True, device="cpu")
    deps = _deps()
    sampler = tnodes.HunyuanFoleySampler()
    plain, _ = sampler.generate_audio(fm, deps, force_offload=False, **SAMPLER_KW)
    (swap,) = tnodes.HunyuanBlockSwap().set_args(blocks_to_swap=3, prefetch_blocks=1)
    first, _ = sampler.generate_audio(fm, deps, block_swap_args=swap, force_offload=False,
                                      **SAMPLER_KW)
    assert offload.swapped_blocks(fm["params"], "single_blocks") == [1, 2, 3]
    assert first["waveform"].tobytes() == plain["waveform"].tobytes()
    (zero,) = tnodes.HunyuanBlockSwap().set_args(blocks_to_swap=0)
    again, _ = sampler.generate_audio(fm, deps, block_swap_args=zero, force_offload=False,
                                      **SAMPLER_KW)
    assert fm["params"].block_swap is None
    assert again["waveform"].tobytes() == plain["waveform"].tobytes()


def test_force_offload_leaves_the_swapped_blocks_in_host_memory():
    fm = tnodes.HunyuanModelLoader.init_random("tiny", "fp32", 0, perturb=True, device="cpu")
    deps = _deps()
    sampler = tnodes.HunyuanFoleySampler()
    (swap,) = tnodes.HunyuanBlockSwap().set_args(blocks_to_swap=5)
    first, _ = sampler.generate_audio(fm, deps, block_swap_args=swap, force_offload=True,
                                      **SAMPLER_KW)
    model = fm["params"]
    swapped = {i: _data_ptrs(model.single_blocks[i]) for i in range(4)}
    host = fm["_host"]
    assert fm["_offloaded"] and not any(k.startswith("single_blocks.") for k in host.views)
    assert not any(k.startswith("triple_blocks.1.") for k in host.views)
    assert any(k.startswith("triple_blocks.0.") for k in host.views)
    second, _ = sampler.generate_audio(fm, deps, block_swap_args=swap, force_offload=True,
                                       **SAMPLER_KW)
    assert fm["_host"] is host  # the same buffers: the swap did not change
    assert all(_data_ptrs(model.single_blocks[i]) == swapped[i] for i in range(4))
    assert offload.swapped_blocks(model, "triple_blocks") == [1]
    assert second["waveform"].tobytes() == first["waveform"].tobytes()


def test_bundle_window_reaches_the_forward(monkeypatch):
    """``ModelBundle.offload_prefetch`` is the window every denoise step asks for."""
    model = _model()
    offload.offload_block_suffix(model, 4)
    seen = []
    real = offload.stream_blocks

    def spy(m, family, window=1):
        seen.append(window)
        return real(m, family, window)

    monkeypatch.setattr(mmdit.offload, "stream_blocks", spy)
    bundle = ModelBundle(model, _deps()["dac_params"], TINY, compute_dtype=torch.float32,
                         offload_prefetch=3)
    text = torch.zeros(1, 16, CFG.condition_dim)
    generate_audio(bundle, text, text, 1.0, num_inference_steps=2)
    assert seen and set(seen) == {3}


def test_unpinned_host_buffers_raise(monkeypatch):
    """On a card, a block whose host buffers could not be page-locked is refused (and put
    back), never streamed from pageable memory."""
    model = _model()
    model.block_swap = offload.BlockSwap(torch.device("cuda"))
    restored = []

    class Pageable:
        pinned = False

    monkeypatch.setattr(offload, "park", lambda block: Pageable())
    monkeypatch.setattr(offload, "restore", lambda block, device: restored.append(block))
    with pytest.raises(RuntimeError, match="page-lock"):
        offload.offload_block_suffix(model, 2)
    assert restored == [model.single_blocks[2]]
    assert offload.swapped_blocks(model, "single_blocks") == []
