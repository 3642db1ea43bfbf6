"""The port's quantized storage (``io/quantize.py``, ``ops/nn.py``) against the JAX package's
(``foley_tpu/io/quantize.py``, ``foley_tpu/ops/nn.py``) at the TINY config on the CPU.

Both sides quantize the same weights: the port's own init (zero leaves perturbed), carried
into a JAX tree by ``torch_helpers.jax_tree_from_port``. A JAX-quantized tree crosses back
through ``io/from_jax.py``; its codes and scales must equal the port's own quantization bit
for bit, with the same counts and bytes saved. A second config with ``sync_in_ksz = 3``
holds the per-tap int8 scales of a conv outside the blocks (the shipped configs have 1).

Tolerances: dense and forward in fp32 at atol 1e-5 / rtol 1e-4 for the weight-only modes
(the dequant is the same elementwise product on both sides; the products are summed in
another order). int8_dynamic's integer accumulator is equal exactly; its forward is held at
a relative L2 of 1e-3 (it reads 1.9e-7 here), because the JAX forward runs its activation
quantization inside compiled block scans, where XLA may divide by 127 through a reciprocal
(a jitted ``max / 127.0`` differs from the eager one in the last place): one code that
rounds the other way moves a product by a whole step of the activation's scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.io import quantize as jq
from foley_tpu.models import mmdit as jmm
from foley_tpu.ops import nn as jnn
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.core.params import param_bytes, perturb_zero_leaves
from foley_tpu_torch.io import quantize as tq
from foley_tpu_torch.io.from_jax import mmdit_from_jax, state_dict_from_jax
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.ops import nn as tnn
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

MODES = ("fp8_e4m3fn", "fp8_e5m2", "int8", "int8_dynamic", "int4")
TOL = dict(atol=1e-5, rtol=1e-4)
DYN_FORWARD_REL = 1e-3
CFGS = {"tiny": (TINY.model, J_TINY.model),
        "tiny_ksz3": (dataclasses.replace(TINY.model, sync_in_ksz=3),
                      dataclasses.replace(J_TINY.model, sync_in_ksz=3))}


def _port(cfg, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return perturb_zero_leaves(tmm.init(cfg, g, device="cpu"), g).to(dtype)


@pytest.fixture(scope="module")
def trees():
    """{config: (port fp32 model's state, its JAX tree)}."""
    out = {}
    for name, (cfg, j_cfg) in CFGS.items():
        model = _port(cfg)
        out[name] = model.state_dict(), jax_tree_from_port(model, jmm.init, j_cfg)
    return out


def _model(state, cfg, dtype):
    model = tmm.MMDiT(cfg, device="cpu")
    model.load_state_dict(state)
    return model.to(dtype)


def _jax_quantized(tree, mode, dtype):
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jq.quantize_params(jax.tree.map(lambda a: jnp.asarray(a, jdtype), tree), mode)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("config", sorted(CFGS))
@pytest.mark.parametrize("mode", MODES)
def test_storage_equals_jax_bit_for_bit(trees, mode, config, dtype):
    state, tree = trees[config]
    cfg = CFGS[config][0]
    j_params, j_counts, j_saved = _jax_quantized(tree, mode, dtype)
    model = _model(state, cfg, dtype)
    before = param_bytes(model)
    counts, saved = tq.quantize_params(model, mode)
    assert counts == j_counts and saved == j_saved
    assert before - param_bytes(model) == saved
    bridged = state_dict_from_jax(jax.device_get(j_params))
    got = model.state_dict()
    assert set(got) == set(bridged)
    for k, v in got.items():
        assert v.dtype == bridged[k].dtype and v.shape == bridged[k].shape, k
        assert torch.equal(v.view(torch.uint8) if v.element_size() == 1 else v,
                           bridged[k].view(torch.uint8) if v.element_size() == 1
                           else bridged[k]), k
    kinds = {k.rsplit(".", 1)[1] for k in got if "weight_" in k}
    if mode.startswith("fp8"):
        assert not kinds and any(v.dtype == tq.FP8_DTYPES[mode] for v in got.values())
    else:
        assert kinds == {"weight_" + {"int8_dynamic": "int8_dyn"}.get(mode, mode),
                         "weight_scale"}


def test_per_tap_scales_of_a_conv_outside_the_blocks(trees):
    """The JAX rule gives a non-stacked conv one int8 scale per (tap, output channel), a
    block's conv one per output channel."""
    state, _ = trees["tiny_ksz3"]
    model = _model(state, CFGS["tiny_ksz3"][0], torch.float32)
    tq.quantize_params(model, "int8")
    w1 = model.sync_in.conv_mlp.w1
    assert w1.weight_scale.shape == (w1.weight_int8.shape[0], 1, 3)
    lin = model.single_blocks[0].linear1
    assert lin.weight_scale.shape == (lin.weight_int8.shape[0], 1, 1)
    tq.quantize_params(m4 := _model(state, CFGS["tiny_ksz3"][0], torch.float32), "int4")
    assert m4.sync_in.conv_mlp.w1.weight_scale.shape[-1] == 3  # int4 groups are per tap


DENIED = ("final_layer.linear", "final_layer.adaLN", "triple_blocks.0.audio_cross_q",
          "triple_blocks.1.v_cond_cross_q", "triple_blocks.0.audio_cross_proj",
          "triple_blocks.1.v_cond_cross_proj", "visual_proj.w1", "visual_proj.w3")
TAKEN = ("triple_blocks.0.audio_self_attn_qkv", "single_blocks.3.linear_qkv",
         "single_blocks.0.linear1", "single_blocks.2.linear2.w2", "time_in.mlp_0",
         "cond_in.linear_1", "audio_embedder")


@pytest.mark.parametrize("mode", MODES)
def test_deny_list(trees, mode):
    state, _ = trees["tiny"]
    model = _model(state, TINY.model, torch.float32)
    tq.quantize_params(model, mode)
    modules = dict(model.named_modules())
    for name in DENIED:
        w = modules[name].stored_weight()
        assert isinstance(w, torch.Tensor) and w.dtype == torch.float32, name
    for name in TAKEN:
        w = modules[name].stored_weight()
        assert isinstance(w, tnn.QuantizedWeight) or w.dtype in tq.FP8_DTYPES.values(), name
    for name, p in model.named_parameters():  # norms, biases, empty features
        if "norm" in name or name.endswith("bias") or "empty" in name or "pos_emb" in name:
            assert p.dtype == torch.float32, name


def _leaf(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layer", ["triple_blocks.audio_self_attn_qkv", "time_in.mlp_0"])
def test_dense_matches_jax(trees, mode, layer):
    state, tree = trees["tiny"]
    j_params, _, _ = _jax_quantized(tree, mode, torch.float32)
    model = _model(state, TINY.model, torch.float32)
    tq.quantize_params(model, mode)
    j_w = _leaf(j_params, layer + ".w")
    j_b = _leaf(j_params, layer + ".b")
    module = dict(model.named_modules())[layer.replace("blocks.", "blocks.1.")]
    if layer.startswith("triple_blocks"):
        j_w = jax.tree.map(lambda a: a[1], j_w)
        j_b = j_b[1]
    cin = _leaf(tree, layer + ".w").shape[-2]
    rng = np.random.default_rng(7)
    for rows in ((6,), (2, 3), (1,)):
        x = rng.normal(size=rows + (cin,)).astype(np.float32)
        ref = np.asarray(jnn.dense(jnp.asarray(x), j_w, j_b))
        got = tnn.dense(torch.from_numpy(x), module.stored_weight(), module.bias).numpy()
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("rows", [1, 2, 17, 250])
def test_int8_dynamic_accumulator_is_exact(trees, rows):
    state, tree = trees["tiny"]
    j_params, _, _ = _jax_quantized(tree, "int8_dynamic", torch.float32)
    model = _model(state, TINY.model, torch.float32)
    tq.quantize_params(model, "int8_dynamic")
    w = model.triple_blocks[0].audio_mlp.fc2.stored_weight()
    j_w = _leaf(j_params, "triple_blocks.audio_mlp.fc2.w")
    x = np.random.default_rng(rows).normal(size=(rows, w.q.shape[1])).astype(np.float32) * 3
    jx, jsx = jnn._quantize_act(jnp.asarray(x))
    tx, tsx = tnn.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    j_acc = jnp.einsum("...i,io->...o", jx, j_w["int8_dyn"][0],
                       preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(tnn.int_mm(tx, w.q).numpy(), np.asarray(j_acc))


@pytest.mark.parametrize("rows", list(range(1, 17)))
def test_int_mm_pads_rows(rows):
    """``int_mm`` pads to the card's ``_int_mm`` rules (more than 16 rows, K and N multiples
    of 8) and cuts back: the int32 product of every row count equals the exact one."""
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(rng.integers(-127, 128, (rows, 60), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (20, 60), dtype=np.int8))
    got = tnn.int_mm(a, w)
    assert got.dtype == torch.int32 and got.shape == (rows, 20)
    assert torch.equal(got, a.int() @ w.int().t())


def _inputs():
    rng = np.random.default_rng(4)
    return (rng.normal(size=(2, 20, TINY.model.audio_vae_latent_dim)).astype(np.float32),
            np.asarray([500.0, 300.0], np.float32),
            rng.normal(size=(2, 8, TINY.model.condition_dim)).astype(np.float32),
            rng.normal(size=(2, 4, TINY.model.clip_dim)).astype(np.float32),
            rng.normal(size=(2, 8, TINY.model.sync_feat_dim)).astype(np.float32))


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax(trees, mode):
    """A quantized tiny forward through the bridged JAX-quantized tree against
    ``mmdit.apply`` on that tree."""
    _, tree = trees["tiny"]
    j_params, _, _ = _jax_quantized(tree, mode, torch.float32)
    model = mmdit_from_jax(jax.device_get(j_params), TINY.model, device="cpu")
    w = model.triple_blocks[0].audio_self_attn_qkv.stored_weight()
    assert isinstance(w, tnn.QuantizedWeight) or w.dtype in tq.FP8_DTYPES.values()
    arrays = _inputs()
    ref = np.asarray(jmm.apply(j_params, *(jnp.asarray(a) for a in arrays), J_TINY.model,
                               attn_impl="xla"))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in arrays)).numpy()
    assert float(np.std(ref)) > 0.1
    if mode == "int8_dynamic":
        rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        assert rel <= DYN_FORWARD_REL, rel
    else:
        np.testing.assert_allclose(got, ref, **TOL)


def test_int8_generation_matches_jax(trees, monkeypatch):
    """int8 ``generate_audio`` end to end (``tests/test_io.py::
    test_int8_end_to_end_generation``), against the JAX generation on the same quantized
    tree and noise."""
    from foley_tpu.models import dac_vae as jdac
    from foley_tpu.pipeline import generate as jgen
    from foley_tpu_torch.io.from_jax import dac_from_jax
    from foley_tpu_torch.pipeline import generate as tgen
    from torch_helpers import jax_latents

    _, tree = trees["tiny"]
    j_params, _, _ = _jax_quantized(tree, "int8", torch.float32)
    # the DAC's conv weights scaled by 0.65 keep the decode out of tanh's saturation, where
    # the last place of a latent decides the sign of a clipped sample (test_torch_edit.py)
    dac = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * 0.65 if path[-1].key == "w" else np.asarray(x),
        jax.device_get(jax.jit(jdac.init, static_argnums=1)(jax.random.PRNGKey(1),
                                                            J_TINY.dac)))
    j_bundle = jgen.ModelBundle(mmdit_params=j_params, dac_params=dac, pipeline_cfg=J_TINY,
                                compute_dtype=jnp.float32)
    t_bundle = tgen.ModelBundle(mmdit_from_jax(jax.device_get(j_params), TINY.model,
                                               device="cpu"),
                                dac_from_jax(dac, TINY.dac, device="cpu"), TINY,
                                compute_dtype=torch.float32)
    text = np.random.default_rng(3).normal(size=(1, 16, TINY.model.condition_dim)).astype(
        np.float32)
    ref = jgen.generate_audio(j_bundle, jnp.asarray(text), jnp.asarray(text), 1.0,
                              num_inference_steps=2, batch_size=1, seed=0, return_latents=True)
    monkeypatch.setattr(tgen, "prepare_latents", jax_latents(0))
    got = tgen.generate_audio(t_bundle, torch.from_numpy(text), torch.from_numpy(text), 1.0,
                              num_inference_steps=2, batch_size=1, seed=0, return_latents=True)
    assert got.audio_batch.shape == (1, 1, 48000) and np.isfinite(got.audio_batch).all()
    assert float(np.abs(got.audio_batch).max()) > 0
    np.testing.assert_allclose(got.latents, np.asarray(ref.latents), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got.audio_batch, np.asarray(ref.audio_batch), atol=1e-4, rtol=0)


def test_unknown_mode_raises(trees):
    state, _ = trees["tiny"]
    with pytest.raises(ValueError, match="unknown quantization"):
        tq.quantize_params(_model(state, TINY.model, torch.float32), "int3")


@pytest.mark.parametrize("group_size", [16, 32])
def test_int4_groups_equal_jax(trees, group_size):
    """Narrower int4 groups than the default 128 (several a weight at TINY's widths)."""
    state, tree = trees["tiny"]
    j_params, j_counts, j_saved = jq.quantize_int4(
        jax.tree.map(jnp.asarray, tree), group_size=group_size)
    model = _model(state, TINY.model, torch.float32)
    assert tq.quantize_int4(model, group_size=group_size) == (j_counts, j_saved)
    bridged = state_dict_from_jax(jax.device_get(j_params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, bridged[k]), k
    assert model.single_blocks[0].linear_qkv.weight_scale.shape[1] == 64 // group_size
