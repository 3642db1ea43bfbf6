"""The port's MMDiT against the JAX ``mmdit.apply`` at the TINY config, on the CPU.

The JAX parameters pass through ``io/from_jax.py``. Every leaf that is zero at init (adaLN
and final layers, empty features, the sync position embedding) is replaced with seeded
values and the qk-norm weights (ones at init) with seeded values in [0.5, 1.5], so the
modulation, the gates and the per-stream norm tables all reach the velocity.

The port always takes the fused qk-norm + RoPE attention (its plain version on the CPU);
it is held against JAX ``attn_impl="pallas_fused"`` with the Pallas kernel in interpret mode
and against ``attn_impl="xla"``. fp32 atol 1e-5 / rtol 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import foley_tpu.ops.pallas.fused_attention as JFA
from foley_tpu.configs import TINY as J_TINY
from foley_tpu.core.params import param_count as jax_param_count
from foley_tpu.models import mmdit as jmm
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.core.params import param_count, perturb_zero_leaves
from foley_tpu_torch.io.from_jax import mmdit_from_jax
from foley_tpu_torch.models import mmdit as tmm
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

CFG, J_CFG = TINY.model, J_TINY.model
TOL = dict(atol=1e-5, rtol=1e-4)


def seeded_tree(params, seed):
    """Host copy of a JAX tree with its zero leaves and its norm weights made random."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        x = np.array(x)
        if not np.any(x):
            return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
        if path[-1].key == "weight":  # qk-norm weights: ones at init
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(params))


@pytest.fixture(scope="module")
def models():
    params = seeded_tree(jax.jit(jmm.init, static_argnums=1)(jax.random.PRNGKey(0), J_CFG), seed=3)
    return params, mmdit_from_jax(params, CFG, device="cpu")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JFA, "fused_qk_attention",
                        functools.partial(JFA.fused_qk_attention, interpret=True))


def _inputs(shared_visuals: bool, same_t: bool):
    rng = np.random.default_rng(4)
    b, t = 2, 20
    x = rng.normal(size=(b, t, CFG.audio_vae_latent_dim)).astype(np.float32)
    ts = np.asarray([500.0, 500.0] if same_t else [500.0, 100.0], np.float32)
    cond = rng.normal(size=(b, 8, CFG.condition_dim)).astype(np.float32)
    clip = rng.normal(size=(b, 4, CFG.clip_dim)).astype(np.float32)
    sync = rng.normal(size=(b, 8, CFG.sync_feat_dim)).astype(np.float32)
    if shared_visuals:  # T2A: the two CFG halves carry the same visual rows
        clip, sync = np.repeat(clip[:1], 2, 0), np.repeat(sync[:1], 2, 0)
    return x, ts, cond, clip, sync


@pytest.mark.parametrize("hoists", [False, True])
@pytest.mark.parametrize("visual_rows_shared", [False, True])
def test_forward_matches_jax(models, interpret, hoists, visual_rows_shared):
    params, model = models
    arrays = _inputs(visual_rows_shared, same_t=hoists)
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a) for a in arrays]
    jkw, tkw = {}, {}
    if hoists:
        t0 = jnp.asarray(arrays[1][:1])
        a_mods, v_mods = jmm.precompute_triple_mods(params, t0, J_CFG, jnp.float32)
        jkw = dict(text_kv=jmm.precompute_text_kv(params, jargs[2], J_CFG),
                   triple_mods=(a_mods[0], v_mods[0]))
        ta, tv = model.precompute_triple_mods(targs[1][:1], torch.float32)
        tables = model.attention_tables(arrays[0].shape[1] // CFG.patch_size,
                                        arrays[3].shape[1], arrays[2].shape[1])
        tkw = dict(text_kv=model.precompute_text_kv(targs[2]), triple_mods=(ta[0], tv[0]),
                   tables=tables)
    ref = {impl: np.asarray(jmm.apply(params, *jargs, J_CFG, attn_impl=impl,
                                      visual_rows_shared=visual_rows_shared, **jkw))
           for impl in ("pallas_fused", "xla")}
    with torch.no_grad():
        got = model(*targs, visual_rows_shared=visual_rows_shared, **tkw).numpy()
    assert float(np.std(ref["xla"])) > 0.1  # signal actually flows
    np.testing.assert_allclose(got, ref["pallas_fused"], **TOL)
    np.testing.assert_allclose(got, ref["xla"], **TOL)


def test_forward_bf16_matches_jax(models, interpret):
    """The main path's dtype: bf16 weights and activations on both sides. bf16 rounds at
    other places in the two frameworks (the JAX bf16 forward is itself 0.8% in relative L2
    from its fp32 forward here), so this holds the port to 1.5% relative L2 and 0.03 max
    abs error on a velocity of std ~0.4."""
    params, _ = models
    pb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    model = mmdit_from_jax(jax.device_get(pb), CFG, device="cpu")
    assert next(model.parameters()).dtype == torch.bfloat16
    arrays = _inputs(False, False)
    as_bf16 = lambda a: a.astype(jnp.bfloat16) if a.ndim > 1 else a  # noqa: E731 (t stays fp32)
    ref = np.asarray(jmm.apply(pb, *(as_bf16(jnp.asarray(a)) for a in arrays), J_CFG,
                               attn_impl="pallas_fused")).astype(np.float32)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a).to(torch.bfloat16) if a.ndim > 1
                      else torch.from_numpy(a) for a in arrays))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1.5e-2
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=0)


def test_hoisted_tensors_match_jax(models):
    params, model = models
    _, _, cond, _, _ = _inputs(False, True)
    ts = np.asarray([999.0, 500.0, 20.0], np.float32)
    j_k, j_v = jmm.precompute_text_kv(params, jnp.asarray(cond), J_CFG)
    t_k, t_v = model.precompute_text_kv(torch.from_numpy(cond))
    np.testing.assert_allclose(t_k.numpy(), np.asarray(j_k), **TOL)
    np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), **TOL)
    j_mods = jmm.precompute_triple_mods(params, jnp.asarray(ts), J_CFG, jnp.float32)
    t_mods = model.precompute_triple_mods(torch.from_numpy(ts), torch.float32)
    for t, j in zip(t_mods, j_mods):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_timestep_embedding_matches_jax():
    t = np.asarray([0.0, 1.5, 500.0, 999.0], np.float32)
    np.testing.assert_allclose(tmm.timestep_embedding(torch.from_numpy(t)).numpy(),
                               np.asarray(jmm.timestep_embedding(jnp.asarray(t))), **TOL)


@pytest.mark.parametrize("audio_len,visual_len", [(250, 40), (20, 4), (20, 20), (4, 10)])
def test_rope_tables_match_jax(audio_len, visual_len):
    j = jmm.build_rope_tables(J_CFG, audio_len, visual_len, 8)
    t = tmm.build_rope_tables(CFG, audio_len, visual_len, 8)
    assert (t.audio_joint is None) == (j.audio_joint is None)
    for name in ("audio", "joint", "visual_cross", "text", "audio_joint", "visual_joint"):
        if getattr(j, name) is None:
            continue
        for tt, jt in zip(getattr(t, name), getattr(j, name)):
            np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)


def test_tables_of_other_lengths_raise(models):
    _, model = models
    arrays = _inputs(False, False)
    tables = model.attention_tables(arrays[0].shape[1] // CFG.patch_size + 2,
                                    arrays[3].shape[1], arrays[2].shape[1])
    with pytest.raises(ValueError, match="attention tables"):
        model(*(torch.from_numpy(a) for a in arrays), tables=tables)


def test_failed_identity_check_raises(models):
    _, model = models
    x, ts, cond, _, sync = _inputs(False, False)
    clip = np.zeros((2, 30, CFG.clip_dim), np.float32)  # more visual tokens than audio
    with pytest.raises(NotImplementedError):
        model(*(torch.from_numpy(a) for a in (x, ts, cond, clip, sync)))


@pytest.mark.parametrize("change", [dict(use_attention_mask=True),
                                    dict(interleaved_audio_visual_rope=False),
                                    dict(qk_norm=False)])
def test_configs_outside_the_fused_kernel_raise(change):
    with pytest.raises(NotImplementedError):
        tmm.MMDiT(dataclasses.replace(CFG, **change), device="cpu")


def test_init_schemes_and_param_count():
    model = tmm.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    assert param_count(model) == jax_param_count(jmm.init(jax.random.PRNGKey(0), J_CFG))
    assert not model.final_layer.linear.weight.any()
    assert not model.triple_blocks[0].audio_mod.weight.any()
    assert torch.equal(model.single_blocks[0].q_norm.weight, torch.ones(CFG.head_dim))
    lim = 1.0 / CFG.hidden_size ** 0.5
    w = model.triple_blocks[1].audio_self_attn_qkv.weight
    assert float(w.abs().max()) <= lim and float(w.std()) > 0.5 * lim
    assert abs(float(model.time_in.mlp_0.weight.std()) - 0.02) < 0.002


def test_perturb_zero_leaves_touches_only_zero_leaves():
    model = tmm.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    perturb_zero_leaves(model, torch.Generator().manual_seed(1))
    for name, p in model.state_dict().items():
        if before[name].any():
            assert torch.equal(p, before[name]), name
        else:
            assert p.any() and float(p.std()) < 0.05, name


def test_forward_matches_jax_at_xxl_width():
    """The real width, hidden 1536 and 12 heads of 128, with the depth cut to one triple and
    one single block, at the 5 s lengths (audio 250, visual 40, sync 112, text 77), in fp32
    against ``attn_impl="xla"``, on the port's own init (``torch_helpers.py``: a jitted JAX
    init at this width compiles for seconds). Tolerance: relative L2 1e-5 and atol 1e-4 on a
    velocity of std ~2: sums over 1536-6144 terms in another order."""
    from foley_tpu.configs import XXL as J_XXL
    from foley_tpu_torch.configs import XXL

    cut = dict(depth_triple_blocks=1, depth_single_blocks=1)
    j_cfg, cfg = dataclasses.replace(J_XXL.model, **cut), dataclasses.replace(XXL.model, **cut)
    assert (cfg.hidden_size, cfg.num_heads, cfg.head_dim) == (1536, 12, 128)
    params = seeded_tree(jax_tree_from_port(
        tmm.init(cfg, torch.Generator().manual_seed(1), device="cpu"), jmm.init, j_cfg), seed=5)
    model = mmdit_from_jax(params, cfg, device="cpu")
    clip_len, sync_len = XXL.t2a_lengths(5.0)
    rng = np.random.default_rng(6)
    arrays = (rng.normal(size=(1, XXL.latent_length(5.0), cfg.audio_vae_latent_dim)),
              np.asarray([700.0]), rng.normal(size=(1, cfg.text_length, cfg.condition_dim)),
              rng.normal(size=(1, clip_len, cfg.clip_dim)),
              rng.normal(size=(1, sync_len, cfg.sync_feat_dim)))
    arrays = [a.astype(np.float32) for a in arrays]
    assert [a.shape[1] for a in arrays if a.ndim == 3] == [250, 77, 40, 112]
    apply = jax.jit(jmm.apply, static_argnums=6, static_argnames="attn_impl")
    ref = np.asarray(apply(params, *(jnp.asarray(a) for a in arrays), j_cfg, attn_impl="xla"))
    del params
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in arrays)).numpy()
    assert float(np.std(ref)) > 0.1
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
