"""The denoiser configurations outside K1's precondition against the JAX ``mmdit.apply``,
at the TINY config on the CPU.

The JAX package takes its fused kernel for the joint attention only with qk-norm on, no
attention mask and interleaved RoPE whose decomposition holds at the lengths
(``foley_tpu/models/mmdit.py:354-355``); otherwise it runs XLA attention. The port takes the
plain ``ops/attention.py::sdpa`` there, on every device, with the JAX mask and the exact
interleave / rotate / decouple path. Each case is held against ``attn_impl="xla"`` and
``"pallas_fused"`` (interpret mode), on the port's own seeded init with every zero leaf and
norm weight drawn (``tests/test_torch_mmdit.py::seeded_tree``). Tolerance:
``test_torch_mmdit.py``'s fp32 bound, atol 1e-5 / rtol 1e-4.
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
from foley_tpu.models import mmdit as jmm
from foley_tpu.ops import rope as jrope
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import mmdit_from_jax
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.ops import rope as trope
from test_torch_mmdit import seeded_tree
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
CASES = {
    "attention_mask": (dict(use_attention_mask=True), 4),
    "no_qk_norm": (dict(qk_norm=False), 4),
    "rope_not_interleaved": (dict(interleaved_audio_visual_rope=False), 4),
    "identity_fails": ({}, 30),  # more visual tokens (30) than audio (20)
}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JFA, "fused_qk_attention",
                        functools.partial(JFA.fused_qk_attention, interpret=True))


def _models(change, seed=0):
    cfg = dataclasses.replace(TINY.model, **change)
    j_cfg = dataclasses.replace(J_TINY.model, **change)
    params = seeded_tree(jax_tree_from_port(
        tmm.init(cfg, torch.Generator().manual_seed(seed), device="cpu"), jmm.init, j_cfg),
        seed=seed + 3)
    return cfg, j_cfg, params, mmdit_from_jax(params, cfg, device="cpu")


def _inputs(cfg, visual_len):
    rng = np.random.default_rng(4)
    b, t, text = 2, 20, 8
    arrays = (rng.normal(size=(b, t, cfg.audio_vae_latent_dim)),
              np.asarray([500.0, 100.0]), rng.normal(size=(b, text, cfg.condition_dim)),
              rng.normal(size=(b, visual_len, cfg.clip_dim)),
              rng.normal(size=(b, 8, cfg.sync_feat_dim)))
    mask = np.ones((b, text), bool)
    mask[0, 5:] = False
    mask[1, 2:4] = False
    return [a.astype(np.float32) for a in arrays], mask


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_matches_jax(interpret, case):
    change, visual_len = CASES[case]
    cfg, j_cfg, params, model = _models(change)
    arrays, mask = _inputs(cfg, visual_len)
    tables = model.attention_tables(20, visual_len, 8)
    assert tables.triple_norms is None and tables.joint_rope is None  # the plain route
    kw = dict(cond_mask=mask) if cfg.use_attention_mask else {}
    refs = [np.asarray(jmm.apply(params, *(jnp.asarray(a) for a in arrays), j_cfg,
                                 attn_impl=impl, **{k: jnp.asarray(v) for k, v in kw.items()}))
            for impl in ("xla", "pallas_fused")]
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in arrays),
                    **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert float(np.std(refs[0])) > 0.1
    for ref in refs:
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("case", ["no_qk_norm", "identity_fails"])
def test_hoisted_plain_route_matches_jax(interpret, case):
    """The denoise loop's hoists (text K/V, adaLN vectors, tables built once) on the plain
    route: the same velocity as the JAX ``apply`` with its own hoists."""
    change, visual_len = CASES[case]
    cfg, j_cfg, params, model = _models(change, seed=1)
    arrays, _ = _inputs(cfg, visual_len)
    arrays[1] = np.asarray([300.0, 300.0], np.float32)
    jargs = [jnp.asarray(a) for a in arrays]
    a_mods, v_mods = jmm.precompute_triple_mods(params, jargs[1][:1], j_cfg, jnp.float32)
    ref = np.asarray(jmm.apply(params, *jargs, j_cfg, attn_impl="xla",
                               text_kv=jmm.precompute_text_kv(params, jargs[2], j_cfg),
                               triple_mods=(a_mods[0], v_mods[0])))
    targs = [torch.from_numpy(a) for a in arrays]
    with torch.no_grad():
        ta, tv = model.precompute_triple_mods(targs[1][:1], torch.float32)
        got = model(*targs, text_kv=model.precompute_text_kv(targs[2]),
                    triple_mods=(ta[0], tv[0]),
                    tables=model.attention_tables(20, visual_len, 8)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_exact_interleave_equals_the_decomposed_k1_route():
    """Where the identity holds, the exact interleave / decouple path (the plain route's
    tables, without the decomposed interleave ones) and K1's decomposed tables rotate alike:
    the two velocities agree within fp32 rounding (atol 1e-5), the check the card's
    ``configs`` phase makes at XXL."""
    cfg, _, _, model = _models({}, seed=2)
    arrays, _ = _inputs(cfg, 4)
    targs = [torch.from_numpy(a) for a in arrays]
    tables = model.attention_tables(20, 4, 8)
    assert tmm.fused_joint(cfg, tables.ropes)
    exact = tmm.AttentionTables(
        ropes=tables.ropes._replace(audio_joint=None, visual_joint=None), joint_rope=None,
        triple_norms=None, single_norms=tables.single_norms)
    with torch.no_grad():
        fused = model(*targs).numpy()
        plain = model(*targs, tables=exact).numpy()
    np.testing.assert_allclose(plain, fused, **TOL)


@pytest.mark.parametrize("audio_len,visual_len", [(20, 30), (20, 4), (7, 5), (5, 9)])
def test_interleave_and_decouple_match_jax(audio_len, visual_len):
    """``ops/rope.py``'s interleave / decouple against the JAX functions, on length pairs
    where the identity check holds and where it fails."""
    rng = np.random.default_rng(audio_len * 100 + visual_len)
    a = rng.normal(size=(2, audio_len, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, visual_len, 2, 8)).astype(np.float32)
    j = jrope.interleave_sequences(jnp.asarray(a), jnp.asarray(v))
    t = trope.interleave_sequences(torch.from_numpy(a), torch.from_numpy(v))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for tt, jj in zip(trope.decouple_interleaved(t, audio_len, visual_len),
                      jrope.decouple_interleaved(j, audio_len, visual_len)):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jj))


def test_attention_mask_matches_jax():
    """The mask of a ``use_attention_mask`` config, the JAX ``apply``'s construction (which
    leaves every ``[visual; audio]`` pair attending whatever the text mask)."""
    mask = np.ones((2, 6), bool)
    mask[0, 3:] = False
    got = tmm.joint_attention_mask(torch.from_numpy(mask), 4, 9)
    assert got.shape == (2, 1, 13, 13) and got.dtype == torch.bool
    ones_av = jnp.ones((2, 13), bool)
    concat = jnp.concatenate([jnp.asarray(mask), ones_av], axis=1)
    m1 = jnp.broadcast_to(concat[:, None, None, :], (2, 1, 19, 19))
    full = (m1 & jnp.swapaxes(m1, 2, 3)).at[:, :, :, 0].set(True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(full[:, :, 6:, 6:]))
