"""The port's Synchformer against the JAX package's, on the CPU in fp32.

Both sides get the same weights (``synchformer.init`` through ``io/from_jax.py``, every
zero leaf made random and LN weights moved off 1) and the same frames, drawn with numpy.
Tolerance: atol 2e-5 / rtol 1e-4 through two divided space-time blocks (fp32 sums in
another order); the antialiased resizes 1e-4, as float rounding of one filter computed twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import SynchformerConfig as JCfg
from foley_tpu.models import synchformer as jsync
from foley_tpu.pipeline import features as jfeat
from foley_tpu_torch.configs import SynchformerConfig as TCfg
from foley_tpu_torch.io.from_jax import synchformer_from_jax
from foley_tpu_torch.models import synchformer as tsync
from foley_tpu_torch.pipeline import features as tfeat
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=2e-5, rtol=1e-4)
RESIZE_TOL = dict(atol=1e-4, rtol=0)
FIELDS = dict(img_size=32, patch_size=8, temporal_patch_size=2, num_frames=16, embed_dim=24,
              depth=2, num_heads=2, mlp_ratio=2.0)
J_CFG, T_CFG = JCfg(**FIELDS), TCfg(**FIELDS)


def _seeded(params, rng):
    def fill(path, x):
        x = np.array(x)
        if not np.any(x):
            return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
        if path[-1].key == "weight":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(fill, jax.device_get(params))


@pytest.fixture(scope="module")
def nets():
    params = _seeded(jsync.init(jax.random.PRNGKey(0), J_CFG), np.random.default_rng(4))
    return params, synchformer_from_jax(params, T_CFG, device="cpu")


def test_apply_matches_jax(nets):
    params, model = nets
    segs = np.random.default_rng(1).uniform(-1, 1, (1, 2, 16, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jsync.apply(params, jnp.asarray(segs), J_CFG))
    got = tsync.apply(model, torch.from_numpy(segs)).numpy()
    assert got.shape == (1, 2, 8, 24)
    assert float(np.std(ref)) > 1e-2
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("group", ["time", "space"])
def test_divided_attention_matches_jax(nets, group):
    params, model = nets
    f, n = 4, 6
    x = np.random.default_rng(2).normal(size=(3, 1 + f * n, 24)).astype(np.float32)
    jp, blk = params["blocks"][0], model.blocks[0]
    qkv, proj = (("time_qkv", "time_proj") if group == "time" else ("attn_qkv", "attn_proj"))
    ref = np.asarray(jsync._divided_attention(jp[qkv], jp[proj], jnp.asarray(x), group, f, n, 2))
    got = tsync._divided_attention(getattr(blk, qkv), getattr(blk, proj), torch.from_numpy(x),
                                   group, f, n, 2).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_spatial_agg_matches_jax(nets, masked):
    params, model = nets
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 7, 24)).astype(np.float32)
    mask = rng.random((5, 7)) > 0.4 if masked else None
    ref = np.asarray(jsync._spatial_agg(params["spatial_agg"], jnp.asarray(x), 2,
                                        key_mask=None if mask is None else jnp.asarray(mask)))
    got = tsync._spatial_agg(model.spatial_agg, torch.from_numpy(x), 2,
                             key_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == (5, 24)
    np.testing.assert_allclose(got, ref, **TOL)


def test_patchify_3d_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 4, 16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsync._patchify_3d(torch.from_numpy(x), 2, 8).numpy(),
                                  np.asarray(jsync._patchify_3d(jnp.asarray(x), 2, 8)))


@pytest.mark.parametrize("shape", [(3, 240, 426, 3),   # 720p after its 3x3 box downsample
                                   (2, 360, 640, 3),   # short side 360 -> 224
                                   (2, 20, 30, 3),     # upscale
                                   (2, 100, 60, 3)])   # portrait: crop the height
def test_preprocess_frames_device_matches_jax(shape):
    size = 224 if shape[1] > 200 else 32
    u8 = np.random.default_rng(shape[1]).integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jsync.preprocess_frames_device(jnp.asarray(u8), size))
    got = tsync.preprocess_frames_device(torch.from_numpy(u8), size).numpy()
    assert got.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got, ref, **RESIZE_TOL)


@pytest.mark.parametrize("t", [40, 25, 9])  # 4 segments, 2 with a ragged tail, one short input
def test_encode_frames_device_matches_segments_and_jax(nets, t):
    """The unique-frame upload + on-device window gather equals windowing on the host
    (``sync_segments``) and encoding the preprocessed segments, and the JAX route."""
    params, model = nets
    frames = np.random.default_rng(t).random((t, 48, 40, 3)).astype(np.float32)
    enc = tsync.SynchformerEncoder(model)
    got = tsync.encode_frames_device(enc, frames)
    num = max((t - 16) // 8 + 1, 1)
    assert got.shape == (1, num * 8, 24) and got.dtype == torch.float32

    segs = tfeat.sync_segments(frames)
    np.testing.assert_array_equal(segs, jfeat.sync_segments(frames))
    flat = torch.from_numpy(segs.reshape(-1, 48, 40, 3))
    pix = tsync.preprocess_frames_device((flat.clamp(0, 1) * 255).to(torch.uint8), 32)
    host = enc.encode(pix.reshape(num, 16, 32, 32, 3))
    np.testing.assert_allclose(got.numpy(), host.numpy(), atol=1e-6)

    j_enc = jsync.SynchformerEncoder(params, J_CFG, preprocess="device")
    ref = np.asarray(jsync.encode_frames_device(j_enc, frames))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_init_has_the_jax_layout_and_schemes():
    model = tsync.init(T_CFG, torch.Generator().manual_seed(0), device="cpu")
    jtree = jax.eval_shape(lambda: jsync.init(jax.random.PRNGKey(0), J_CFG))
    ref = synchformer_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                      jtree), T_CFG, device="cpu")
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    sd = model.state_dict()
    assert not sd["temp_embed"].any() and not sd["blocks.1.fc2.bias"].any()
    assert sd["cls_token"].any() and sd["spatial_agg.cls_token"].any()
    enc = tsync.init_random(0, 16, device="cpu")
    assert (enc.cfg.embed_dim, enc.cfg.depth, enc.cfg.num_frames) == (16, 2, 16)
