"""The port's SigLIP2 tower against the JAX package's, on the CPU in fp32.

Both sides get the same weights (``siglip2.init`` through ``io/from_jax.py``, every zero
leaf made random and LN weights moved off 1, so biases and norms are exercised) and the
same images, drawn with numpy. Tolerance: the towers agree to atol 2e-5 / rtol 1e-4 (fp32
sums in another order through two layers); the antialiased resizes to 1e-4, as float
rounding of two implementations of the same filter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.models import siglip2 as jsig
from foley_tpu_torch.io.from_jax import siglip2_from_jax
from foley_tpu_torch.models import siglip2 as tsig
from foley_tpu_torch.ops.kernels import flash_attention as FL
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=2e-5, rtol=1e-4)
RESIZE_TOL = dict(atol=1e-4, rtol=0)
# the tiny geometry of tests/test_pallas.py's SigLIP2 case: 16 tokens, 2 heads of 64
J_CFG = jsig.SiglipVisionConfig(hidden_size=128, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, image_size=32, patch_size=8)
T_CFG = tsig.SiglipVisionConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})


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
def towers():
    params = _seeded(jsig.init(jax.random.PRNGKey(0), J_CFG), np.random.default_rng(3))
    return params, siglip2_from_jax(params, T_CFG, device="cpu")


@pytest.mark.parametrize("pooled", [True, False])
def test_apply_matches_jax(towers, pooled):
    params, model = towers
    imgs = np.random.default_rng(7).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jsig.apply(params, jnp.asarray(imgs), J_CFG, pooled=pooled))
    before = FL.flash_attention.launches
    got = tsig.apply(model, torch.from_numpy(imgs), pooled=pooled).numpy()
    assert FL.flash_attention.launches == before  # CPU tensors take the plain version
    assert got.shape == ((3, 128) if pooled else (3, 16, 128))
    assert float(np.std(ref)) > 1e-2
    np.testing.assert_allclose(got, ref, **TOL)


def test_apply_at_another_grid_resizes_the_position_embeddings(towers):
    params, model = towers
    imgs = np.random.default_rng(8).uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
    ref = np.asarray(jsig.apply(params, jnp.asarray(imgs), J_CFG, pooled=True))
    np.testing.assert_allclose(tsig.apply(model, torch.from_numpy(imgs)).numpy(), ref, **TOL)


@pytest.mark.parametrize("grid,target", [(8, 4), (8, 5), (4, 8), (32, 20)])
def test_resize_pos_embed_matches_jax(grid, target):
    pos = np.random.default_rng(grid * target).normal(size=(grid * grid, 12)).astype(np.float32)
    ref = np.asarray(jsig._resize_pos_embed(jnp.asarray(pos), target))
    got = tsig._resize_pos_embed(torch.from_numpy(pos), target).numpy()
    assert got.shape == (target * target, 12)
    np.testing.assert_allclose(got, ref, **RESIZE_TOL)


def test_patchify_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsig._patchify(torch.from_numpy(x), 8).numpy(),
                                  np.asarray(jsig._patchify(jnp.asarray(x), 8)))


@pytest.mark.parametrize("shape,size", [((3, 96, 128, 3), 32),    # downscale
                                        ((2, 20, 30, 3), 48),      # upscale
                                        ((2, 90, 160, 3), 64)])    # 16:9 to a square
def test_preprocess_frames_device_matches_jax(shape, size):
    u8 = np.random.default_rng(size).integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jsig.preprocess_frames_device(jnp.asarray(u8), size))
    got = tsig.preprocess_frames_device(torch.from_numpy(u8), size).numpy()
    assert got.shape == (shape[0], size, size, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **RESIZE_TOL)
    flt = u8.astype(np.float32) / 255.0  # float [0, 1] input takes the same route
    np.testing.assert_allclose(tsig.preprocess_frames_device(torch.from_numpy(flt), size)
                               .numpy(), got, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_encode_matches_jax(towers, dtype):
    """The device route end to end: host box-downsample (70x90 -> 35x45 at image size 32),
    the resize, the tower and the MAP head; bf16 compute within bf16 rounding."""
    params, model = towers
    frames = np.random.default_rng(9).random((4, 70, 90, 3)).astype(np.float32)
    j_enc = jsig.Siglip2Encoder(params, J_CFG, preprocess="device", attn_impl="xla")
    ref = np.asarray(j_enc.encode(frames))
    got = tsig.Siglip2Encoder(model.to(dtype), compute_dtype=dtype).encode(frames)
    model.float()
    assert got.shape == (1, 4, 128) and got.dtype == torch.float32
    tol = TOL if dtype == torch.float32 else dict(atol=0.1, rtol=0.05)
    np.testing.assert_allclose(got.numpy(), ref, **tol)


def test_init_has_the_jax_layout_and_schemes():
    model = tsig.init(T_CFG, torch.Generator().manual_seed(0), device="cpu")
    jtree = jax.eval_shape(lambda: jsig.init(jax.random.PRNGKey(0), J_CFG))
    ref = siglip2_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jtree),
                           T_CFG, device="cpu")
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    sd = model.state_dict()
    assert not sd["layers.0.q.bias"].any() and torch.equal(sd["layers.1.ln2.weight"],
                                                          torch.ones(128))
    assert 0.015 < float(sd["layers.0.fc1.weight"].std()) < 0.025
    assert 0.015 < float(sd["position_embedding"].std()) < 0.025
    assert sd["head.probe"].shape == (1, 1, 128) and sd["head.probe"].any()


def test_init_random_geometry():
    enc = tsig.init_random(0, 16, device="cpu")
    assert enc.cfg.hidden_size == 16 and enc.cfg.num_hidden_layers == 2
    assert enc.compute_dtype == torch.float32 and enc.device == torch.device("cpu")
    full = tsig.SiglipVisionConfig()
    assert (full.grid ** 2, full.head_dim) == (1024, 64)  # K2's real geometry
