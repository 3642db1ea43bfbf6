"""The port's SigLIP2 and Synchformer at their real width against the JAX package's, on the
CPU in fp32: hidden 768, 12 heads of 64, MLP 3072, at the real geometry (SigLIP2's 512 x 512
image in 16 x 16 patches, 1,024 tokens; Synchformer's 16-frame 224 x 224 segment, 8 x 196
tokens), with the depth cut to one layer (a Synchformer block holds both its divided
attentions, time and space), one image and one segment, as
``tests/test_torch_mmdit.py::test_forward_matches_jax_at_xxl_width`` holds the denoiser.
The small-width tests (``test_torch_siglip2.py``, ``test_torch_synchformer.py``) cannot see
a fault that only shows with 12 heads or 768 channels.

Both sides get the same weights (the JAX ``init`` through ``io/from_jax.py``, every zero
leaf made random and LN weights moved off 1) and the same inputs, drawn with numpy.
Tolerance: relative L2 1e-5 and atol 1e-4 on features of std ~0.5-1: sums over 768-3072
terms in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from foley_tpu.configs import SynchformerConfig as JSyncCfg
from foley_tpu.models import siglip2 as jsig
from foley_tpu.models import synchformer as jsync
from foley_tpu_torch.configs import SynchformerConfig as TSyncCfg
from foley_tpu_torch.io.from_jax import siglip2_from_jax, synchformer_from_jax
from foley_tpu_torch.models import siglip2 as tsig
from foley_tpu_torch.models import synchformer as tsync
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

REL_TOL, ATOL = 1e-5, 1e-4


def _seeded(params, rng):
    def fill(path, x):
        x = np.array(x)
        if not np.any(x):
            return (rng.normal(size=x.shape) * 0.05).astype(x.dtype)
        if path[-1].key == "weight":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(fill, jax.device_get(params))


def _held(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape
    assert float(np.std(ref)) > 0.1
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < REL_TOL
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_siglip2_matches_jax_at_real_width():
    j_cfg = dataclasses.replace(jsig.SiglipVisionConfig(), num_hidden_layers=1)
    t_cfg = tsig.SiglipVisionConfig(**{f: getattr(j_cfg, f) for f in j_cfg.__dataclass_fields__})
    assert (t_cfg.hidden_size, t_cfg.num_attention_heads, t_cfg.head_dim, t_cfg.grid) == \
        (768, 12, 64, 32)
    params = _seeded(jsig.init(jax.random.PRNGKey(0), j_cfg), np.random.default_rng(1))
    model = siglip2_from_jax(params, t_cfg, device="cpu")
    imgs = np.random.default_rng(2).uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jsig.apply, static_argnums=2)(params, jnp.asarray(imgs), j_cfg))
    del params
    with torch.no_grad():
        got = tsig.apply(model, torch.from_numpy(imgs)).numpy()
    _held(got, ref)


def test_synchformer_matches_jax_at_real_width():
    j_cfg = dataclasses.replace(JSyncCfg(), depth=1)
    t_cfg = dataclasses.replace(TSyncCfg(), depth=1)
    assert (t_cfg.embed_dim, t_cfg.num_heads, t_cfg.img_size, t_cfg.num_frames) == \
        (768, 12, 224, 16)
    params = _seeded(jsync.init(jax.random.PRNGKey(0), j_cfg), np.random.default_rng(3))
    model = synchformer_from_jax(params, t_cfg, device="cpu")
    segs = np.random.default_rng(4).uniform(-1, 1, (1, 1, 16, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jsync.apply, static_argnums=2)(params, jnp.asarray(segs), j_cfg))
    del params
    with torch.no_grad():
        got = tsync.apply(model, torch.from_numpy(segs)).numpy()
    assert got.shape == (1, 1, 8, 768)
    _held(got, ref)
