"""The AST's content mask on the port (``foley_tpu_torch/models/ast.py``: the token mask, the
masked encoder, the masked frequency pooling, ``extract_features_segments``) against the JAX
package's ``foley_tpu/models/ast.py``, on the CPU, at the desync tests' small AST (one layer
of 32, two heads, the real 66 x 128 spectrogram) from one seeded checkpoint.

The JAX package adds a float32-minimum bias to a masked logit, the port replaces the logit
with it: both give exact zeros after the softmax. Tolerance: the desync tests' fp32 atol and
rtol 1e-4, forward and gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.models import ast as jast
from foley_tpu_torch.models import ast as tast
from test_torch_desync import AST_SMALL, TOL, _ast_pair
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def pair():
    return _ast_pair(tast.ASTConfig(**AST_SMALL), 7)


def _jax_features(j_params, j_agg, jcfg):
    """The JAX ``extract_features`` with a mask, compiled once for the module's shapes."""
    return jax.jit(lambda s, m: jast.extract_features(j_params, j_agg, s, jcfg, cont_mask=m))


def _case(kind, shape, seed):
    """A seeded spectrogram and its mask (1 = kept): scattered cells, or one whole time
    step (every patch over frames 20-29 masked)."""
    rng = np.random.default_rng(seed)
    spec = rng.normal(size=shape).astype(np.float32)
    mask = np.ones(shape, np.float32)
    if kind == "cells":
        mask[rng.random(shape) < 2e-3] = 0.0
    else:
        mask[..., 20:30, :] = 0.0
    return spec, mask


@pytest.mark.parametrize("kind", ["cells", "time_step"])
def test_masked_features_match_jax(pair, kind):
    j_params, j_agg, jcfg, port, agg = pair
    spec, mask = _case(kind, (2, 66, 128), 11)
    ref_tok = np.asarray(jast.token_mask_from_cont_mask(jnp.asarray(mask), jcfg))
    got_tok = tast.token_mask_from_cont_mask(torch.from_numpy(mask), port.cfg).numpy()
    np.testing.assert_array_equal(got_tok, ref_tok)
    assert 0 < (~got_tok).sum() < got_tok.size and got_tok[:, :2].all()
    ref = np.asarray(jax.jit(lambda s, t: jast.apply(j_params, s, jcfg, token_mask=t))(
        jnp.asarray(spec), jnp.asarray(ref_tok)))
    with torch.no_grad():
        got = tast.apply(port, torch.from_numpy(spec), torch.from_numpy(got_tok)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    ref = np.asarray(_jax_features(j_params, j_agg, jcfg)(jnp.asarray(spec),
                                                          jnp.asarray(mask)))
    with torch.no_grad():
        got = tast.extract_features(port, agg, torch.from_numpy(spec),
                                    cont_mask=torch.from_numpy(mask)).numpy()
        plain = tast.extract_features(port, agg, torch.from_numpy(spec)).numpy()
    assert got.shape == (2, 6, 32)
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(got - plain).max() > 1e-3  # the mask changes the features


@pytest.mark.parametrize("for_loop", [False, True])
def test_segments_match_jax(pair, for_loop):
    j_params, j_agg, jcfg, port, agg = pair
    spec, mask = _case("cells", (1, 2, 66, 128), 12)
    cont = None if for_loop else mask
    ref = np.asarray(jax.jit(lambda s, m: jast.extract_features_segments(
        j_params, j_agg, s, jcfg, for_loop=for_loop, cont_mask=m))(
            jnp.asarray(spec), None if cont is None else jnp.asarray(cont)))
    with torch.no_grad():
        got = tast.extract_features_segments(
            port, agg, torch.from_numpy(spec), for_loop=for_loop,
            cont_mask=None if cont is None else torch.from_numpy(cont)).numpy()
    assert got.shape == ref.shape == (1, 2, 6, 32)
    np.testing.assert_allclose(got, ref, **TOL)
    if for_loop:
        with pytest.raises(ValueError, match="for_loop"):
            tast.extract_features_segments(port, agg, torch.from_numpy(spec), for_loop=True,
                                           cont_mask=torch.from_numpy(mask))


def test_masked_gradient_matches_jax(pair):
    """d(sum(w * features)) / d spectrogram, with a mask, against ``jax.grad``."""
    j_params, j_agg, jcfg, port, agg = pair
    spec, mask = _case("cells", (2, 66, 128), 13)
    w = np.random.default_rng(14).normal(size=(2, 6, 32)).astype(np.float32)

    def loss(s):
        out = jast.extract_features(j_params, j_agg, s, jcfg, cont_mask=jnp.asarray(mask))
        return jnp.sum(out * w)

    ref = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(spec)))
    x = torch.from_numpy(spec).requires_grad_(True)
    out = tast.extract_features(port, agg, x, cont_mask=torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    got = x.grad.numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, **TOL)
