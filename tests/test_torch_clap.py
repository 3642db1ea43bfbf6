"""The port's CLAP text tower against the JAX ``clap.apply`` at ``ClapTextConfig.tiny()`` on
the CPU, in fp32, with the same weights (``io/from_jax.py``; LayerNorm and bias leaves made
random so every parameter matters) and the same token ids and masks.

Tolerance atol 2e-5 / rtol 1e-4: two fp32 post-LN layers, summed in another order by each
framework.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.api.nodes import HunyuanFoleySampler
from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import clap as jclap
from foley_tpu_torch.configs import ClapTextConfig
from foley_tpu_torch.io.from_jax import clap_from_jax
from foley_tpu_torch.models import clap as tclap
from foley_tpu_torch.pipeline import features as tfeat
from torch_helpers import jax_native_library, one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=2e-5, rtol=1e-4)
J_CFG, CFG = jclap.ClapTextConfig.tiny(), ClapTextConfig.tiny()


@pytest.fixture(scope="module")
def towers():
    rng = np.random.default_rng(0)

    def fill(path, x):
        x = np.asarray(x)
        if path[-1].key in ("weight", "bias", "b"):  # LayerNorms and biases
            return rng.normal(1.0 if path[-1].key == "weight" else 0.0, 0.1,
                              x.shape).astype(x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(
        fill, jax.device_get(jclap.init(jax.random.PRNGKey(0), J_CFG)))
    return params, clap_from_jax(params, CFG, device="cpu")


def _ids(lengths, width, seed):
    """Random ids [N, width], row i valid over its first lengths[i] tokens, pad after."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, CFG.vocab_size, (len(lengths), width)).astype(np.int32)
    mask = (np.arange(width)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids[mask == 0] = CFG.pad_token_id
    return ids, mask


def test_config_equals_jax():
    for cfg_t, cfg_j in ((CFG, J_CFG), (ClapTextConfig(), jclap.ClapTextConfig())):
        assert {f: getattr(cfg_t, f) for f in cfg_t.__dataclass_fields__} == \
            {f: getattr(cfg_j, f) for f in cfg_j.__dataclass_fields__}
        assert cfg_t.head_dim == cfg_j.head_dim


@pytest.mark.parametrize("lengths", [(9, 6, 3), (9,), (1, 9)])
def test_apply_matches_jax(towers, lengths):
    params, model = towers
    ids, mask = _ids(lengths, 9, seed=len(lengths))
    ref = np.asarray(jclap.apply(params, jnp.asarray(ids), jnp.asarray(mask), J_CFG))
    got = tclap.apply(model, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (len(lengths), 9, CFG.hidden_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_valid_positions_ignore_the_batch_padding(towers):
    """A row's valid positions do not depend on how far the batch pads it."""
    _, model = towers
    ids, mask = _ids((6,), 6, seed=5)
    solo = tclap.apply(model, torch.from_numpy(ids), torch.from_numpy(mask))
    wide_ids = np.concatenate([ids, np.full((1, 4), CFG.pad_token_id, np.int32)], axis=1)
    wide_mask = np.concatenate([mask, np.zeros((1, 4), np.int32)], axis=1)
    padded = tclap.apply(model, torch.from_numpy(wide_ids), torch.from_numpy(wide_mask))
    np.testing.assert_allclose(padded[:, :6].numpy(), solo.numpy(), **TOL)


def _tokenizer(prompts, padding, truncation, max_length, return_tensors):
    """A word-level stand-in with the call of ``transformers.AutoTokenizer``."""
    assert padding and truncation and return_tensors == "np"
    rows = [[2 + sum(map(ord, w)) % (CFG.vocab_size - 2) for w in p.split()][:max_length]
            for p in prompts]
    width = max(len(r) for r in rows)
    ids = np.full((len(rows), width), CFG.pad_token_id, np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = r, 1
    return {"input_ids": ids, "attention_mask": mask}


def test_encode_text_rows_match_the_sampler_node(towers):
    """``features.encode_text`` is the sampler node's ``_encode_text``: one [negative, prompt]
    batch through CLAP, (prompt row, negative row) out."""
    params, model = towers
    prompt, negative = "glass shattering on a stone floor", "noisy harsh"
    j_deps = {"clap": jclap.ClapTextEncoder(params, J_CFG, _tokenizer)}
    j_text, j_uncond = HunyuanFoleySampler._encode_text(j_deps, prompt, negative, J_TINY)
    text, uncond = tfeat.encode_text({"clap": tclap.ClapTextEncoder(model, _tokenizer)},
                                     prompt, negative)
    assert text.shape == uncond.shape == (1, 6, CFG.hidden_size)
    np.testing.assert_allclose(text.numpy(), np.asarray(j_text), **TOL)
    np.testing.assert_allclose(uncond.numpy(), np.asarray(j_uncond), **TOL)
    # the negative prompt is padded inside the batch: its two words match it alone
    alone = tclap.ClapTextEncoder(model, _tokenizer).encode([negative])
    np.testing.assert_allclose(uncond[:, :2].numpy(), alone.numpy(), **TOL)


def test_encoder_without_tokenizer_takes_ids(towers):
    _, model = towers
    enc = tclap.ClapTextEncoder(model)
    with pytest.raises(ValueError, match="no tokenizer"):
        enc.encode(["a prompt"])
    ids, mask = _ids((4, 2), 4, seed=7)
    np.testing.assert_array_equal(
        enc.encode_ids(ids, mask).numpy(),
        tclap.apply(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy())


def test_init_schemes():
    model = tclap.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    emb = model.embeddings
    assert 0.015 < float(emb.word.std()) < 0.025
    assert float(model.layers[0].attn_ln.weight.min()) == 1.0
    limit = 1.0 / CFG.hidden_size ** 0.5
    assert float(model.layers[0].q.weight.abs().max()) <= limit
