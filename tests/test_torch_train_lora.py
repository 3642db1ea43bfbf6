"""The training side of the port's LoRA (``models/lora.py``: ``init_lora``,
``merge_block_lora``, ``block_lora``; ``MMDiT.forward``'s ``lora``) against the JAX
package's, on the CPU: the counterparts of ``tests/test_lora.py``'s adapter tests.

The base is a TINY denoiser with its zero leaves made random (a JAX tree through
``io/from_jax.py``), so every comparison reaches the output. Tolerance: a runtime adapter
against the merged weights and against JAX, atol / rtol 1e-5 on the velocity (fp32, the
delta's products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import lora as jlora
from foley_tpu.models import mmdit as jmm
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import lora_from_jax, mmdit_from_jax
from foley_tpu_torch.io.quantize import quantize_params
from foley_tpu_torch.models import lora as tlora
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.parallel import offload
from foley_tpu_torch.training import train as ttrain
from test_torch_mmdit import seeded_tree
from test_torch_train import _randomized_lora
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

CFG, J_CFG = TINY.model, J_TINY.model
RANK = 4
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def params():
    return seeded_tree(jax_tree_from_port(
        tmm.init(CFG, torch.Generator().manual_seed(0), device="cpu"), jmm.init, J_CFG), seed=3)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(2, 20, CFG.audio_vae_latent_dim)), np.asarray([500.0, 250.0]),
              rng.normal(size=(2, 8, CFG.condition_dim)), rng.normal(size=(2, 4, CFG.clip_dim)),
              rng.normal(size=(2, 16, CFG.sync_feat_dim)))
    return [a.astype(np.float32) for a in arrays]


def _forward(model, inputs, **kw):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in inputs), **kw).numpy()


def test_init_lora_matches_jax_tree(params):
    """The names (the adapter format's), shapes and dtype of JAX's ``init_lora`` tree; ``a``
    uniform within 1/sqrt(fan_in) (K * in for a conv), ``b`` zeros."""
    model = mmdit_from_jax(params, CFG, device="cpu")
    ref = lora_from_jax(jax.device_get(jlora.init_lora(jax.random.PRNGKey(3), params, RANK)))
    got = tlora.init_lora(model, torch.Generator().manual_seed(3), rank=RANK)
    assert sorted(got) == sorted(ref)
    for name, t in got.items():
        assert t.shape == ref[name].shape and t.dtype == torch.float32, name
        if name.endswith(".b"):
            assert not t.any(), name
            continue
        fan_in = t.shape[-2] * (t.shape[1] if t.ndim == 4 else 1)
        limit = fan_in ** -0.5
        assert float(t.abs().max()) <= limit and float(t.abs().max()) > 0.9 * limit, name
        assert float(ref[name].abs().max()) <= limit, name
    assert "triple_blocks.audio_mod.a" not in got  # the zero-init adaLN heads are not adapted
    assert {"single_blocks.linear2.w1.a", "single_blocks.linear1.a",
            "triple_blocks.audio_mlp.fc1.a"} <= set(got)
    with pytest.raises(ValueError, match="no LoRA targets"):
        tlora.init_lora(model, torch.Generator(), targets=["nothing"])


@pytest.mark.parametrize("attn_impl", ["fused", "xla"])
def test_fresh_lora_is_identity(params, inputs, attn_impl):
    """``b`` zero: the adapted forward equals the base's exactly, and so does the merge."""
    model = mmdit_from_jax(params, CFG, device="cpu")
    lora = tlora.init_lora(model, torch.Generator().manual_seed(3), rank=RANK)
    base = _forward(model, inputs, attn_impl=attn_impl)
    assert np.abs(base).max() > 0
    np.testing.assert_array_equal(_forward(model, inputs, attn_impl=attn_impl, lora=lora), base)
    tlora.merge_lora(model, lora, 1.0)
    np.testing.assert_array_equal(_forward(model, inputs, attn_impl=attn_impl), base)


def test_runtime_lora_matches_merged_and_jax(params, inputs):
    """A random adapter at scale 0.7: the runtime adapter (merged inside each block) equals
    the load-time merge and the JAX ``apply(..., lora=...)``; both differ from the base."""
    j_lora = _randomized_lora(params, rank=RANK)
    adapter = lora_from_jax(j_lora)
    model = mmdit_from_jax(params, CFG, device="cpu")
    base = _forward(model, inputs, attn_impl="xla")
    runtime = _forward(model, inputs, attn_impl="xla", lora=adapter, lora_scale=0.7)
    ref = np.asarray(jmm.apply(params, *(jnp.asarray(a) for a in inputs), J_CFG,
                               lora=j_lora, lora_scale=0.7))
    np.testing.assert_allclose(runtime, ref, **TOL)
    assert np.abs(runtime - base).max() > 1e-4
    tlora.merge_lora(model, adapter, 0.7)
    np.testing.assert_allclose(_forward(model, inputs, attn_impl="xla"), runtime, **TOL)


def test_runtime_lora_refuses_what_would_bypass_it(params, inputs):
    """The hoists (their weights would bypass the adapter), a quantized base and swapped
    blocks raise, with the JAX package's messages."""
    model = mmdit_from_jax(params, CFG, device="cpu")
    lora = tlora.init_lora(model, torch.Generator().manual_seed(3), rank=RANK)
    args = [torch.from_numpy(a) for a in inputs]
    text_kv = model.precompute_text_kv(args[2])
    with pytest.raises(ValueError, match="merge_lora"):
        model(*args, lora=lora, text_kv=text_kv)
    mods = model.precompute_triple_mods(args[1], torch.float32)
    with pytest.raises(ValueError, match="merge_lora"):
        model(*args, lora=lora, triple_mods=(mods[0][0], mods[1][0]))
    offload.offload_block_suffix(model, 2)
    for kw in (dict(lora=lora), dict(remat=True)):
        with pytest.raises(ValueError, match="placement-split"):
            model(*args, **kw)
    offload.merge_block_suffix(model)
    quantize_params(model, "int8")
    with pytest.raises(ValueError, match="quantized"):
        model(*args, lora=lora)


def test_lora_train_step_trains_the_factors_only(params):
    """Four LoRA steps on one fixed batch with fixed draws (Adam 3e-3, fp32): the loss falls,
    every factor gets a finite gradient, and no base weight changes or requires a gradient."""
    from foley_tpu_torch.training.optim import adam

    model = mmdit_from_jax(params, CFG, device="cpu")
    base = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in (
        ("latents", (2, 20, CFG.audio_vae_latent_dim)), ("cond", (2, 8, CFG.condition_dim)),
        ("clip_feat", (2, 4, CFG.clip_dim)), ("sync_feat", (2, 16, CFG.sync_feat_dim)))}
    init_state, step = ttrain.make_lora_train_step(model, optimizer=adam(3e-3),
                                                   compute_dtype=torch.float32)
    lora0 = tlora.init_lora(model, torch.Generator().manual_seed(6), rank=RANK)
    state = init_state(lora0)
    gen = torch.Generator().manual_seed(9)
    noise, sigma = torch.randn(2, 20, CFG.audio_vae_latent_dim, generator=gen), torch.rand(
        2, generator=gen)
    losses = []
    for _ in range(4):
        state, loss = step(state, batch, noise=noise, sigma=sigma)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 4 and all(not torch.equal(v, lora0[k]) for k, v in state.lora.items()
                                   if k.endswith(".b"))
    assert not any(p.requires_grad for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, base[k]), k
