"""The port's flow-matching loss, its gradients and its train steps (``training/train.py``)
against the JAX package's, on the CPU.

Both sides see the same weights (a JAX tree from the port's init with its zero leaves made
random, through ``io/from_jax.py``), the same batch (numpy, from a seed) and the same noise
and sigma: the JAX draws of the step's key, injected into the port (``jax.random`` bits
cannot be reproduced). The JAX side is ``foley_tpu.training.train`` as it stands: the XLA
attention route with ``remat=True``.

Tolerances: the loss within 1e-6 relative, every gradient leaf within 1e-5 relative L2 (the
same fp32 products summed in another order; a leaf the loss does not reach is None on the
port's side and zero on JAX's). The steps: the parameters' updates (new minus old) within
3e-4 relative L2 (read up to 1.1e-4): a new parameter is ``p + u`` rounded to fp32, whose
step at |p| ~ 0.05 is 4e-5 of the 1e-4 update, and an Adam update ``m / (sqrt(v) + eps)``
divides by the gradient's own size, so an element whose gradient is near eps moves the most
for a given difference in it. The moments within
1e-5 relative L2 after the first step (they are linear and quadratic in the gradients) and
within 1e-4 after the second, whose gradients follow from the first update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.configs import XXL as J_XXL
from foley_tpu.models import lora as jlora
from foley_tpu.models import mmdit as jmm
from foley_tpu.pipeline import features as jfeat
from foley_tpu.training import train as jtrain
from foley_tpu_torch.configs import TINY, XXL
from foley_tpu_torch.io.from_jax import lora_from_jax, mmdit_from_jax, state_dict_from_jax
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.pipeline import features as tfeat
from foley_tpu_torch.training import train as ttrain
from test_torch_mmdit import seeded_tree
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

LOSS_REL, GRAD_REL, UPDATE_REL = 1e-6, 1e-5, 3e-4
MOMENT_REL = (1e-5, 1e-4)  # after the first step, after the second
CUT = dict(depth_triple_blocks=1, depth_single_blocks=1)
CONFIGS = {"tiny": (TINY.model, J_TINY.model, 20),
           "xxl": (dataclasses.replace(XXL.model, **CUT),
                   dataclasses.replace(J_XXL.model, **CUT), 25)}


def _rel(got, ref) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
                 / np.linalg.norm(np.asarray(ref, np.float64)))


def _batch(cfg, length, seed, b=2):
    rng = np.random.default_rng(seed)
    shapes = {"latents": (b, length, cfg.audio_vae_latent_dim), "cond": (b, 8, cfg.condition_dim),
              "clip_feat": (b, 4, cfg.clip_dim), "sync_feat": (b, 16, cfg.sync_feat_dim)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _draws(key, batch):
    """The noise and sigma ``foley_tpu.training.train.flow_match_loss`` draws from ``key``."""
    k_noise, k_t = jax.random.split(key)
    x1 = batch["latents"]
    return (torch.from_numpy(np.array(jax.random.normal(k_noise, x1.shape, jnp.float32))),
            torch.from_numpy(np.array(jax.random.uniform(k_t, (x1.shape[0],), jnp.float32))))


def _randomized_lora(params, seed=7, rank=4, scale=0.05):
    """A JAX adapter with both factors random (a fresh one has b = 0)."""
    lora = jlora.init_lora(jax.random.PRNGKey(seed), params, rank=rank)
    leaves, treedef = jax.tree.flatten(lora)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    return jax.device_get(jax.tree.unflatten(treedef, [
        jax.random.normal(k, x.shape, x.dtype) * scale for k, x in zip(keys, leaves)]))


def _port_value_and_grad(model, batch, draws, lora=None, lora_scale=1.0, remat=True):
    """The loss and the gradients of every parameter (``lora`` None) or of every factor,
    through ``training/train.py::value_and_grad``; ``remat`` False runs ``flow_match_loss``'s
    arithmetic with the blocks not checkpointed."""
    noise, sigma = draws
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = dict(model.named_parameters()) if lora is None else lora

    def loss_fn():
        if remat:
            return ttrain.flow_match_loss(model, tensors, compute_dtype=torch.float32,
                                          lora=lora, lora_scale=lora_scale, noise=noise,
                                          sigma=sigma)
        x1 = tensors["latents"]
        x = (1 - sigma)[:, None, None] * x1 + sigma[:, None, None] * noise
        pred = model(x, sigma * 1000, *(tensors[k] for k in ("cond", "clip_feat", "sync_feat")),
                     attn_impl="xla", remat=False, lora=lora, lora_scale=lora_scale)
        return (pred - (noise - x1)).square().mean()

    for t in leaves.values():
        t.requires_grad_(True)
    try:
        return ttrain.value_and_grad(loss_fn, leaves)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)


def _assert_grads_close(got: dict, ref: dict, tol=GRAD_REL):
    assert set(got) == set(ref)
    reached = 0
    for name, g in got.items():
        r = ref[name].numpy()
        if not np.any(r):  # a leaf the loss does not reach
            assert g is None or not g.any(), name
            continue
        reached += 1
        assert g is not None, name
        assert _rel(g.numpy(), r) <= tol, (name, _rel(g.numpy(), r))
    assert reached > len(got) // 2


def _setup(name):
    cfg, j_cfg, length = CONFIGS[name]
    params = seeded_tree(jax_tree_from_port(
        tmm.init(cfg, torch.Generator().manual_seed(0), device="cpu"), jmm.init, j_cfg), seed=3)
    return cfg, j_cfg, params, _batch(cfg, length, seed=1)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def tiny():
    return _setup("tiny")


@pytest.mark.parametrize("mode", ["full", "lora"])
def test_flow_match_loss_and_grads_match_jax(setup, mode):
    """At TINY and at the XXL width (1 + 1 blocks, hidden 1536, 12 heads of 128)."""
    cfg, j_cfg, params, batch = setup
    key = jax.random.PRNGKey(4)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = mmdit_from_jax(params, cfg, device="cpu")
    if mode == "full":
        j_loss, j_grads = jax.value_and_grad(jtrain.flow_match_loss)(
            params, j_batch, key, j_cfg, jnp.float32)
        ref = state_dict_from_jax(jax.device_get(j_grads))
        loss, grads = _port_value_and_grad(model, batch, _draws(key, batch))
    else:
        j_lora = _randomized_lora(params)
        j_loss, j_grads = jax.value_and_grad(
            lambda lo: jtrain.flow_match_loss(params, j_batch, key, j_cfg, jnp.float32, lora=lo,
                                              lora_scale=0.7))(j_lora)
        ref = lora_from_jax(jax.device_get(j_grads))
        loss, grads = _port_value_and_grad(model, batch, _draws(key, batch),
                                           lora=lora_from_jax(j_lora), lora_scale=0.7)
        assert not any(p.requires_grad for p in model.parameters())
    assert abs(float(loss) - float(j_loss)) <= LOSS_REL * abs(float(j_loss))
    _assert_grads_close(grads, ref)


def test_remat_gradients_equal_bit_for_bit(tiny):
    """Recomputing each block in the backward changes no bit of any gradient, the LoRA
    factors' (merged inside the checkpointed block) included."""
    cfg, _, params, batch = tiny
    model = mmdit_from_jax(params, cfg, device="cpu")
    draws = _draws(jax.random.PRNGKey(2), batch)
    lora = lora_from_jax(_randomized_lora(params))
    for adapter in (None, lora):
        (l_on, g_on), (l_off, g_off) = (
            _port_value_and_grad(model, batch, draws, lora=adapter, remat=r) for r in (True, False))
        assert torch.equal(l_on, l_off)
        for name, g in g_on.items():
            assert (g is None) == (g_off[name] is None), name
            assert g is None or torch.equal(g, g_off[name]), name


def test_training_route_never_calls_the_kernel(tiny, monkeypatch):
    """``attn_impl="xla"``: no call reaches ``fused_qk_attention`` in either block family
    (the inference route does, once a block)."""
    cfg, _, params, batch = tiny
    model = mmdit_from_jax(params, cfg, device="cpu")
    calls = []
    real = tmm.fused_qk_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tmm, "fused_qk_attention", counting)
    init_state, step = ttrain.make_lora_train_step(model, compute_dtype=torch.float32)
    from foley_tpu_torch.models.lora import init_lora

    state = init_state(init_lora(model, torch.Generator().manual_seed(0), rank=4))
    step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
    assert not calls
    with torch.no_grad():
        model(*(torch.from_numpy(batch[k]) for k in ("latents",)), torch.tensor([500.0, 20.0]),
              *(torch.from_numpy(batch[k]) for k in ("cond", "clip_feat", "sync_feat")))
    assert len(calls) == cfg.depth_triple_blocks + cfg.depth_single_blocks


def test_step_keeps_tf32_out_under_high_precision(monkeypatch):
    """A caller's ``"high"`` fp32 matmul precision lets TF32 in on a card; the fp32 step holds
    it off in every block's forward and in its recomputation in the backward (``true_fp32``
    around the step, ``exact_fp32`` inside the checkpointed block), and the step's result
    equals the one at the default precision bit for bit."""
    cfg, j_cfg, _ = CONFIGS["tiny"]
    params = seeded_tree(jax_tree_from_port(
        tmm.init(cfg, torch.Generator().manual_seed(0), device="cpu"), jmm.init, j_cfg), seed=3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 20, seed=1).items()}
    seen = []
    real = tmm.SingleBlock.forward

    def recording(self, *a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(self, *a, **k)

    monkeypatch.setattr(tmm.SingleBlock, "forward", recording)
    results = []
    for precision in ("highest", "high"):
        model = mmdit_from_jax(params, cfg, device="cpu")
        init_state, step = ttrain.make_train_step(model, compute_dtype=torch.float32)
        torch.set_float32_matmul_precision(precision)
        try:
            state, loss = step(init_state(model), batch, torch.Generator().manual_seed(5))
        finally:
            torch.set_float32_matmul_precision("highest")
        results.append((loss, state.params))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert len(seen) == 2 * 2 * cfg.depth_single_blocks and not any(seen)  # forward + recompute
    assert torch.equal(results[0][0], results[1][0])
    for name, p in results[0][1].items():
        assert torch.equal(p, results[1][1][name]), name


def _assert_state_close(got_leaves, got_mu, got_nu, before, ref_leaves, ref_mu, ref_nu,
                        moment_rel):
    for name, p in got_leaves.items():
        moved = (p - before[name]).numpy()
        ref_moved = ref_leaves[name].numpy() - before[name].numpy()
        if np.any(ref_moved):
            assert _rel(moved, ref_moved) <= UPDATE_REL, (name, _rel(moved, ref_moved))
        else:
            assert not np.any(moved), name
        for got, ref in ((got_mu, ref_mu), (got_nu, ref_nu)):
            r = ref[name].numpy()
            if np.any(r):
                assert _rel(got[name].numpy(), r) <= moment_rel, name
            else:
                assert not got[name].any(), name


def test_train_step_matches_jax():
    """``make_train_step``'s defaults (adamw 1e-4, b1 0.9, b2 0.95, weight decay 0.01), two
    steps at TINY in fp32: the losses, the parameters and both moments. The empty features
    the batch does not use get no gradient and are still decayed, as optax decays them."""
    cfg, j_cfg, length = CONFIGS["tiny"]
    params = seeded_tree(jax_tree_from_port(
        tmm.init(cfg, torch.Generator().manual_seed(0), device="cpu"), jmm.init, j_cfg), seed=3)
    init_j, step_j = jtrain.make_train_step(j_cfg, compute_dtype=jnp.float32)
    model = mmdit_from_jax(params, cfg, device="cpu")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    init_t, step_t = ttrain.make_train_step(model, compute_dtype=torch.float32)
    j_state, t_state = init_j(params), init_t(model)
    for i, key in enumerate((jax.random.PRNGKey(11), jax.random.PRNGKey(12))):
        batch = _batch(cfg, length, seed=20 + i)
        j_state, j_loss = jax.jit(step_j)(j_state, {k: jnp.asarray(v) for k, v in batch.items()},
                                          key)
        noise, sigma = _draws(key, batch)
        t_state, loss = step_t(t_state, {k: torch.from_numpy(v) for k, v in batch.items()},
                               noise=noise, sigma=sigma)
        assert abs(float(loss) - float(j_loss)) <= LOSS_REL * abs(float(j_loss))
        adam = jax.device_get(j_state.opt_state[0])
        _assert_state_close(t_state.params, t_state.opt_state.mu, t_state.opt_state.nu, before,
                            state_dict_from_jax(jax.device_get(j_state.params)),
                            state_dict_from_jax(adam.mu), state_dict_from_jax(adam.nu),
                            MOMENT_REL[i])
    assert t_state.step == 2 and t_state.opt_state.count == 2
    assert not any(p.requires_grad for p in model.parameters())
    # no gradient reaches the empty clip features (the batch brings its own), yet they decay
    assert not t_state.opt_state.mu["empty_clip_feat"].any()
    assert not torch.equal(t_state.params["empty_clip_feat"], before["empty_clip_feat"])


def test_lora_train_step_matches_jax():
    """``make_lora_train_step``'s defaults (adam 1e-4, b1 0.9, b2 0.95) from a fresh JAX
    adapter (b = 0: only b has a gradient at step one), two steps at TINY in fp32: the
    losses, the factors and both moments; the base is unchanged."""
    cfg, j_cfg, length = CONFIGS["tiny"]
    params = seeded_tree(jax_tree_from_port(
        tmm.init(cfg, torch.Generator().manual_seed(0), device="cpu"), jmm.init, j_cfg), seed=3)
    j_lora = jax.device_get(jlora.init_lora(jax.random.PRNGKey(6), params, rank=4))
    init_j, step_j = jtrain.make_lora_train_step(j_cfg, params, lora_scale=0.5,
                                                 compute_dtype=jnp.float32)
    model = mmdit_from_jax(params, cfg, device="cpu")
    base = {k: v.clone() for k, v in model.state_dict().items()}
    init_t, step_t = ttrain.make_lora_train_step(model, lora_scale=0.5,
                                                 compute_dtype=torch.float32)
    lora0 = lora_from_jax(j_lora)
    j_state, t_state = init_j(j_lora), init_t(lora0)
    for i, key in enumerate((jax.random.PRNGKey(13), jax.random.PRNGKey(14))):
        batch = _batch(cfg, length, seed=30 + i)
        j_state, j_loss = jax.jit(step_j)(j_state, {k: jnp.asarray(v) for k, v in batch.items()},
                                          key)
        noise, sigma = _draws(key, batch)
        t_state, loss = step_t(t_state, {k: torch.from_numpy(v) for k, v in batch.items()},
                               noise=noise, sigma=sigma)
        assert abs(float(loss) - float(j_loss)) <= LOSS_REL * abs(float(j_loss))
        adam = jax.device_get(j_state.opt_state[0])
        _assert_state_close({k: v.detach() for k, v in t_state.lora.items()},
                            t_state.opt_state.mu, t_state.opt_state.nu, lora0,
                            lora_from_jax(jax.device_get(j_state.lora)), lora_from_jax(adam.mu),
                            lora_from_jax(adam.nu), MOMENT_REL[i])
    for k, v in model.state_dict().items():
        assert torch.equal(v, base[k]), k


def test_apply_drop_visual_matches_jax():
    cfg, j_cfg, _ = CONFIGS["tiny"]
    params = seeded_tree(jax_tree_from_port(
        tmm.init(cfg, torch.Generator().manual_seed(0), device="cpu"), jmm.init, j_cfg), seed=3)
    model = mmdit_from_jax(params, cfg, device="cpu")
    batch = _batch(cfg, 20, seed=9, b=4)
    mask = np.array([True, False, True, False])
    j_clip, j_sync = jfeat.apply_drop_visual(params, jnp.asarray(batch["clip_feat"]),
                                             jnp.asarray(batch["sync_feat"]), jnp.asarray(mask))
    clip, sync = tfeat.apply_drop_visual(model, torch.from_numpy(batch["clip_feat"]),
                                         torch.from_numpy(batch["sync_feat"]),
                                         torch.from_numpy(mask))
    np.testing.assert_array_equal(clip.numpy(), np.asarray(j_clip))
    np.testing.assert_array_equal(sync.numpy(), np.asarray(j_sync))
    assert not np.array_equal(clip[0].numpy(), batch["clip_feat"][0])
    np.testing.assert_array_equal(clip[1].numpy(), batch["clip_feat"][1])
