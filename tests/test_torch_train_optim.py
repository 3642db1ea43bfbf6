"""The port's Adam and AdamW (``training/optim.py``) against ``optax.adam`` /
``optax.adamw``, and optax's state carried across (``io/from_jax.py::
optimizer_state_from_jax``), on the CPU.

The leaves are a TINY denoiser's (a JAX tree, numpy from a seed), the gradients numpy from a
seed, with ``empty_clip_feat``'s gradient zero (optax: zeros from ``jax.grad``; the port:
None, as ``torch.autograd.grad`` gives it): that leaf's moments stay zero and AdamW still
decays it. Tolerance, relative L2 per leaf: fp32 1e-7, bf16 2^-8 (one bf16 rounding step:
XLA may keep a product in fp32 across a fused op). Read: equal bit for bit in both, the
same per-op roundings in the same order (the bias correction's power taken as XLA takes
it, a float power).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import mmdit as jmm
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import optimizer_state_from_jax, state_dict_from_jax
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.training.optim import adam, adamw
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

REL = {torch.float32: 1e-7, torch.bfloat16: 2.0 ** -8}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
OPTIMIZERS = {"adamw": (lambda: optax.adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.01),
                        lambda: adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.01)),
              "adam": (lambda: optax.adam(1e-4, b1=0.9, b2=0.95),
                       lambda: adam(1e-4, b1=0.9, b2=0.95)),
              "adamw_defaults": (lambda: optax.adamw(3e-3), lambda: adamw(3e-3))}


@pytest.fixture(scope="module")
def tree():
    """A TINY tree with its empty clip features made random (zero at init), so their decay
    shows."""
    t = jax_tree_from_port(tmm.init(TINY.model, torch.Generator().manual_seed(0),
                                    device="cpu"), jmm.init, J_TINY.model)
    t["empty_clip_feat"] = np.random.default_rng(1).normal(
        size=t["empty_clip_feat"].shape).astype(np.float32)
    return t


def _grads(tree, seed):
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 1e-2).astype(np.float32), tree)
    g["empty_clip_feat"] = np.zeros_like(g["empty_clip_feat"])
    return g


def _assert_close(got: torch.Tensor, ref: torch.Tensor, dtype, name):
    got, ref = (t.double().numpy() for t in (got, ref))
    if not ref.any():
        assert not got.any(), name
        return
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= REL[dtype], (name, rel)


def _run(tree, dtype, name, steps):
    """``steps`` updates of the same leaves on both sides -> (port leaves and state, optax
    leaves and state)."""
    make_optax, make_port = OPTIMIZERS[name]
    j_params = jax.tree.map(lambda x: jnp.asarray(x, JDT[dtype]), tree)
    j_opt = make_optax()
    j_state = j_opt.init(j_params)
    t_params = {k: v.to(dtype) for k, v in state_dict_from_jax(tree).items()}
    t_opt = make_port()
    t_state = t_opt.init(t_params)
    for i in range(steps):
        g = _grads(tree, seed=10 + i)
        j_grads = jax.tree.map(lambda x: jnp.asarray(x, JDT[dtype]), g)
        updates, j_state = j_opt.update(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_grads = {k: v.to(dtype) for k, v in state_dict_from_jax(g).items()}
        t_grads["empty_clip_feat"] = None  # the leaf the loss does not reach
        t_state = t_opt.update_(t_params, t_grads, t_state)
    return (t_params, t_state), (j_params, j_state)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(tree, name, dtype, steps):
    (t_params, t_state), (j_params, j_state) = _run(tree, dtype, name, steps)
    adam_state = jax.device_get(j_state[0])
    refs = {"params": state_dict_from_jax(jax.device_get(j_params)),
            "mu": state_dict_from_jax(adam_state.mu), "nu": state_dict_from_jax(adam_state.nu)}
    assert t_state.count == int(adam_state.count) == steps
    for kind, got in (("params", t_params), ("mu", t_state.mu), ("nu", t_state.nu)):
        for k, v in got.items():
            assert v.dtype == dtype, (kind, k)
            _assert_close(v, refs[kind][k], dtype, f"{kind}.{k}")
    assert not t_state.mu["empty_clip_feat"].any()
    if dtype == torch.float32:  # in bf16 a 1e-6 relative decay rounds back to the leaf
        before = state_dict_from_jax(tree)["empty_clip_feat"]
        assert torch.equal(t_params["empty_clip_feat"], before) == (name == "adam")


def test_optimizer_state_from_jax_continues_optax():
    """optax's state after two steps, carried across, then one more step on each side: the
    same leaves and moments as optax's third step (fp32, 1e-7), for the full tree and for a
    LoRA adapter's (``lora=True``: the stacked factor names)."""
    from foley_tpu.models import lora as jlora
    from foley_tpu_torch.io.from_jax import lora_from_jax

    params = jax_tree_from_port(tmm.init(TINY.model, torch.Generator().manual_seed(0),
                                         device="cpu"), jmm.init, J_TINY.model)
    j_lora = jax.device_get(jlora.init_lora(jax.random.PRNGKey(1), params, rank=4))
    for leaves, convert, lora in ((params, state_dict_from_jax, False),
                                  (j_lora, lora_from_jax, True)):
        j_opt, port = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.01), adamw(
            1e-3, b1=0.9, b2=0.95, weight_decay=0.01)
        j_params = jax.tree.map(jnp.asarray, leaves)
        j_state = j_opt.init(j_params)
        for i in range(3):
            if i == 2:  # carry the state across before the last step
                t_state = optimizer_state_from_jax(jax.device_get(j_state), lora=lora)
                t_params = convert(jax.device_get(j_params))
                assert t_state.count == 2 and set(t_state.mu) == set(t_params)
            rng = np.random.default_rng(i)
            g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 1e-2).astype(np.float32),
                             leaves)
            updates, j_state = j_opt.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
            j_params = optax.apply_updates(j_params, updates)
        t_state = port.update_(t_params, convert(g), t_state)
        adam_state = jax.device_get(j_state[0])
        for got, ref in ((t_params, convert(jax.device_get(j_params))),
                         (t_state.mu, convert(adam_state.mu)),
                         (t_state.nu, convert(adam_state.nu))):
            for k, v in got.items():
                _assert_close(v, ref[k], torch.float32, k)
        assert t_state.count == 3


def test_optimizer_state_from_jax_needs_adam_state():
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        optimizer_state_from_jax((optax.EmptyState(),))
