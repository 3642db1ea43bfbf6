"""Training over a ("data", "model") mesh (``foley_tpu_torch/parallel/training.py``, with the
differentiable collectives of ``parallel/{mesh,sharding}.py``) against the one-rank port and
the JAX package's sharded steps (``tests/test_parallel.py``'s ``test_training_step_sharded``
and ``test_lora_training_step_sharded``), on the CPU: gloo ranks in spawned processes
(``tests/torch_parallel_programs.py::train_program``), one launch a mesh shape, (2, 2) and
(1, 2), one thread a rank.

Both sides see the same weights (``torch_helpers.jax_tree_from_port`` with the zero leaves
and the qk-norm weights made random, carried over through ``io/from_jax.py``), the same
global batch (numpy, from a seed) and the same noise and sigma: the JAX draws of the step's
key, injected into the port as the global batch's, of which each rank keeps its rows
(``jax.random`` bits cannot be reproduced).

Tolerances:
- against the one-rank port's step on the global batch: the loss and every gathered
  gradient within 1e-5 relative (the row sums and the ``data`` mean add the same fp32
  products in another order);
- against JAX's steps on its own (2, 2) mesh: ``tests/test_torch_train.py``'s ``LOSS_REL``,
  ``UPDATE_REL`` and ``MOMENT_REL`` (the losses, the parameters' or factors' updates and
  both moments after the first and the second step);
- the loops' resume, the replicated leaves across ranks and the checkpoints across the
  mesh and one rank: bit for bit.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_programs as programs
from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import mmdit as jmm
from foley_tpu.parallel import mesh as jmesh
from foley_tpu.parallel.sharding import shard_params as j_shard_params
from foley_tpu.training import train as jtrain
from foley_tpu_torch.api.nodes import HunyuanModelLoader
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import lora_from_jax, mmdit_from_jax, state_dict_from_jax
from foley_tpu_torch.io.quantize import quantize_params
from foley_tpu_torch.models import lora as tlora
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.parallel import training as pt
from foley_tpu_torch.parallel.launch import launch
from foley_tpu_torch.parallel.mesh import Axis, Mesh, RankMesh, make_mesh
from foley_tpu_torch.parallel.offload import offload_block_suffix
from foley_tpu_torch.parallel.sharding import lora_slices, shard_params, take_slice
from foley_tpu_torch.training import loop
from foley_tpu_torch.training import train as ttrain
from test_torch_mmdit import seeded_tree
from test_torch_train import LOSS_REL, MOMENT_REL, _assert_state_close, _draws
from test_torch_train import _rel
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

CFG, J_CFG = TINY.model, J_TINY.model
ONE_RANK_REL = 1e-5
MESHES = [(2, 2), (1, 2)]
B, LENGTH = 4, 20
#: XLA's CPU code generation without its expensive passes: each sharded step compiles in
#: about 15 s on an 8-core x86 CPU instead of 35 s, and the partitioned HLO is the same.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    shapes = {"latents": (b, LENGTH, CFG.audio_vae_latent_dim), "cond": (b, 8, CFG.condition_dim),
              "clip_feat": (b, 4, CFG.clip_dim), "sync_feat": (b, 16, CFG.sync_feat_dim)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def stand_in_mesh(data=1, model=1, rank=0):
    """A rank's mesh without process groups: what needs no collective (placement, rows,
    draws, refusals) runs on it in this process."""
    d, m = divmod(rank, model)
    axes = {"data": Axis("data", None, data, d), "model": Axis("model", None, model, m)}
    return RankMesh(Mesh(data, model, ("cpu",) * (data * model), "gloo"), rank, axes, None)


def _jax_sharded_steps(params, batch, key, lora=None, steps=2):
    """JAX's sharded steps on its (2, 2) mesh (``tests/test_parallel.py``'s setup): the
    full step's defaults, or the LoRA step with ``optax.adam(1e-2)`` over the sharded base.
    Returns each step's loss and its (trained leaves, mu, nu) in the port's names."""
    mesh = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    base = j_shard_params(params, mesh)
    if lora is None:
        init_state, train_step = jtrain.make_train_step(J_CFG, compute_dtype=jnp.float32)
        state, convert = init_state(base), state_dict_from_jax
    else:
        init_state, train_step = jtrain.make_lora_train_step(
            J_CFG, base, optimizer=optax.adam(1e-2), compute_dtype=jnp.float32)
        state, convert = init_state(lora), lora_from_jax
    ds = NamedSharding(mesh, P("data"))
    j_batch = {k: jax.device_put(jnp.asarray(v), ds) for k, v in batch.items()}
    jitted, out = jax.jit(train_step, compiler_options=FAST_COMPILE), []
    with mesh:
        for _ in range(steps):
            state, loss = jitted(state, j_batch, key)
            adam = jax.device_get(state.opt_state[0])
            leaves = state.params if lora is None else state.lora
            out.append((float(loss), convert(jax.device_get(leaves)), convert(adam.mu),
                        convert(adam.nu)))
    return out


def _jax_lora_tree(adapter):
    """The port's adapter as the JAX package's LoRA tree (``io/from_jax.py::lora_from_jax``
    inverted)."""
    tree = {}
    for name, t in adapter.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.numpy()
    return tree


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The weights, batches and draws; two adapters for the whole model (a fresh one, b = 0,
    and one with both factors random); the one-rank port's loss and gradients; a one-rank
    checkpoint for the mesh to restore."""
    params = seeded_tree(jax_tree_from_port(
        tmm.init(CFG, torch.Generator().manual_seed(0), device="cpu"), jmm.init, J_CFG), seed=3)
    model = mmdit_from_jax(params, CFG, device="cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(1)
    draws = _draws(jax.random.PRNGKey(4), batch)
    fresh = tlora.init_lora(model, torch.Generator().manual_seed(6), rank=4)
    rng = np.random.default_rng(7)
    lora_random = {k: torch.from_numpy((rng.normal(size=v.shape) * 0.05).astype(np.float32))
                   for k, v in fresh.items()}
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    adapter = {k: v.clone() for k, v in lora_random.items()}

    def one_rank(leaves, lora=None):
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            return ttrain.value_and_grad(lambda: ttrain.flow_match_loss(
                model, tensors, compute_dtype=torch.float32, lora=lora, lora_scale=0.7,
                noise=draws[0], sigma=draws[1]), leaves)
        finally:
            for t in leaves.values():
                t.requires_grad_(False)

    tmp = tmp_path_factory.mktemp("mesh_train")
    one_rank_state = loop.train(mmdit_from_jax(params, CFG, device="cpu"),
                                iter([_batch(40)]), 1, ckpt_dir=str(tmp / "one_rank"),
                                log_every=0, seed=9)
    stats = (np.linspace(-0.5, 0.5, CFG.audio_vae_latent_dim).astype(np.float32),
             np.linspace(0.5, 2.0, CFG.audio_vae_latent_dim).astype(np.float32))
    return {
        "params": params, "state": state, "batch": batch, "draws": draws,
        "step_key": jax.random.PRNGKey(1), "step_draws": _draws(jax.random.PRNGKey(1), batch),
        "lora_random": lora_random, "lora_fresh": fresh,
        "one_rank_full": one_rank(dict(model.named_parameters())),
        "one_rank_lora": one_rank(adapter, adapter),
        "tmp": tmp, "one_rank_state": one_rank_state,
        "one_rank_ckpt": loop.latest_checkpoint(str(tmp / "one_rank")), "latent_stats": stats,
        "loop_batches": [_batch(50 + i) for i in range(2)]}


def _launch(refs, data, model):
    """``train_program`` on a ``data x model`` mesh (the loops and exports on (2, 2))."""
    plan = {k: refs[k] for k in ("state", "batch", "draws", "step_draws", "lora_random",
                                 "lora_fresh", "loop_batches", "latent_stats")}
    plan.update(loops=(data, model) == (2, 2), tmp=str(refs["tmp"]),
                one_rank_ckpt=refs["one_rank_ckpt"])
    mesh = make_mesh(data, model, ["cpu"] * (data * model))
    return launch(mesh, programs.train_program, plan, threads=1, timeout=400)


@pytest.fixture(scope="module")
def results(refs):
    """The two launches (each in a thread: their ranks are processes of their own) while
    JAX's sharded steps compile and run here: (JAX's full steps, JAX's LoRA steps, the runs
    by mesh shape)."""
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        launched = {shape: pool.submit(_launch, refs, *shape) for shape in MESHES}
        j_full = _jax_sharded_steps(refs["params"], refs["batch"], refs["step_key"])
        j_lora = _jax_sharded_steps(refs["params"], refs["batch"], refs["step_key"],
                                    lora=_jax_lora_tree(refs["lora_fresh"]), steps=3)
        return j_full, j_lora, {shape: f.result() for shape, f in launched.items()}


@pytest.fixture(scope="module")
def runs(results):
    return results[2]


# ---------------------------------------------------------------------------------
# Without a launch: rows, draws, slices, refusals
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("data,rows", [(2, 4), (4, 8), (1, 3)])
def test_data_rows_split_the_global_batch(data, rows):
    """Each rank's rows, in rank order, make the global batch (numpy and tensors)."""
    batch = {"latents": np.arange(rows * 3, dtype=np.float32).reshape(rows, 3),
             "cond": torch.arange(rows * 2).reshape(rows, 2)}
    parts = [next(pt.data_rows(iter([batch]), stand_in_mesh(data, 1, r))) for r in range(data)]
    np.testing.assert_array_equal(np.concatenate([p["latents"] for p in parts]),
                                  batch["latents"])
    assert torch.equal(torch.cat([p["cond"] for p in parts]), batch["cond"])
    assert all(len(p["latents"]) == rows // data for p in parts)


def test_data_rows_refuse_a_batch_data_does_not_divide():
    with pytest.raises(ValueError, match="does not split over data=2"):
        next(pt.data_rows(iter([{"latents": np.zeros((3, 2))}]), stand_in_mesh(2, 2)))
    with pytest.raises(ValueError, match="different row counts"):
        next(pt.data_rows(iter([{"latents": np.zeros((4, 2)), "cond": np.zeros((2, 1))}]),
                          stand_in_mesh(2, 1)))


def test_rank_draws_are_the_global_batchs():
    """Every rank draws the global batch's noise, then sigma, and keeps its rows: what
    ``flow_match_loss`` draws on one card for the whole batch, from the same generator."""
    batch = {"latents": torch.zeros(4, 5, 3)}
    gen = torch.Generator().manual_seed(3)
    noise, sigma = torch.randn(4, 5, 3, generator=gen), torch.rand(4, generator=gen)
    for r in range(2):
        got = pt.rank_draws({"latents": batch["latents"][2 * r:2 * r + 2]},
                            stand_in_mesh(2, 2, 2 * r), torch.Generator().manual_seed(3))
        assert torch.equal(got[0], noise[2 * r:2 * r + 2])
        assert torch.equal(got[1], sigma[2 * r:2 * r + 2])
    given = pt.rank_draws({"latents": batch["latents"][2:]}, stand_in_mesh(2, 1, 1),
                          noise=noise, sigma=sigma)
    assert torch.equal(given[0], noise[2:]) and torch.equal(given[1], sigma[2:])
    with pytest.raises(ValueError, match="global batch"):
        pt.rank_draws({"latents": batch["latents"][2:]}, stand_in_mesh(2, 1, 1),
                      noise=noise[2:], sigma=sigma[2:])


@pytest.mark.parametrize("rank", [0, 1])
def test_lora_slices_follow_the_placed_layers(refs, rank):
    """On model rank ``rank`` of 2, every adapted weight merged from the sliced factors is
    that rank's slice of the weight merged from the whole ones, and the whole factors take
    the slices' gradients."""
    whole = mmdit_from_jax(refs["params"], CFG, device="cpu")
    placed = shard_params(mmdit_from_jax(refs["params"], CFG, device="cpu"),
                          stand_in_mesh(1, 2, rank))
    adapter = {k: v.clone().requires_grad_(True) for k, v in refs["lora_random"].items()}
    sliced = lora_slices(adapter, placed, stand_in_mesh(1, 2, rank))
    checked = 0
    for family, path, a, b in tlora._pairs(adapter):
        for i in range(len(getattr(whole, family))):
            w = getattr(whole, family)[i].get_submodule(path)
            p = getattr(placed, family)[i].get_submodule(path)
            full = tlora.merge_block_lora(w.weight, a[i], b[i], 0.7)
            part = tlora.merge_block_lora(p.weight, sliced[f"{family}.{path}.a"][i],
                                          sliced[f"{family}.{path}.b"][i], 0.7)
            if type(p).__name__.startswith("Column"):
                ref = take_slice(full, 0, p.parts, 2, rank)
            elif type(p).__name__.startswith("Row"):
                ref = take_slice(full, 1, 1, 2, rank)
            else:
                ref = full
            assert torch.equal(part, ref), (family, path, i)
            checked += 1
    assert checked == sum(len(getattr(whole, f)) for f, *_ in tlora._pairs(adapter))
    sum(v.sum() for v in sliced.values()).backward()
    assert all(adapter[k].grad is not None for k in adapter)


def test_adapter_of_the_placed_model_is_refused(refs):
    """``init_lora`` reads the weights' shapes: an adapter drawn after placing is a rank's
    shapes, and the LoRA step refuses it at its first entry."""
    mesh = stand_in_mesh(1, 2)
    placed = shard_params(mmdit_from_jax(refs["params"], CFG, device="cpu"), mesh)
    adapter = tlora.init_lora(placed, torch.Generator().manual_seed(0), rank=4)
    init_state, _ = pt.make_sharded_lora_train_step(placed, mesh)
    with pytest.raises(ValueError, match="before shard_params"):
        init_state(adapter)


def test_refusals_at_one_entry(refs):
    """Block swap (any mesh) and integer storage at ``model > 1``: the step's creation
    refuses (``shard_params``); a LoRA base in integer storage: its first step
    (``block_lora``, as JAX's merge refuses it)."""
    swapped = mmdit_from_jax(refs["params"], CFG, device="cpu")
    offload_block_suffix(swapped, 1)
    with pytest.raises(ValueError, match="block swap|swapped"):
        pt.make_sharded_train_step(swapped, stand_in_mesh(2, 1))
    int8 = mmdit_from_jax(refs["params"], CFG, device="cpu")
    quantize_params(int8, "int8")
    with pytest.raises(ValueError, match="int8 weight storage at model=2"):
        pt.make_sharded_lora_train_step(int8, stand_in_mesh(1, 2))
    init_state, step = pt.make_sharded_lora_train_step(int8, stand_in_mesh())
    state = init_state(refs["lora_fresh"])
    with pytest.raises(ValueError, match="cannot merge LoRA"):
        step(state, {k: torch.from_numpy(v) for k, v in refs["batch"].items()},
             torch.Generator().manual_seed(0))


def test_world_of_one_equals_the_one_card_step_bit_for_bit(refs):
    """A mesh of one rank issues no collective and steps as ``make_train_step`` does, bit for
    bit (what ``chip_smoke.py``'s ``nccl_world1`` holds on the card)."""
    batch = {k: torch.from_numpy(v) for k, v in refs["batch"].items()}
    results = []
    for make in (lambda m: ttrain.make_train_step(m, compute_dtype=torch.float32),
                 lambda m: pt.make_sharded_train_step(m, stand_in_mesh(),
                                                      compute_dtype=torch.float32)):
        model = mmdit_from_jax(refs["params"], CFG, device="cpu")
        init_state, step = make(model)
        state, loss = step(init_state(model), batch, loop.step_generator(3, 0, "cpu"))
        results.append((loss, state))
    (l1, s1), (l2, s2) = results
    assert torch.equal(l1, l2)
    for k, v in s1.params.items():
        assert torch.equal(v, s2.params[k]) and torch.equal(s1.opt_state.nu[k],
                                                            s2.opt_state.nu[k]), k


# ---------------------------------------------------------------------------------
# On the mesh
# ---------------------------------------------------------------------------------

def _assert_grads(got: dict, unreached, ref: dict, tol=ONE_RANK_REL):
    reached = 0
    for name, r in ref.items():
        if r is None or not r.any():
            assert name in unreached or not got[name].any(), name
            continue
        reached += 1
        assert _rel(got[name].numpy(), r.numpy()) <= tol, (name, _rel(got[name].numpy(),
                                                                      r.numpy()))
    assert reached > len(ref) // 2


@pytest.mark.parametrize("shape", MESHES)
def test_gradients_match_the_one_rank_port(refs, runs, shape):
    """The global loss and every gathered gradient (full and LoRA) within 1e-5 of the
    one-rank port's step on the global batch."""
    out = runs[shape]
    loss, grads = refs["one_rank_full"]
    assert abs(float(out["full_loss"]) - float(loss)) <= ONE_RANK_REL * abs(float(loss))
    _assert_grads(out["full_grads"], out["unreached"], grads)
    loss, grads = refs["one_rank_lora"]
    assert abs(float(out["lora_loss"]) - float(loss)) <= ONE_RANK_REL * abs(float(loss))
    _assert_grads(out["lora_grads"], (), grads)


@pytest.mark.parametrize("shape", MESHES)
def test_full_steps_match_jax_sharded(refs, results, shape):
    """Two full steps on one batch and key against JAX's ``make_train_step`` on its (2, 2)
    mesh: the losses, the updates and both moments; the loss falls, as JAX's test asserts."""
    out = results[2][shape]
    before = refs["state"]
    for i, ((j_loss, j_params, j_mu, j_nu), loss, whole) in enumerate(
            zip(results[0], out["full_losses"], out["full_states"])):
        assert abs(loss - j_loss) <= LOSS_REL * abs(j_loss)
        params, mu, nu, step, count = whole
        assert step == count == i + 1
        _assert_state_close(params, mu, nu, {k: before[k] for k in params}, j_params, j_mu,
                            j_nu, MOMENT_REL[i])
    assert out["full_losses"][1] < out["full_losses"][0]


@pytest.mark.parametrize("shape", MESHES)
def test_lora_steps_match_jax_sharded(refs, results, shape):
    """Three LoRA steps (adam 1e-2) on one batch and key against JAX's
    ``make_lora_train_step`` over its sharded base: the losses, and the factors and moments
    after the first two steps; the loss falls; the base is unchanged on every rank."""
    out = results[2][shape]
    for i, ((j_loss, j_lora, j_mu, j_nu), loss) in enumerate(
            zip(results[1], out["lora_losses"])):
        assert abs(loss - j_loss) <= LOSS_REL * abs(j_loss), (i, loss, j_loss)
        if i < 2:
            lora, mu, nu, _, _ = out["lora_states"][i]
            _assert_state_close(lora, mu, nu, refs["lora_fresh"], j_lora, j_mu, j_nu,
                                MOMENT_REL[i])
    assert out["lora_losses"][2] < out["lora_losses"][0]
    assert all(r["base_unchanged"] for r in out["ranks"])


@pytest.mark.parametrize("shape", MESHES)
def test_replicated_leaves_stay_identical_across_ranks(runs, shape):
    """After the steps every replicated parameter and every LoRA factor holds the same
    bits on every rank, and a sharded leaf on every rank of its ``model`` column."""
    ranks = runs[shape]["ranks"]
    sharded = set(ranks[0]["sharded"])
    for name in ranks[0]["param_digests"]:
        groups = {}
        for r in ranks:
            key = r["model_rank"] if name in sharded else 0
            groups.setdefault(key, set()).add(r["param_digests"][name])
        assert all(len(d) == 1 for d in groups.values()), name
    assert len({tuple(sorted(r["lora_digests"].items())) for r in ranks}) == 1
    if shape[1] > 1:
        assert len({r["param_digests"][n] for r in ranks for n in sharded}) > 1


@pytest.mark.parametrize("shape", MESHES)
def test_collectives_of_a_step(runs, shape):
    """A rank's collectives in one full forward and backward: the forward's row sums and
    gathers, recomputed in the backward by the checkpointed blocks (the sync MLP is not
    checkpointed), the column inputs' gradient sums, the gradient buckets and the loss."""
    data, model = shape
    rows = 6 * CFG.depth_triple_blocks + 2 * CFG.depth_single_blocks
    gathers = 2 * CFG.depth_triple_blocks + CFG.depth_single_blocks
    for r in runs[shape]["ranks"]:
        c = {k: v["calls"] for k, v in r["counts"].items()}
        assert c["all_reduce"] == rows + 1 and c["backward.all_reduce"] == rows
        assert c["all_gather"] == c["backward.all_gather"] == gathers
        assert c["backward.all_reduce_dx"] > 0
        assert 1 <= c["all_reduce_grads"] <= 4
        assert c.get("all_reduce_loss", 0) == (data > 1)
        assert {"ColumnParallelDense", "RowParallelConv1d"} <= set(r["layers"])


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_mesh_resume_is_bit_for_bit(runs, kind):
    """``train_sharded`` / ``train_lora_sharded``: one step, a checkpoint and a resume to
    two equal two steps straight, bit for bit (JAX's
    ``test_training_loop_checkpoint_resume``)."""
    out = runs[(2, 2)]
    straight, resumed = out[f"{kind}_straight"], out[f"{kind}_resumed"]
    assert straight[3:] == resumed[3:] == (2, 2)
    for i in range(3):
        for name, t in straight[i].items():
            assert torch.equal(t, resumed[i][name]), (i, name)


def test_mesh_checkpoint_restores_on_one_rank(refs, runs):
    """``training/loop.py::restore_checkpoint`` on one rank reads the mesh's checkpoint:
    the whole state, equal to the mesh's gathered one."""
    out = runs[(2, 2)]
    model = tmm.MMDiT(CFG, device="cpu")
    init_state, _ = ttrain.make_train_step(model)
    state = loop.restore_checkpoint(loop.latest_checkpoint(out["full_ckpt"]), init_state(model))
    params, mu, nu, step, count = out["full_resumed"]
    assert state.step == step == 2 and state.opt_state.count == count
    for name, t in params.items():
        assert torch.equal(state.params[name], t) and torch.equal(
            state.opt_state.mu[name], mu[name]) and torch.equal(state.opt_state.nu[name],
                                                                nu[name]), name


def test_one_rank_checkpoint_restores_on_the_mesh(refs, runs):
    """A checkpoint of ``training/loop.py::train`` on one rank, restored on the (2, 2)
    mesh and gathered back: the one-rank run's state."""
    ref = refs["one_rank_state"]
    params, mu, nu, step, count = runs[(2, 2)]["one_rank_restored"]
    assert step == ref.step == 1 and count == ref.opt_state.count
    for name, t in params.items():
        assert torch.equal(t, ref.params[name]) and torch.equal(
            mu[name], ref.opt_state.mu[name]) and torch.equal(nu[name],
                                                              ref.opt_state.nu[name]), name


def test_exports_load_through_the_one_card_loader(refs, runs):
    """The mesh's exports: the whole model (with its latent statistics) and the adapter,
    loaded by ``HunyuanModelLoader`` on one rank (the adapter merged at load over the
    export), equal to the mesh's trained state."""
    out = runs[(2, 2)]
    (fm,) = HunyuanModelLoader().load_model(out["full_export"], config="tiny", device="cpu")
    params = out["full_resumed"][0]
    for k, v in fm["params"].state_dict().items():
        assert torch.equal(v, params[k]), k
    for got, want in zip(fm["latent_stats"], refs["latent_stats"]):
        np.testing.assert_array_equal(got.numpy(), want)
    (merged,) = HunyuanModelLoader().load_model(out["full_export"], config="tiny",
                                                lora_path=out["lora_export"], device="cpu")
    expected = mmdit_from_jax(refs["params"], CFG, device="cpu")
    expected.load_state_dict(params)
    tlora.merge_lora(expected, out["lora_resumed"][0], 0.5)
    for k, v in merged["params"].state_dict().items():
        assert torch.equal(v, expected.state_dict()[k]), k
    assert not torch.equal(merged["params"].single_blocks[0].linear_qkv.weight,
                           fm["params"].single_blocks[0].linear_qkv.weight)
