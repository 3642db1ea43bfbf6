"""The mesh (``foley_tpu_torch/parallel/{mesh,sharding,launch,inference}.py``) against the JAX
package's ``foley_tpu/parallel/`` on the CPU: gloo ranks in spawned processes
(``tests/torch_parallel_programs.py``), the inputs and weights seeded numpy carried over
through ``io/from_jax.py`` (and ``torch_helpers.jax_tree_from_port``).

Tolerance: the sharded forward against JAX's ``mmdit.apply`` at the JAX test's own atol 2e-4
/ rtol 1e-3 (``tests/test_parallel.py``), and against the port's one-rank forward at 1e-5
(the row-parallel sums add the same fp32 products in another order). ``sharded_generate``:
its latents within 1e-5 of JAX's and of the one-rank port's, and its audio at the JAX test's
atol 5e-4 / rtol 1e-2 against the decode of those same latents. The random TINY decoder
ends in a saturated tanh (99.8% of its samples are +-1), so latents 2.4e-7 apart decode to
waveforms whose zero crossings move: about 100 of the 96,000 samples differ by more than
5e-4 between any two of JAX, the one-rank port and the mesh, as they do between the port's
and JAX's decode of JAX's own latents. Audio is therefore held on the same latents.

Each launch spawns its ranks, which import torch: the forward and the generation share one
launch per mesh shape, and every rank runs on one thread.
"""

import copy
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_programs as programs
from foley_tpu.configs import TINY as J_TINY
from foley_tpu.configs import XXL as J_XXL
from foley_tpu.core.params import flatten_params
from foley_tpu.io import quantize as jquant
from foley_tpu.models import dac_vae as jdac
from foley_tpu.models import mmdit as jmmdit
from foley_tpu.parallel import mesh as jmesh
from foley_tpu.parallel import sharding as jshard
from foley_tpu.pipeline import generate as jgen
from foley_tpu.sampling.denoise import prepare_latents as j_prepare_latents
from foley_tpu_torch.configs import TINY, XXL
from foley_tpu_torch.core.params import perturb_zero_leaves
from foley_tpu_torch.io.from_jax import dac_from_jax
from foley_tpu_torch.io.quantize import quantize_params
from foley_tpu_torch.models import dac_vae, mmdit
from foley_tpu_torch.parallel import sharding
from foley_tpu_torch.parallel.launch import RankFailed, launch
from foley_tpu_torch.parallel.mesh import make_mesh, rank_devices
from foley_tpu_torch.pipeline import generate as tgen
from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio
from foley_tpu_torch.sampling.denoise import to_pcm16
from torch_helpers import jax_tree_from_port, one_torch_thread  # noqa: F401 (autouse)

CFG = TINY.model
J_CFG = J_TINY.model
FORWARD_JAX_TOL = dict(atol=2e-4, rtol=1e-3)   # tests/test_parallel.py's forward bound
GENERATE_JAX_TOL = dict(atol=5e-4, rtol=1e-2)  # tests/test_parallel.py's audio bound
TIGHT_TOL = dict(atol=1e-5, rtol=1e-5)
GEN_KW = dict(duration_s=1.0, guidance_scale=4.5, num_inference_steps=2, batch_size=2,
              seed=5, text_bucket=16)  # the JAX test's


# ---------------------------------------------------------------------------------
# make_mesh
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("data,model,n", [
    (None, None, 8), (None, 2, 8), (4, None, 8), (4, 2, 8), (2, 4, 8), (None, None, 1),
    (None, 3, 8), (3, None, 8), (3, 2, 8), (2, 2, 8)])
def test_make_mesh_matches_jax(data, model, n):
    """Shapes and rank order as JAX's ``make_mesh`` gives them, and a ``ValueError`` where
    JAX asserts."""
    try:
        ref = jmesh.make_mesh(data, model, jax.devices()[:n])
    except AssertionError:
        with pytest.raises(ValueError):
            make_mesh(data, model, ["cpu"] * n)
        return
    got = make_mesh(data, model, ["cpu"] * n)
    assert got.shape == dict(ref.shape) and got.world == n
    # rank r = d * model + m sits where JAX puts device r of the list
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    assert ids.tolist() == np.arange(n).reshape(got.data, got.model).tolist()


def test_backend_and_placement():
    """NCCL only where every rank has a card of its own; ranks sharing a card or on the
    CPU take gloo; ``--device cuda`` refuses more ranks than visible cards."""
    assert make_mesh(2, 1, ["cuda:0", "cuda:1"]).backend == "nccl"
    assert make_mesh(1, 2, ["cuda:0", "cuda:0"]).backend == "gloo"
    assert make_mesh(2, 2, ["cpu"] * 4).backend == "gloo"
    with pytest.raises(ValueError, match="all be CUDA cards or all the CPU"):
        make_mesh(2, 1, ["cuda:0", "cpu"])
    assert rank_devices("cpu", 2, 2) == ("cpu",) * 4
    assert rank_devices("cpu", 2) == ("cpu",) * 2
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 cards"):
            rank_devices("cuda", 1, 2)


# ---------------------------------------------------------------------------------
# The rule table
# ---------------------------------------------------------------------------------

def _jax_path(name: str, template) -> str:
    """The JAX tree's flat path of a port state-dict name: stacked blocks lose their index,
    and a layer's ``weight`` / ``bias`` are ``w`` / ``b`` (a norm's ``weight`` keeps its
    name)."""
    parts = name.split(".")
    if parts[0] in ("triple_blocks", "single_blocks"):
        parts.pop(1)
    path = ".".join(parts)
    if path in template:
        return path
    parts[-1] = {"weight": "w", "bias": "b"}[parts[-1]]
    return ".".join(parts)


def _jax_axis(spec: P, ndim: int):
    """The torch axis of the JAX spec's ``model`` axis: JAX's last axis (out) is torch's 0,
    the one before it (in) torch's 1; None when replicated."""
    if jmesh.MODEL_AXIS not in tuple(spec):
        return None
    return {-1: 0, -2: 1}[tuple(spec).index(jmesh.MODEL_AXIS) - ndim]


@pytest.mark.parametrize("config", ["tiny", "xxl"])
def test_rule_table_matches_jax_leaf_by_leaf(config):
    """Every port leaf gets the kind and the sharded axis that JAX's ``partition_spec_for``
    gives its counterpart; the table is JAX's, regex for regex."""
    assert sharding.MMDIT_PARAM_RULES == jshard.MMDIT_PARAM_RULES
    t_cfg, j_cfg = {"tiny": (CFG, J_CFG), "xxl": (XXL.model, J_XXL.model)}[config]
    template = flatten_params(jax.eval_shape(lambda k: jmmdit.init(k, j_cfg),
                                             jax.random.PRNGKey(0)))
    state = mmdit.MMDiT(t_cfg, device="meta").state_dict()
    assert {_jax_path(n, template) for n in state} == set(template)
    kinds = set()
    for name, leaf in state.items():
        jpath = _jax_path(name, template)
        jleaf = types.SimpleNamespace(ndim=len(template[jpath].shape))
        ref = jshard.partition_spec_for(jpath, jleaf)
        got = sharding.partition_spec_for(name, leaf)
        jkind = next(k for pattern, k in jshard.MMDIT_PARAM_RULES if re.search(pattern, jpath))
        assert sharding._first(sharding.MMDIT_PARAM_RULES, name, None) == jkind, name
        assert got.axis == _jax_axis(ref, jleaf.ndim), (name, ref, got)
        kinds.add(got.kind)
    assert kinds == {"col", "row", "replicate"}
    table = sharding.param_shardings(mmdit.MMDiT(t_cfg, device="meta"))
    assert table["single_blocks.0.linear_qkv.weight"] == sharding.Spec("col", 0, 3)
    assert table["single_blocks.0.linear2.w2.weight"] == sharding.Spec("row", 1, 1)
    assert table["triple_blocks.0.audio_mod.bias"] == sharding.Spec("col", 0, 9)
    assert table["triple_blocks.0.audio_self_proj.bias"] == sharding.REPLICATED


@pytest.mark.parametrize("mode", ["fp8_e4m3fn", "int8", "int8_dynamic", "int4"])
def test_quantized_storage_shards_as_jax_does(mode):
    """JAX's ``shard_params`` places fp8 storage on a model=2 mesh and refuses the integer
    kinds (their scales' size-1 input axis cannot shard on the row rules); the port refuses
    the same kinds, by name before loading anything and in its ``shard_params``, and takes
    them at model=1."""
    gen = torch.Generator().manual_seed(0)
    params = jax_tree_from_port(mmdit.init(CFG, gen, device="cpu"), jmmdit.init, J_CFG)
    quantized = jquant.quantize_params(params, mode)[0]
    mesh = jmesh.make_mesh(1, 2, jax.devices()[:2])
    if mode.startswith("fp8"):
        jshard.shard_params(quantized, mesh)
        sharding.check_quantization(mode, 2)
    else:
        with pytest.raises(ValueError):
            jshard.shard_params(quantized, mesh)
        with pytest.raises(ValueError, match="use fp8 or model=1"):
            sharding.check_quantization(mode, 2)
        port = mmdit.init(CFG, torch.Generator().manual_seed(0), device="cpu")
        quantize_params(port, mode)
        with pytest.raises(ValueError, match="use fp8 or model=1"):
            sharding.shard_params(port, types.SimpleNamespace(model=2))
    sharding.check_quantization(mode, 1)


# ---------------------------------------------------------------------------------
# The sharded forward and generation against JAX
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refs():
    """Seeded TINY fp32 weights (the zero-initialized leaves perturbed, so the velocity is
    not zero), one batch of forward inputs, and the JAX and one-rank port references."""
    gen = torch.Generator().manual_seed(0)
    model = perturb_zero_leaves(mmdit.init(CFG, gen, device="cpu"), gen)
    j_params = jax_tree_from_port(model, jmmdit.init, J_CFG)
    j_dac = jdac.init(jax.random.PRNGKey(1), J_TINY.dac)
    dac = dac_from_jax(j_dac, TINY.dac, device="cpu")
    rng = np.random.default_rng(0)
    b, tl = 8, 20  # the JAX test's
    inputs = (rng.normal(size=(b, tl, CFG.audio_vae_latent_dim)).astype(np.float32),
              np.linspace(0, 999, b, dtype=np.float32),
              rng.normal(size=(b, 8, CFG.condition_dim)).astype(np.float32),
              rng.normal(size=(b, 4, CFG.clip_dim)).astype(np.float32),
              rng.normal(size=(b, 8, CFG.sync_feat_dim)).astype(np.float32))
    j_velocity = np.asarray(jax.jit(lambda p, *a: jmmdit.apply(p, *a, J_CFG))(
        j_params, *map(jnp.asarray, inputs)))
    t_inputs = tuple(torch.from_numpy(a) for a in inputs)
    fp8 = copy.deepcopy(model)
    quantize_params(fp8, "fp8_e4m3fn")
    with torch.no_grad():
        t_velocity = model(*t_inputs).numpy()
        t_fp8_velocity = fp8(*t_inputs).numpy()
    text = rng.normal(size=(1, 10, CFG.condition_dim)).astype(np.float32)
    j_bundle = jgen.ModelBundle(mmdit_params=j_params, dac_params=j_dac, pipeline_cfg=J_TINY,
                                compute_dtype=jnp.float32)
    j_out = jgen.generate_audio(j_bundle, jnp.asarray(text), jnp.asarray(text),
                                return_latents=True, **GEN_KW)
    latent_len = TINY.latent_length(GEN_KW["duration_s"])
    noise = torch.from_numpy(np.array(j_prepare_latents(
        jax.random.PRNGKey(GEN_KW["seed"]), GEN_KW["batch_size"], latent_len,
        CFG.audio_vae_latent_dim)))
    t_bundle = ModelBundle(model, dac, TINY, compute_dtype=torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgen, "prepare_latents", lambda *a, **k: noise.clone())
        t_out = generate_audio(t_bundle, torch.from_numpy(text), torch.from_numpy(text),
                               return_latents=True, **GEN_KW)
    return dict(mmdit_state=model.state_dict(), dac=dac, dac_state=dac.state_dict(),
                inputs=t_inputs, text=torch.from_numpy(text), noise=noise,
                j_velocity=j_velocity, t_velocity=t_velocity, t_fp8_velocity=t_fp8_velocity,
                j_out=j_out, t_out=t_out)


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (2, 2)])
def test_sharded_forward_and_generate_match_jax(refs, data, model):
    """The forward of the placed denoiser over the whole batch, and ``sharded_generate``,
    on a ``data x model`` mesh of gloo ranks, against JAX (the module's tolerances)."""
    mesh = make_mesh(data, model, ["cpu"] * (data * model))
    out = launch(mesh, programs.forward_and_generate, refs["mmdit_state"], refs["dac_state"],
                 refs["inputs"], refs["text"], GEN_KW, refs["noise"], threads=1, timeout=300)

    np.testing.assert_allclose(out["velocity"], refs["j_velocity"], **FORWARD_JAX_TOL)
    np.testing.assert_allclose(out["velocity"], refs["t_velocity"], **TIGHT_TOL)
    assert float(np.abs(out["velocity"]).max()) > 0
    # fp8 storage shards as any weight (JAX's shard_params places it, the quantization test)
    np.testing.assert_allclose(out["fp8_velocity"], refs["t_fp8_velocity"], **TIGHT_TOL)
    assert not np.allclose(out["fp8_velocity"], out["velocity"], **TIGHT_TOL)
    j_out, t_out = refs["j_out"], refs["t_out"]
    np.testing.assert_allclose(out["latents"], np.asarray(j_out.latents), **TIGHT_TOL)
    np.testing.assert_allclose(out["latents"], t_out.latents, **TIGHT_TOL)
    assert out["audio"].shape == np.asarray(j_out.audio_batch).shape == (2, 1, 48000)
    with torch.no_grad():  # the module docstring: audio on the same latents
        pcm = to_pcm16(dac_vae.decode(refs["dac"], torch.from_numpy(out["latents"])))
    same_latents = pcm[:, :48000, 0].float().numpy()[:, None, :] / 32767.0
    np.testing.assert_allclose(out["audio"], same_latents, **GENERATE_JAX_TOL)

    ranks = out["ranks"]
    full = sum(t.numel() for t in refs["mmdit_state"].values())
    for r in ranks:
        assert r["state_is_its_slices"]
        ops = r["forward_counts"]
        # one gather a sharded adaLN layer, and the velocities over data where data > 1
        assert ops.get("all_gather", {}).get("calls", 0) == r["gathered"] + (data > 1)
        if model == 1:
            assert "all_reduce" not in ops and r["params"] == full
            assert "RowParallelDense" not in r["layers"]
        else:  # 6 row layers a triple block, 2 a single block, 1 in sync_in
            assert ops["all_reduce"]["calls"] == 6 * CFG.depth_triple_blocks + \
                2 * CFG.depth_single_blocks + 1
            assert {"ColumnParallelDense", "RowParallelDense", "ColumnParallelConv1d",
                    "RowParallelConv1d"} <= set(r["layers"])
            assert r["params"] < full


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_failed_rank_fails_the_launch(how):
    """A rank that raises or dies fails the launch with its traceback (or exit code), and
    the rank left waiting in a collective is stopped."""
    match = "rank 1 refuses" if how == "raise" else "died"
    with pytest.raises(RankFailed, match=match):
        launch(make_mesh(2, 1, ["cpu"] * 2), programs.fail_on_rank, 1, how, threads=1,
               timeout=120)
