"""LoRA merge at load (``foley_tpu_torch/models/lora.py``) against the JAX package's
``merge_lora`` / ``load_lora``, on the CPU at the TINY config.

The adapter is the JAX ``init_lora`` over the model's tree with every ``b`` drawn non-zero
here (a fresh ``b`` is zero, which would make the merge the identity). The port reads it
through ``io/from_jax.py::lora_from_jax`` or, on the surfaces, from the directory
``tools/lora_to_safetensors.py`` writes from the JAX package's orbax adapter.

Tolerances: merged weights within one unit in the last place of the weight's dtype of
``merge_lora``'s (fp32, bf16, fp16), bit for bit on fp8 weights; the merged model's velocity
within ``test_torch_mmdit.py``'s bounds (fp32 atol 1e-5 / rtol 1e-4, bf16 1.5% relative L2);
the surfaces' audio within ``test_torch_nodes.py``'s atol 1e-4 and the CLI's 5 int16 steps.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.api import nodes as jnodes
from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import lora as jlora
from foley_tpu.models import mmdit as jmm
from foley_tpu_torch.api import nodes as tnodes
from foley_tpu_torch.configs import TINY
from foley_tpu_torch.io.from_jax import lora_from_jax, mmdit_from_jax, state_dict_from_jax
from foley_tpu_torch.models import lora as tlora
from foley_tpu_torch.models import mmdit as tmm
from foley_tpu_torch.parallel import offload
from foley_tpu_torch.pipeline import generate as tgen
from test_torch_mmdit import seeded_tree
from torch_helpers import (  # noqa: F401 (autouse)
    jax_latents,
    jax_tree_from_port,
    one_torch_thread,
    save_checkpoint_dir,
)
from torch_helpers import jax_native_library  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CFG, J_CFG = TINY.model, J_TINY.model
RANK, SCALE = 4, 0.7
TOL = dict(atol=1e-5, rtol=1e-4)
AUDIO_TOL = dict(atol=1e-4, rtol=0)
PCM_TOL = 5  # int16 steps (tests/test_torch_cli.py)
# block weights under DEFAULT_TARGETS: 13 a triple block, 5 a single block
N_ADAPTED = CFG.depth_triple_blocks * 13 + CFG.depth_single_blocks * 5


def _adapter(params, seed=7, b_std=0.05):
    """The JAX ``init_lora`` adapter with every ``b`` drawn non-zero (and ``a`` kept)."""
    lora = jlora.init_lora(jax.random.PRNGKey(seed), params, rank=RANK)
    rng = np.random.default_rng(seed)

    def fill(path, x):
        x = np.array(x)
        return (rng.normal(size=x.shape) * b_std).astype(x.dtype) if path[-1].key == "b" else x

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(lora))


@pytest.fixture(scope="module")
def base():
    params = seeded_tree(jax_tree_from_port(
        tmm.init(CFG, torch.Generator().manual_seed(0), device="cpu"), jmm.init, J_CFG), seed=3)
    return params, _adapter(params)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A float tensor's bits as sign-magnitude ordered integers (adjacent floats differ by
    one)."""
    view = {4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()]
    i = t.contiguous().view(view).numpy().astype(np.int64)
    top = 1 << (8 * t.element_size() - 1)
    return np.where(i < 0, -(i + top), i)


def _merged_pair(params, lora, dtype, scale=SCALE):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    pd = jax.device_get(jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), params))
    ref = state_dict_from_jax(jax.device_get(jlora.merge_lora(pd, lora, scale=scale)))
    model = mmdit_from_jax(pd, CFG, device="cpu")
    n = tlora.merge_lora(model, lora_from_jax(lora), scale)
    return pd, model, ref, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_merge_matches_jax(base, dtype):
    params, lora = base
    pd, model, ref, n = _merged_pair(params, lora, dtype)
    assert n == N_ADAPTED
    before = state_dict_from_jax(pd)
    changed = 0
    for k, v in model.state_dict().items():
        assert v.dtype == ref[k].dtype == dtype, k
        assert np.abs(_bits(v) - _bits(ref[k])).max() <= 1, k
        changed += int(not torch.equal(v, before[k]))
    assert changed == n


@pytest.mark.parametrize("fp8", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_weights_merge_bit_for_bit(base, fp8):
    """An fp8 checkpoint's weights keep fp8 through the precision cast, and the JAX merge
    runs its ops in fp8: the port widens each op to fp32 and rounds back, bit for bit."""
    params, lora = base
    targets = {".".join(n.split(".")[:-1]) for n in lora_from_jax(lora)}

    def cast(path, x):
        name = ".".join(str(p.key) for p in path[:-1])
        to = getattr(jnp, fp8) if path[-1].key == "w" and name in targets else jnp.bfloat16
        return np.asarray(jnp.asarray(x).astype(to))

    pd = jax.tree_util.tree_map_with_path(cast, params)
    ref = state_dict_from_jax(jax.device_get(jlora.merge_lora(pd, lora, scale=SCALE)))
    model = mmdit_from_jax(pd, CFG, device="cpu", dtype=torch.bfloat16)
    tlora.merge_lora(model, lora_from_jax(lora), SCALE)
    n_fp8 = 0
    for k, v in model.state_dict().items():
        assert v.dtype == ref[k].dtype, k
        assert torch.equal(v.view(torch.uint8), ref[k].view(torch.uint8)) if (
            v.element_size() == 1) else np.abs(_bits(v) - _bits(ref[k])).max() <= 1, k
        n_fp8 += v.element_size() == 1
    assert n_fp8 == N_ADAPTED


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_jax(base, dtype):
    """The merged model's velocity against ``mmdit.apply`` on ``merge_lora``'s tree."""
    params, lora = base
    _, model, _, _ = _merged_pair(params, lora, dtype)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    merged = jlora.merge_lora(jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), params), lora,
                              scale=SCALE)
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=(2, 20, CFG.audio_vae_latent_dim)), np.asarray([500.0, 100.0]),
              rng.normal(size=(2, 8, CFG.condition_dim)), rng.normal(size=(2, 4, CFG.clip_dim)),
              rng.normal(size=(2, 8, CFG.sync_feat_dim))]
    arrays = [a.astype(np.float32) for a in arrays]
    ref = np.asarray(jmm.apply(merged, *(jnp.asarray(a).astype(jdt) if a.ndim > 1
                                          else jnp.asarray(a) for a in arrays), J_CFG,
                               attn_impl="xla")).astype(np.float32)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a).to(dtype) if a.ndim > 1 else torch.from_numpy(a)
                      for a in arrays)).float().numpy()
    assert float(np.std(ref)) > 0.1
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1.5e-2


def test_scale_zero_is_the_base_model(base):
    params, lora = base
    model = mmdit_from_jax(params, CFG, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tlora.merge_lora(model, lora_from_jax(lora), 0.0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_quantized_and_swapped_models_refuse_the_merge(base):
    """A weight in integer storage raises with the JAX package's message; a model whose
    blocks the swap moved to host memory raises too (the loaders merge before both)."""
    params, lora = base
    model = mmdit_from_jax(params, CFG, device="cpu")
    for block in model.triple_blocks:  # integer storage in the one leaf JAX's tree has it
        m = block.audio_self_attn_qkv
        m.set_quantized("int8", m.weight.to(torch.int8), torch.ones(m.weight.shape[0], 1))
    with pytest.raises(ValueError) as port_err:
        tlora.merge_lora(model, lora_from_jax(lora), 1.0)
    qtree = jax.tree.map(np.asarray, params)
    leaf = qtree["triple_blocks"]["audio_self_attn_qkv"]
    qtree["triple_blocks"]["audio_self_attn_qkv"] = {"int8": leaf["w"], "scale": leaf["w"]}
    with pytest.raises(ValueError) as jax_err:
        jlora.merge_lora(qtree, lora, 1.0)
    assert str(port_err.value) == str(jax_err.value)
    swapped = mmdit_from_jax(params, CFG, device="cpu")
    offload.offload_block_suffix(swapped, 3)
    with pytest.raises(ValueError, match="block swap"):
        tlora.merge_lora(swapped, lora_from_jax(lora), 1.0)


def test_lora_delta_is_the_xla_product():
    """``lora_delta`` (a fused multiply-add a rank step, in order) equals XLA's CPU product
    of the same fp32 factors bit for bit, dense and per-tap conv shapes."""
    rng = np.random.default_rng(1)
    for a_shape, b_shape in (((3, 64, 16), (3, 16, 192)), ((3, 3, 48, 16), (3, 3, 16, 40))):
        a = rng.uniform(-0.1, 0.1, a_shape).astype(np.float32)
        b = (rng.normal(size=b_shape) * 0.05).astype(np.float32)
        ref = np.asarray(jnp.asarray(a) @ jnp.asarray(b))
        got = tlora.lora_delta(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------------
# The surfaces: orbax adapter -> tools/lora_to_safetensors.py -> loader, CLI, server
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("lora_ckpts")
    save_checkpoint_dir(root)
    (j_model,) = jnodes.HunyuanModelLoader().load_model(
        str(root / "hunyuanvideo_foley.safetensors"), config="tiny")
    lora = _adapter(jax.device_get(j_model["params"]), seed=11, b_std=1.0)
    jlora.save_lora(str(root / "adapter_orbax"), lora, rank=RANK, scale=0.5)
    spec = importlib.util.spec_from_file_location(  # the tool's command line, in this process
        "lora_to_safetensors", ROOT / "tools" / "lora_to_safetensors.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main([str(root / "adapter_orbax"), str(root / "adapter_port")]) == 0
    return root, lora


def test_tool_converts_the_orbax_adapter(ckpt_dir):
    root, lora = ckpt_dir
    adapter, scale = tlora.load_lora(str(root / "adapter_port"))
    ref = lora_from_jax(lora)
    assert scale == 0.5 and set(adapter) == set(ref)
    for k, v in adapter.items():
        assert torch.equal(v, ref[k]), k


def test_loader_matches_jax_node_audio(ckpt_dir, monkeypatch):
    """The model loader merges after the precision cast (a widget scale 2 times the meta's
    0.5), and the sampler node's audio matches the JAX node's on the orbax adapter."""
    root, _ = ckpt_dir
    ckpt = str(root / "hunyuanvideo_foley.safetensors")
    (j_model,) = jnodes.HunyuanModelLoader().load_model(
        ckpt, config="tiny", lora_path=str(root / "adapter_orbax"), lora_scale=2.0)
    (j_deps,) = jnodes.HunyuanDependenciesLoader().load_dependencies(
        str(root / "vae_128d_48k.safetensors"), None, precision="fp32")
    (t_model,) = tnodes.HunyuanModelLoader().load_model(
        ckpt, config="tiny", lora_path=str(root / "adapter_port"), lora_scale=2.0,
        device="cpu")
    (t_deps,) = tnodes.HunyuanDependenciesLoader().load_dependencies(
        str(root / "vae_128d_48k.safetensors"), None, precision="fp32", device="cpu")
    ref = state_dict_from_jax(jax.device_get(j_model["params"]))
    for k, v in t_model["params"].state_dict().items():
        assert np.abs(_bits(v) - _bits(ref[k])).max() <= 1, k
    kw = dict(duration=1.0, steps=2, seed=3, allow_unconditioned=True)
    j_audio, _ = jnodes.HunyuanFoleySampler().generate_audio(j_model, j_deps, **kw)
    monkeypatch.setattr(tgen, "prepare_latents", jax_latents(3))
    t_audio, _ = tnodes.HunyuanFoleySampler().generate_audio(t_model, t_deps, **kw)
    np.testing.assert_allclose(np.asarray(t_audio["waveform"]),
                               np.asarray(j_audio["waveform"]), **AUDIO_TOL)


@pytest.mark.parametrize("quantization", ["fp8_e4m3fn", "fp8_e5m2", "int8", "int8_dynamic",
                                          "int4"])
def test_merge_comes_before_each_quantization(ckpt_dir, quantization):
    """The loader with an adapter and a quantization holds what the JAX loader holds: the
    adapted weights, quantized (codes, scales and fp8 bits equal)."""
    root, _ = ckpt_dir
    ckpt = str(root / "hunyuanvideo_foley.safetensors")
    (j_model,) = jnodes.HunyuanModelLoader().load_model(
        ckpt, config="tiny", quantization=quantization, lora_path=str(root / "adapter_orbax"))
    (t_model,) = tnodes.HunyuanModelLoader().load_model(
        ckpt, config="tiny", quantization=quantization, lora_path=str(root / "adapter_port"),
        device="cpu")
    ref = state_dict_from_jax(jax.device_get(j_model["params"]))
    got = t_model["params"].state_dict()
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype, k
        if v.is_floating_point() and v.element_size() > 1:
            assert np.abs(_bits(v) - _bits(ref[k])).max() <= 1, k
        else:
            assert torch.equal(v.view(torch.uint8), ref[k].view(torch.uint8)), k


def test_cli_matches_jax(ckpt_dir, monkeypatch, tmp_path):
    """``--lora`` / ``--lora_scale`` through both command lines on one checkpoint directory:
    the JAX CLI reads the orbax adapter, the port's the converted one."""
    from test_torch_cli import RUN, _inject_noise, _read

    from foley_tpu import cli as jcli
    from foley_tpu_torch import cli as tcli

    root, _ = ckpt_dir
    base = ["--model_path", str(root), "--duration", "1", "--lora_scale", "1.5"] + RUN
    assert jcli.main(base + ["--lora", str(root / "adapter_orbax"),
                             "--output", str(tmp_path / "jax.wav")]) == 0
    _inject_noise(monkeypatch, 3)
    assert tcli.main(base + ["--lora", str(root / "adapter_port"), "--device", "cpu",
                             "--output", str(tmp_path / "port.wav")]) == 0
    ref, got = _read(tmp_path / "jax.wav"), _read(tmp_path / "port.wav")
    assert got.shape == ref.shape == (48000,)
    assert np.abs(got - ref).max() <= PCM_TOL
    assert tcli.main(["--model_path", str(root), "--duration", "1", "--device", "cpu",
                      "--output", str(tmp_path / "plain.wav")] + RUN) == 0
    assert np.abs(_read(tmp_path / "plain.wav") - got).max() > PCM_TOL  # the adapter acts


def test_server_matches_jax(ckpt_dir, monkeypatch):
    """``--lora`` through both servers' ``main`` (the HTTP server stubbed): the served
    request's audio matches the JAX server's."""
    from foley_tpu.serving import server as jserver
    from foley_tpu_torch.serving import server as tserver

    root, _ = ckpt_dir
    served = {}

    class NoServer:
        def serve_forever(self):
            pass

    def capture(key):
        return lambda service, host, port: served.setdefault(key, service) and NoServer()

    argv = ["--model_path", str(root), "--config", "tiny", "--durations", "1",
            "--warmup_steps", "1", "--lora_scale", "0.8", "--precision", "fp32"]
    monkeypatch.setattr(jserver, "create_server", capture("jax"))
    assert jserver.main(argv + ["--lora", str(root / "adapter_orbax")]) == 0
    monkeypatch.setattr(tserver, "create_server", capture("port"))
    assert tserver.main(argv + ["--lora", str(root / "adapter_port"), "--device", "cpu"]) == 0
    request = {"prompt": "glass shattering", "duration": 1.0, "steps": 2, "seed": 3}
    ref = served["jax"].generate(dict(request))
    monkeypatch.setattr(tgen, "prepare_latents", jax_latents(3))
    got = served["port"].generate(dict(request))
    np.testing.assert_allclose(got["waveform"], np.asarray(ref["waveform"]), **AUDIO_TOL)
