"""The port's nodes (``api/nodes.py``) against the JAX package's, on the CPU at the TINY
config in fp32: the graph of ``tests/test_node_graph.py`` run through both packages.

Both graphs load the same files: a reference-layout denoiser checkpoint
(``tests/test_io.py``'s synthetic state dict, every weight random and nonzero), the DAC, a
SigLIP2 and a CLAP checkpoint (``tests/helpers.py``) and a byte-level BPE tokenizer both
packages read (``torch_helpers.save_bpe_tokenizer``). The sync encoder of the V2A route is a
tiny Synchformer checkpoint loaded by each package's ``load`` (the dependencies loader takes
the full geometry only). The initial noise is the JAX draw, injected into the port
(``jax.random`` and a ``torch.Generator`` give other bits for one seed).

Tolerance: audio atol 1e-4, the V2A and long-form tests' (the two decodes each quantize to
16-bit PCM; the DAC's folded weights differ in the last place, ``test_torch_convert.py``).
The port's own repeats (``force_offload``, the warm-up) are held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.api import nodes as jnodes
from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import synchformer as jsync
from foley_tpu.sampling import denoise as jden
from foley_tpu_torch.api import nodes as tnodes
from foley_tpu_torch.configs import TINY, SynchformerConfig
from foley_tpu_torch.io.convert import save_safetensors
from foley_tpu_torch.models import synchformer as tsync
from foley_tpu_torch.parallel import offload
from foley_tpu_torch.pipeline import generate as tgen
from foley_tpu_torch.pipeline import longform as tlong
from helpers import save_dac_checkpoint, save_tiny_clap_checkpoint, save_tiny_siglip2_checkpoint
from test_io import _synthetic_mmdit_sd
from test_torch_convert import _synchformer_sd
from torch_helpers import one_torch_thread, save_bpe_tokenizer  # noqa: F401 (autouse)

AUDIO_TOL = dict(atol=1e-4, rtol=0)
STEPS = 2
SYNC_FIELDS = dict(img_size=32, patch_size=8, temporal_patch_size=2, num_frames=16,
                   embed_dim=16, depth=2, num_heads=2, mlp_ratio=2.0)
KW = dict(negative_prompt="noisy harsh", cfg_scale=4.5, steps=STEPS, sampler="euler",
          batch_size=1, seed=3)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("node_ckpts")
    save_safetensors(str(root / "hunyuanvideo_foley.safetensors"),
                     {k: torch.from_numpy(np.array(v))
                      for k, v in _synthetic_mmdit_sd(J_TINY.model).items()})
    save_dac_checkpoint(str(root / "vae_128d_48k.safetensors"), J_TINY.dac)
    save_tiny_clap_checkpoint(str(root / "clap"), hidden=TINY.model.condition_dim, heads=2,
                              vocab_size=400)
    save_tiny_siglip2_checkpoint(str(root / "siglip2"), hidden=TINY.model.clip_dim, heads=2)
    save_bpe_tokenizer(str(root / "tokenizer"))
    save_safetensors(str(root / "synchformer_state_dict.safetensors"),
                     _synchformer_sd(SynchformerConfig(**SYNC_FIELDS), 6))
    return root


@pytest.fixture(scope="module")
def graphs(ckpts):
    """(JAX model, JAX deps, port model, port deps) loaded through each package's nodes."""
    deps_kw = dict(synchformer_model=None, siglip2_model=str(ckpts / "siglip2"),
                   clap_model=str(ckpts / "clap"), clap_tokenizer=str(ckpts / "tokenizer"))
    (j_model,) = jnodes.HunyuanModelLoader().load_model(
        str(ckpts / "hunyuanvideo_foley.safetensors"), config="tiny")
    (j_deps,) = jnodes.HunyuanDependenciesLoader().load_dependencies(
        str(ckpts / "vae_128d_48k.safetensors"), precision="fp32", **deps_kw)
    (t_model,) = tnodes.HunyuanModelLoader().load_model(
        str(ckpts / "hunyuanvideo_foley.safetensors"), config="tiny", device="cpu")
    (t_deps,) = tnodes.HunyuanDependenciesLoader().load_dependencies(
        str(ckpts / "vae_128d_48k.safetensors"), precision="fp32", device="cpu", **deps_kw)
    assert t_model["dtype"] == torch.float32  # "auto": the checkpoint's fp32
    assert t_deps["dac_cfg"] == TINY.dac  # inferred from the checkpoint's shapes
    return j_model, j_deps, t_model, t_deps


def _inject_noise(monkeypatch, seed, module=tgen):
    def noise(gen, b, length, dim, dtype=torch.float32):
        return torch.from_numpy(np.array(jden.prepare_latents(jax.random.PRNGKey(seed), b,
                                                              length, dim)))
    monkeypatch.setattr(module, "prepare_latents", noise)


def _pair(graphs, monkeypatch, node, fn, *, noise_module=tgen, j_model=None, t_model=None,
          **kw):
    j_m, j_deps, t_m, t_deps = graphs
    ref = getattr(getattr(jnodes, node)(), fn)(j_model or j_m, j_deps, **kw)
    _inject_noise(monkeypatch, kw.get("seed", 0), noise_module)
    got = getattr(getattr(tnodes, node)(), fn)(t_model or t_m, t_deps, **kw)
    return ref, got


def _assert_audio(got, ref, shape):
    for g, r in zip(got, ref):
        assert g["sample_rate"] == r["sample_rate"] == 48000
        assert g["waveform"].shape == np.asarray(r["waveform"]).shape
        np.testing.assert_allclose(g["waveform"], np.asarray(r["waveform"]), **AUDIO_TOL)
    assert got[1]["waveform"].shape == shape
    assert float(np.abs(got[1]["waveform"]).max()) > 0


def test_sampler_t2a_matches_jax(graphs, monkeypatch):
    ref, got = _pair(graphs, monkeypatch, "HunyuanFoleySampler", "generate_audio",
                     duration=1.0, prompt="glass shattering", force_offload=False, **KW)
    _assert_audio(got, ref, (1, 1, 48000))
    other = tnodes.HunyuanFoleySampler().generate_audio(
        graphs[2], graphs[3], duration=1.0, prompt="footsteps on ice", force_offload=False,
        **KW)
    assert np.abs(other[0]["waveform"] - got[0]["waveform"]).max() > 0  # the prompt conditions


def test_sampler_v2a_matches_jax(graphs, ckpts, monkeypatch):
    path = str(ckpts / "synchformer_state_dict.safetensors")
    j_sync = jsync.load(path, jsync.SynchformerConfig(**SYNC_FIELDS))
    j_sync.preprocess = "device"
    j_deps = dict(graphs[1], synchformer=j_sync)
    t_deps = dict(graphs[3], synchformer=tsync.load(path, SynchformerConfig(**SYNC_FIELDS),
                                                    device="cpu"))
    image = np.random.default_rng(4).random((13, 40, 56, 3)).astype(np.float32)
    kw = dict(KW, duration=1.0, prompt="rain", frame_rate=12, image=image, force_offload=False)
    ref = jnodes.HunyuanFoleySampler().generate_audio(graphs[0], j_deps, **kw)
    _inject_noise(monkeypatch, kw["seed"])
    got = tnodes.HunyuanFoleySampler().generate_audio(graphs[2], t_deps, **kw)
    _assert_audio(got, ref, (1, 1, 48000))
    t2a = tnodes.HunyuanFoleySampler().generate_audio(
        graphs[2], t_deps, **dict(kw, image=None))
    assert np.abs(t2a[0]["waveform"] - got[0]["waveform"]).max() > 0  # the video conditions


def test_sampler_long_form_past_max_duration_matches_jax(graphs, monkeypatch):
    """Past the config's single-window cap (cut to 2 s here, on both sides) the sampler goes
    long-form in ``default_window_s`` windows: 3 s in two 2 s windows."""
    j_model = dict(graphs[0], cfg=dataclasses.replace(J_TINY, max_duration_s=2.0))
    t_model = dict(graphs[2], cfg=dataclasses.replace(TINY, max_duration_s=2.0))
    ref, got = _pair(graphs, monkeypatch, "HunyuanFoleySampler", "generate_audio",
                     noise_module=tlong, j_model=j_model, t_model=t_model, duration=3.0,
                     prompt="thunder", force_offload=False, **KW)
    _assert_audio(got, ref, (1, 1, 3 * 48000))


def test_continuation_node_matches_jax(graphs, monkeypatch):
    rng = np.random.default_rng(5)
    src = {"waveform": rng.uniform(-0.5, 0.5, (1, 2, 48000)).astype(np.float32),
           "sample_rate": 48000}
    ref, got = _pair(graphs, monkeypatch, "HunyuanFoleyContinuation", "continue_audio",
                     noise_module=tlong, audio=src, duration=1.0, prompt="metal clink",
                     context_s=0.5, force_offload=False,
                     **{k: v for k, v in KW.items() if k != "negative_prompt"})
    _assert_audio(got, ref, (1, 1, 48000))
    with pytest.raises(ValueError, match="48000 Hz"):
        tnodes.HunyuanFoleyContinuation().continue_audio(
            graphs[2], graphs[3], dict(src, sample_rate=16000), duration=1.0, steps=STEPS)


def test_select_audio_from_batch_matches_jax(graphs, monkeypatch):
    ref, got = _pair(graphs, monkeypatch, "HunyuanFoleySampler", "generate_audio",
                     duration=1.0, prompt="wind", force_offload=False,
                     **dict(KW, batch_size=2))
    _assert_audio(got, ref, (2, 1, 48000))
    for index in (0, 1, 5, -1):
        (t,) = tnodes.SelectAudioFromBatch().select_audio(got[1], index)
        (j,) = jnodes.SelectAudioFromBatch().select_audio(ref[1], index)
        assert t["waveform"].shape == (1, 1, 48000) and t["sample_rate"] == 48000
        np.testing.assert_allclose(t["waveform"], np.asarray(j["waveform"]), **AUDIO_TOL)
    assert tnodes.SelectAudioFromBatch.INPUT_TYPES() == jnodes.SelectAudioFromBatch.INPUT_TYPES()


def test_force_offload_parks_and_restores_bit_for_bit(ckpts, graphs):
    (model,) = tnodes.HunyuanModelLoader().load_model(
        str(ckpts / "hunyuanvideo_foley.safetensors"), config="tiny", device="cpu")
    weights = {k: v.clone() for k, v in model["params"].state_dict().items()}
    kw = dict(KW, duration=1.0, prompt="glass shattering")
    sampler = tnodes.HunyuanFoleySampler()
    first = sampler.generate_audio(model, graphs[3], force_offload=True, **kw)
    host = model["_host"]
    assert model["_offloaded"] and model["_park_s"] >= 0
    # parked: every weight now lives in the host buffers
    ptrs = {t.data_ptr() for t in host.views.values()}
    assert all(p.data_ptr() in ptrs for p in model["params"].parameters())
    second = sampler.generate_audio(model, graphs[3], force_offload=True, **kw)
    assert model["_host"] is host and model["_restore_s"] >= 0  # buffers allocated once
    assert first[1]["waveform"].tobytes() == second[1]["waveform"].tobytes()
    sampler.generate_audio(model, graphs[3], force_offload=False, **kw)
    assert not model["_offloaded"]
    for k, v in model["params"].state_dict().items():
        assert torch.equal(v, weights[k]), k


def test_compile_warmup_runs_each_bucket_once(graphs, monkeypatch):
    calls = []
    real = tnodes.generate_audio
    monkeypatch.setattr(tnodes, "generate_audio",
                        lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    (cfg,) = tnodes.HunyuanCompileConfig().make_config(durations="1", batch_sizes="1,2",
                                                        text_buckets="16")
    assert cfg == jnodes.HunyuanCompileConfig().make_config(
        durations="1", batch_sizes="1,2", text_buckets="16")[0]
    model = dict(graphs[2])
    kw = dict(KW, duration=1.0, prompt="rain", force_offload=False, torch_compile_cfg=cfg)
    tnodes.HunyuanFoleySampler().generate_audio(model, graphs[3], **kw)
    assert len(model["_warm_buckets"]) == 2 and len(calls) == 3  # two buckets + the run
    tnodes.HunyuanFoleySampler().generate_audio(model, graphs[3], **kw)
    assert len(calls) == 4  # warmed: the run alone


def test_node_schemas_equal_jax():
    for name, cls in tnodes.NODE_CLASS_MAPPINGS.items():
        jcls = jnodes.NODE_CLASS_MAPPINGS[name]
        assert cls.INPUT_TYPES() == jcls.INPUT_TYPES() or name in (
            "HunyuanModelLoader", "HunyuanDependenciesLoader"), name
        assert (cls.RETURN_TYPES, cls.FUNCTION, cls.CATEGORY) == (
            jcls.RETURN_TYPES, jcls.FUNCTION, jcls.CATEGORY), name
    for name in ("HunyuanModelLoader", "HunyuanDependenciesLoader"):
        t, j = (m[name].INPUT_TYPES() for m in (tnodes.NODE_CLASS_MAPPINGS,
                                                jnodes.NODE_CLASS_MAPPINGS))
        for part in ("required", "optional"):
            assert list(t[part]) == list(j[part])
            assert all(t[part][k][0] == j[part][k][0]
                       and t[part][k][1].get("default") == j[part][k][1].get("default")
                       for k in t[part]), (name, part)


@pytest.mark.parametrize("quantization,swap", [
    ("fp8_e4m3fn", 0), ("fp8_e5m2", 0), ("int8", 4), ("int8_dynamic", 0), ("int4", 5),
    ("auto", 0)])
def test_memory_modes_match_jax(ckpts, graphs, monkeypatch, quantization, swap):
    """``HunyuanModelLoader(quantization=...)`` on both packages, then the sampler with
    ``HunyuanBlockSwap`` (the JAX sampler needs a ``pinned_host`` memory kind to split and
    runs unsplit here): the same audio; the port's split persists on its model."""
    ckpt = str(ckpts / "hunyuanvideo_foley.safetensors")
    (j_model,) = jnodes.HunyuanModelLoader().load_model(ckpt, quantization=quantization,
                                                        config="tiny")
    (t_model,) = tnodes.HunyuanModelLoader().load_model(ckpt, quantization=quantization,
                                                        config="tiny", device="cpu")
    (args,) = tnodes.HunyuanBlockSwap().set_args(blocks_to_swap=swap, prefetch_blocks=1)
    ref, got = _pair(graphs, monkeypatch, "HunyuanFoleySampler", "generate_audio",
                     j_model=j_model, t_model=t_model, duration=1.0, prompt="glass shattering",
                     force_offload=False, block_swap_args=args if swap else None, **KW)
    _assert_audio(got, ref, (1, 1, 48000))
    assert offload.partition_report(t_model["params"])["host_blocks"] == swap


def test_fp8_checkpoint_loads_bit_for_bit(ckpts, tmp_path):
    """A checkpoint that stores fp8 weights: its fp8 tensors load as they are (the
    precision cast skips them), ``auto`` quantization takes the checkpoint's fp8 type, and
    every tensor equals the JAX loader's on the same file, bit for bit."""
    from foley_tpu_torch.io.convert import load_torch_state_dict
    from foley_tpu_torch.io.from_jax import state_dict_from_jax

    sd = load_torch_state_dict(str(ckpts / "hunyuanvideo_foley.safetensors"))
    path = str(tmp_path / "fp8.safetensors")
    save_safetensors(path, {k: v.to(torch.float8_e5m2) if k.endswith("linear_qkv.weight")
                            else v for k, v in sd.items()})
    for quantization in ("none", "auto"):
        kw = dict(precision="bf16", quantization=quantization, config="tiny")
        (j_model,) = jnodes.HunyuanModelLoader().load_model(path, **kw)
        (t_model,) = tnodes.HunyuanModelLoader().load_model(path, device="cpu", **kw)
        model = t_model["params"]
        assert model.single_blocks[1].linear_qkv.weight.dtype == torch.float8_e5m2
        assert model.single_blocks[1].modulation.weight.dtype == (
            torch.bfloat16 if quantization == "none" else torch.float8_e5m2)
        ref = state_dict_from_jax(jax.device_get(j_model["params"]))
        got = model.state_dict()
        assert set(got) == set(ref)
        for k, v in got.items():
            assert v.dtype == ref[k].dtype, k
            assert torch.equal(v.view(torch.uint8), ref[k].view(torch.uint8)) if (
                v.element_size() == 1) else torch.equal(v, ref[k]), k


def test_refusals(ckpts, graphs, tmp_path):
    """What the loaders still refuse: the orbax directory route, an unknown preprocessing
    route (``pil`` and ``device`` load: ``tests/test_torch_pil_resize.py``), an unknown
    quantization, an adapter directory that is not there; and the sampler without text
    features. The memory modes load and run
    (``test_memory_modes_match_jax``), LoRA merges (``tests/test_torch_lora.py``)."""
    loader, ckpt = tnodes.HunyuanModelLoader(), str(ckpts / "hunyuanvideo_foley.safetensors")
    with pytest.raises(ValueError, match="quantization"):
        loader.load_model(ckpt, quantization="int3", config="tiny", device="cpu")
    with pytest.raises(FileNotFoundError):
        loader.load_model(ckpt, lora_path=str(tmp_path / "no_adapter"), config="tiny",
                          device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        loader.load_model(str(tmp_path), config="tiny", device="cpu")
    with pytest.raises(ValueError, match="video_preprocess"):
        tnodes.HunyuanDependenciesLoader().load_dependencies(
            str(ckpts / "vae_128d_48k.safetensors"), None, video_preprocess="bicubic",
            device="cpu")
    deps = {k: v for k, v in graphs[3].items() if k != "clap"}
    with pytest.raises(ValueError, match="allow_unconditioned"):
        tnodes.HunyuanFoleySampler().generate_audio(graphs[2], deps, duration=1.0, steps=STEPS)


@pytest.mark.parametrize("precision", ["fp16", "fp32"])
def test_every_precision_loads_and_matches_jax(ckpts, precision):
    """The loaders' fp16 and fp32 (which the card runs through K1's and K2's fp16 and fp32
    kernels) through both packages' nodes on the same files: the denoiser's velocity and
    SigLIP2's pooled features against the JAX nodes' models. fp32 atol 1e-5 / rtol 1e-4;
    fp16 relative L2 2e-3 and atol 1e-2 (fp16 rounds at other places in the two packages)."""
    from foley_tpu.models import mmdit as jmm
    from foley_tpu.models import siglip2 as jsig
    from foley_tpu_torch.models import siglip2 as tsig

    ckpt = str(ckpts / "hunyuanvideo_foley.safetensors")
    deps_kw = dict(synchformer_model=None, siglip2_model=str(ckpts / "siglip2"),
                   precision=precision)
    (j_model,) = jnodes.HunyuanModelLoader().load_model(ckpt, precision, config="tiny")
    (j_deps,) = jnodes.HunyuanDependenciesLoader().load_dependencies(
        str(ckpts / "vae_128d_48k.safetensors"), **deps_kw)
    (t_model,) = tnodes.HunyuanModelLoader().load_model(ckpt, precision, config="tiny",
                                                        device="cpu")
    (t_deps,) = tnodes.HunyuanDependenciesLoader().load_dependencies(
        str(ckpts / "vae_128d_48k.safetensors"), device="cpu", **deps_kw)
    dtype = tnodes.resolve_dtype(precision)
    assert t_model["dtype"] == dtype and next(t_model["params"].parameters()).dtype == dtype
    assert t_deps["siglip2"].compute_dtype == dtype

    def close(got, ref):
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)
        assert float(np.std(ref)) > 0.01
        if precision == "fp32":
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
        else:
            assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 2e-3
            np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)

    m = TINY.model
    rng = np.random.default_rng(6)
    np_dtype = np.float16 if precision == "fp16" else np.float32
    arrays = [rng.normal(size=(2, 20, m.audio_vae_latent_dim)), np.asarray([500.0, 100.0]),
              rng.normal(size=(2, 8, m.condition_dim)), rng.normal(size=(2, 4, m.clip_dim)),
              rng.normal(size=(2, 8, m.sync_feat_dim))]
    arrays = [a.astype(np.float32 if a.ndim == 1 else np_dtype) for a in arrays]
    ref = jmm.apply(j_model["params"], *map(jnp.asarray, arrays), J_TINY.model,
                    attn_impl="xla")
    with torch.no_grad():
        got = t_model["params"](*map(torch.from_numpy, arrays))
    assert got.dtype == dtype
    close(got, ref)

    j_sig, t_sig = j_deps["siglip2"], t_deps["siglip2"]
    images = rng.uniform(-1, 1, (3, j_sig.cfg.image_size, j_sig.cfg.image_size, 3))
    ref = jsig.apply(j_sig.params, jnp.asarray(images, j_sig.compute_dtype), j_sig.cfg)
    with torch.no_grad():
        got = tsig.apply(t_sig.model, torch.from_numpy(images).to(dtype))
    close(got, ref)
