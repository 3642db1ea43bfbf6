"""The port's ComfyUI node pack (``foley_tpu_torch/comfyui``) against the JAX package's
(``comfyui_adapter``), on the CPU at the TINY config: the same node mappings, the in-repo
workflow export run through both on the same checkpoint files (the reference-layout
denoiser of ``tests/test_io.py``, the DAC, a CLAP with a byte-level BPE tokenizer beside it),
and ComfyUI's torch tensors at the boundary. The initial noise is the JAX draw, injected into
the port. Tolerance: audio atol 1e-4 (``tests/test_torch_nodes.py``'s)."""

import os
import sys
import types

import numpy as np
import pytest
import torch

import comfyui_adapter
from comfyui_adapter import workflow as jwf
from foley_tpu_torch import comfyui
from foley_tpu_torch.api import nodes as tnodes
from foley_tpu_torch.comfyui import workflow as twf
from foley_tpu_torch.pipeline import generate as tgen
from torch_helpers import jax_latents, one_torch_thread, save_checkpoint_dir  # noqa: F401

WORKFLOW = os.path.join(os.path.dirname(__file__), "..", "example_workflows",
                        "HunyuanVideoFoleyExample.json")


def test_mappings_equal_the_jax_adapters():
    assert list(comfyui.NODE_CLASS_MAPPINGS) == list(comfyui_adapter.NODE_CLASS_MAPPINGS)
    assert (comfyui.NODE_DISPLAY_NAME_MAPPINGS.keys()
            == comfyui_adapter.NODE_DISPLAY_NAME_MAPPINGS.keys())
    for name, cls in comfyui.NODE_CLASS_MAPPINGS.items():
        jcls = comfyui_adapter.NODE_CLASS_MAPPINGS[name]
        assert (cls.RETURN_TYPES, cls.FUNCTION, cls.CATEGORY) == (
            jcls.RETURN_TYPES, jcls.FUNCTION, jcls.CATEGORY), name
        assert list(cls.INPUT_TYPES()["required"]) == list(jcls.INPUT_TYPES()["required"]), name


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("comfy_ckpts")
    save_checkpoint_dir(root)
    return root


def _run(wf, graph, root, extra=None):
    ids = {n["type"]: n["id"] for n in graph["nodes"]}
    overrides = {
        ids["HunyuanModelLoader"]: {"model_name": str(root / "hunyuanvideo_foley.safetensors"),
                                    "precision": "fp32", "quantization": "none",
                                    "config": "tiny"},
        ids["HunyuanDependenciesLoader"]: {
            "vae_model": str(root / "vae_128d_48k.safetensors"), "synchformer_model": None,
            "siglip2_model": "", "clap_model": str(root / "clap")},
        ids["HunyuanFoleyTorchCompile"]: {"durations": "1", "batch_sizes": "1",
                                          "text_buckets": "77"},
        ids["HunyuanBlockSwap"]: {"blocks_to_swap": 0},
        ids["HunyuanFoleySampler"]: {"duration": 1.0, "steps": 2, "batch_size": 2},
    }
    previews = []
    results = wf.execute_workflow(graph, overrides=overrides,
                                  external={"PreviewAudio": lambda node, inputs: previews.append(
                                      inputs["audio"]) or ()}, **(extra or {}))
    return results, ids, previews


class _CpuModelLoader(comfyui.HunyuanModelLoader):
    def load_model(self, *args, **kwargs):
        return super().load_model(*args, device="cpu", **kwargs)


class _CpuDependenciesLoader(comfyui.HunyuanDependenciesLoader):
    def load_dependencies(self, *args, **kwargs):
        return super().load_dependencies(*args, device="cpu", **kwargs)


#: The pack with its loaders on the CPU (in ComfyUI they take the card, the nodes' default).
_CPU_MAPPINGS = dict(comfyui.NODE_CLASS_MAPPINGS, HunyuanModelLoader=_CpuModelLoader,
                     HunyuanDependenciesLoader=_CpuDependenciesLoader)


def test_example_workflow_matches_the_jax_adapter(ckpts, monkeypatch):
    graph = twf.load_workflow(WORKFLOW)
    assert graph == jwf.load_workflow(WORKFLOW)
    sampler = next(n for n in graph["nodes"] if n["type"] == "HunyuanFoleySampler")
    seed = twf.map_widgets(comfyui.HunyuanFoleySampler, sampler["widgets_values"])["seed"]
    assert seed == jwf.map_widgets(comfyui_adapter.HunyuanFoleySampler,
                                   sampler["widgets_values"])["seed"]
    ref, ids, j_previews = _run(jwf, graph, ckpts)

    monkeypatch.setattr(tgen, "prepare_latents", jax_latents(seed))
    got, _, t_previews = _run(twf, graph, ckpts, {"node_mappings": _CPU_MAPPINGS})
    node = ids["HunyuanFoleySampler"]
    for g, r in zip(got[node], ref[node]):
        assert isinstance(g["waveform"], torch.Tensor) and g["sample_rate"] == 48000
        assert g["waveform"].shape == r["waveform"].shape
        np.testing.assert_allclose(g["waveform"].numpy(), r["waveform"].numpy(), atol=1e-4,
                                   rtol=0)
    assert got[node][1]["waveform"].shape == (2, 1, 48000)
    picked = got[ids["SelectAudioFromBatch"]][0]["waveform"]
    assert isinstance(picked, torch.Tensor) and picked.shape == (1, 1, 48000)
    assert len(t_previews) == len(j_previews) == 2


def test_torch_image_in_torch_audio_out(monkeypatch):
    """IMAGE (torch [T, H, W, C] in [0, 1]) reaches the node as numpy frames; the nodes'
    numpy AUDIO leaves as torch, for the sampler, the continuation and the selector."""
    seen = {}

    def generate(self, *args, image=None, **kwargs):
        seen["image"] = image
        wf = np.full((2, 1, 8), 0.25, np.float32)
        return ({"waveform": wf[:1], "sample_rate": 48000},
                {"waveform": wf, "sample_rate": 48000})

    def cont(self, foley_model, dependencies, audio, **kwargs):
        seen["audio"] = audio["waveform"]
        return generate(self)

    monkeypatch.setattr(tnodes.HunyuanFoleySampler, "generate_audio", generate)
    monkeypatch.setattr(tnodes.HunyuanFoleyContinuation, "continue_audio", cont)
    image = torch.rand(3, 4, 5, 3, generator=torch.Generator().manual_seed(0))
    first, batch = comfyui.HunyuanFoleySampler().generate_audio({}, {}, image=image)
    assert isinstance(seen["image"], np.ndarray) and seen["image"].dtype == np.float32
    np.testing.assert_array_equal(seen["image"], image.numpy())
    assert isinstance(first["waveform"], torch.Tensor) and first["waveform"].shape == (1, 1, 8)
    assert isinstance(batch["waveform"], torch.Tensor) and batch["waveform"].shape == (2, 1, 8)
    src = {"waveform": torch.zeros(1, 2, 8), "sample_rate": 48000}
    first, _ = comfyui.HunyuanFoleyContinuation().continue_audio({}, {}, src)
    assert isinstance(seen["audio"], np.ndarray) and isinstance(first["waveform"], torch.Tensor)
    (row,) = comfyui.SelectAudioFromBatch().select_audio(batch, 1)
    assert isinstance(row["waveform"], torch.Tensor) and row["waveform"].shape == (1, 1, 8)
    (none_image,) = [comfyui._image_to_numpy(None)]
    assert none_image is None


def test_model_names_resolve_through_folder_paths(monkeypatch, tmp_path):
    """With ComfyUI's ``folder_paths`` importable, a name resolves under ``models/foley/``
    (registered on first use, as the JAX adapter does); without it, a name stays as given."""
    assert comfyui._resolve_model_path("x.safetensors") == "x.safetensors"
    (tmp_path / "foley").mkdir()
    (tmp_path / "foley" / "m.safetensors").write_bytes(b"")
    fake = types.SimpleNamespace(models_dir=str(tmp_path), folder_names_and_paths={},
                                 supported_pt_extensions={".safetensors"})

    def get_full_path(kind, name):
        for d in fake.folder_names_and_paths[kind][0]:
            if os.path.exists(os.path.join(d, name)):
                return os.path.join(d, name)
        return None

    fake.get_full_path = get_full_path
    monkeypatch.setitem(sys.modules, "folder_paths", fake)
    got = comfyui._resolve_model_path("m.safetensors")
    assert got == os.path.join(str(tmp_path), "foley", "m.safetensors")
    assert fake.folder_names_and_paths["foley"][0] == [os.path.join(str(tmp_path), "foley")]
    assert got == comfyui_adapter._resolve_model_path("m.safetensors")
    assert comfyui._resolve_model_path("absent.pt") == "absent.pt"
