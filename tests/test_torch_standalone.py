"""The port's standalone library surface (``foley_tpu_torch/pipeline/standalone.py`` and the
package's lazy exports) against the JAX package's, on the CPU at the TINY config: one
checkpoint directory (the reference-layout denoiser of ``tests/test_io.py``, the DAC and a
CLAP with a byte-level BPE tokenizer beside it) through ``load_model``,
``feature_process`` and ``denoise_process`` in both packages. The initial noise is the JAX
draw, injected into the port. Tolerance: text features 1e-5 (fp32 CLAP,
``tests/test_torch_clap.py``), audio atol 1e-4 (``tests/test_torch_nodes.py``'s)."""

import sys

import numpy as np
import pytest

import foley_tpu
import foley_tpu_torch
from foley_tpu.pipeline import standalone as jsa
from foley_tpu_torch.io.native import MediaProcessingError
from foley_tpu_torch.pipeline import generate as tgen
from foley_tpu_torch.pipeline import standalone as tsa
from torch_helpers import jax_latents, one_torch_thread, save_checkpoint_dir  # noqa: F401


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("standalone_ckpts")
    save_checkpoint_dir(root)
    return root


@pytest.fixture(scope="module")
def managers(model_dir):
    return (jsa.load_model(str(model_dir), config="tiny"),
            tsa.load_model(str(model_dir), config="tiny", device="cpu"))


def test_feature_process_matches_jax(managers):
    j_md, t_md = managers
    j_vis, j_text, j_len = jsa.feature_process(None, "glass shattering", j_md,
                                               neg_prompt="noisy harsh", duration_s=1.0)
    t_vis, t_text, t_len = tsa.feature_process(None, "glass shattering", t_md,
                                               neg_prompt="noisy harsh", duration_s=1.0)
    assert t_vis == j_vis == {} and t_len == j_len == 1.0
    assert set(t_text) == set(j_text) == {"text_feat", "uncond_text_feat"}
    for key in t_text:
        np.testing.assert_allclose(t_text[key].numpy(), np.asarray(j_text[key]), atol=1e-5,
                                   rtol=1e-5)
    assert tsa.feature_process(None, "x", t_md)[2] == jsa.feature_process(None, "x", j_md)[2]


def test_feature_process_refuses_a_video_naming_item_13(managers, monkeypatch, tmp_path):
    """A video file needs ffmpeg: without one on ``PATH`` the port raises the JAX package's
    message (``tests/test_torch_video.py`` runs the frames-directory and ffmpeg routes)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setitem(sys.modules, "av", None)  # no PyAV either, as on the card's machine
    (tmp_path / "clip.mp4").write_bytes(b"\0" * 64)
    with pytest.raises(RuntimeError, match="no video decoder"):
        tsa.feature_process(str(tmp_path / "clip.mp4"), "rain", managers[1])


@pytest.mark.parametrize("batch_size", [1, 2])
def test_denoise_process_matches_jax(managers, monkeypatch, batch_size):
    j_md, t_md = managers
    kw = dict(guidance_scale=4.5, num_inference_steps=2, batch_size=batch_size, seed=3)
    j_vis, j_text, length = jsa.feature_process(None, "rain on a roof", j_md, duration_s=1.0)
    t_vis, t_text, _ = tsa.feature_process(None, "rain on a roof", t_md, duration_s=1.0)
    ref, j_sr = jsa.denoise_process(j_vis, j_text, length, j_md, **kw)

    monkeypatch.setattr(tgen, "prepare_latents", jax_latents(3))
    got, t_sr = tsa.denoise_process(t_vis, t_text, length, t_md, **kw)
    assert t_sr == j_sr == 48000
    assert got.shape == np.asarray(ref).shape == (batch_size, 1, 48000)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=0)
    assert float(np.abs(got).max()) > 0


def test_lazy_exports_match_jax(monkeypatch, tmp_path):
    names = ["load_model", "denoise_process", "feature_process", "merge_audio_video",
             "AttributeDict", "NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
    assert set(names) <= set(foley_tpu_torch.__all__)
    assert set(foley_tpu_torch.__all__) == set(foley_tpu.__all__)
    assert foley_tpu_torch.load_model is tsa.load_model
    assert foley_tpu_torch.feature_process is tsa.feature_process
    assert foley_tpu_torch.denoise_process is tsa.denoise_process
    assert set(foley_tpu_torch.NODE_CLASS_MAPPINGS) == set(foley_tpu.NODE_CLASS_MAPPINGS)
    assert foley_tpu_torch.AttributeDict({"a": {"b": 1}}).a.b == 1
    monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg
    with pytest.raises(MediaProcessingError, match="ffmpeg not found"):
        foley_tpu_torch.merge_audio_video("v.mp4", "a.wav", "out.mp4")
    with pytest.raises(AttributeError):
        foley_tpu_torch.not_an_export
