"""The port's PIL-exact resampler (``ops/pil_resize.py``) against ``PIL.Image.resize``, and
the encoders' PIL preprocessing route on it (SigLIP2's and Synchformer's
``preprocess_frames``, the V2A encode, the CLI's and the server's ``--v2a_preprocess pil``
and the dependencies node's ``video_preprocess="pil"``) against the JAX package's, on the
CPU.

PIL is on this machine and only the tests import it; the port never does. The resampler
equals Pillow byte for byte in every case (BICUBIC and BILINEAR, up and down, 1-pixel and
non-square edges, one and three bands), and so do the encoders' preprocessed pixels (the
same uint8 bytes, then the same fp32 arithmetic). The features through the towers within
the encoders' own tolerances (``test_torch_video.py``'s FEAT_TOL: fp32 sums in another
order), the CLI's WAV within 5 int16 steps, as the device route's tests hold them.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from foley_tpu.models import siglip2 as jsig
from foley_tpu.models import synchformer as jsync
from foley_tpu.pipeline import features as jfeat
from foley_tpu_torch.ops import pil_resize
from foley_tpu_torch.models import siglip2 as tsig
from foley_tpu_torch.models import synchformer as tsync
from test_torch_siglip2 import J_CFG as SIG_J_CFG, towers  # noqa: F401 (fixture)
from test_torch_synchformer import J_CFG as SYNC_J_CFG, nets  # noqa: F401 (fixture)
from test_torch_video import FEAT_TOL, PCM_TOL, v2a_dir  # noqa: F401 (fixture)
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)

FILTERS = {pil_resize.BICUBIC: Image.BICUBIC, pil_resize.BILINEAR: Image.BILINEAR}

# (in_h, in_w, out_h, out_w): down, up, mixed, 1-pixel and non-square edges
SHAPES = [
    (64, 80, 16, 20), (97, 61, 13, 29), (720, 1280, 224, 398), (48, 48, 512, 512),
    (7, 9, 31, 17), (30, 40, 30, 17), (30, 40, 11, 40), (1, 1, 5, 7), (5, 7, 1, 1),
    (1, 60, 1, 13), (60, 1, 9, 1), (2, 3, 200, 3), (33, 33, 32, 34), (17, 90, 90, 17),
    (123, 45, 7, 150), (64, 64, 64, 64),
]


def _image(h, w, c=3, seed=0):
    return np.random.default_rng(seed + 7 * h + w).integers(0, 256, (h, w, c), dtype=np.uint8)


def _pil(a, width, height, kind):
    img = Image.fromarray(a[..., 0] if a.shape[-1] == 1 else a)
    out = np.asarray(img.resize((width, height), FILTERS[kind]))
    return out.reshape(height, width, a.shape[-1])


@pytest.mark.parametrize("kind", sorted(FILTERS))
@pytest.mark.parametrize("in_h,in_w,out_h,out_w", SHAPES)
def test_resize_equals_pillow(kind, in_h, in_w, out_h, out_w):
    a = _image(in_h, in_w)
    got = pil_resize.resize(torch.from_numpy(a), (out_w, out_h), kind)
    assert got.dtype == torch.uint8 and got.shape == (out_h, out_w, 3)
    np.testing.assert_array_equal(got.numpy(), _pil(a, out_w, out_h, kind))


@pytest.mark.parametrize("kind", sorted(FILTERS))
def test_single_band_and_batches_equal_pillow(kind):
    """A one-band ("L") image, and a batch [2, 3, H, W, C] equal to its frames one by one."""
    a = _image(37, 23, c=1)
    np.testing.assert_array_equal(
        pil_resize.resize(torch.from_numpy(a), (50, 11), kind).numpy(), _pil(a, 50, 11, kind))
    batch = np.stack([_image(19, 41, seed=s) for s in range(6)]).reshape(2, 3, 19, 41, 3)
    got = pil_resize.resize(torch.from_numpy(batch), (8, 30), kind).numpy()
    assert got.shape == (2, 3, 30, 8, 3)
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(got[i, j], _pil(batch[i, j], 8, 30, kind))


def test_resize_chunks_large_batches(monkeypatch):
    """Frames split into chunks (to bound the accumulators) give the same bytes."""
    batch = torch.from_numpy(np.stack([_image(30, 50, seed=s) for s in range(5)]))
    whole = pil_resize.resize(batch, (20, 12))
    monkeypatch.setattr(pil_resize, "_CHUNK_ELEMENTS", 1)
    assert torch.equal(pil_resize.resize(batch, (20, 12)), whole)


def test_resize_refuses_what_pillow_would_not_do_here():
    with pytest.raises(TypeError, match="uint8"):
        pil_resize.resize(torch.zeros(4, 4, 3), (2, 2))
    with pytest.raises(ValueError, match="filter"):
        pil_resize.resize(torch.zeros(4, 4, 3, dtype=torch.uint8), (2, 2), "lanczos")
    with pytest.raises(ValueError, match="at least 1"):
        pil_resize.resize(torch.zeros(4, 4, 3, dtype=torch.uint8), (0, 2))


# ---------------------------------------------------------------------------------
# The encoders' PIL route
# ---------------------------------------------------------------------------------

def _frames(t, h, w, seed=1):
    return np.random.default_rng(seed).random((t, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("hw,size", [((72, 128), 64), ((40, 30), 512), ((50, 50), 32)])
def test_siglip2_preprocess_frames_equals_jax(hw, size):
    frames = _frames(3, *hw)
    ref = jsig.preprocess_frames(frames, size)
    got = tsig.preprocess_frames(frames, size, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hw,size", [((72, 128), 32), ((130, 60), 32), ((200, 200), 224),
                                     ((90, 161), 64)])
def test_synchformer_preprocess_frames_equals_jax(hw, size):
    frames = _frames(3, *hw)
    ref = jsync.preprocess_frames(frames, size)
    got = tsync.preprocess_frames(frames, size, device="cpu")
    assert got.shape == ref.shape == (3, size, size, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_siglip2_pil_encode_matches_jax(towers):  # noqa: F811
    params, model = towers
    frames = _frames(4, 70, 90)
    j_enc = jsig.Siglip2Encoder(params, SIG_J_CFG, preprocess="pil", attn_impl="xla")
    enc = tsig.Siglip2Encoder(model, preprocess="pil")
    got = enc.encode(frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_enc.encode(frames)), **FEAT_TOL)
    enc.preprocess = "device"
    assert not torch.equal(enc.encode(frames), got)  # the two routes differ
    enc.preprocess = "lanczos"
    with pytest.raises(ValueError, match="preprocess"):
        enc.encode(frames)


@pytest.mark.parametrize("t", [40, 9])
def test_synchformer_pil_encode_matches_jax(nets, t):  # noqa: F811
    """The V2A route and the segments route on PIL's resize of each unique frame, against
    the JAX ``encode_segments`` of ``sync_segments`` (which resizes every segment's frames)."""
    params, model = nets
    frames = _frames(t, 48, 40, seed=t)
    j_enc = jsync.SynchformerEncoder(params, SYNC_J_CFG, preprocess="pil")
    ref = np.asarray(jsync.encode_segments(j_enc, jfeat.sync_segments(frames)))
    enc = tsync.SynchformerEncoder(model, preprocess="pil")
    got = tsync.encode_frames(enc, frames)
    np.testing.assert_allclose(got.numpy(), ref, **FEAT_TOL)
    assert torch.equal(tsync.encode_segments(enc, frames), got)


def test_cli_frames_dir_v2a_pil_matches_jax(v2a_dir, monkeypatch, tmp_path):  # noqa: F811
    """``--v2a_preprocess pil`` through both CLIs on a PNG directory: the same WAV."""
    from test_torch_cli import RUN, _inject_noise as cli_noise, _read

    from foley_tpu import cli as jcli
    from foley_tpu_torch import cli as tcli

    argv = ["--model_path", str(v2a_dir), "--single_video", str(v2a_dir / "frames"),
            "--frames_fps", "8", "--duration", "1", "--v2a_preprocess", "pil"] + RUN
    assert jcli.main(argv + ["--output", str(tmp_path / "jax.wav")]) == 0
    cli_noise(monkeypatch, 3)
    assert tcli.main(argv + ["--output", str(tmp_path / "port.wav"), "--device", "cpu"]) == 0
    ref, got = _read(tmp_path / "jax.wav"), _read(tmp_path / "port.wav")
    assert got.shape == ref.shape == (48000,)
    assert np.abs(got - ref).max() <= PCM_TOL


def test_dependencies_node_takes_the_pil_route(v2a_dir):  # noqa: F811
    from foley_tpu_torch.api.nodes import HunyuanDependenciesLoader

    (deps,) = HunyuanDependenciesLoader().load_dependencies(
        str(v2a_dir / "vae_128d_48k.safetensors"), None, precision="fp32",
        siglip2_model=str(v2a_dir / "siglip2"), video_preprocess="pil", device="cpu")
    assert deps["siglip2"].preprocess == "pil"
    frames = _frames(2, 40, 30)
    np.testing.assert_array_equal(
        tsig.preprocess_frames(frames, deps["siglip2"].cfg.image_size, "cpu").numpy(),
        jsig.preprocess_frames(frames, deps["siglip2"].cfg.image_size))


def test_server_main_takes_the_pil_route(monkeypatch):
    """``--v2a_preprocess pil --enable_v2a``: the served encoders take the PIL route, and a
    ``--v2a_warmup_hw`` geometry is dropped (the PIL resize outputs a fixed size); the HTTP
    server itself is stubbed."""
    from foley_tpu_torch.serving import server as tserver

    served = {}

    class NoServer:
        def serve_forever(self):
            pass

    monkeypatch.setattr(tserver, "create_server",
                        lambda service, host, port: served.setdefault("svc", service)
                        and NoServer())
    assert tserver.main(["--random_init", "tiny", "--device", "cpu", "--durations", "1",
                         "--warmup_steps", "1", "--enable_v2a", "--v2a_preprocess", "pil",
                         "--v2a_warmup_hw", "36x64"]) == 0
    svc = served["svc"]
    assert {k: e.preprocess for k, e in svc.video_encoders.items()} == {
        "siglip2": "pil", "synchformer": "pil"}
    assert svc.v2a_warmup_hw is None
