"""The port's server (``serving/server.py``) against the JAX package's, on the CPU at the TINY
config in fp32: the port's HTTP round trips held against ``foley_tpu.serving``'s
``FoleyService.generate`` on the same weights (both loaded through each package's nodes from
the same checkpoint files, ``tests/test_torch_nodes.py``) and the same requests, with the
JAX noise injected into the port.

Tolerance: audio atol 1e-4 against JAX (``test_torch_nodes.py``'s); within the port, JSON
and WAV carry the same bytes, the in-bucket PCM16 stream equals the WAV exactly, a windowed
stream is within 1.5/32767 of the batch audio (the JAX package's own bound), and a coalesced
row is within 1e-4 of its request served alone (the batched GEMMs sum in another order).
"""

import base64
import io
import json
import re
import threading
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foley_tpu.configs import TINY as J_TINY
from foley_tpu.models import synchformer as jsync
from foley_tpu.pipeline import generate as jgen
from foley_tpu.serving import server as jserver
from foley_tpu_torch.configs import TINY, SynchformerConfig
from foley_tpu_torch.io.native import wav_image
from foley_tpu_torch.models import synchformer as tsync
from foley_tpu_torch.pipeline import generate as tgen
from foley_tpu_torch.pipeline import longform as tlong
from foley_tpu_torch.serving import server as tserver
from test_torch_nodes import SYNC_FIELDS, _inject_noise, ckpts, graphs  # noqa: F401 (fixtures)
from torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_helpers import jax_native_library  # noqa: F401 (autouse)

AUDIO_TOL = dict(atol=1e-4, rtol=0)
STREAM_TOL = 1.5 / 32767
BASE = {"prompt": "glass shattering", "negative_prompt": "noisy harsh", "duration": 1.0,
        "steps": 2, "seed": 3}


@pytest.fixture(scope="module")
def services(graphs, ckpts):
    j_model, j_deps, t_model, t_deps = graphs
    path = str(ckpts / "synchformer_state_dict.safetensors")
    j_sync = jsync.load(path, jsync.SynchformerConfig(**SYNC_FIELDS))
    j_sync.preprocess = "device"
    kw = dict(durations=(1.0,), text_buckets=(16,), default_steps=2)
    j_svc = jserver.FoleyService(
        jgen.ModelBundle(j_model["params"], j_deps["dac_params"], J_TINY,
                         compute_dtype=jnp.float32),
        j_deps["clap"], video_encoders={"siglip2": j_deps["siglip2"], "synchformer": j_sync},
        **kw)
    t_bundle = tgen.ModelBundle(t_model["params"], t_deps["dac_params"], TINY,
                                compute_dtype=torch.float32)
    t_video = {"siglip2": t_deps["siglip2"],
               "synchformer": tsync.load(path, SynchformerConfig(**SYNC_FIELDS), device="cpu")}
    t_svc = tserver.FoleyService(t_bundle, t_deps["clap"], video_encoders=t_video, **kw)
    t_svc.warmup(steps=2)
    return j_svc, t_svc


@pytest.fixture(scope="module")
def server(services):
    srv = tserver.create_server(services[1], host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _post(server, body):
    req = urllib.request.Request(server + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read(), dict(r.headers)


def _pcm(wav_bytes):
    with wave.open(io.BytesIO(wav_bytes)) as f:
        assert (f.getframerate(), f.getnchannels(), f.getsampwidth()) == (48000, 1, 2)
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def _frames_b64(n=13, h=40, w=56):
    frames = np.random.default_rng(4).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, frames=frames)
    return base64.b64encode(buf.getvalue()).decode()


def _continue_b64(seconds=1.0):
    x = np.random.default_rng(5).uniform(-0.5, 0.5, int(seconds * 48000)).astype(np.float32)
    return base64.b64encode(wav_image(x, 48000)).decode()


def _against_jax(services, server, monkeypatch, body, module=tgen):
    """(port samples from HTTP as float, JAX service samples) of one request."""
    ref = services[0].generate(dict(body))
    _inject_noise(monkeypatch, body["seed"], module)
    data, headers = _post(server, body)
    assert headers["Content-Type"] == "audio/wav"
    got = _pcm(data).astype(np.float32) / 32767.0
    ref_w = np.asarray(ref["waveform"])[0]
    assert got.shape == ref_w.shape
    np.testing.assert_allclose(got, ref_w, **AUDIO_TOL)
    assert np.abs(got).max() > 0
    return got, data


def test_warmup_health_index_and_404(services, server):
    assert (1.0, 1, 16) in services[1].warm_buckets
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert body == {"status": "ok", "warm_buckets": [[1.0, 1, 16]]}
    with urllib.request.urlopen(server + "/", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/html") and b"/generate" in r.read()
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nothing", timeout=30)
    assert e.value.code == 404


def test_wav_and_json_match_jax(services, server, monkeypatch):
    got, wav = _against_jax(services, server, monkeypatch, BASE)
    assert got.shape == (48000,)
    data, headers = _post(server, dict(BASE, response="json"))
    assert headers["Content-Type"] == "application/json"
    payload = json.loads(data)
    assert payload["sample_rate"] == 48000 and set(payload["timings"]) >= {"prepare_s"}
    assert base64.b64decode(payload["audio_base64"]) == wav  # the same samples


def test_pcm16_stream_equals_wav(server, monkeypatch):
    _inject_noise(monkeypatch, BASE["seed"])
    wav, _ = _post(server, BASE)
    stream, headers = _post(server, dict(BASE, response="pcm16_stream"))
    assert headers["X-Sample-Rate"] == "48000" and headers["X-Total-Samples"] == "48000"
    assert stream == _pcm(wav).tobytes()


def test_long_form_over_bucket_matches_jax_and_streams(services, server, monkeypatch):
    """1.5 s past the 1 s bucket: long-form in 1 s windows (snapped to the window grid)."""
    body = dict(BASE, duration=1.5, seed=4)
    got, _ = _against_jax(services, server, monkeypatch, body, module=tlong)
    assert got.shape == (72000,)
    stream, headers = _post(server, dict(body, response="pcm16_stream"))
    assert headers["X-Total-Samples"] == "72000"
    streamed = np.frombuffer(stream, "<i2").astype(np.float32) / 32767.0
    np.testing.assert_allclose(streamed, got, atol=STREAM_TOL, rtol=0)


def test_continuation_matches_jax(services, server, monkeypatch):
    body = dict(BASE, continue_b64=_continue_b64(), context_s=0.5, seed=5)
    got, _ = _against_jax(services, server, monkeypatch, body, module=tlong)
    assert got.shape == (48000,)
    stream, _ = _post(server, dict(body, response="pcm16_stream"))
    np.testing.assert_allclose(np.frombuffer(stream, "<i2").astype(np.float32) / 32767.0, got,
                               atol=STREAM_TOL, rtol=0)


def test_v2a_frames_b64_matches_jax(services, server, monkeypatch):
    body = dict(BASE, frames_b64=_frames_b64(), frames_fps=12.0, seed=6)
    got, _ = _against_jax(services, server, monkeypatch, body)
    t2a = services[1].generate(dict(BASE, seed=6))  # same noise, no video
    assert np.abs(np.asarray(t2a["waveform"])[0] - got).max() > 1e-3


@pytest.mark.parametrize("body,match", [
    ({"frames_path": "FRAMES", "mux_video": True, "response": "avi"}, "avi"),
    ({"frames_b64": "FRAMES", "mux_video": True, "response": "json"}, "json"),
    ({"response": "avi"}, 'response="avi" requires a V2A request'),
    ({"mux_video": True, "response": "pcm16_stream"},
     "mux_video is not supported with response=pcm16_stream"),
])
def test_media_requests_answer_400(server, tmp_path, body, match):
    """``mux_video`` is served: ``"response": "avi"`` returns the MJPEG AVI and ``"json"``
    adds it as ``video_base64``, equal to the JAX package's ``build_avi_bytes`` of the
    request's frames and the served audio. ``"avi"`` without a video answers the JAX
    package's message (500); ``mux_video`` on a PCM stream answers 400 with the JAX
    package's message."""
    from foley_tpu.io import avi as javi
    from PIL import Image

    rng = np.random.default_rng(11)
    clip = rng.integers(0, 256, (13, 40, 56, 3), dtype=np.uint8)
    body = dict(BASE, **body, frames_fps=12.0)
    if body.get("frames_path") == "FRAMES":
        d = tmp_path / "frames"
        d.mkdir()
        for i, fr in enumerate(clip):
            Image.fromarray(fr).save(d / f"{i:02d}.jpg")
        body["frames_path"] = str(d)
        clip = np.stack([np.asarray(Image.open(d / f"{i:02d}.jpg").convert("RGB"))
                         for i in range(len(clip))])
    elif body.get("frames_b64") == "FRAMES":
        buf = io.BytesIO()
        np.savez(buf, frames=clip)
        body["frames_b64"] = base64.b64encode(buf.getvalue()).decode()
    if match in ("avi", "json"):
        data, headers = _post(server, body)
        if match == "avi":
            assert headers["Content-Type"] == "video/x-msvideo"
            avi = data
        else:
            payload = json.loads(data)
            avi = base64.b64decode(payload["video_base64"])
            wav = _pcm(base64.b64decode(payload["audio_base64"]))
        info_path = tmp_path / "got.avi"
        info_path.write_bytes(avi)
        pcm = np.frombuffer(javi.read_avi_info(str(info_path))["pcm"], "<i2")[0::2]
        assert pcm.size == 48000 and np.abs(pcm).max() > 0
        if match == "json":
            np.testing.assert_array_equal(pcm, wav)  # the AVI carries the served audio
        assert avi == javi.build_avi_bytes(clip, 12.0, pcm, 48000)
        return
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, body)
    assert e.value.code == (400 if "pcm16" in match else 500)
    assert match in json.loads(e.value.read())["error"]


def test_metrics_count_requests_and_failures(services, server):
    with urllib.request.urlopen(server + "/metrics", timeout=30) as r:
        before = json.loads(r.read())
    _post(server, dict(BASE, seed=8))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, dict(BASE, steps="not-an-int"))
    assert e.value.code == 500
    with urllib.request.urlopen(server + "/metrics", timeout=30) as r:
        after = json.loads(r.read())
    assert after["requests_total"] == before["requests_total"] + 2
    assert after["failures_total"] == before["failures_total"] + 1
    assert after["in_flight"] == 0
    assert after["latency_ms"]["p95"] >= after["latency_ms"]["p50"] > 0


def test_request_threads_return_no_grad_tensors(services):
    """Grad mode is thread-local: a request thread starts with it on. Nothing it computes
    may require grad."""
    t_svc = services[1]
    out = {}

    def request():
        out["grad_mode"] = torch.is_grad_enabled()
        out["text"] = t_svc._text(BASE)
        out["video"] = t_svc._visual_features(dict(BASE, frames_b64=_frames_b64()), 1.0)
        res = tgen.generate_audio(t_svc.bundle, *out["text"], 1.0, num_inference_steps=2,
                                  return_latents=True)
        out["result"] = (res.audio_batch, res.latents)

    thread = threading.Thread(target=request)
    thread.start()
    thread.join()
    assert out["grad_mode"]
    tensors = [*out["text"], *out["video"]]
    assert tensors and not any(t.requires_grad for t in tensors)
    assert all(isinstance(a, np.ndarray) for a in out["result"])


def _batching(services, **kw):
    return tserver.BatchingFoleyService(services[1].bundle, services[1].text_encoder,
                                        durations=(1.0,), text_buckets=(16,), default_steps=2,
                                        **kw)


def test_batching_coalesces_rows_equal_to_solo(services):
    svc = _batching(services, max_batch=2, batch_window_s=0.3)
    reqs = [dict(BASE, prompt="glass shattering", seed=11), dict(BASE, prompt="rain", seed=12)]
    with ThreadPoolExecutor(2) as ex:
        outs = list(ex.map(svc.generate, reqs))
    groups = {g for s, g, _ in svc.events if s == "device_start"}
    assert len(groups) == 1 and svc.groups_in_flight() == 0  # one batch-2 call
    for req, out in zip(reqs, outs):
        solo = services[1].generate(req)
        assert out["waveform"].shape == (1, 48000)
        np.testing.assert_allclose(out["waveform"], solo["waveform"], atol=1e-4, rtol=0)
    assert np.abs(outs[0]["waveform"] - outs[1]["waveform"]).max() > 0


def test_batching_failure_does_not_wedge_and_buckets_split(services):
    svc = _batching(services, max_batch=4, batch_window_s=0.2)
    with pytest.raises(Exception):
        svc.generate(dict(BASE, sampler="bogus"))
    assert svc.generate(dict(BASE, seed=1))["waveform"].shape == (1, 48000)
    reqs = [dict(BASE, seed=1), dict(BASE, steps=3, seed=2), dict(BASE, seed=3)]
    n_before = len({g for s, g, _ in svc.events if s == "device_start"})
    with ThreadPoolExecutor(3) as ex:
        outs = list(ex.map(svc.generate, reqs))
    assert all(o["waveform"].shape == (1, 48000) for o in outs)
    assert len({g for s, g, _ in svc.events if s == "device_start"}) - n_before == 2


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "data=2", "--blocks_to_swap", "2", "--random_init", "tiny"], "drop --mesh"),
    (["--random_init", "tiny", "--model_path", "ckpts"], "exactly one"),
    (["--prefetch_blocks", "1", "--random_init", "tiny"], "--blocks_to_swap"),
    (["--v2a_warmup_hw", "12x", "--random_init", "tiny"], "bad geometry"),
    (["--precision", "auto", "--random_init", "tiny"], "--precision auto"),
])
def test_main_refuses_unported_options(argv, match, capsys):
    with pytest.raises(SystemExit):
        tserver.main(argv + ["--device", "cpu"])
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("quantization,swap,prefetch", [("int8", 3, 1), ("int4", 6, 0)])
def test_main_serves_the_memory_modes(monkeypatch, quantization, swap, prefetch):
    """``--quantization``, ``--blocks_to_swap`` and ``--prefetch_blocks``: the served bundle
    holds the quantized, split denoiser with the window, and the warm-up generates through
    it (the HTTP server itself is stubbed)."""
    from foley_tpu_torch.parallel import offload

    served = {}

    class NoServer:
        def serve_forever(self):
            pass

    monkeypatch.setattr(tserver, "create_server",
                        lambda service, host, port: served.setdefault("svc", service)
                        and NoServer())
    assert tserver.main(["--random_init", "tiny", "--device", "cpu", "--durations", "1",
                         "--warmup_steps", "2", "--quantization", quantization,
                         "--blocks_to_swap", str(swap), "--prefetch_blocks",
                         str(prefetch)]) == 0
    bundle = served["svc"].bundle
    assert bundle.offload_prefetch == prefetch + 1
    assert offload.partition_report(bundle.mmdit)["host_blocks"] == swap
    kind = {"int8": "weight_int8", "int4": "weight_int4"}[quantization]
    assert hasattr(bundle.mmdit.single_blocks[0].linear_qkv, kind)
    out = served["svc"].generate(dict(BASE, seed=1))
    assert out["waveform"].shape == (1, 48000) and np.abs(out["waveform"]).max() > 0
