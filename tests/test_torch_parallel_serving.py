"""The served mesh: ``python -m foley_tpu_torch.serving.server --mesh data=2,model=2 --device
cpu`` in a subprocess (its five processes: the launcher and four gloo ranks) against the
one-rank ``FoleyService`` of the same checkpoint directory in this process, as
``tests/test_serving.py::test_sharded_serving_over_virtual_mesh`` holds the JAX package's
mesh against its one-chip service: a T2A request, two requests coalesced into one batch,
and a long-form PCM stream, with a request refused between them (its batch does not split
over ``data``) that leaves the mesh serving; a long-form stream whose client leaves after its
header while a request waits, which the mesh serves as one rank would (the stream's windows
left run on every rank, rank 0 included, before the waiting request starts); then SIGTERM,
to which the server answers with exit code 0.
And the refusals of ``--mesh``, with the JAX server's messages, before anything loads.

Tolerance: the responses are 16-bit PCM, and the row-parallel sums add the same fp32 products
in another order, so a sample whose value lies within a rounding of a PCM step boundary may
round the other way: each sample is held within one PCM step (1.5/32767, the windowed
stream's bound in ``tests/test_torch_serving.py``), and all but a few per mille of them
equal, bit for bit. The latents themselves are held at 1e-5 in
``tests/test_torch_parallel.py``.
"""

import http.client
import io
import json
import re
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from foley_tpu.serving import server as jserver
from foley_tpu_torch.parallel.inference import MeshCalls, MeshFault
from foley_tpu_torch.pipeline.generate import generate_audio_multi
from foley_tpu_torch.serving import server as tserver
from torch_helpers import one_torch_thread, save_checkpoint_dir  # noqa: F401 (autouse)
from torch_helpers import jax_native_library  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
PCM_STEP = 1.5 / 32767
T2A = {"prompt": "glass shattering", "negative_prompt": "noisy harsh", "duration": 1.0,
       "steps": 2, "seed": 3}
PAIR = [dict(T2A, prompt="rain on a tin roof", seed=11), dict(T2A, prompt="wind", seed=12)]
LONG = {"prompt": "footsteps on ice", "duration": 2.5, "steps": 2, "seed": 4,
        "response": "pcm16_stream"}
LEFT = dict(LONG, prompt="a door creaks", duration=8.0, steps=4)  # left after its header
WAITING = dict(T2A, prompt="a kettle whistles", seed=5)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpts")
    save_checkpoint_dir(root)
    return root


def _argv(ckpt):
    return ["--model_path", str(ckpt), "--config", "tiny", "--precision", "fp32",
            "--durations", "1", "--warmup_steps", "2", "--max_batch", "2", "--device", "cpu"]


class _Server:
    """The server subprocess, its stderr read on a thread (the bound port is logged)."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "foley_tpu_torch.serving.server", *argv, "--port", "0"],
            cwd=ROOT, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True)
        self.lines, self.url = [], None
        self.bound = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stderr:
            self.lines.append(line)
            m = re.search(r"serving on (http://[\d.]+:\d+)", line)
            if m:
                self.url = m.group(1)
                self.bound.set()

    def metrics(self) -> dict:
        with urllib.request.urlopen(self.url + "/metrics", timeout=60) as r:
            return json.loads(r.read())

    def post(self, body) -> bytes:
        req = urllib.request.Request(self.url + "/generate", data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()


def _wav(raw: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(raw)) as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2").astype(np.float32) / 32767


def _assert_pcm_close(got, ref):
    got, ref = np.ravel(got), np.ravel(ref)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= PCM_STEP, diff.max()
    assert (diff > 0).mean() <= 5e-3, (diff > 0).mean()
    assert np.abs(got).max() > 0


def test_mesh_server_serves_like_one_rank(ckpt):
    server = _Server(_argv(ckpt) + ["--mesh", "data=2,model=2"])
    try:
        # the one-rank reference while the ranks load and warm up
        args = tserver.build_parser().parse_args(_argv(ckpt))
        bundle, text_encoder, _ = tserver.load_models(args, torch.device("cpu"))
        solo = tserver.FoleyService(bundle, text_encoder, durations=(1.0,))
        assert server.bound.wait(240), "".join(server.lines)

        _assert_pcm_close(_wav(server.post(T2A)), solo.generate(T2A)["waveform"])
        # refused before any rank starts it (one row does not split over data=2): the
        # request fails, the mesh serves on
        with pytest.raises(urllib.error.HTTPError, match="500") as refused:
            server.post(dict(T2A, cfg_scale=1.0))
        assert b"do not split over the mesh's data=2" in refused.value.read()

        with ThreadPoolExecutor(2) as ex:
            pair = list(ex.map(server.post, PAIR))
        # what the batching service's dispatcher runs for the pair, on one rank
        text_b, uncond_b, seeds = tserver.BatchingFoleyService._prepare_group(
            solo, [types.SimpleNamespace(request=r) for r in PAIR])
        multi = generate_audio_multi(bundle, text_b, uncond_b, 1.0, seeds,
                                     num_inference_steps=2, text_bucket=solo.text_buckets[0])
        for raw, row in zip(pair, multi.audio_batch):
            _assert_pcm_close(_wav(raw), row)
        assert not np.array_equal(_wav(pair[0]), _wav(pair[1]))

        stream = np.frombuffer(server.post(LONG), "<i2").astype(np.float32) / 32767
        ref = b"".join(c["pcm"] for c in list(solo.generate_stream(LONG))[1:])
        _assert_pcm_close(stream, np.frombuffer(ref, "<i2").astype(np.float32) / 32767)
        assert stream.shape == (int(2.5 * 48000),)

        # a client leaves a long-form stream while a request waits for the card
        host, port = server.url.removeprefix("http://").split(":")
        left = http.client.HTTPConnection(host, int(port), timeout=300)
        left.request("POST", "/generate", json.dumps(LEFT))
        resp = left.getresponse()  # the status line and headers: the windows have begun
        assert resp.status == 200
        with ThreadPoolExecutor(1) as ex:
            waiting = ex.submit(server.post, WAITING)
            while server.metrics()["in_flight"] < 2:
                time.sleep(0.02)
            time.sleep(0.5)  # past the batch window and the prompt's encoding
            resp.close()
            left.close()
            _assert_pcm_close(_wav(waiting.result()), solo.generate(WAITING)["waveform"])
        dropped = r"generate failed: .*(Broken pipe|Connection reset)"  # the stream's write
        assert any(re.search(dropped, line) for line in server.lines), "".join(server.lines)

        server.proc.send_signal(signal.SIGTERM)
        assert server.proc.wait(120) == 0, "".join(server.lines)
    finally:
        if server.proc.poll() is None:
            server.proc.kill()
            server.proc.wait()
    log = "".join(server.lines)
    for rank in range(4):
        assert f"as rank {rank} (gloo, cpu)" in log
    assert re.search(r"rank [123]: ran \d+ calls of rank 0", log)


def _windows(bundle, events, n, fail_at=None):
    """A streamed pipeline call of ``n`` windows, each logged in ``events``."""
    for i in range(n):
        if i == fail_at:
            raise RuntimeError(f"window {i} fails")
        events.append(("window", i))
        yield i


def _one(bundle, events):
    events.append(("one",))
    return 1


def _mesh_calls(events):
    """Rank 0's ``MeshCalls`` over a stand-in mesh that logs each call it hands on."""
    mesh = types.SimpleNamespace(
        broadcast_object=lambda msg: events.append(("broadcast", msg[0].__name__)))
    return MeshCalls(mesh, bundle=None)


def test_mesh_calls_run_a_left_stream_to_its_end_first():
    """A stream whose consumer leaves after its first window runs its other windows on
    rank 0 before a call that waits meanwhile is handed to the other ranks (they run every
    window of the stream first: another order would pair the ranks' collectives wrongly)."""
    events = []
    calls = _mesh_calls(events)
    stream = calls.call(_windows, events, 3)
    assert next(stream) == 0
    waiting = threading.Thread(target=calls.call, args=(_one, events))
    waiting.start()
    time.sleep(0.2)  # the waiting call blocks on the stream
    stream.close()
    waiting.join(10)
    assert events == [("broadcast", "_windows"), ("window", 0), ("window", 1), ("window", 2),
                      ("broadcast", "_one"), ("one",)]
    assert calls.fault is None


def test_mesh_calls_fault_when_a_left_stream_fails():
    """A window that fails while a left stream runs out faults the served mesh: the
    server is shut down and no other call starts."""
    events, shut_down = [], []
    calls = _mesh_calls(events)
    calls.on_fault = lambda: shut_down.append(True)
    stream = calls.call(_windows, events, 3, fail_at=2)
    assert next(stream) == 0
    with pytest.raises(MeshFault, match="window 2 fails"):
        stream.close()
    assert shut_down == [True]
    with pytest.raises(MeshFault, match="faulted"):
        calls.call(_one, events)
    assert ("one",) not in events


@pytest.mark.parametrize("argv", [
    ["--mesh", "data=2", "--blocks_to_swap", "4"],
    ["--mesh", "data=0"],
    ["--mesh", "data=2,data=2"],
    ["--mesh", "tensor=2"],
    ["--mesh", "model=x"]])
def test_mesh_refusals_match_jax(argv, capsys):
    """Each refusal the JAX server makes of ``--mesh``, with its message, before any load."""
    with pytest.raises(SystemExit):
        jserver.main(argv + ["--random_init", "tiny"])
    ref = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    with pytest.raises(SystemExit):
        tserver.main(argv + ["--random_init", "tiny", "--device", "cpu"])
    assert capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1] == ref


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "model=2", "--quantization", "int8"], "use fp8 or model=1"),
    (["--mesh", "model=2", "--quantization", "int4"], "use fp8 or model=1"),
    (["--mesh", "model=4"], "does not divide"),
    (["--mesh", "data=2", "--device", "cuda"], "cards"),
])
def test_mesh_refusals_of_the_port(argv, match, capsys):
    """What the port refuses further, before any load: integer weight storage at model > 1
    (``test_torch_parallel.py`` shows JAX refusing it at placement), a model axis that does
    not split the TINY denoiser's heads, more ranks than cards on ``--device cuda``."""
    with pytest.raises(SystemExit):
        tserver.main(["--random_init", "tiny", "--device", "cpu"] + argv)
    assert match in capsys.readouterr().err
