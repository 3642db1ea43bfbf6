"""HTTP serving of Foley generation on the port (``foley_tpu/serving/server.py``
counterpart): a thread-safe ``FoleyService`` around a ``ModelBundle``, warmed over declared
(duration, batch, text-bucket) buckets, and a standard-library HTTP server:

- ``GET /``            -> a minimal web page (prompt box -> audio player);
- ``GET /healthz``     -> {"status": "ok", "warm_buckets": [...]};
- ``GET /metrics``     -> request counters and latency percentiles;
- ``POST /generate``   -> WAV bytes (audio/wav), JSON with base64 WAV, or raw int16 PCM
  streamed as windows finish (``"response": "pcm16_stream"``).
  Body: {"prompt", "negative_prompt", "duration", "steps", "cfg_scale", "sampler",
  "batch_size", "seed", "response": "wav"|"json"|"pcm16_stream"}. V2A (a server with video
  encoders): add {"frames_b64": base64 of an .npz holding "frames" [T, H, W, 3] uint8 or
  float [0, 1], "frames_fps": float} or {"frames_path": a server-local video file or
  directory of PNG frames, read by ``pipeline/video.py``, "frames_fps": float}; a
  ``frames_path`` must lie under the server's ``frames_root`` (``--frames_root``; the whole
  file system on a loopback bind, nothing on another bind unless given). Continuation:
  {"continue_b64": base64 of a 16-bit WAV at the DAC's rate, "context_s": float}.

The memory modes are the CLI's: ``--quantization`` stores the denoiser's weights quantized
(``io/quantize.py``) and ``--blocks_to_swap N`` keeps its last N blocks in page-locked host
memory, streamed through ``--prefetch_blocks + 1`` device slots a family
(``parallel/offload.py``). ``--lora DIR`` merges an adapter (``models/lora.py``) into the
denoiser at load, before any quantization or block swap.

Requests the port cannot serve answer 400 with the reason: ``mux_video`` (with
``"response": "avi"``) writes an MJPEG AVI whose frames PIL encodes, and the card's machine
has no PIL. Any other failure answers 500, as in the JAX package.

Multi-card serving (``--mesh data=D,model=M``, the JAX server's flag and messages): the
server process starts ``D x M`` ranks (``parallel/launch.py``), one a card with ``--device
cuda`` (NCCL), or all on one device with ``--device cuda:N`` / ``cpu`` (gloo). Every rank
loads the models and places its denoiser (``parallel/inference.py::shard_bundle``); rank 0
alone loads the encoders and serves HTTP, and each pipeline call of a request (a generation,
a coalesced batch, a long-form run or stream, the warm-up) runs on every rank with rank 0's
arguments, where the JAX server enters ``with mesh``. A call that fails on any rank once the
ranks have started it stops the server (exit code 1); what would fail inside one (an
unknown sampler, a batch whose rows do not split over ``data``) is refused before.
``--blocks_to_swap`` is refused with ``--mesh``, as in the JAX package, and so are int8,
int8_dynamic and int4 storage with ``model > 1`` (``parallel/sharding.py::check_quantization``).

SIGTERM or SIGINT shuts the server down (exit code 0), on one device or a mesh.

Device work is serialized by a lock (one generation on the card at a time); a duration is
snapped up to the smallest warmed bucket that holds it, and one past the largest bucket
runs long-form in windows of the largest. ``BatchingFoleyService`` (``--max_batch > 1``)
coalesces concurrent requests of one bucket into one batched generation, distinct prompts
and seeds per row.

Threads: ``ThreadingHTTPServer`` runs each request on a thread of its own. Grad mode is
thread-local in PyTorch, so every forward a thread reaches holds its own ``no_grad`` (the
models' entry points are decorated, and their weights do not require grad). The kernels'
launch counters are taken under a lock (``ops/kernels/common.py::count_launch``), so they
stay exact when requests run concurrently.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import queue
import signal
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from foley_tpu_torch.io.native import float_to_pcm16, wav_image
from foley_tpu_torch.models import clap as clap_mod
from foley_tpu_torch.pipeline import features
from foley_tpu_torch.parallel.inference import MeshCalls
from foley_tpu_torch.pipeline.generate import ModelBundle, generate_audio, generate_audio_multi
from foley_tpu_torch.pipeline.longform import (
    continue_audio,
    continue_audio_stream,
    default_window_s,
    emitted_samples,
    generate_audio_long,
    generate_audio_long_stream,
    plan_v2a_long,
)
from foley_tpu_torch.sampling.flow_match import solver_init

logger = logging.getLogger("foley_tpu_torch")

_NO_PIL = "needs PIL's JPEG encoder, which the card's machine has not"


class UnsupportedRequest(ValueError):
    """A request the port cannot serve (answered 400)."""


def _has_video(request: Dict) -> bool:
    return "frames_b64" in request or "frames_path" in request


class FoleyService:
    def __init__(self, bundle: ModelBundle, text_encoder=None,
                 durations: Sequence[float] = (5.0,), batch_sizes: Sequence[int] = (1,),
                 text_buckets: Sequence[int] = (77,), default_steps: int = 50,
                 video_encoders: Optional[Dict] = None,
                 v2a_warmup_hw: Optional[Tuple[int, int]] = None,
                 frames_root: Optional[str] = "/", mesh=None):
        self.bundle = bundle
        # multi-card serving: rank 0's ``RankMesh``, the bundle placed on it
        # (``parallel/inference.py::shard_bundle``); each pipeline call runs on every rank
        self.mesh_calls = MeshCalls(mesh, bundle) if mesh is not None else None
        # frames_path allowlist: requests read only under this directory (None: no
        # frames_path); main narrows it by the bind, the default serves in-process callers
        self.frames_root = frames_root
        self.text_encoder = text_encoder
        self.video_encoders = video_encoders
        # (H, W) of the frames the video warm-up encodes
        self.v2a_warmup_hw = v2a_warmup_hw
        self.durations = sorted(float(d) for d in durations)
        self.batch_sizes = sorted(batch_sizes)
        self.text_buckets = sorted(text_buckets)
        self.default_steps = default_steps
        self._lock = threading.Lock()
        self.warm_buckets: List[Tuple[float, int, int]] = []
        self._metrics_lock = threading.Lock()
        self._requests_total = 0
        self._failures_total = 0
        self._in_flight = 0
        self._latencies_ms: List[float] = []  # newest last

    # -- observability ----------------------------------------------------------
    _LATENCY_WINDOW = 512

    def _record_request(self, elapsed_ms: float, ok: bool) -> None:
        with self._metrics_lock:
            self._requests_total += 1
            if not ok:
                self._failures_total += 1
            self._latencies_ms.append(elapsed_ms)
            if len(self._latencies_ms) > self._LATENCY_WINDOW:
                del self._latencies_ms[: -self._LATENCY_WINDOW]

    def metrics(self) -> Dict:
        """Counters and latency percentiles over the last ``_LATENCY_WINDOW`` requests."""
        with self._metrics_lock:
            lat = list(self._latencies_ms)
            out = {"requests_total": self._requests_total,
                   "failures_total": self._failures_total, "in_flight": self._in_flight,
                   "warm_buckets": list(self.warm_buckets)}
        if lat:
            arr = np.sort(np.asarray(lat))
            out["latency_ms"] = {"p50": round(float(np.percentile(arr, 50)), 1),
                                 "p95": round(float(np.percentile(arr, 95)), 1),
                                 "max": round(float(arr[-1]), 1), "window": len(arr)}
        return out

    def _begin_request(self) -> float:
        with self._metrics_lock:
            self._in_flight += 1
        return time.monotonic()

    def _end_request(self, t0: float, ok: bool) -> None:
        with self._metrics_lock:
            self._in_flight -= 1
        self._record_request((time.monotonic() - t0) * 1e3, ok)

    def _run(self, fn, *args, **kwargs):
        """``fn(bundle, *args, **kwargs)``: a pipeline call, on every rank of a mesh."""
        if self.mesh_calls is not None:
            return self.mesh_calls.call(fn, *args, **kwargs)
        return fn(self.bundle, *args, **kwargs)

    # -- warm-up ----------------------------------------------------------------
    def _zero_text(self, length: Optional[int] = None) -> torch.Tensor:
        cfgm = self.bundle.pipeline_cfg.model
        return torch.zeros((1, length or self.text_buckets[0], cfgm.condition_dim))

    def warmup(self, steps: Optional[int] = None) -> None:
        """Run every declared bucket once (the warm-up node's runtime role), then the video
        encoders once per duration."""
        steps = steps or self.default_steps
        for d in self.durations:
            for b in self.batch_sizes:
                for tb in self.text_buckets:
                    logger.info(f"warmup: duration={d}s batch={b} text_bucket={tb}")
                    z = self._zero_text(tb)
                    with self._lock:
                        self._run(generate_audio, z, z, d, guidance_scale=4.5,
                                  num_inference_steps=steps, batch_size=b, seed=0,
                                  text_bucket=tb)
                    self.warm_buckets.append((d, b, tb))
        if self.video_encoders:
            h, w = self.v2a_warmup_hw or (32, 32)
            for d in self.durations:
                logger.info(f"warmup: v2a encoders duration={d}s source {h}x{w}")
                frames = np.zeros((max(int(round(d * 16.0)), 1), h, w, 3), np.float32)
                features.encode_video(self.video_encoders, frames, 16.0, d,
                                      self.bundle.pipeline_cfg)

    def _snap_duration(self, duration: float) -> float:
        for d in self.durations:
            if duration <= d:
                return d
        return self.durations[-1]

    def _continuation_wav(self, request: Dict) -> Optional[np.ndarray]:
        """A request's ``continue_b64`` WAV -> [1, T] float mono at the DAC's rate, or
        None."""
        if "continue_b64" not in request:
            return None
        raw = base64.b64decode(request["continue_b64"])
        with wave.open(io.BytesIO(raw)) as f:
            sr_want = self.bundle.pipeline_cfg.dac.sample_rate
            if f.getframerate() != sr_want:
                raise ValueError(
                    f"continue_b64 WAV must be {sr_want} Hz (got {f.getframerate()})")
            if f.getsampwidth() != 2:
                raise ValueError("continue_b64 WAV must be 16-bit PCM")
            nch = f.getnchannels()
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        mono = (pcm.astype(np.float32) / 32767.0).reshape(-1, nch).mean(axis=1)
        return mono[None]

    # -- V2A inputs -------------------------------------------------------------
    def _frames_from_request(self, request: Dict):
        """A request's ``frames_b64`` or ``frames_path`` -> ([T, H, W, 3] float [0, 1],
        fps)."""
        fps = float(request.get("frames_fps", 16.0))
        if "frames_b64" not in request:
            import os

            from foley_tpu_torch.pipeline.video import read_video_frames

            # frames_path makes the server read a local file for a client: only under the
            # allowlist, so a non-loopback deployment does not probe local files
            if self.frames_root is None:
                raise ValueError("frames_path is disabled on this server (non-loopback bind "
                                 "without --frames_root); send frames_b64 instead")
            path = os.path.realpath(str(request["frames_path"]))
            root = os.path.realpath(self.frames_root)
            if path != root and not path.startswith(root.rstrip(os.sep) + os.sep):
                raise ValueError("frames_path outside the server's --frames_root allowlist")
            return read_video_frames(path, dir_fps=fps, device=self.bundle.mmdit.device)
        raw = base64.b64decode(request["frames_b64"])
        with np.load(io.BytesIO(raw)) as z:
            frames = z["frames"]
        if frames.dtype == np.uint8:
            frames = frames.astype(np.float32) / 255.0
        return np.clip(frames.astype(np.float32), 0.0, 1.0), fps

    def _visual_features(self, request: Dict, bucket_duration: float):
        """(clip_feat, sync_feat) of a request's video, (None, None) for T2A."""
        if not _has_video(request):
            return None, None
        if not self.video_encoders:
            raise ValueError("V2A request (frames_b64/frames_path) but the server has no "
                             "video encoders; start it with --enable_v2a")
        frames, fps = self._frames_from_request(request)
        return features.encode_video(self.video_encoders, frames, fps, bucket_duration,
                                     self.bundle.pipeline_cfg)

    def _text(self, request: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.text_encoder is None:
            z = self._zero_text()
            return z, z
        feats = clap_mod.encode_text(self.text_encoder, [
            request.get("negative_prompt", "noisy, harsh"), request.get("prompt", "")])
        return feats[1:2], feats[0:1]

    def _plan(self, request: Dict) -> Tuple[float, bool, float, Optional[np.ndarray]]:
        """(duration, long_form, bucket_duration, continuation wav) of a request, after its
        refusals: a duration past the largest bucket runs long-form in windows of the
        largest; long-form V2A encodes at ``plan_v2a_long``'s snapped duration."""
        if request.get("mux_video") or request.get("response") == "avi":
            raise UnsupportedRequest(f"mux_video (an MJPEG AVI of the frames and the audio) "
                                     f"{_NO_PIL}")
        cont_wav = self._continuation_wav(request)
        if cont_wav is not None and _has_video(request):
            raise ValueError("continuation (continue_b64) is text-conditioned only; "
                             "remove frames_b64/frames_path")
        duration = float(request.get("duration", 5.0))
        long_form = duration > self.durations[-1]
        bucket_duration = duration if long_form else self._snap_duration(duration)
        if long_form and _has_video(request):
            bucket_duration, _, _ = plan_v2a_long(self.bundle.pipeline_cfg, duration,
                                                  window_s=self.durations[-1])
        return duration, long_form, bucket_duration, cont_wav

    def _common(self, request: Dict) -> Dict:
        common = dict(guidance_scale=float(request.get("cfg_scale", 4.5)),
                      num_inference_steps=int(request.get("steps", self.default_steps)),
                      sampler=request.get("sampler", "euler"),
                      batch_size=int(request.get("batch_size", 1)),
                      seed=int(request.get("seed", 0)), text_bucket=self.text_buckets[0])
        # what would fail inside a pipeline call is refused before any rank starts it
        solver_init(common["sampler"])
        self._check_rows(common["batch_size"], common["guidance_scale"])
        return common

    def _check_rows(self, batch: int, guidance_scale: float) -> None:
        """On a mesh, the batch's rows (doubled for CFG) must split over ``data``."""
        rows = batch * (2 if guidance_scale > 1.0 else 1)
        if self.mesh_calls is not None and rows % self.mesh_calls.mesh.data:
            raise ValueError(f"{rows} rows (the batch, doubled for CFG) do not split over "
                             f"the mesh's data={self.mesh_calls.mesh.data}")

    # -- inference --------------------------------------------------------------
    def generate(self, request: Dict) -> Dict:
        duration, long_form, bucket_duration, cont_wav = self._plan(request)
        clip_feat, sync_feat = self._visual_features(request, bucket_duration)
        text, uncond = self._text(request)
        common = self._common(request)
        with self._lock:
            if cont_wav is not None:
                result = self._run(
                    continue_audio, cont_wav, text, uncond, duration,
                    context_s=float(request.get("context_s", 4.0)),
                    window_s=default_window_s(self.bundle.pipeline_cfg), **common)
            elif long_form:
                # arbitrary durations reuse a bounded set of window sizes
                result = self._run(
                    generate_audio_long, text, uncond, duration, clip_feat=clip_feat,
                    sync_feat=sync_feat, window_s=self.durations[-1],
                    snap_to_window_grid=True, **common)
            else:
                result = self._run(generate_audio, text, uncond, bucket_duration,
                                   clip_feat=clip_feat, sync_feat=sync_feat, **common)
        n = int(duration * result.sample_rate)
        return {"waveform": np.asarray(result.audio_first)[0, :, :n],  # [C, T]
                "sample_rate": result.sample_rate, "timings": result.timings}

    def generate_stream(self, request: Dict):
        """Streaming ``generate``: yields a header dict, then one dict per finished chunk,
        ``{"pcm": <little-endian int16 mono bytes>, "start_sample": int, "final": bool}``.
        Long-form and continuation requests emit one chunk per window as it is denoised;
        in-bucket requests one chunk. Streams the first batch row and bypasses batching."""
        if request.get("mux_video"):
            raise UnsupportedRequest(f"mux_video {_NO_PIL}")
        duration, long_form, bucket_duration, cont_wav = self._plan(request)
        # the latency ramp applies to windowed runs; checked before the header is sent
        ramp = {}
        if request.get("first_window_s") is not None:
            if not long_form and cont_wav is None:
                raise ValueError(
                    "first_window_s applies to windowed streams only (duration over the "
                    "largest bucket, or continuation); this request is single-shot")
            ramp["first_window_s"] = float(request["first_window_s"])
        common = self._common(request)
        clip_feat, sync_feat = self._visual_features(request, bucket_duration)
        text, uncond = self._text(request)
        pcfg = self.bundle.pipeline_cfg
        sr = pcfg.dac.sample_rate
        if cont_wav is not None:
            # continuation emits on the latent grid: latent_length(duration) frames
            n_total = pcfg.latent_length(duration) * pcfg.dac.hop_length
        else:
            n_total = emitted_samples(duration, sr)
        yield {"header": {"sample_rate": sr, "channels": 1, "total_samples": n_total}}
        with self._lock:
            if cont_wav is not None:
                chunks = self._run(
                    continue_audio_stream, cont_wav, text, uncond, duration,
                    context_s=float(request.get("context_s", 4.0)),
                    window_s=default_window_s(pcfg), **common, **ramp)
            elif long_form:
                chunks = self._run(
                    generate_audio_long_stream, text, uncond, duration, clip_feat=clip_feat,
                    sync_feat=sync_feat, window_s=self.durations[-1],
                    snap_to_window_grid=True, **common, **ramp)
            else:
                result = self._run(generate_audio, text, uncond, bucket_duration,
                                   clip_feat=clip_feat, sync_feat=sync_feat, **common)
                w = np.asarray(result.audio_first)[0, 0, :n_total]
                yield {"pcm": float_to_pcm16(w).tobytes(), "start_sample": 0, "final": True}
                return
            try:
                for ch in chunks:
                    yield {"pcm": ch.pcm16[0].tobytes(), "start_sample": ch.start_sample,
                           "final": ch.final}
            finally:
                # a client that left: closed under the lock (on a mesh, the stream's windows
                # left run on rank 0 before another call may start)
                chunks.close()


class BatchingFoleyService(FoleyService):
    """Continuous batching: concurrent requests with matching buckets (duration, steps,
    sampler, cfg_scale) run as one ``generate_audio_multi`` call, one prompt and seed per
    row. A former thread admits queued requests into groups and runs their host work (CLAP,
    padding) while the previous group is on the card; a dispatcher thread owns the card.
    V2A, continuation and over-bucket requests are served directly."""

    def __init__(self, *args, max_batch: int = 4, batch_window_s: float = 0.05,
                 pipeline_depth: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self._queue: list = []
        self._queue_lock = threading.Lock()
        self._queue_event = threading.Event()
        # bounded, so the former backpressures instead of running ahead of the card
        self._dispatch_q: "queue.Queue" = queue.Queue(maxsize=max(pipeline_depth - 1, 1))
        self.events: List[Tuple[str, int, float]] = []  # (stage, group_id, t)
        self._events_lock = threading.Lock()
        self._group_counter = 0
        threading.Thread(target=self._form_loop, daemon=True).start()
        threading.Thread(target=self._dispatch_loop, daemon=True).start()

    class _Pending:
        def __init__(self, request):
            self.request = request
            self.event = threading.Event()
            self.result = None
            self.error = None

    def generate(self, request: Dict) -> Dict:
        if (_has_video(request) or "continue_b64" in request or request.get("mux_video")
                or float(request.get("duration", 5.0)) > self.durations[-1]):
            return FoleyService.generate(self, request)
        solver_init(request.get("sampler", "euler"))  # refused before any rank starts
        pending = self._Pending(request)
        with self._queue_lock:
            self._queue.append(pending)
        self._queue_event.set()
        pending.event.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _bucket(self, req: Dict):
        return (self._snap_duration(float(req.get("duration", 5.0))),
                int(req.get("steps", self.default_steps)), req.get("sampler", "euler"),
                float(req.get("cfg_scale", 4.5)))

    def _mark(self, stage: str, gid: int) -> None:
        with self._events_lock:
            self.events.append((stage, gid, time.monotonic()))

    def groups_in_flight(self) -> int:
        """Groups prepared or on the card but not yet finished (from the event log)."""
        with self._events_lock:
            started = {g for s, g, _ in self.events if s == "prepare_start"}
            finished = {g for s, g, _ in self.events if s == "done"}
        return len(started - finished)

    def _form_loop(self):
        while True:
            self._queue_event.wait()
            time.sleep(self.batch_window_s)  # let concurrent arrivals coalesce
            with self._queue_lock:
                if not self._queue:
                    self._queue_event.clear()
                    continue
                bucket = self._bucket(self._queue[0].request)
                group = [p for p in self._queue
                         if self._bucket(p.request) == bucket][: self.max_batch]
                for p in group:
                    self._queue.remove(p)
                if not self._queue:
                    self._queue_event.clear()
                self._group_counter += 1
                gid = self._group_counter
            try:
                self._mark("prepare_start", gid)
                prepared = self._prepare_group(group)
                self._mark("prepare_done", gid)
                self._dispatch_q.put((gid, group, bucket, prepared))  # blocks at the bound
            except Exception as e:  # noqa: BLE001
                for p in group:
                    p.error = e
                    p.event.set()

    def _dispatch_loop(self):
        while True:
            gid, group, bucket, prepared = self._dispatch_q.get()
            try:
                self._mark("device_start", gid)
                self._dispatch_group(group, bucket, prepared)
            except Exception as e:  # noqa: BLE001
                for p in group:
                    p.error = e
                    p.event.set()
            finally:
                self._mark("done", gid)

    def _prepare_group(self, group):
        """Host and encoder work of a group: text features padded to one length."""
        texts, unconds, seeds = [], [], []
        for p in group:
            text, uncond = self._text(p.request)
            texts.append(text[0].cpu())
            unconds.append(uncond[0].cpu())
            seeds.append(int(p.request.get("seed", 0)))
        max_l = max(t.shape[0] for t in texts)

        def pad(t):
            return torch.nn.functional.pad(t, (0, 0, 0, max_l - t.shape[0]))

        return (torch.stack([pad(t) for t in texts]), torch.stack([pad(t) for t in unconds]),
                seeds)

    def _dispatch_group(self, group, bucket, prepared):
        duration, steps, sampler, cfg_scale = bucket
        text_b, uncond_b, seeds = prepared
        self._check_rows(len(seeds), cfg_scale)
        with self._lock:
            result = self._run(generate_audio_multi, text_b, uncond_b, duration, seeds,
                               guidance_scale=cfg_scale, num_inference_steps=steps,
                               sampler=sampler, text_bucket=self.text_buckets[0])
        for i, p in enumerate(group):
            n = int(float(p.request.get("duration", duration)) * result.sample_rate)
            p.result = {"waveform": result.audio_batch[i][:, :n],
                        "sample_rate": result.sample_rate, "timings": None}
            p.event.set()


_INDEX_HTML = b"""<!doctype html>
<html><head><meta charset="utf-8"><title>foley</title>
<style>body{font-family:sans-serif;max-width:640px;margin:3em auto;padding:0 1em}
label{display:block;margin:.6em 0 .2em}input,select{width:100%;padding:.4em}
button{margin-top:1em;padding:.6em 1.4em}#status{margin-top:1em;color:#555}</style></head>
<body><h2>foley &mdash; text &rarr; Foley audio</h2>
<label>Prompt</label><input id="prompt" value="rain on a tin roof">
<label>Negative prompt</label><input id="neg" value="noisy, harsh">
<label>Duration (s)</label><input id="dur" type="number" value="5" min="1" max="600">
<label>Steps</label><input id="steps" type="number" value="50" min="10" max="100">
<label>CFG scale</label><input id="cfg" type="number" value="4.5" step="0.5" min="1" max="10">
<label>Seed</label><input id="seed" type="number" value="0">
<button onclick="gen()">Generate</button>
<div id="status"></div><audio id="player" controls style="width:100%;margin-top:1em"></audio>
<script>
async function gen(){
  const s=document.getElementById('status');s.textContent='generating...';
  const body={prompt:prompt_el('prompt'),negative_prompt:prompt_el('neg'),
    duration:+prompt_el('dur'),steps:+prompt_el('steps'),cfg_scale:+prompt_el('cfg'),
    seed:+prompt_el('seed')};
  const r=await fetch('/generate',{method:'POST',body:JSON.stringify(body)});
  if(!r.ok){s.textContent='error: '+await r.text();return;}
  const blob=await r.blob();
  document.getElementById('player').src=URL.createObjectURL(blob);
  s.textContent='done';
}
function prompt_el(id){return document.getElementById(id).value}
</script></body></html>
"""


def create_server(service: FoleyService, host: str = "127.0.0.1",
                  port: int = 8321) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.info("http: " + fmt % args)

        def _send(self, code: int, body: bytes, ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                payload = {"status": "ok", "warm_buckets": service.warm_buckets}
                self._send(200, json.dumps(payload).encode())
            elif self.path == "/metrics":
                self._send(200, json.dumps(service.metrics()).encode())
            elif self.path in ("/", "/index.html"):
                self._send(200, _INDEX_HTML, ctype="text/html; charset=utf-8")
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, b'{"error": "not found"}')
                return
            # the metrics span parse, generate and WAV framing, and complete before the
            # response is sent: a client that has its answer sees it in /metrics
            t0 = service._begin_request()
            ok, streamed, code = False, False, 500
            body, ctype = b"", "application/json"
            try:
                length = int(self.headers.get("Content-Length", 0))
                request = json.loads(self.rfile.read(length) or b"{}")
                if request.get("response") == "pcm16_stream":
                    # the first item (the header) runs every check, so a bad request
                    # still gets a clean JSON error
                    gen = service.generate_stream(request)
                    header = next(gen)["header"]
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("X-Sample-Rate", str(header["sample_rate"]))
                    self.send_header("X-Channels", str(header["channels"]))
                    self.send_header("X-Total-Samples", str(header["total_samples"]))
                    self.send_header("Connection", "close")  # the body ends at the close
                    self.end_headers()
                    streamed = True
                    for chunk in gen:
                        self.wfile.write(chunk["pcm"])
                        self.wfile.flush()
                    ok = True
                    self.close_connection = True
                    return
                out = service.generate(request)
                wav = wav_image(out["waveform"], out["sample_rate"])
                if request.get("response", "wav") == "json":
                    body = json.dumps({"audio_base64": base64.b64encode(wav).decode(),
                                       "sample_rate": out["sample_rate"],
                                       "timings": out["timings"]}).encode()
                else:
                    body, ctype = wav, "audio/wav"
                ok, code = True, 200
            except UnsupportedRequest as e:
                logger.warning(f"generate refused: {e}")
                body, code = json.dumps({"error": str(e)}).encode(), 400
            except Exception as e:  # noqa: BLE001 — surface errors to the client
                logger.warning(f"generate failed: {e}")
                body = json.dumps({"error": str(e)}).encode()
            finally:
                service._end_request(t0, ok)
            if streamed:
                # headers are on the wire: a failure mid-stream shows only as the early
                # close (fewer than X-Total-Samples samples)
                self.close_connection = True
                return
            self._send(code, body, ctype=ctype)

    server = ThreadingHTTPServer((host, port), Handler)
    logger.info(f"serving on http://{host}:{server.server_address[1]}")  # port 0: the OS's
    return server


def build_parser():
    import argparse

    p = argparse.ArgumentParser("foley-serve", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", default=None,
                   help="checkpoint directory (hunyuanvideo_foley, vae_128d_48k, "
                        "synchformer_state_dict, clap/, siglip2/)")
    p.add_argument("--random_init", default=None, choices=["xxl", "xl", "tiny"])
    p.add_argument("--device", default="cuda",
                   help="torch device the models run on (default cuda); with --mesh, cuda "
                        "puts one rank on each visible card, cuda:N or cpu every rank there")
    p.add_argument("--precision", default="bf16", choices=["auto", "bf16", "fp16", "fp32"])
    p.add_argument("--quantization", default="none",
                   choices=["none", "auto", "fp8_e4m3fn", "fp8_e5m2", "int8", "int8_dynamic",
                            "int4"],
                   help="weight storage of the denoiser (the HunyuanModelLoader node's modes)")
    p.add_argument("--lora", default="",
                   help="LoRA adapter directory (models/lora.py) merged into the denoiser at "
                        "load (before any --quantization)")
    p.add_argument("--lora_scale", type=float, default=1.0,
                   help="multiplier on the adapter's own recommended scale")
    p.add_argument("--config", default="xxl", choices=["xxl", "xl", "tiny"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--durations", default="5")
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--max_batch", type=int, default=1,
                   help=">1 enables request coalescing (BatchingFoleyService)")
    p.add_argument("--enable_v2a", action="store_true",
                   help="load the SigLIP2/Synchformer encoders so requests may carry "
                        "frames_b64 / frames_path")
    p.add_argument("--v2a_preprocess", default="device", choices=["device", "pil"])
    p.add_argument("--v2a_warmup_hw", default="",
                   help='source frame geometry "HxW" (e.g. 360x640) for the V2A warm-up')
    p.add_argument("--frames_root", default=None,
                   help="directory allowlist for request frames_path reads; required to "
                        "enable frames_path on a non-loopback --host (loopback binds allow "
                        "any local path)")
    p.add_argument("--mesh", default="",
                   help='multi-card serving over a ("data","model") mesh, e.g. '
                        '"data=2,model=2": the denoiser shards per the Megatron col/row '
                        "rules, the DAC replicates, and every request runs on every rank "
                        "(parallel/). Empty = one device.")
    p.add_argument("--blocks_to_swap", type=int, default=0,
                   help="keep the LAST N of the 54 blocks in page-locked host memory, "
                        "streamed to the card each step; composes with --quantization; "
                        "one device only (not with --mesh)")
    p.add_argument("--prefetch_blocks", type=int, default=0,
                   help="extra swapped-block copies in flight (device window = N+1)")
    return p


def load_models(args, dev: torch.device, encoders: bool = True):
    """(bundle, text encoder, video encoders) of the server's flags on ``dev``; the encoders
    are None unless ``encoders`` (a mesh's rank 0 alone runs them)."""
    from foley_tpu_torch.api.nodes import HunyuanModelLoader, adapt_random_model, resolve_dtype

    text_encoder = video_encoders = None
    if args.random_init:
        from foley_tpu_torch.configs import get_config
        from foley_tpu_torch.models import dac_vae, siglip2, synchformer

        fm = HunyuanModelLoader.init_random(args.random_init, args.precision, 0, device=dev)
        adapt_random_model(fm["params"], args.lora, args.lora_scale, args.quantization)
        cfg = get_config(args.random_init)
        dac = dac_vae.init(cfg.dac, torch.Generator(device=dev).manual_seed(1), device=dev)
        bundle = ModelBundle(fm["params"], dac, cfg, compute_dtype=fm["dtype"])
        if args.enable_v2a and encoders:
            dtype = resolve_dtype(args.precision)
            video_encoders = {
                "siglip2": siglip2.init_random(2, cfg.model.clip_dim, device=dev, dtype=dtype),
                "synchformer": synchformer.init_random(3, cfg.model.sync_feat_dim, device=dev,
                                                       dtype=dtype)}
    else:
        from foley_tpu_torch.pipeline.standalone import load_model

        manager = load_model(args.model_path, config=args.config, precision=args.precision,
                             quantization=args.quantization, lora_path=args.lora,
                             lora_scale=args.lora_scale, device=dev)
        bundle = ModelBundle(manager.foley["params"], manager.dac["params"],
                             manager.pipeline_cfg, compute_dtype=manager.foley["dtype"],
                             latent_stats=manager.foley.get("latent_stats"))
        if encoders:
            text_encoder = manager.clap
            if args.enable_v2a:
                video_encoders = {"siglip2": manager.siglip2,
                                  "synchformer": manager.synchformer}
    for enc in (video_encoders or {}).values():
        enc.preprocess = args.v2a_preprocess
    return bundle, text_encoder, video_encoders


def _service(args, bundle, text_encoder, video_encoders, warmup_hw, mesh=None) -> FoleyService:
    if args.frames_root:
        frames_root = args.frames_root
    elif args.host in ("127.0.0.1", "localhost", "::1"):
        frames_root = "/"  # loopback clients already have local file access
    else:
        frames_root = None  # a public bind: no frames_path unless allowlisted
    service_cls = FoleyService if args.max_batch <= 1 else BatchingFoleyService
    extra = {} if args.max_batch <= 1 else {"max_batch": args.max_batch}
    return service_cls(bundle, text_encoder,
                       durations=tuple(float(x) for x in args.durations.split(",")),
                       video_encoders=video_encoders, v2a_warmup_hw=warmup_hw,
                       frames_root=frames_root, mesh=mesh, **extra)


def _serve(service: FoleyService, args) -> None:
    """Serve HTTP until SIGTERM or SIGINT (or a mesh fault) shuts the server down."""
    server = create_server(service, args.host, args.port)

    def shut_down(*_):  # serve_forever runs on this thread: shut it down from another
        threading.Thread(target=server.shutdown, daemon=True).start()

    restore = {}
    if threading.current_thread() is threading.main_thread():
        restore = {s: signal.signal(s, shut_down) for s in (signal.SIGTERM, signal.SIGINT)}
    if service.mesh_calls is not None:
        service.mesh_calls.on_fault = shut_down
    try:
        server.serve_forever()
    finally:
        for s, handler in restore.items():
            signal.signal(s, handler)


def serve_rank(mesh, args, warmup_hw) -> None:
    """A rank of the served mesh (``parallel/launch.py`` runs it): its bundle placed; rank 0
    serves HTTP, every other rank runs rank 0's pipeline calls until it stops them. SIGTERM
    and SIGINT reach every rank: rank 0 shuts its server down, the others wait for it."""
    from foley_tpu_torch.parallel.inference import follow, shard_bundle

    leader = mesh.rank == 0
    bundle, text_encoder, video_encoders = load_models(args, mesh.device, encoders=leader)
    bundle = shard_bundle(bundle, mesh)
    if not leader:
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, signal.SIG_IGN)
        n = follow(mesh, bundle)
        logger.info(f"rank {mesh.rank}: ran {n} calls of rank 0")
        return
    service = _service(args, bundle, text_encoder, video_encoders, warmup_hw, mesh=mesh)
    service.warmup(steps=args.warmup_steps)
    _serve(service, args)
    if service.mesh_calls.fault is not None:  # the other ranks may be mid-call: fail the launch
        raise service.mesh_calls.fault
    with service._lock:  # after the call in flight, if any
        service.mesh_calls.stop()


def main(argv=None) -> int:
    """``python -m foley_tpu_torch.serving.server --random_init xxl [--enable_v2a]`` on the
    card, or ``--device cpu --random_init tiny`` on the CPU; ``--mesh data=D,model=M`` over
    ``D x M`` ranks."""
    from foley_tpu_torch.core.device import resolve_device
    from foley_tpu_torch.parallel.mesh import parse_mesh_spec

    p = build_parser()
    args = p.parse_args(argv)
    if args.blocks_to_swap and args.mesh:
        p.error("--blocks_to_swap is a single-chip memory mode; drop --mesh")
    if args.prefetch_blocks and not args.blocks_to_swap:
        p.error("--prefetch_blocks only applies with --blocks_to_swap > 0")
    try:
        mesh_spec = parse_mesh_spec(args.mesh)  # before any load
    except ValueError as e:
        p.error(str(e))
    if bool(args.random_init) == bool(args.model_path):
        p.error("pass exactly one of --random_init and --model_path")
    if args.random_init and args.precision == "auto":
        p.error("--precision auto reads a checkpoint's dtype; name one with --random_init")
    warmup_hw = None
    if args.v2a_warmup_hw:
        parts = args.v2a_warmup_hw.lower().split("x")
        if len(parts) != 2 or not all(x.isdigit() and int(x) > 0 for x in parts):
            p.error(f'--v2a_warmup_hw: bad geometry {args.v2a_warmup_hw!r} '
                    '(expected "HxW", positive integers)')
        warmup_hw = (int(parts[0]), int(parts[1]))
    if warmup_hw and args.v2a_preprocess != "device":
        # the PIL resize outputs a fixed size: no work depends on the source geometry
        logger.warning("--v2a_warmup_hw has no effect with --v2a_preprocess pil; ignoring")
        warmup_hw = None

    if mesh_spec:
        return _main_mesh(p, args, mesh_spec, warmup_hw)

    bundle, text_encoder, video_encoders = load_models(args, resolve_device(args.device))
    if args.blocks_to_swap > 0:
        from foley_tpu_torch.parallel.offload import offload_block_suffix

        offload_block_suffix(bundle.mmdit, args.blocks_to_swap)
        bundle = bundle._replace(offload_prefetch=args.prefetch_blocks + 1)
    service = _service(args, bundle, text_encoder, video_encoders, warmup_hw)
    service.warmup(steps=args.warmup_steps)
    _serve(service, args)
    return 0


def _main_mesh(p, args, mesh_spec, warmup_hw) -> int:
    """The served mesh: refused before any load where it cannot run, else its ranks
    launched; returns when rank 0 stops them (a failed rank raises ``RankFailed``)."""
    import os

    from foley_tpu_torch.configs import get_config
    from foley_tpu_torch.parallel.launch import launch
    from foley_tpu_torch.parallel.mesh import make_mesh, rank_devices
    from foley_tpu_torch.parallel.sharding import check_quantization, check_widths

    data, model = mesh_spec.get("data"), mesh_spec.get("model")
    try:
        mesh = make_mesh(data, model, rank_devices(args.device, data, model))
        check_quantization(args.quantization, mesh.model)
        check_widths(get_config(args.random_init or args.config).model, mesh.model)
    except ValueError as e:
        p.error(str(e))
    logger.info(f"mesh {mesh.data}x{mesh.model} over {mesh.backend}: ranks on {mesh.devices}")
    on_cpu = all(d == "cpu" for d in mesh.devices)  # the ranks share the host's cores
    launch(mesh, serve_rank, args, warmup_hw,
           threads=max(1, (os.cpu_count() or 1) // mesh.world) if on_cpu else None)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    raise SystemExit(main())
