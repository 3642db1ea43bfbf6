"""Closed-loop text-to-audio clients, one request at a time each, through
``pipeline/generate.py::generate_audio`` (the sampler node's main path): every request of
the cell's duration, steps and guidance, batch 1, a new seed each, its final latents and
PCM kept for the comparison. Each request's prompt features are drawn from its seed and its
negative prompt is zeros (``text.py``), so its two CFG rows differ.

Parameters (the cell's ``params``): ``duration_s``, ``steps``, ``guidance``, ``text_len``,
``text_scale``.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench import compare
from port_bench.harness import Group, Request, Run


def request(run: Run, seed: int) -> Request:
    from foley_tpu_torch.pipeline.generate import generate_audio

    p = run.params
    text, uncond = compare.text_features(run, seed)
    start = time.monotonic()
    res = generate_audio(run.bundle, text, uncond, p["duration_s"], guidance_scale=p["guidance"],
                         num_inference_steps=p["steps"], sampler="euler", batch_size=1,
                         seed=seed, return_latents=True)
    end = time.monotonic()
    pcm = np.round(res.audio_batch[0, 0].astype(np.float64) * 32767.0)
    return Request(start=start, end=end, audio_s=p["duration_s"], seed=seed, pcm=pcm,
                   latents=res.latents[0], timings=res.timings)


def setup(run: Run) -> None:
    request(run, run.request_seed())


def window(run: Run, seconds: float) -> None:
    from foley_tpu_torch.ops.kernels import fused_attention

    t0 = time.monotonic()
    before = fused_attention.fused_qk_attention.launches
    while time.monotonic() - t0 < seconds:
        r = request(run, run.request_seed())
        run.requests.append(r)
        run.groups.append(Group(rows=1, start=r.start, end=r.end, requests=[len(run.requests) - 1]))
        prep = r.start + r.timings["prepare_s"]
        run.span("prepare", r.start, prep)
        run.span("denoise_decode", prep, prep + r.timings["denoise_decode_s"])
        run.span("request", r.start, r.end)
    run.counters["k1_launches"] = fused_attention.fused_qk_attention.launches - before


def judge(run: Run):
    return compare.judge_with_latents(
        run, run.sample(len(run.requests), run.cell["check"]["requests"]))
