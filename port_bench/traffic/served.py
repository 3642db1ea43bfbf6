"""Closed-loop client threads in the process sharing one ``BatchingFoleyService``
(``serving/server.py``): each calls ``generate`` with a T2A request of its own seed and calls
again when the reply comes back. The service coalesces concurrent requests into one
``generate_audio_multi`` call of up to ``max_batch`` rows. A request's wall runs from the
client's call to its return.

Parameters: ``clients``, ``duration_s``, ``steps``, ``guidance``, ``text_len``,
``text_scale``, ``max_batch``, ``batch_window_s``. The service's text encoder is
``text.SeededTextEncoder``: a request's prompt ``prompt-<seed>`` gives the features drawn
from its seed, its empty negative prompt zeros, so each row's two CFG halves differ.

Groups are read from the service's own ``events`` (``prepare_start``, ``prepare_done``,
``device_start``, ``done``, one group id each): a request belongs to the first group
formed after it was submitted.
"""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np

from port_bench import compare, text
from port_bench.harness import Group, Request, Run


def _service(run: Run):
    from foley_tpu_torch.serving.server import BatchingFoleyService

    p = run.params
    encoder = text.SeededTextEncoder(p["text_len"], run.config["model"]["condition_dim"],
                                     p["text_scale"])
    return BatchingFoleyService(run.bundle, text_encoder=encoder, durations=(p["duration_s"],),
                                batch_sizes=(1,), text_buckets=(p["text_len"],),
                                default_steps=p["steps"], max_batch=p["max_batch"],
                                batch_window_s=p["batch_window_s"])


def _clients(run: Run, deadline_s: float, out: List[Request]) -> None:
    """``clients`` threads calling the service until ``deadline_s`` seconds have passed
    since they were released (0: one request each)."""
    p = run.params
    service = run.state["service"]
    lock = threading.Lock()
    gate = threading.Barrier(p["clients"])
    errors = []

    def client():
        gate.wait()
        t0 = time.monotonic()
        while True:
            with lock:
                seed = run.request_seed()
            start = time.monotonic()
            reply = service.generate({"prompt": f"{text.PROMPT}{seed}", "negative_prompt": "",
                                      "duration": p["duration_s"], "steps": p["steps"],
                                      "cfg_scale": p["guidance"], "seed": seed})
            end = time.monotonic()
            pcm = np.round(np.asarray(reply["waveform"][0], np.float64) * 32767.0)
            with lock:
                out.append(Request(start=start, end=end, audio_s=p["duration_s"], seed=seed,
                                   pcm=pcm))
            if end - t0 >= deadline_s:
                return

    def guarded():
        try:
            client()
        except BaseException as e:  # a failed client fails the run, after the others end
            errors.append(e)
            raise

    threads = [threading.Thread(target=guarded) for _ in range(p["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _groups(service, first: int, timeout_s: float = 10.0) -> List[dict]:
    """The stages' times of each group formed since event ``first``, once every group has
    its ``done`` (marked just after its clients were answered)."""
    t_end = time.monotonic() + timeout_s
    while True:
        events = {}
        for stage, gid, t in list(service.events[first:]):
            events.setdefault(gid, {})[stage] = t
        if all("done" in e for e in events.values()) or time.monotonic() > t_end:
            return [events[g] for g in sorted(events)]
        time.sleep(0.001)


def setup(run: Run) -> None:
    run.state["service"] = _service(run)
    _clients(run, 0.0, [])


def window(run: Run, seconds: float) -> None:
    from foley_tpu_torch.ops.kernels import fused_attention

    service = run.state["service"]
    before = fused_attention.fused_qk_attention.launches
    n_events = len(service.events)
    reqs: List[Request] = []
    _clients(run, seconds, reqs)
    run.counters["k1_launches"] = fused_attention.fused_qk_attention.launches - before
    run.requests.extend(sorted(reqs, key=lambda r: r.start))
    groups = _groups(service, n_events)
    for g in groups:
        run.span("served.prepare", g["prepare_start"], g["prepare_done"])
        run.span("served.wait_for_card", g["prepare_done"], g["device_start"])
        run.span("served.device", g["device_start"], g["done"])
    for r in run.requests:
        run.span("request", r.start, r.end)
    for g in groups:
        run.groups.append(Group(rows=0, start=g["device_start"], end=g["done"]))
    formed = [g["prepare_start"] for g in groups]
    for i, r in enumerate(run.requests):
        j = next((k for k, t in enumerate(formed) if t >= r.start), None)
        if j is not None:
            run.groups[j].rows += 1
            run.groups[j].requests.append(i)
    if sum(g.rows for g in run.groups) != len(run.requests):
        raise RuntimeError("the service's events do not account for every request")


def close(run: Run) -> None:
    """The service's threads outlive the window: they let go of the program here."""
    run.state["service"].bundle = None


def judge(run: Run):
    """Every row of groups drawn from the seed, each against its own seed's reference."""
    full = [i for i, g in enumerate(run.groups) if g.rows]
    picked = [r for j in run.sample(len(full), run.cell["check"]["groups"])
              for r in run.groups[full[j]].requests]
    return compare.judge_pcm(run, picked)
