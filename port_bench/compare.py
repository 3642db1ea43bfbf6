"""The comparison that decides ``correct``: the reference (``reference/``) run once the
window has closed and the program is freed, on the same seeded weights (drawn again) and
the same inputs (the seeded noise and text features of each request), in fp32 with TF32
off; and the numbers compared with each cell's limits.

- ``latent_rel_err``: a request's final latents (the denoiser through K1, the CFG combine and
  the Euler schedule) against the reference's, relative L2, the worst request judged;
- ``decode_rel_err``: the request's PCM against the reference's decode of the program's own
  final latents, relative L2: the DAC decode and the PCM16 step alone;
- ``pcm_rel_err``: the request's PCM against the reference's whole chain (noise, schedule,
  denoiser, decode), relative L2, for entries that return no latents (the served one).

With random weights a decode that saturates would pass a PCM comparison whatever came
before it. The codec's gains (the configuration's ``weights``) keep the decode inside tanh's
linear range; each run logs the judged audio's share of full-scale samples beside its rms,
so that a reader sees the comparison did not go blind.
"""

from __future__ import annotations

import contextlib
import sys
from typing import List

import numpy as np
import torch

from port_bench import text, weights
from port_bench.harness import Check, Run
from port_bench.reference import dac as ref_dac
from port_bench.reference import sampling


@contextlib.contextmanager
def fp32_exact(tf32: bool = False):
    """fp32 products without TF32 (``tf32=True``: with it, the controls' lower precision)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def text_features(run: Run, seed: int):
    """(prompt, negative prompt) features [1, text_len, condition_dim] of the request of
    this seed (``text.py``)."""
    return text.features(seed, run.params["text_len"], run.config["model"]["condition_dim"],
                         run.params["text_scale"])


def codec_weights(run: Run):
    """The codec's fp32 weights, the very tensors the program was given."""
    return weights.dac(run.config["dac"], run.config["weights"]["dac_gains"], run.seed,
                       run.device)


def reference_latents(run: Run, seeds: List[int]) -> torch.Tensor:
    """The reference's final latents [N, T, C] of the cell's T2A requests of these seeds, on
    the host; worked out once a run (the denoiser's weights drawn again, in fp32)."""
    key = tuple(seeds)
    if key not in run.reference:
        sd = weights.mmdit(run.config["model"], run.seed, run.device, run.model_dtype)
        W = {k: v.float() for k, v in sd.items()}
        del sd
        p = run.params
        feats = [text_features(run, s) for s in seeds]
        with fp32_exact():
            run.reference[key] = sampling.t2a_latents(
                W, run.config, seeds, p["duration_s"], p["steps"], p["guidance"],
                torch.cat([f[0] for f in feats]).to(run.device),
                torch.cat([f[1] for f in feats]).to(run.device), run.device).cpu()
    return run.reference[key]


def decode_pcm(run: Run, D, latents: torch.Tensor, tf32: bool = False) -> np.ndarray:
    """PCM16 values [N, samples] of the reference's decode, one latent sequence at a time."""
    n = int(run.params["duration_s"] * run.config["dac"]["sample_rate"])
    out = []
    with fp32_exact(tf32), torch.no_grad():
        for z in latents:
            pcm = ref_dac.to_pcm16(ref_dac.decode(D, run.config["dac"], z[None].float()))
            out.append(pcm[0, :n].double().cpu().numpy())
    return np.stack(out)


def rel(got: np.ndarray, ref: np.ndarray) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def log_audio(reqs) -> None:
    """The judged audio's level: its rms and its share of full-scale samples."""
    pcm = np.concatenate([r.pcm for r in reqs])
    print(f"judged audio: rms {float(np.sqrt(np.mean(pcm ** 2))) / 32767:.4f} of full scale, "
          f"{float(np.mean(np.abs(pcm) >= 32767)):.6f} of its samples at full scale",
          file=sys.stderr, flush=True)


def limits(run: Run, name: str) -> float:
    return float(run.cell["check"]["limits"][name])


def judge_with_latents(run: Run, picked: List[int]) -> List[Check]:
    """The checks of requests whose entry returned its final latents."""
    reqs = [run.requests[i] for i in picked]
    ref = reference_latents(run, [r.seed for r in reqs]).numpy()
    got = torch.from_numpy(np.stack([r.latents for r in reqs])).to(run.device)
    ref_pcm = decode_pcm(run, codec_weights(run), got)
    log_audio(reqs)
    lat = max(rel(r.latents, ref[i]) for i, r in enumerate(reqs))
    dec = max(rel(r.pcm, ref_pcm[i]) for i, r in enumerate(reqs))
    return [Check("latent_rel_err", lat, limits(run, "latent_rel_err")),
            Check("decode_rel_err", dec, limits(run, "decode_rel_err"))]


def judge_pcm(run: Run, picked: List[int]) -> List[Check]:
    """The checks of requests whose entry returned audio alone."""
    reqs = [run.requests[i] for i in picked]
    ref = reference_latents(run, [r.seed for r in reqs]).to(run.device)
    ref_pcm = decode_pcm(run, codec_weights(run), ref)
    log_audio(reqs)
    pcm = max(rel(r.pcm, ref_pcm[i]) for i, r in enumerate(reqs))
    return [Check("pcm_rel_err", pcm, limits(run, "pcm_rel_err"))]
