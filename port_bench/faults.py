"""Faults planted under the timed path, each a context manager: what ``correct`` has to
catch. The CPU tests run a cell at TINY with each (``tests/test_port_bench_faults.py``);
``controls.py`` reads the CFG faults on the card at a cell's own size.

- ``step_unchanged``: a solver step that returns its state unchanged;
- ``uncond_dropped``: the unconditional half of the CFG batch left out, the combine taken
  over the conditional half alone (the guidance then does nothing);
- ``guidance_wrong``: the guidance scale half a unit below the one asked for;
- ``half_batch``: the second half of a served group's rows answered with the first half's
  audio;
- ``altered``: the audio the entry hands back altered where it is produced.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch


@contextlib.contextmanager
def step_unchanged():
    from foley_tpu_torch.sampling import denoise

    with mock.patch.object(denoise, "solver_step",
                           lambda solver, state, v, sample, sigmas: sample.float()):
        yield


@contextlib.contextmanager
def uncond_dropped():
    from foley_tpu_torch.models.mmdit import MMDiT

    forward = MMDiT.forward

    def cond_only(self, x, *args, **kwargs):
        v = forward(self, x, *args, **kwargs)
        half = v.shape[0] // 2
        return torch.cat([v[half:], v[half:]])

    with mock.patch.object(MMDiT, "forward", cond_only):
        yield


@contextlib.contextmanager
def guidance_wrong():
    from foley_tpu_torch.sampling import denoise

    denoise_latents = denoise.denoise_latents

    def lower(model, latents, features, guidance_scale, *args, **kwargs):
        return denoise_latents(model, latents, features, guidance_scale - 0.5, *args, **kwargs)

    with mock.patch.object(denoise, "denoise_latents", lower):
        yield


@contextlib.contextmanager
def half_batch():
    from foley_tpu_torch.pipeline import generate
    from foley_tpu_torch.serving import server

    multi = generate.generate_audio_multi

    def dropped(*args, **kwargs):
        res = multi(*args, **kwargs)
        half = res.audio_batch.shape[0] // 2
        res.audio_batch[half:] = res.audio_batch[:half]
        return res

    with mock.patch.object(server, "generate_audio_multi", dropped):
        yield


@contextlib.contextmanager
def altered():
    from foley_tpu_torch.pipeline import generate

    to_host = generate._to_host

    def changed(*args, **kwargs):
        audio = to_host(*args, **kwargs)
        audio[..., :4800] += np.float32(0.05)
        return audio

    with mock.patch.object(generate, "_to_host", changed):
        yield


FAULTS = {f.__name__: f for f in (step_unchanged, uncond_dropped, guidance_wrong, half_batch,
                                  altered)}
CFG = ("uncond_dropped", "guidance_wrong")  # the faults read on the card
