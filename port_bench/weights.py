"""Seeded weights in the checkpoint layout (``reference/layout.py``), made on the device in
a few large draws: one flat buffer a distribution, each tensor a view of it, scaled in
place. The same seed on the same device gives the same tensors, so a run draws them once
for the program and again, after the program is freed, for the reference.

The denoiser's schemes follow the reference's random initialisation with its zero leaves
perturbed (``init_random(perturb=True)``): a linear or convolution weight and its bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the timestep MLP and every zero leaf N(0, 0.02), qk
RMSNorm weights U(0.75, 1.25). The codec's are the configuration's ``weights`` group:
weight-norm directions N(0, 1), magnitudes a gain a part times U(0.9, 1.1), Snake alphas
U(0.5, 1.5), biases N(0, 0.01); the gains keep the decoder's output inside tanh's linear
range, so that the decoded audio does not clip.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from port_bench.reference import layout


def _numel(shape) -> int:
    return math.prod(shape)


def _draw(entries: List, gen: torch.Generator, device, dtype, fill) -> Dict[str, torch.Tensor]:
    """One flat buffer for ``entries``, filled by ``fill(buffer, gen)``, cut into views."""
    total = sum(_numel(shape) for _, shape, _, _ in entries)
    if not total:
        return {}
    flat = torch.empty(total, device=device, dtype=dtype)
    fill(flat, gen)
    out, at = {}, 0
    for key, shape, _, _ in entries:
        n = _numel(shape)
        out[key] = flat[at: at + n].view(shape)
        at += n
    return out


def mmdit(model: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    entries = list(layout.mmdit_entries(model))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    by_role = {}
    for e in entries:
        by_role.setdefault({"bias": "weight", "zero": "time"}.get(e[2], e[2]), []).append(e)
    sd = {}
    uniform = by_role["weight"]
    sd.update(_draw(uniform, gen, device, dtype, lambda t, g: t.uniform_(-1.0, 1.0, generator=g)))
    for key, _, _, fan in uniform:
        sd[key].mul_(1.0 / math.sqrt(fan))
    sd.update(_draw(by_role["time"], gen, device, dtype,
                    lambda t, g: t.normal_(0.0, 0.02, generator=g)))
    sd.update(_draw(by_role["norm"], gen, device, dtype,
                    lambda t, g: t.uniform_(0.75, 1.25, generator=g)))
    return {key: sd[key] for key, _, _, _ in entries}


def dac(codec: dict, gains: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    entries = list(layout.dac_entries(codec))
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    f32 = torch.float32
    groups = {"wn_v": [], "wn_g": [], "alpha": [], "dac_bias": [], "conv": []}
    for e in entries:
        groups[e[2].split(":")[0]].append(e)
    sd = {}
    sd.update(_draw(groups["wn_v"], gen, device, f32, lambda t, g: t.normal_(generator=g)))
    sd.update(_draw(groups["wn_g"], gen, device, f32,
                    lambda t, g: t.uniform_(0.9, 1.1, generator=g)))
    for key, _, role, _ in groups["wn_g"]:
        sd[key].mul_(gains[role.split(":")[1]])
    sd.update(_draw(groups["alpha"], gen, device, f32,
                    lambda t, g: t.uniform_(0.5, 1.5, generator=g)))
    sd.update(_draw(groups["dac_bias"], gen, device, f32,
                    lambda t, g: t.normal_(0.0, 0.01, generator=g)))
    sd.update(_draw(groups["conv"], gen, device, f32, lambda t, g: t.uniform_(-1.0, 1.0, generator=g)))
    for key, _, _, fan in groups["conv"]:
        sd[key].mul_(1.0 / math.sqrt(fan))
    return {key: sd[key] for key, _, _, _ in entries}
