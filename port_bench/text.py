"""The text features of a request, made by the benchmark and handed alike to the program and
to the reference (CLAP's weights and tokenizer would be a download).

A request's prompt is ``text_scale`` times a standard normal draw ``[1, text_len,
condition_dim]`` seeded with the request's seed; its negative prompt is zeros. So the two
CFG rows of every request differ: a guidance scale, a combine or an unconditional half that
goes wrong changes the answer. ``text_scale`` is the cell's parameter (PERF.md gives the
readings it was chosen from).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

PROMPT = "prompt-"  # the served requests' prompt: ``prompt-<seed>``


def prompt(seed: int, text_len: int, dim: int, scale: float) -> torch.Tensor:
    """A request's prompt features [1, text_len, dim], fp32 on the host."""
    gen = torch.Generator().manual_seed(int(seed) ^ 0x5EED_7E47)
    return scale * torch.randn((1, text_len, dim), generator=gen, dtype=torch.float32)


def features(seed: int, text_len: int, dim: int, scale: float) -> Tuple[torch.Tensor,
                                                                         torch.Tensor]:
    """(prompt, negative prompt) features of a request, each [1, text_len, dim]."""
    return prompt(seed, text_len, dim, scale), torch.zeros(1, text_len, dim)


class SeededTextEncoder:
    """What the service reads text features from (``clap.encode_text`` calls ``encode``):
    ``prompt-<seed>`` gives that seed's prompt features, any other text zeros."""

    def __init__(self, text_len: int, dim: int, scale: float):
        self.text_len, self.dim, self.scale = text_len, dim, scale

    def encode(self, prompts: List[str]) -> torch.Tensor:
        return torch.cat([
            prompt(int(p[len(PROMPT):]), self.text_len, self.dim, self.scale)
            if p.startswith(PROMPT) else torch.zeros(1, self.text_len, self.dim)
            for p in prompts])
