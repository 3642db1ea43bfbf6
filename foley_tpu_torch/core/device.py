"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller names another device. Without a card
and without an explicit device it raises: the port never falls back to the CPU on its own,
so a run that was meant for the card cannot silently measure the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU")
    return torch.device("cuda")
