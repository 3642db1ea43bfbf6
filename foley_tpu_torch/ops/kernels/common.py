"""What the kernels' wrappers share around their C entries: the operand check every TMA
tensor map needs, the current-device context a launch runs in, and how a C entry's return
code is read. Nothing is built or loaded when this module is imported."""

from __future__ import annotations

import contextlib

import torch


def check_operand(name: str, x: torch.Tensor) -> None:
    """The kernels' precondition on an operand they read as a TMA tensor map (K1's and K2's
    [B, L, H, D], K3's x [M, K] and w [B, K, N]): bf16, a unit last stride, other strides
    multiples of 16 bytes, a 16-byte aligned pointer."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16, got {x.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte rows; it needs a unit last stride, "
                         f"strides that are multiples of 8 and a 16-byte aligned pointer, got "
                         f"strides {x.stride()}")


def on_device(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device (the C entries launch on the
    current device): no context at all when it already is, which the 2,700 launches of a
    request save the cost of."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check_launch(kernel: str, err: int) -> None:
    """Raises on a failed launch: -1 is an operand the driver cannot describe as a tensor
    map, -2 a driver without the tensor-map encoder, anything else a cudaError."""
    if err == -1:
        raise ValueError(f"{kernel}: the driver cannot describe an operand's strides as a TMA "
                         f"tensor map")
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{'no cuTensorMapEncodeTiled' if err == -2 else f'cudaError {err}'}")
