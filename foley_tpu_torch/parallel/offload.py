"""Block swap: the last N of the denoiser's blocks kept in page-locked host memory and
streamed to the card during each forward (``foley_tpu/parallel/offload.py`` counterpart).

The design is the reference's own (``hifi_foley.py:545-612``):

- ``offload_block_suffix(model, n)`` parks the last ``n`` of ``[triple (18); single (36)]``,
  the single blocks first, from the back (``n`` is clamped to the number of blocks). Each
  swapped block's weights move into one page-locked host allocation of its own
  (``pipeline/manager.py::park``). A new ``n`` moves only the blocks whose place changes,
  so the card never holds two copies of the model; ``merge_block_suffix`` brings every
  block back.
- ``stream_blocks`` runs a family's blocks in order. Each family has ``window =
  prefetch_blocks + 1`` device slots, each one block's worth of tensors. The copy of a
  swapped block into its slot runs on a side CUDA stream (``non_blocking``), and an event
  orders the block's forward after it; the copy of block ``j + window`` waits on an event
  recorded after block ``j``'s forward, which frees its slot. So the card holds at most
  ``window`` swapped blocks of a family, as the JAX package's gated fetch
  (``models/mmdit.py::_run_stack``) does. The first ``window`` copies start before the
  family's resident blocks run, and overlap them. The forward itself stays on the current
  stream, so a swapped forward runs the same kernels on the same inputs as the resident one
  and gives the same bits.
- On the CPU, host and device are the same: the slots are CPU tensors, the copies are plain
  copies, and there are no streams or events.

The swap state lives on the model (``MMDiT.block_swap``), so a split persists between
requests, and the node API's ``force_offload`` leaves the swapped blocks where they are
(``pipeline/manager.py::park`` / ``restore`` skip them).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional

import torch
from torch import nn
from torch.func import functional_call

from foley_tpu_torch.pipeline.manager import HostBuffers, _signature, _tensors, park, restore

logger = logging.getLogger("foley_tpu_torch")

FAMILIES = ("triple_blocks", "single_blocks")


def block_tensors(block: nn.Module) -> Dict[str, torch.Tensor]:
    """A block's parameters and buffers by name."""
    return dict(_tensors(block))


class _Family:
    """One block family's swapped blocks (index -> host buffers) and its device slots."""

    def __init__(self):
        self.host: Dict[int, HostBuffers] = {}
        self.slots: List[Dict[str, torch.Tensor]] = []
        self.stream = None

    def slots_for(self, blocks: nn.ModuleList, window: int,
                  device: torch.device) -> List[Dict[str, torch.Tensor]]:
        """``window`` slots shaped like the family's swapped blocks (all alike: quantization
        treats every block of a family the same way)."""
        del self.slots[window:]
        while len(self.slots) < window:
            first = blocks[min(self.host)]
            sig = _signature(first)
            if any(_signature(blocks[i]) != sig for i in self.host):
                raise ValueError("the swapped blocks of a family differ in their tensors")
            self.slots.append({n: torch.empty(t.shape, dtype=t.dtype, device=device)
                               for n, t in block_tensors(first).items()})
        return self.slots


class BlockSwap:
    """The swap state a model carries (``MMDiT.block_swap``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.families = {f: _Family() for f in FAMILIES}

    def prefixes(self) -> tuple:
        """The qualified-name prefixes of the swapped blocks' tensors."""
        return tuple(f"{f}.{i}." for f, fam in self.families.items() for i in sorted(fam.host))

    def swapped(self, family: str) -> List[int]:
        return sorted(self.families[family].host)


def swapped_blocks(model: nn.Module, family: str) -> List[int]:
    """The indices of ``family``'s blocks held in host memory."""
    swap = getattr(model, "block_swap", None)
    return [] if swap is None else swap.swapped(family)


@torch.no_grad()
def _retarget(model: nn.Module, swap: BlockSwap, family: str, keep: int) -> None:
    """Hold the first ``keep`` blocks of ``family`` on the device and the rest in host
    memory, moving only the blocks whose place changes."""
    fam = swap.families[family]
    blocks = getattr(model, family)
    changed = False
    for i, block in enumerate(blocks):
        if i >= keep and i not in fam.host:
            host = park(block)
            if swap.device.type == "cuda" and not host.pinned:
                restore(block, swap.device)  # no pageable fallback: the copies would block
                raise RuntimeError(f"{family}.{i}: page-locking its host buffers failed "
                                   "(cudaHostRegister); block swap needs page-locked memory")
            fam.host[i] = host
            changed = True
        elif i < keep and i in fam.host:
            restore(block, swap.device)
            del fam.host[i]
            changed = True
    if changed:
        fam.slots = []


def offload_block_suffix(model: nn.Module, blocks_to_swap: int) -> nn.Module:
    """Park the last ``blocks_to_swap`` of the model's ``[triple; single]`` blocks in host
    memory (the single blocks first, from the back), in place; 0 merges every block back.
    Returns the model."""
    if blocks_to_swap <= 0:
        return merge_block_suffix(model)
    n_triple, n_single = len(model.triple_blocks), len(model.single_blocks)
    n = min(int(blocks_to_swap), n_triple + n_single)
    swap_single = min(n, n_single)
    swap_triple = min(n - swap_single, n_triple)
    if model.block_swap is None:
        model.block_swap = BlockSwap(model.device)
    _retarget(model, model.block_swap, "single_blocks", n_single - swap_single)
    _retarget(model, model.block_swap, "triple_blocks", n_triple - swap_triple)
    logger.info(f"block swap: {swap_triple}/{n_triple} triple + {swap_single}/{n_single} "
                "single blocks in host memory")
    return model


def merge_block_suffix(model: nn.Module) -> nn.Module:
    """Bring every swapped block back to the model's device, in place. Returns the model."""
    swap = model.block_swap
    if swap is not None:
        for family in FAMILIES:
            _retarget(model, swap, family, len(getattr(model, family)))
        model.block_swap = None
    return model


def partition_report(model: nn.Module) -> Dict[str, float]:
    """The blocks' placement in MB (the reference's BlockSwap memory report,
    ``hifi_foley.py:609-612``): {"host_mb", "device_mb", "host_blocks", "device_blocks"}."""
    rep = {"host_mb": 0.0, "device_mb": 0.0, "host_blocks": 0, "device_blocks": 0}
    for family in FAMILIES:
        swapped = set(swapped_blocks(model, family))
        for i, block in enumerate(getattr(model, family)):
            where = "host" if i in swapped else "device"
            rep[f"{where}_mb"] += sum(t.numel() * t.element_size()
                                      for t in block_tensors(block).values()) / 1e6
            rep[f"{where}_blocks"] += 1
    return rep


def log_partition_report(model: nn.Module) -> Dict[str, float]:
    rep = partition_report(model)
    logger.info("--- BlockSwap memory report ---")
    logger.info(f"Blocks in pinned host RAM: {rep['host_blocks']} ({rep['host_mb']:.2f} MB)")
    logger.info(f"Blocks on the device:      {rep['device_blocks']} ({rep['device_mb']:.2f} MB)")
    logger.info("-------------------------------")
    return rep


def _on_slot(block: nn.Module, slot: Dict[str, torch.Tensor]):
    def run(*args, **kwargs):
        return functional_call(block, slot, args, kwargs)
    return run


def stream_blocks(model: nn.Module, family: str, window: int = 1) -> Iterator:
    """Yield a callable per block of ``family``, in order: the block itself when it is
    resident, else the block run on a device slot holding its weights. Ask for the next block
    only after the last one's forward was issued: that is when its slot is handed on."""
    blocks = getattr(model, family)
    swap: Optional[BlockSwap] = model.block_swap
    idx = [] if swap is None else swap.swapped(family)
    if not idx:
        yield from blocks
        return
    fam, device = swap.families[family], swap.device
    first, n = idx[0], len(idx)
    w = max(1, min(int(window), n))
    slots = fam.slots_for(blocks, w, device)
    cuda = device.type == "cuda"
    ready: List[Optional[torch.cuda.Event]] = [None] * n
    if cuda:
        compute = torch.cuda.current_stream(device)
        if fam.stream is None:
            fam.stream = torch.cuda.Stream(device)
        side = fam.stream
        side.wait_stream(compute)  # the last forward's use of the slots comes first

    def fetch(j: int) -> None:
        src = block_tensors(blocks[first + j])
        slot = slots[j % w]
        if cuda:
            with torch.cuda.stream(side):
                for name, t in slot.items():
                    t.copy_(src[name], non_blocking=True)
                ready[j] = torch.cuda.Event()
                ready[j].record(side)
        else:
            for name, t in slot.items():
                t.copy_(src[name])

    for j in range(w):
        fetch(j)
    for i, block in enumerate(blocks):
        if i < first:
            yield block
            continue
        j = i - first
        if cuda:
            compute.wait_event(ready[j])
        yield _on_slot(block, slots[j % w])
        if j + w < n:
            if cuda:
                done = torch.cuda.Event()
                done.record(compute)
                side.wait_event(done)
            fetch(j + w)
