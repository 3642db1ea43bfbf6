"""The ("data", "model") mesh over ``torch.distributed`` ranks (``foley_tpu/parallel/mesh.py``
counterpart).

One JAX process drives every device of its mesh, and XLA partitions each program over it.
Here each rank is a process of its own (``parallel/launch.py`` starts them), and the mesh is
what a rank knows of its place: the CFG-doubled batch splits on ``data`` (data parallelism)
and the heads and MLP widths on ``model`` (Megatron tensor parallelism,
``parallel/sharding.py``).

- ``make_mesh(data, model, devices)`` keeps the JAX defaults: every device on ``data`` when
  neither size is given; one size given, the other is ``n // size``. JAX's asserts are
  ``ValueError``s with the same conditions. ``devices`` holds one device a rank;
  ``rank_devices`` makes it from a ``--device``: ``cuda`` puts one rank on each visible card
  (and refuses a mesh larger than the cards), ``cuda:N`` or ``cpu`` puts every rank on that
  one device.
- Rank ``r = d * model + m`` sits at ``(d, m)``, JAX's ``reshape(data, model)``. The
  ``model`` axis groups the ranks of one row, the ``data`` axis those of one column.
- The backend follows the placement: NCCL where each rank has a card of its own, gloo where
  ranks share a device (NCCL refuses two ranks on one card) or run on the CPU. It is chosen
  here, before any rank starts, never after a failed start.

``make_mesh`` returns a description (picklable, no process group). ``Mesh.join(rank)`` runs
in each rank once its default process group is up and returns the rank's ``RankMesh``: its
device, a group per axis and a gloo ``control`` group over every rank, which carries the
objects rank 0 hands the others (a served request's arguments, ``parallel/inference.py``).
Every collective of the port goes through a ``RankMesh`` method, which counts its calls and
bytes (``RankMesh.counts``).

The parallel layers' collectives are ``torch.autograd.Function``s, so a train step
(``parallel/training.py``) differentiates through them (Megatron's f and g):

- ``sum_over``: the row-parallel output, summed over the axis out of place; its gradient
  passes through unchanged (every rank already holds the whole gradient of the sum, so
  ``torch.distributed.nn``'s all-reduce backward would multiply it by the axis size);
- ``copy_to``: the column-parallel input, the identity; its gradient (this rank's share,
  through its own output features) summed over the axis;
- ``gather_parts``: the all-gather of the adaLN vectors; its gradient is this rank's slice
  of the whole one, part by part (``sharding.take_slice``'s layout), with no collective.

Without autograd they issue what the plain calls issue: ``sum_over`` one all-reduce, the
others nothing more. A collective is counted under its op, and, while ``phase`` is not
``"forward"``, under ``"<phase>.<op>"``: the train step sets ``"backward"`` when its backward
starts, so the checkpointed blocks' recomputed sums and gathers and the column inputs'
gradient sums (``all_reduce_dx``) are counted apart from the forward's.
"""

from __future__ import annotations

import dataclasses
import datetime
import pickle
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: Every rank of the mesh, as an axis name of the collectives (the default process group).
ALL_AXES = "all"

#: The control group's timeout: a rank other than 0 of a served mesh waits in it for the
#: next request, however long the server stays idle.
CONTROL_TIMEOUT = datetime.timedelta(days=365)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data x model`` mesh of ranks: rank ``r`` on ``devices[r]``, over ``backend``."""

    data: int
    model: int
    devices: Tuple[str, ...]
    backend: str

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def join(self, rank: int) -> "RankMesh":
        """Rank ``rank``'s mesh; the default process group must be up with ``world`` ranks.
        Every rank makes every group, in the same order (``dist.new_group``'s rule)."""
        if dist.get_world_size() != self.world or dist.get_rank() != rank:
            raise ValueError(f"rank {dist.get_rank()} of {dist.get_world_size()} joins a "
                             f"{self.data}x{self.model} mesh as rank {rank}")
        d, m = divmod(rank, self.model)
        axes = {}
        for col in range(self.model):
            group = dist.new_group([row * self.model + col for row in range(self.data)])
            if col == m:
                axes[DATA_AXIS] = Axis(DATA_AXIS, group, self.data, d)
        for row in range(self.data):
            group = dist.new_group([row * self.model + col for col in range(self.model)])
            if row == d:
                axes[MODEL_AXIS] = Axis(MODEL_AXIS, group, self.model, m)
        control = dist.new_group(list(range(self.world)), backend="gloo",
                                 timeout=CONTROL_TIMEOUT)
        return RankMesh(self, rank, axes, control)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a rank's mesh: its process group, its size and the rank's place on it."""

    name: str
    group: object
    size: int
    rank: int


class RankMesh:
    """A rank's view of its mesh: ``rank``, ``device``, ``data_rank``, ``model_rank``, the
    axes and the counted collectives."""

    def __init__(self, mesh: Mesh, rank: int, axes: Dict[str, Axis], control):
        self.mesh, self.rank, self.axes, self.control = mesh, rank, axes, control
        self.device = torch.device(mesh.devices[rank])
        self._lock = threading.Lock()
        self._counts: Dict[str, List[int]] = {}
        self.phase = "forward"  # the counts' prefix (module docstring)

    def __repr__(self) -> str:
        return f"RankMesh({self.mesh.data}x{self.mesh.model}, rank {self.rank}, {self.device})"

    @property
    def data(self) -> int:
        return self.mesh.data

    @property
    def model(self) -> int:
        return self.mesh.model

    @property
    def world(self) -> int:
        return self.mesh.world

    @property
    def data_rank(self) -> int:
        return self.axes[DATA_AXIS].rank

    @property
    def model_rank(self) -> int:
        return self.axes[MODEL_AXIS].rank

    # -- counts -----------------------------------------------------------------------
    def _count(self, op: str, nbytes: int) -> None:
        key = op if self.phase == "forward" else f"{self.phase}.{op}"
        with self._lock:
            c = self._counts.setdefault(key, [0, 0])
            c[0] += 1
            c[1] += nbytes

    def counts(self) -> Dict[str, Dict[str, int]]:
        """``{op: {"calls", "bytes"}}`` since the last ``reset_counts``; the bytes of each
        call's result (an all-gather's whole, an all-reduce's sum, a broadcast's payload)."""
        with self._lock:
            return {op: {"calls": c, "bytes": b} for op, (c, b) in sorted(self._counts.items())}

    def reset_counts(self) -> None:
        with self._lock:
            self._counts.clear()

    # -- collectives ------------------------------------------------------------------
    def size(self, axis: str) -> int:
        """The ranks on ``axis`` (``ALL_AXES``: every rank)."""
        return self.world if axis == ALL_AXES else self.axes[axis].size

    def _group(self, axis: str):
        return None if axis == ALL_AXES else self.axes[axis].group

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "all_reduce") -> torch.Tensor:
        """The sum of ``t`` over ``axis``, in ``t``'s own dtype (as XLA's all-reduce sums);
        ``t`` is summed in place when it is contiguous, so it may not be a tensor autograd
        tracks (``sum_over`` is the differentiable sum). ``op``: the count's name."""
        if t.requires_grad:
            raise ValueError("all_reduce sums in place: use sum_over on a tensor that "
                             "requires a gradient")
        t = t.contiguous()
        dist.all_reduce(t, group=self._group(axis))
        self._count(op, t.numel() * t.element_size())
        return t

    def sum_over(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, out of place; its gradient passes unchanged."""
        return _SumOver.apply(t, self, axis)

    def copy_to(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` itself; its gradient summed over ``axis`` (op ``all_reduce_dx``)."""
        return _CopyTo.apply(t, self, axis)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated along ``dim`` in rank order."""
        a = self.axes[axis]
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(a.size)]
        dist.all_gather(parts, t, group=a.group)
        out = torch.cat(parts, dim=dim)
        self._count("all_gather", out.numel() * out.element_size())
        return out

    def gather_parts(self, t: torch.Tensor, axis: str, parts: int) -> torch.Tensor:
        """The whole of a last axis made of ``parts`` equal parts, each split over ``axis``
        (``sharding.take_slice``'s inverse): every rank's pieces, part by part. Its gradient
        is this rank's slice of the whole gradient."""
        return _GatherParts.apply(t, self, axis, parts)

    def _gather_parts(self, t: torch.Tensor, axis: str, parts: int) -> torch.Tensor:
        pieces = self.all_gather(t.unsqueeze(-2), axis, dim=-2)  # [..., size, parts * c]
        # [..., size, parts, c] -> [..., parts, size, c] -> [..., parts * size * c]
        return pieces.unflatten(-1, (parts, -1)).transpose(-3, -2).flatten(-3)

    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` on every rank, pickled over the control group (the host)."""
        if self.rank == 0:
            data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
            size = torch.tensor([data.numel()], dtype=torch.int64)
        else:
            size = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(size, 0, group=self.control)
        if self.rank != 0:
            data = torch.empty(int(size), dtype=torch.uint8)
        dist.broadcast(data, 0, group=self.control)
        self._count("broadcast", data.numel())
        return obj if self.rank == 0 else pickle.loads(data.numpy().tobytes())

    def barrier(self) -> None:
        """Every rank waits here for every other (the control group)."""
        dist.barrier(group=self.control)
        self._count("barrier", 0)

    def gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank (the control group)."""
        out = [None] * self.mesh.world
        dist.all_gather_object(out, obj, group=self.control)
        self._count("gather_object", len(pickle.dumps(obj)) * self.mesh.world)
        return out

    # -- data parallelism -------------------------------------------------------------
    def data_rows(self, rows: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a batch of ``rows`` split on ``data``; a batch the
        axis does not divide raises (the CFG pair, 2B rows, must divide by ``data``)."""
        if rows % self.data:
            raise ValueError(f"a batch of {rows} rows does not split over data={self.data}: "
                             "the CFG pair (2B rows) must be divisible by the data axis")
        n = rows // self.data
        return self.data_rank * n, (self.data_rank + 1) * n


class _SumOver(torch.autograd.Function):
    """The row-parallel output (``RankMesh.sum_over``)."""

    @staticmethod
    def forward(ctx, t, mesh: RankMesh, axis: str):
        return mesh.all_reduce(t.detach().clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    """The column-parallel input (``RankMesh.copy_to``)."""

    @staticmethod
    def forward(ctx, t, mesh: RankMesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(grad, ctx.axis, op="all_reduce_dx"), None, None


class _GatherParts(torch.autograd.Function):
    """The gathered adaLN vectors (``RankMesh.gather_parts``)."""

    @staticmethod
    def forward(ctx, t, mesh: RankMesh, axis: str, parts: int):
        ctx.size, ctx.rank, ctx.parts = mesh.axes[axis].size, mesh.axes[axis].rank, parts
        return mesh._gather_parts(t, axis, parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.unflatten(-1, (ctx.parts, ctx.size, -1)).select(-2, ctx.rank).flatten(-2)
        return grad.contiguous(), None, None, None


def rank_devices(device, data: Optional[int] = None,
                 model: Optional[int] = None) -> Tuple[str, ...]:
    """The ranks' devices for a ``--device``: ``cuda`` gives every visible card, one rank
    each, and refuses a ``data x model`` larger than the cards; ``cuda:N`` or ``cpu`` gives
    that device once for each of the ``data x model`` ranks (a size not given is 1)."""
    dev = torch.device(device)
    wanted = (data or 1) * (model or 1)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if wanted > n:
            raise ValueError(f"a mesh of {wanted} ranks on --device cuda needs {wanted} cards, "
                             f"{n} visible; name one device (cuda:0, cpu) to put every rank "
                             "on it")
        return tuple(f"cuda:{i}" for i in range(n))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"--device {dev}: no CUDA device is visible")
    return (str(dev),) * wanted


def make_mesh(data: Optional[int] = None, model: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh (the JAX ``make_mesh``'s defaults and checks) of one rank a
    device of ``devices`` (default: every visible card); the backend as the module says."""
    devices = tuple(str(torch.device(d)) for d in (
        devices if devices is not None else rank_devices("cuda", data, model)))
    n = len(devices)
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        if n % model:
            raise ValueError(f"{n} devices do not split into model={model}")
        data = n // model
    elif model is None:
        if n % data:
            raise ValueError(f"{n} devices do not split into data={data}")
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) != 1 or kinds - {"cuda", "cpu"}:
        raise ValueError(f"the ranks' devices must all be CUDA cards or all the CPU: {devices}")
    own_cards = kinds == {"cuda"} and len(set(devices)) == n
    return Mesh(data, model, devices, "nccl" if own_cards else "gloo")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"data=4,model=2"`` -> ``{"data": 4, "model": 2}`` (the server's ``--mesh``); a bad
    entry raises ``ValueError`` with the JAX server's message."""
    out: Dict[str, int] = {}
    for kv in filter(None, spec.split(",")):
        key, _, val = kv.partition("=")
        key = key.strip()
        if key not in (DATA_AXIS, MODEL_AXIS) or not val.strip().isdigit() or int(val) < 1 \
                or key in out:
            raise ValueError(f"--mesh: bad entry {kv!r} (expected e.g. \"data=4,model=2\", "
                             "positive sizes, no duplicate axes)")
        out[key] = int(val)
    return out
