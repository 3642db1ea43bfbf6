"""Generation over a ("data", "model") mesh (``foley_tpu/parallel/inference.py``
counterpart).

The JAX package reuses ``generate_audio`` unchanged: the shardings travel with the arrays,
and XLA partitions the one program. Here every rank runs the unchanged pipeline on its own
bundle, and the mesh lives in two places only:

- the denoiser's layers (``parallel/sharding.py::shard_params``: tensor parallelism on
  ``model``);
- ``DataParallelDenoiser`` (where ``data > 1``), the object the denoise loop calls in the
  denoiser's place (``cfg``, ``precompute_text_kv``, ``attention_tables``,
  ``precompute_triple_mods`` and the call): it takes the whole CFG batch, runs this rank's
  rows on ``data`` and all-gathers the velocities, so the loop, the CFG combine and the
  solver see the whole batch on every rank. No rank of it holds a CFG pair's two halves, so
  ``visual_rows_shared`` stays off; at ``data == 1`` the loop calls the placed denoiser
  itself.

The DAC is replicated: every rank decodes the whole batch.

- ``place_denoiser(model, mesh)`` / ``shard_bundle(bundle, mesh)``: a rank's denoiser, or
  its bundle with the denoiser placed.
- ``sharded_generate(bundle, mesh, ...)``: ``generate_audio`` on every rank with rank 0's
  arguments (its text and visual features: the encoders run on rank 0 alone).
- The served mesh (``serving/server.py``): rank 0 serves HTTP and runs each request's
  pipeline call through ``MeshCalls.call``, which hands the function and its arguments to
  every other rank (``follow``) and runs it. A stream is run to its end on every rank, and
  holds the calls' lock until it has, on rank 0 too: the next call starts after its last
  window, whether its client read it or left.
  A call that fails once the ranks have started it may leave them out of step: on rank 0
  it raises ``MeshFault`` (the server then stops), on another rank it ends the rank (and
  the launch fails).
"""

from __future__ import annotations

import inspect
import logging
import threading
from typing import Callable, Optional

import torch

from foley_tpu_torch.parallel.mesh import DATA_AXIS, RankMesh
from foley_tpu_torch.parallel.sharding import shard_params
from foley_tpu_torch.pipeline.generate import GenerationResult, ModelBundle, generate_audio

logger = logging.getLogger("foley_tpu_torch")


class DataParallelDenoiser:
    """The denoiser over the mesh's ``data`` axis, ``data > 1`` (module docstring); every
    other attribute is the placed denoiser's."""

    def __init__(self, model, mesh: RankMesh):
        self.model, self.mesh = model, mesh

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        lo, hi = self.mesh.data_rows(t.shape[0])
        return t[lo:hi]

    def precompute_text_kv(self, cond: torch.Tensor):
        """This rank's rows of every block's text K/V."""
        return self.model.precompute_text_kv(self._rows(cond))

    def __call__(self, x, t, cond, clip_feat, sync_feat, *, visual_rows_shared: bool = False,
                 **kw) -> torch.Tensor:
        """The velocity of the whole batch: this rank's rows, all-gathered over ``data``
        (``text_kv`` in ``kw`` holds this rank's rows already; ``visual_rows_shared`` does
        not hold for them)."""
        v = self.model(*(self._rows(a) for a in (x, t, cond, clip_feat, sync_feat)), **kw)
        return self.mesh.all_gather(v, DATA_AXIS)


def place_denoiser(model, mesh: RankMesh):
    """The denoiser ``mesh``'s rank runs: ``model`` placed by the rules (in place), behind
    a ``DataParallelDenoiser`` where ``data > 1``."""
    model = shard_params(model, mesh)
    return DataParallelDenoiser(model, mesh) if mesh.data > 1 else model


def shard_bundle(bundle: ModelBundle, mesh: RankMesh) -> ModelBundle:
    """A rank's bundle: its denoiser placed (``place_denoiser``); the DAC replicated (the
    rank's own copy)."""
    model = place_denoiser(bundle.mmdit, mesh)
    logger.info(f"bundle placed on the {mesh.data}x{mesh.model} mesh as rank {mesh.rank} "
                f"({mesh.mesh.backend}, {mesh.device})")
    return bundle._replace(mmdit=model)


def to_host(obj):
    """Tensors (in tuples, lists and dicts) moved to the host, to be pickled."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def sharded_generate(bundle: ModelBundle, mesh: RankMesh, *args, **kwargs) -> GenerationResult:
    """``generate_audio`` on every rank of ``mesh`` with rank 0's arguments (every rank
    calls it). The CFG pair (2B rows) must be divisible by the data-axis size. The other
    arguments are ``pipeline.generate.generate_audio``'s."""
    args, kwargs = mesh.broadcast_object(to_host((args, kwargs)))
    return generate_audio(bundle, *args, **kwargs)


class MeshFault(RuntimeError):
    """A call failed on rank 0 after every rank had started it: the ranks may be out of
    step, and the served mesh takes no other request."""


class MeshCalls:
    """Rank 0's side of a served mesh: ``call`` runs a pipeline function on every rank,
    ``stop`` ends the other ranks' ``follow``. Calls are serialized by a lock of their own
    (the server's device lock holds them too)."""

    def __init__(self, mesh: RankMesh, bundle: ModelBundle):
        self.mesh, self.bundle = mesh, bundle
        self._lock = threading.Lock()
        self.fault: Optional[MeshFault] = None
        self.on_fault: Optional[Callable[[], None]] = None  # the server's shutdown
        self.stopped = False

    def call(self, fn: Callable, *args, **kwargs):
        """``fn(bundle, *args, **kwargs)`` on every rank. A generator function's call
        returns a generator (``_stream``) that starts the call on its first item."""
        if inspect.isgeneratorfunction(fn):
            return self._stream(fn, args, kwargs)
        with self._lock:
            self._start(fn, args, kwargs)
            try:
                return fn(self.bundle, *args, **kwargs)
            except Exception as e:
                raise self._faulted(fn, e) from e

    def _start(self, fn, args, kwargs) -> None:
        """Hand the call to every other rank (under ``_lock``)."""
        if self.fault is not None or self.stopped:
            raise MeshFault(f"the served mesh is {'down' if self.stopped else 'faulted'}: "
                            f"{self.fault}")
        self.mesh.broadcast_object((fn, to_host(args), to_host(kwargs)))

    def _faulted(self, fn, e: Exception) -> MeshFault:
        self.fault = MeshFault(f"{getattr(fn, '__name__', fn)} failed on rank 0 of the served "
                               f"mesh: {e}")
        if self.on_fault is not None:
            self.on_fault()
        return self.fault

    def _stream(self, fn, args, kwargs):
        """The chunks of a streamed call, ``_lock`` held from its start until its last
        window has run here: a consumer that leaves early closes this generator, which then
        runs the windows left (the other ranks run every window), so no other call's
        collectives interleave with them."""
        with self._lock:
            self._start(fn, args, kwargs)
            consumer = True
            try:
                for chunk in fn(self.bundle, *args, **kwargs):
                    if consumer:
                        try:
                            yield chunk
                        except GeneratorExit:
                            consumer = False
            except Exception as e:
                raise self._faulted(fn, e) from e

    def stop(self) -> None:
        """End every other rank's ``follow`` (once; no call runs after it)."""
        with self._lock:
            if not self.stopped:
                self.stopped = True
                self.mesh.broadcast_object(None)


def follow(mesh: RankMesh, bundle: ModelBundle) -> int:
    """A rank other than 0: run each call rank 0 makes until ``MeshCalls.stop``; returns the
    number of calls. A call that raises here raises out of the rank (its launch fails and
    the other ranks are stopped): rank 0 may wait in a collective this rank will not join."""
    n = 0
    while True:
        msg = mesh.broadcast_object()
        if msg is None:
            return n
        fn, args, kwargs = msg
        out = fn(bundle, *args, **kwargs)
        if inspect.isgenerator(out):
            for _ in out:
                pass
        n += 1
