"""Start the ranks of a mesh (no JAX counterpart: one JAX process drives every device).

``launch(mesh, fn, *args)`` starts ``mesh.world`` processes from the *spawn* context (never
fork: the caller may hold a CUDA context, which a forked child cannot use). Rank ``r`` sets
its device, joins the default process group through a ``file://`` store in a fresh temporary
directory (no port to collide with another run), builds its ``RankMesh`` (``Mesh.join``) and
calls ``fn(rank_mesh, *args)``. ``fn`` and ``args`` are pickled into a file of that
directory, which each rank reads once it has started: ``fn`` must be importable by name.
Through the spawn pipe a call's arguments past the pipe's 64 KiB would hold each rank's start
until the rank before it had imported its modules, so the ranks would start one after
another; through the file they start together.

- Rank 0's result comes back through a file of that directory (pickled by the rank, read
  here), so return host objects, not CUDA tensors.
- A rank that raises or dies fails the launch: ``RankFailed`` is raised here with the
  rank's traceback, and the other ranks are terminated, so none is left waiting in a
  collective. Where several ranks failed, the first to fail is reported.
- Called from the main thread, the launcher passes SIGTERM and SIGINT on to every rank as
  SIGTERM and goes on waiting: the launch ends as its ranks end (a served mesh shuts down
  and returns, ``serving/server.py``; another program's ranks die, which fails the launch).
- The ranks log at the launcher's level, each line marked with its rank.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import signal
import tempfile
import threading
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from foley_tpu_torch.parallel.mesh import Mesh

RESULT_FILE = "result.pkl"
CALL_FILE = "call.pkl"  # (fn, args), pickled by the launcher, read by every rank


class RankFailed(RuntimeError):
    """A rank of a launch raised or died."""


def _error_file(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"rank{rank}.err")


def _rank_main(rank: int, mesh: Mesh, tmp: str, threads: Optional[int],
               log_level: Optional[int]) -> None:
    try:
        with open(os.path.join(tmp, CALL_FILE), "rb") as f:
            fn, args = pickle.load(f)
        if log_level is not None:
            logging.basicConfig(level=log_level,
                                format=f"%(asctime)s rank {rank} %(message)s")
        if threads:
            torch.set_num_threads(threads)
        device = torch.device(mesh.devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(mesh.backend, init_method=f"file://{tmp}/store", rank=rank,
                                world_size=mesh.world)
        out = fn(mesh.join(rank), *args)
        if rank == 0:
            with open(os.path.join(tmp, RESULT_FILE), "wb") as f:
                pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        dist.destroy_process_group()
    except BaseException:
        with open(_error_file(tmp, rank), "w") as f:
            f.write(traceback.format_exc())
        raise  # the process ends with a non-zero exit code


def _forward_stops(procs) -> Callable[[], None]:
    """SIGTERM and SIGINT to this process sent on to every live rank as SIGTERM; returns
    the restore of the previous handlers. Off the main thread: nothing."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    old = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    return lambda: [signal.signal(s, h) for s, h in old.items()]


def _failure(mesh: Mesh, tmp: str, procs) -> Optional[RankFailed]:
    """The failure of the first rank that failed, or None while none has."""
    failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
    if not failed:
        return None

    def when(r):
        path = _error_file(tmp, r)
        return os.path.getmtime(path) if os.path.exists(path) else float("inf")

    rank = min(failed, key=when)
    path = _error_file(tmp, rank)
    where = f"rank {rank} of the {mesh.data}x{mesh.model} mesh"
    if not os.path.exists(path):
        return RankFailed(f"{where} died (exit code {procs[rank].exitcode})")
    with open(path) as f:
        return RankFailed(f"{where} failed:\n{f.read()}")


def _stop(procs, grace: float = 10.0) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
        if p.is_alive():
            p.kill()
            p.join()


def launch(mesh: Mesh, fn: Callable, *args, threads: Optional[int] = None,
           timeout: Optional[float] = None):
    """Run ``fn(rank_mesh, *args)`` on every rank of ``mesh``; returns rank 0's result
    (module docstring). ``threads``: ``torch.set_num_threads`` in each rank. ``timeout``:
    seconds the whole launch may take, else ``RankFailed``."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="foley_mesh_")
    root = logging.getLogger()
    log_level = root.getEffectiveLevel() if root.handlers else None
    try:
        with open(os.path.join(tmp, CALL_FILE), "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, mesh, tmp, threads, log_level))
             for r in range(mesh.world)]
    restore = _forward_stops(procs)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while any(p.exitcode is None for p in procs):
            failure = _failure(mesh, tmp, procs)
            if failure is not None:
                raise failure
            if deadline is not None and time.monotonic() > deadline:
                raise RankFailed(f"the {mesh.data}x{mesh.model} mesh did not finish within "
                                 f"{timeout:.0f} s")
            procs[0].join(0.1)
        failure = _failure(mesh, tmp, procs)
        if failure is not None:
            raise failure
        with open(os.path.join(tmp, RESULT_FILE), "rb") as f:
            return pickle.load(f)
    finally:
        restore()
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)
