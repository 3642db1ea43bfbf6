"""Build and load the port's CUDA kernels and host libraries: ``nvcc`` compiles a ``.cu``
source under ``foley_tpu_torch/csrc`` (``library``), the host C++ compiler a ``.cpp`` source
(``host_library``: the JPEG entropy coder), each into a shared library with a plain C
interface, loaded through ``ctypes``.

A library is built at first use into ``build/torch_kernels/<hash>/`` at the repository root,
where the hash covers its source, the shared headers and the compiler flags, so a stale
library is never loaded. It is written under a temporary name and renamed, so a process
that loads it concurrently never reads a half-written file. A missing compiler or a failed
build raises. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
#: Per kernel compiled by this process: the seconds ``nvcc`` took and what ptxas reported
#: (registers, shared memory, spills).
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _cxx() -> str:
    found = shutil.which("c++")
    if found:
        return found
    raise RuntimeError("c++ not found: the host libraries under foley_tpu_torch/csrc are "
                       "built at first use with the system's C++ compiler")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def host_library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    src = CSRC / f"{name}.cpp"
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _load(name: str, out: Path, command) -> ctypes.CDLL:
    """The library at ``out``, built first by ``command()`` (the compiler's argv without
    ``-o``; called only when a build is needed) if it is not there."""
    if name not in _libs:
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            cmd = command()
            proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cmd[0]} failed on {Path(cmd[-1]).name} "
                                   f"({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent reader never sees a half-written file
            build_info[name] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stderr}
        _libs[name] = ctypes.CDLL(str(out))
    return _libs[name]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiled first if it is not built yet."""
    return _load(name, library_path(name),
                 lambda: [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), str(CSRC / f"{name}.cu")])


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp`` (host code), compiled first with the host
    C++ compiler if it is not built yet."""
    return _load(name, host_library_path(name),
                 lambda: [_cxx(), *HOST_FLAGS, str(CSRC / f"{name}.cpp")])
