"""Build and load the port's CUDA kernels: ``nvcc`` compiles a source under
``foley_tpu_torch/csrc`` into a shared library with a plain C interface, loaded through
``ctypes``.

A library is built at first use into ``build/torch_kernels/<hash>/`` at the repository root,
where the hash covers its source, the shared headers and the compiler flags, so a stale
library is never loaded. Nothing is built or loaded when this module is imported.
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


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiled first if it is not built yet."""
    if name not in _libs:
        out = library_path(name)
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                                   str(CSRC / f"{name}.cu")], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent reader never sees a half-written file
            build_info[name] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stderr}
        _libs[name] = ctypes.CDLL(str(out))
    return _libs[name]
