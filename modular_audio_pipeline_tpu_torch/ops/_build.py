"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, under
``modular_audio_pipeline_tpu_torch/_build/`` (listed in ``.gitignore``).
The library's file name carries a hash of its sources and flags, so a
changed source is rebuilt and a stale library is never loaded. Nothing is
built when a module is imported: the wrappers call :func:`load` on their
first launch, and ``chip_smoke.py`` calls :func:`build` to compile every
kernel at once, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNELS", "build", "load", "build_log"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("flash_attention", "ancestor_attention", "int8_matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): cannot build the CUDA kernels")
    return found


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise RuntimeError(f"missing kernel source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name``, or '' if none is kept."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] = KERNELS) -> None:
    """Compile every named kernel that has no current library, with all
    ``nvcc`` processes started together. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: Dict[str, tuple] = {}
    nvcc: Optional[str] = None
    for name in names:
        lib = _library(name)
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name} (nvcc rc={rc}):\n{build_log(name)[-4000:]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library(name)))
            _LIBS[name] = lib
        return lib
