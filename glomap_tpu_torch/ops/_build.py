"""Build the CUDA kernels of glomap_tpu_torch/csrc/ with nvcc.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), and all nvcc
processes start together. Libraries go to build/torch_kernels/ at the
repository root and are loaded with ctypes; kernels.py declares their
signatures. A failed build raises. Nothing here runs at import time, so
importing the package never needs nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "torch_kernels"
SOURCES = {
    "projection": "projection.cu",
    "gather": "gather.cu",
    "rowsum": "rowsum.cu",
    "pair_rowsum": "pair_rowsum.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of glomap_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = library_path(name)
    return (not so.exists()
            or so.stat().st_mtime < (CSRC / SOURCES[name]).stat().st_mtime)


def build(names=None) -> dict:
    """Compile the named kernels (default all), one nvcc each, in parallel.

    Returns {"seconds": wall time, "ptxas": {name: register/smem report}}.
    Raises RuntimeError with the compiler output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.monotonic()
    procs = {}
    for name in names:
        tmp = library_path(name).with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.monotonic() - t0, "ptxas": reports}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building what is stale first."""
    if name not in _libs:
        if name not in SOURCES:
            raise KeyError(f"unknown kernel {name!r}")
        stale = [n for n in SOURCES if n not in _libs and _stale(n)]
        if stale:
            build(stale)
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]
