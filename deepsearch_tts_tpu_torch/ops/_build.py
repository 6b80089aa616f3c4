"""Build the port's CUDA C++ sources with nvcc and load them with ctypes.

Each ``ops/csrc/*.cu`` exposes a plain C interface (raw pointers, ints,
the CUDA stream; returns the ``cudaGetLastError()`` code), so nvcc compiles
it in seconds without PyTorch's headers. The shared library goes to
``build/torch_kernels/`` at the repo root, named by a hash of the source,
the headers beside it (``hopper.cuh``) and the flags, and is built on first
use — ``python3 chip_smoke.py`` alone builds everything.

Nothing here runs at import time; a failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()                     # guards _locks
_locks: dict[str, threading.Lock] = {}       # one per library: builds run in parallel
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # source name → nvcc's output of the last build


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked at $NVCC, PATH, /usr/local/cuda/bin)")


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` once per process and source hash; return
    the loaded library. Different libraries may build concurrently."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(_CSRC, f"{name}.cu")
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        # the source and the headers beside it (every .cuh: any may be included)
        for path in [src] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        so = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {src} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stderr}")
            build_log[name] = proc.stdout + proc.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib
