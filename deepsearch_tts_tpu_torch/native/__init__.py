"""The C++ radix page index of the prefix cache, built with g++ on first use
and bound with ctypes (port of ``native/``; the same C source).

``radix_index.cpp`` compiles into ``build/native/`` at the repo root (named
by a hash of the source, so a changed source rebuilds), never into the
package. Without g++ :func:`load_native` returns None and
``engine.prefix_cache.make_prefix_cache`` keeps the Python tree, which gives
the same matches: the index is host bookkeeping, not device work.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "radix_index.cpp")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "native")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    """Path of the built library, compiling it if needed; None on failure."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libradix_index_{digest}.so")
    if os.path.exists(so):
        return so
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=180)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def load_native():
    """The ctypes library, or None when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        lib.rpi_new.restype = ctypes.c_void_p
        lib.rpi_new.argtypes = [ctypes.c_uint32]
        lib.rpi_free.argtypes = [ctypes.c_void_p]
        lib.rpi_size.restype = ctypes.c_uint64
        lib.rpi_size.argtypes = [ctypes.c_void_p]
        lib.rpi_match.restype = ctypes.c_uint32
        lib.rpi_match.argtypes = [ctypes.c_void_p, i32p, ctypes.c_uint32, i64p,
                                  ctypes.c_uint32]
        lib.rpi_insert.restype = ctypes.c_uint32
        lib.rpi_insert.argtypes = [ctypes.c_void_p, i32p, ctypes.c_uint32, i64p,
                                   ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8)]
        lib.rpi_evict_lru.restype = ctypes.c_int64
        lib.rpi_evict_lru.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeRadixIndex:
    """Object wrapper over the C radix index (one handle per cache)."""

    def __init__(self, page_size: int):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native radix index unavailable (no g++?)")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.rpi_new(page_size))
        self.page_size = page_size

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.rpi_free(h)

    def match(self, tokens: list[int], max_pages: int = 4096) -> list[int]:
        arr = np.asarray(tokens, np.int32)
        out = np.zeros((max_pages,), np.int64)
        n = self._lib.rpi_match(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_pages)
        return out[:n].tolist()

    def insert(self, tokens: list[int], pages: list[int]) -> list[int]:
        """Records a sequence's full pages; returns those the index newly
        references."""
        arr = np.asarray(tokens, np.int32)
        parr = np.asarray(pages, np.int64)
        mask = np.zeros((len(pages),), np.uint8)
        self._lib.rpi_insert(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr),
            parr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(parr),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return [int(p) for p, m in zip(pages, mask) if m]

    def evict_lru(self) -> int:
        return int(self._lib.rpi_evict_lru(self._h))

    def __len__(self) -> int:
        return int(self._lib.rpi_size(self._h))
