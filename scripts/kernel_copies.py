"""Copies of the port's CUDA sources for the timing scripts: a parent
commit's sources written out, and nvcc builds of a source with text edits
(stamps, a changed constant) beside the port's own library.

``prepare(rev, dest, tool)`` writes ``attention.cu`` and ``hopper.cuh`` of
commit ``rev`` (``git show``, so it needs a git checkout) and a ``REV`` file
into ``dest``, a directory under ``build/`` (ignored by git); ``build``
compiles ``dest``'s (or the tree's) ``attention.cu`` with the port's nvcc
flags, so a timing run also works in a copy without ``.git``. ``card()``
is the card's name and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "deepsearch_tts_tpu_torch", "ops", "csrc")
SOURCES = ("attention.cu", "hopper.cuh")


def prepare(rev: str, dest: str, tool: str) -> None:
    """``rev``'s ``SOURCES`` and a ``REV`` file into ``dest``."""
    os.makedirs(dest, exist_ok=True)
    for name in SOURCES:
        src = subprocess.run(["git", "show", f"{rev}:deepsearch_tts_tpu_torch/ops/csrc/{name}"],
                             cwd=ROOT, capture_output=True, text=True, check=True).stdout
        with open(os.path.join(dest, name), "w") as f:
            f.write(src)
    with open(os.path.join(dest, "REV"), "w") as f:
        f.write(rev + "\n")
    print(f"{tool}: {rev}'s {' and '.join(SOURCES)} in {dest}")


def parent_rev(dest: str, tool: str) -> str:
    """The commit ``prepare`` wrote into ``dest``; stops the script when
    there is none."""
    path = os.path.join(dest, "REV")
    if not os.path.exists(path):
        raise SystemExit(f"{tool}: no parent sources in {dest}: run --prepare REV in a git "
                         "checkout first")
    with open(path) as f:
        return f.read().strip()


def edited(src: str, edits, who: str = "edit") -> str:
    """``src`` with each ``(old, new)`` of ``edits`` applied: ``old`` found
    exactly once, or with ``(old, new, after)`` the first ``old`` past the
    text ``after``, itself found exactly once. A text not found stops the
    script with it."""
    for old, new, *after in edits or ():
        at = 0
        if after:
            if src.count(after[0]) != 1:
                raise SystemExit(f"{who}: kernel text not found once:\n{after[0]}")
            at = src.index(after[0])
        elif src.count(old) != 1:
            raise SystemExit(f"{who}: kernel text not found once:\n{old}")
        i = src.find(old, at)
        if i < 0:
            raise SystemExit(f"{who}: kernel text not found after its anchor:\n{old}")
        src = src[:i] + new + src[i + len(old):]
    return src


def build(src_dir: str, out_dir: str, tag: str, edits=None, tool: str = "build"
          ) -> tuple[ctypes.CDLL, list[str]]:
    """nvcc of ``src_dir``/attention.cu with ``edits`` applied (:func:`edited`), into
    ``out_dir``/lib<tag>.so. Returns the library and ptxas' lines of
    registers and spills."""
    from deepsearch_tts_tpu_torch.ops import _build

    src_dir = os.path.abspath(src_dir)
    with open(os.path.join(src_dir, "attention.cu")) as f:
        src = edited(f.read(), edits, f"{tool} ({tag})")
    src = src.replace('#include "hopper.cuh"',
                      f'#include "{os.path.join(src_dir, "hopper.cuh")}"')
    os.makedirs(out_dir, exist_ok=True)
    path, so = os.path.join(out_dir, f"{tag}.cu"), os.path.join(out_dir, f"lib{tag}.so")
    with open(path, "w") as f:
        f.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{tool}: nvcc failed on {tag}\n{r.stderr[-4000:]}")
    notes = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
             if any(w in ln for w in ("registers", "spill", "Compiling entry"))]
    return ctypes.CDLL(so), notes


def typed_as(lib: ctypes.CDLL, ref: ctypes.CDLL, names) -> ctypes.CDLL:
    """``lib``'s entries ``names`` typed as ``ref``'s (the port's wrappers
    then run on ``lib`` once it stands in ``_build._libs``)."""
    for name in names:
        fn, r = getattr(lib, name), getattr(ref, name)
        fn.argtypes, fn.restype = r.argtypes, r.restype
    lib._dstts_typed = True
    return lib


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
