"""The timing scripts' copies of ``ops/csrc/attention.cu`` (stamps, and
variants with one choice changed) are text edits of the kernels' lines:
each edit's text must be found in the tree's source, or the script stops on
the card with the text it did not find. Here every edit list of
``scripts/time_attention_i8.py``, ``scripts/time_k1_i8.py`` and
``scripts/time_k2_paged.py`` is applied to the tree's ``attention.cu`` by
``scripts/kernel_copies.py``'s ``edited`` (the function their nvcc builds
use), so a kernel change that moves an anchor shows here, on the CPU."""
from __future__ import annotations

import importlib
import os
import sys

import pytest

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import kernel_copies as kc  # noqa: E402

CASES = [("time_attention_i8", "STAMP_EDITS", None), ("time_k1_i8", "TREE_EDITS", None),
         ("time_k1_i8", "VARIANTS", "pieces2"), ("time_k1_i8", "VARIANTS", "ceil"),
         ("time_k1_i8", "VARIANTS", "batch8"), ("time_k2_paged", "TREE_EDITS", None),
         ("time_k2_paged", "VARIANTS", "pieces1"), ("time_k2_paged", "VARIANTS", "plan256"),
         ("time_k2_paged", "VARIANTS", "nopdl")]


def test_cases_cover_every_variant():
    """Every ``VARIANTS`` entry of the scripts is one of :data:`CASES`."""
    for mod in ("time_k1_i8", "time_k2_paged"):
        have = {v for m, n, v in CASES if m == mod and n == "VARIANTS"}
        assert have == set(importlib.import_module(mod).VARIANTS), mod


@pytest.mark.parametrize("mod,name,variant", CASES)
def test_edits_apply_to_the_tree(mod, name, variant):
    """Each edit found where the script looks for it (once, or the first
    past its anchor), and each one changes the source."""
    edits = getattr(importlib.import_module(mod), name)
    if variant is not None:
        edits = edits[variant]
    with open(os.path.join(kc.CSRC, "attention.cu")) as f:
        src = f.read()
    assert edits
    for i in range(len(edits)):
        assert kc.edited(src, edits[:i + 1]) != kc.edited(src, edits[:i]), (mod, name, i)
