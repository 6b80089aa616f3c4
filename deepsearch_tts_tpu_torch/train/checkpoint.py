"""Checkpoint / resume for param trees (port of ``train/checkpoint.py``).

The JAX package saves orbax directories; the card's machine has no orbax
(no jax at all), so the port saves safetensors: one ``params.safetensors``
in the checkpoint directory, written by ``engine/weights.py``'s
:func:`~..engine.weights.save_safetensors` and read back by its reader.
Tree paths are flattened to dotted keys (``layers.wq.a``); the leaves that
are not tensors — ``None`` (a LoRA tree off its adapted weights) and Python
numbers (an adapter's ``alpha`` and ``rank``) — go in the header's
``__metadata__`` as JSON, so a LoRA tree round-trips exactly, types
included. The names, returns and ``step_<n>`` directory rule are JAX's.
The port does not read JAX's orbax directories: a JAX tree crosses over
as numpy through ``engine/weights.params_from_jax``.
"""
from __future__ import annotations

import json
import os
from typing import Any

import torch

FILE = "params.safetensors"


def _flatten(tree: Any, prefix: str, tensors: dict, meta: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, str) or "." in k:
                raise ValueError(f"checkpoint keys are strings without dots, got {k!r}")
            _flatten(v, f"{prefix}{k}.", tensors, meta)
    elif isinstance(tree, torch.Tensor):
        tensors[prefix[:-1]] = tree
    elif tree is None or isinstance(tree, (bool, int, float)):
        meta[prefix[:-1]] = json.dumps(tree)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf at {prefix[:-1]!r}")


def _insert(tree: dict, key: str, value) -> None:
    *path, last = key.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = value


def save_params(path: str, params: Any, step: int | None = None) -> str:
    """Write the tree ``params`` to the directory ``path`` (``path/step_<n>``
    with ``step``), replacing an earlier checkpoint there; returns the
    directory."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    tensors: dict = {}
    meta: dict = {}
    _flatten(params, "", tensors, meta)
    os.makedirs(path, exist_ok=True)
    from ..engine.weights import save_safetensors

    tmp = os.path.join(path, FILE + ".tmp")
    save_safetensors(tmp, tensors, meta)
    os.replace(tmp, os.path.join(path, FILE))
    return path


def restore_params(path: str, like: Any | None = None) -> Any:
    """Read a tree written by :func:`save_params`: CPU tensors in the dtypes
    they were saved in, or with ``like`` (a tree of tensors of the same
    structure) each leaf on its ``like`` leaf's device and in its dtype."""
    from ..engine.weights import _load_safetensors_dir

    ck = _load_safetensors_dir(os.path.abspath(path))
    tree: dict = {}
    for key in ck:
        _insert(tree, key, ck.tensor(key))
    for key, val in ck.metadata.items():
        _insert(tree, key, json.loads(val))
    if like is not None:
        tree = _onto(tree, like)
    return tree


def _onto(tree, like):
    if isinstance(tree, dict):
        return {k: _onto(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


def latest_step_dir(root: str) -> str | None:
    if not os.path.isdir(root):
        return None
    steps = [(int(d.split("_")[1]), d) for d in os.listdir(root)
             if d.startswith("step_") and d.split("_")[1].isdigit()]
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])
