"""Model registry: name → (config, forward) (port of ``models/registry.py``).

This slice carries the dense Qwen3 family. The MoE and MLA names of the JAX
registry raise ``NotImplementedError`` naming the ROADMAP.md item that ports
them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config: Any
    forward: Callable


MODEL_REGISTRY: dict[str, ModelFamily] = {}

# families of the JAX registry that later slices port (ROADMAP.md queue A)
_NOT_PORTED = {
    "qwen3-235b-a22b": "A8 (Qwen3-MoE)",
    "qwen3-30b-a3b": "A8 (Qwen3-MoE)",
    "qwen3-moe-test": "A8 (Qwen3-MoE)",
    "deepseek-v3": "A9 (DeepSeek-V3 / Kimi MLA)",
    "kimi-k2": "A9 (DeepSeek-V3 / Kimi MLA)",
    "deepseek-v3-test": "A9 (DeepSeek-V3 / Kimi MLA)",
}


def register(name: str, config, forward) -> None:
    MODEL_REGISTRY[name.lower()] = ModelFamily(name.lower(), config, forward)


def get_model(name: str) -> ModelFamily:
    key = name.lower()
    if key not in MODEL_REGISTRY:
        _populate()
    if key not in MODEL_REGISTRY:
        if key in _NOT_PORTED:
            raise NotImplementedError(
                f"model {name!r} is not ported to the torch package yet "
                f"(ROADMAP.md item {_NOT_PORTED[key]})")
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[key]


def _populate() -> None:
    from . import qwen3

    for name, cfg in qwen3.QWEN3_CONFIGS.items():
        MODEL_REGISTRY.setdefault(name, ModelFamily(name, cfg, qwen3.forward))
