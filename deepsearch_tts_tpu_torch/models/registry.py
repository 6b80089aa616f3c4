"""Model registry: name → (config, forward, checkpoint converter) (port of
``models/registry.py``).

This slice carries the dense Qwen3 and the Qwen3-MoE families. The MLA
names of the JAX registry raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them. What else differs between the families
(the MLP weights a random init draws, the fused decode layer's widths) is
asked of the config (``mlp_shapes``, ``fused_decode_widths``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config: Any
    forward: Callable
    convert: Callable | None = None   # HF checkpoint → param tree (engine/weights.py)


MODEL_REGISTRY: dict[str, ModelFamily] = {}

# families of the JAX registry that later slices port (ROADMAP.md queue A)
_NOT_PORTED = {
    "deepseek-v3": "A9 (DeepSeek-V3 / Kimi MLA)",
    "kimi-k2": "A9 (DeepSeek-V3 / Kimi MLA)",
    "deepseek-v3-test": "A9 (DeepSeek-V3 / Kimi MLA)",
}


def register(name: str, config, forward, convert=None) -> None:
    MODEL_REGISTRY[name.lower()] = ModelFamily(name.lower(), config, forward, convert)


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
    from ..engine import weights
    from . import qwen3, qwen3_moe

    for mod, configs, convert in (
            (qwen3, qwen3.QWEN3_CONFIGS, weights.convert_qwen3_dense),
            (qwen3_moe, qwen3_moe.QWEN3_MOE_CONFIGS, weights.convert_qwen3_moe)):
        for name, cfg in configs.items():
            MODEL_REGISTRY.setdefault(name, ModelFamily(name, cfg, mod.forward, convert))
