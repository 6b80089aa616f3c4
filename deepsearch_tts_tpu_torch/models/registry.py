"""Model registry: name → (config, forward, checkpoint converter, init)
(port of ``models/registry.py``).

Every family of the JAX registry is carried: dense Qwen3, Qwen3-MoE and
DeepSeek-V3 / Kimi-K2 (MLA). What else differs between the families (the
weights a random init draws, whether the fused decode kernels take the
widths) is asked of the config (``mlp_shapes``, ``fused_decode_fits``,
``latent_cache``). A registry-extension family (a scripted test model, a
plugin) whose config sets ``custom_init`` brings its own init,
``init_params(cfg, seed=, device=)``, as in JAX
(``engine/weights.py`` ``load_or_init_params``).
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
    init_params: Callable | None = None   # (cfg, seed=, device=) → params; read with custom_init
    logical_axes: Callable | None = None  # cfg → logical-axis tree (sharded serving)


MODEL_REGISTRY: dict[str, ModelFamily] = {}


def register(name: str, config, forward, convert=None, init_params=None,
             logical_axes=None) -> None:
    MODEL_REGISTRY[name.lower()] = ModelFamily(name.lower(), config, forward, convert,
                                               init_params, logical_axes)


def get_model(name: str) -> ModelFamily:
    key = name.lower()
    if key not in MODEL_REGISTRY:
        _populate()
    if key not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[key]


def _populate() -> None:
    from ..engine import weights
    from . import deepseek_v3, qwen3, qwen3_moe

    for mod, configs, convert in (
            (qwen3, qwen3.QWEN3_CONFIGS, weights.convert_qwen3_dense),
            (qwen3_moe, qwen3_moe.QWEN3_MOE_CONFIGS, weights.convert_qwen3_moe),
            (deepseek_v3, deepseek_v3.DEEPSEEK_V3_CONFIGS, weights.convert_deepseek_v3)):
        for name, cfg in configs.items():
            MODEL_REGISTRY.setdefault(name, ModelFamily(name, cfg, mod.forward, convert,
                                                        logical_axes=mod.logical_axes))
