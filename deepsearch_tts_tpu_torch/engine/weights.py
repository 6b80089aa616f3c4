"""Weights: HF safetensors → the stacked-layer param tree (port of
``engine/weights.py``, dense Qwen3 family).

The tree has the JAX package's layout (right-multiply weights, per-layer
tensors stacked on a leading layer axis) so that params convert leaf by leaf
in both directions. Random init, used when no checkpoint is given, is drawn
on the target device from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch


def _load_safetensors_dir(path: str) -> dict[str, np.ndarray]:
    """Minimal safetensors reader (little-endian header length, JSON header,
    raw tensor bytes). numpy only; bf16 is widened to float32 by bit shift."""
    tensors: dict[str, np.ndarray] = {}
    files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    dtype_map = {
        "F32": np.float32, "F16": np.float16, "BF16": np.uint16,  # bf16 via view
        "I64": np.int64, "I32": np.int32, "U8": np.uint8,
    }
    for fname in sorted(files):
        with open(os.path.join(path, fname), "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen).decode("utf-8"))
            base = 8 + hlen
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                dt, shape = meta["dtype"], meta["shape"]
                start, end = meta["data_offsets"]
                f.seek(base + start)
                arr = np.frombuffer(f.read(end - start), dtype=dtype_map[dt]).reshape(shape)
                if dt == "BF16":
                    arr = (arr.astype(np.uint32) << 16).view(np.float32)
                tensors[name] = arr
    return tensors


def _to_torch(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def convert_qwen3_dense(raw: dict[str, np.ndarray], cfg, device="cpu",
                        dtype: torch.dtype | None = None) -> dict:
    """HF Qwen3 checkpoint → stacked param tree (models/qwen3.py layout)."""
    L = cfg.n_layers
    dt = dtype or cfg.torch_dtype

    def stack(fmt, transpose=True):
        mats = [raw[fmt.format(i)] for i in range(L)]
        return _to_torch(np.stack([m.T if transpose else m for m in mats]), dt, device)

    params = {
        "embed": _to_torch(raw["model.embed_tokens.weight"], dt, device),
        "final_norm": _to_torch(raw["model.norm.weight"], dt, device),
        "layers": {
            "ln1": stack("model.layers.{}.input_layernorm.weight", transpose=False),
            "ln2": stack("model.layers.{}.post_attention_layernorm.weight", transpose=False),
            "q_norm": stack("model.layers.{}.self_attn.q_norm.weight", transpose=False),
            "k_norm": stack("model.layers.{}.self_attn.k_norm.weight", transpose=False),
            "wq": stack("model.layers.{}.self_attn.q_proj.weight"),
            "wk": stack("model.layers.{}.self_attn.k_proj.weight"),
            "wv": stack("model.layers.{}.self_attn.v_proj.weight"),
            "wo": stack("model.layers.{}.self_attn.o_proj.weight"),
            "w_gate": stack("model.layers.{}.mlp.gate_proj.weight"),
            "w_up": stack("model.layers.{}.mlp.up_proj.weight"),
            "w_down": stack("model.layers.{}.mlp.down_proj.weight"),
        },
    }
    if "lm_head.weight" in raw and not cfg.tie_embeddings:
        params["lm_head"] = _to_torch(raw["lm_head.weight"].T, dt, device)
    return params


def random_params(cfg, device="cpu", seed: int = 0) -> dict:
    """Random dense init on ``device``: normal·fan_in^-½ for matrices (the
    distribution of the JAX package's ``fast_random_params``), ones for the
    norms. Drawn on the device from a ``torch.Generator`` seeded with
    ``seed`` — no host-side weight bytes at all."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = cfg.torch_dtype
    E, H, K, D, L, Fi = (cfg.hidden, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.n_layers, cfg.intermediate)

    def mk(*shape, fan_in=None):
        fan = fan_in if fan_in is not None else shape[-2]
        out = torch.empty(shape, dtype=dt, device=dev)
        # per layer, so the float32 draw never holds a whole stack at once
        for i in range(shape[0] if len(shape) == 3 else 1):
            dst = out[i] if len(shape) == 3 else out
            dst.copy_(torch.randn(dst.shape, generator=gen, device=dev,
                                  dtype=torch.float32).mul_(fan ** -0.5))
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    params = {
        "embed": mk(cfg.vocab_size, E, fan_in=E),
        "final_norm": ones(E),
        "layers": {
            "ln1": ones(L, E), "ln2": ones(L, E),
            "q_norm": ones(L, D), "k_norm": ones(L, D),
            "wq": mk(L, E, H * D), "wk": mk(L, E, K * D), "wv": mk(L, E, K * D),
            "wo": mk(L, H * D, E),
            "w_gate": mk(L, E, Fi), "w_up": mk(L, E, Fi), "w_down": mk(L, Fi, E),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = mk(E, cfg.vocab_size)
    return params


def pack_matmul_params(params: dict) -> dict:
    """Fuse per-layer QKV and gate/up weights into one matrix each (a concat
    over output columns: numerically the identity). The fused decode kernels
    read this packed layout."""
    lp = dict(params["layers"])
    if all(k in lp for k in ("wq", "wk", "wv")):
        lp["wqkv"] = torch.cat([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")], dim=-1)
    if "w_gate" in lp and "w_up" in lp:
        lp["w_gateup"] = torch.cat([lp.pop("w_gate"), lp.pop("w_up")], dim=-1)
    out = dict(params)
    out["layers"] = lp
    return out


def params_from_jax(tree, device="cpu") -> dict:
    """The JAX package's param tree, as numpy arrays, → this port's tree.

    bfloat16 leaves (``ml_dtypes.bfloat16`` in numpy) are reinterpreted bit
    for bit — viewed as int16, then as ``torch.bfloat16`` — so this package
    never imports ``ml_dtypes``; other float leaves keep their dtype."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    a = np.array(tree)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def load_or_init_params(model_name: str, weights_path: str = "", seed: int = 0,
                        device="cpu") -> tuple[dict, str]:
    """Return (params, resolved model name). Random init when no weights."""
    from ..models.registry import get_model

    fam = get_model(model_name)
    if weights_path:
        raw = _load_safetensors_dir(weights_path)
        return convert_qwen3_dense(raw, fam.config, device=device), fam.name
    return random_params(fam.config, device=device, seed=seed), fam.name
