"""Weights: HF safetensors → the stacked-layer param tree (port of
``engine/weights.py``, dense Qwen3 and Qwen3-MoE families).

The tree has the JAX package's layout (right-multiply weights, per-layer
tensors stacked on a leading layer axis; MoE expert stacks [L,NE,...]) so
that params convert leaf by leaf in both directions. Random init, used when
no checkpoint is given, is drawn on the target device from a seeded
``torch.Generator``, directly in the packed single-device layout.
"""
from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping

import numpy as np
import torch


_DTYPES = {
    "F32": np.float32, "F16": np.float16, "BF16": np.uint16,  # bf16 via view
    "I64": np.int64, "I32": np.int32, "U8": np.uint8,
}


class _Checkpoint(Mapping):
    """name → ndarray over a safetensors directory, each tensor read from
    its file when it is looked up (bf16 widened to float32 by bit shift),
    so the host never holds a whole checkpoint in float32 — a qwen3-30b-a3b
    checkpoint would take 122 GB."""

    def __init__(self, index: dict):
        self._index = index

    def __getitem__(self, name: str) -> np.ndarray:
        fname, base, meta = self._index[name]
        start, end = meta["data_offsets"]
        dt = _DTYPES[meta["dtype"]]
        arr = np.fromfile(fname, dtype=dt, count=(end - start) // np.dtype(dt).itemsize,
                          offset=base + start).reshape(meta["shape"])
        if meta["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr

    def __iter__(self):
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)


def _load_safetensors_dir(path: str) -> _Checkpoint:
    """Minimal safetensors reader (little-endian header length, JSON header,
    raw tensor bytes), numpy only: reads the headers now and each tensor
    when it is looked up."""
    files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    index = {}
    for fname in sorted(files):
        full = os.path.join(path, fname)
        with open(full, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen).decode("utf-8"))
        for name, meta in header.items():
            if name != "__metadata__":
                index[name] = (full, 8 + hlen, meta)
    return _Checkpoint(index)


def _to_torch(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _layer_stack(raw, L: int, fmt: str, dt, device, transpose=True) -> torch.Tensor:
    mats = [raw[fmt.format(i)] for i in range(L)]
    return _to_torch(np.stack([m.T if transpose else m for m in mats]), dt, device)


def _convert_attention(raw: Mapping[str, np.ndarray], cfg, device, dt) -> dict:
    """Embedding, norms, attention stacks and lm_head: what the dense and
    the MoE family share."""
    def stack(fmt, transpose=True):
        return _layer_stack(raw, cfg.n_layers, fmt, dt, device, transpose)

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
        },
    }
    if "lm_head.weight" in raw and not cfg.tie_embeddings:
        params["lm_head"] = _to_torch(raw["lm_head.weight"].T, dt, device)
    return params


def convert_qwen3_dense(raw: Mapping[str, np.ndarray], cfg, device="cpu",
                        dtype: torch.dtype | None = None) -> dict:
    """HF Qwen3 checkpoint → stacked param tree (models/qwen3.py layout)."""
    dt = dtype or cfg.torch_dtype
    params = _convert_attention(raw, cfg, device, dt)
    for key, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                      ("w_down", "down_proj")):
        params["layers"][key] = _layer_stack(
            raw, cfg.n_layers, f"model.layers.{{}}.mlp.{proj}.weight", dt, device)
    return params


def convert_qwen3_moe(raw: Mapping[str, np.ndarray], cfg, device="cpu",
                      dtype: torch.dtype | None = None) -> dict:
    """HF Qwen3-MoE checkpoint → stacked param tree (models/qwen3_moe.py
    layout, experts packed: ``w_gateup`` [L,NE,E,2F], gate first, and
    ``w_down`` [L,NE,F,E]). The expert stacks are filled one expert matrix
    at a time, straight into the layout the engine serves, so neither the
    host nor the card ever holds a second copy of them."""
    L, NE, E, Fi = cfg.n_layers, cfg.n_experts, cfg.hidden, cfg.moe_intermediate
    dt = dtype or cfg.torch_dtype
    params = _convert_attention(raw, cfg, device, dt)
    lp = params["layers"]
    lp["router"] = _layer_stack(raw, L, "model.layers.{}.mlp.gate.weight", dt, device)
    lp["w_gateup"] = torch.empty((L, NE, E, 2 * Fi), dtype=dt, device=device)
    lp["w_down"] = torch.empty((L, NE, Fi, E), dtype=dt, device=device)
    for proj, dst in (("gate_proj", lp["w_gateup"][..., :Fi]),
                      ("up_proj", lp["w_gateup"][..., Fi:]), ("down_proj", lp["w_down"])):
        for i in range(L):
            for e in range(NE):
                dst[i, e] = _to_torch(raw[f"model.layers.{i}.mlp.experts.{e}.{proj}.weight"].T,
                                      dt, device)
    return params


def random_params(cfg, device="cpu", seed: int = 0) -> dict:
    """Random init on ``device`` in the packed layout the engine serves
    (``wqkv``, ``w_gateup``): normal·fan_in^-½ for matrices (the
    distribution of the JAX package's ``fast_random_params``: fan_in E for
    q/k/v, gate, up and the router, F for down), ones for the norms. Drawn
    on the device from a ``torch.Generator`` seeded with ``seed``, one
    matrix at a time, so the float32 draw never holds more than one [E,2F]
    (or [V,E]) slab — a whole qwen3-30b-a3b expert stack would take 38.7 GB
    in float32 — and no host-side weight bytes at all."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = cfg.torch_dtype
    E, H, K, D, L = cfg.hidden, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

    def mk(*shape, fan_in=None):
        fan = fan_in if fan_in is not None else shape[-2]
        out = torch.empty(shape, dtype=dt, device=dev)
        for idx in np.ndindex(*shape[:-2]):
            dst = out[idx]
            dst.copy_(torch.randn(dst.shape, generator=gen, device=dev,
                                  dtype=torch.float32).mul_(fan ** -0.5))
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    layers = {
        "ln1": ones(L, E), "ln2": ones(L, E),
        "q_norm": ones(L, D), "k_norm": ones(L, D),
        "wqkv": mk(L, E, (H + 2 * K) * D),
        "wo": mk(L, H * D, E),
    }
    # the family's MLP stacks; every one has its fan_in second to last
    layers.update({k: mk(L, *shape) for k, shape in cfg.mlp_shapes().items()})
    params = {"embed": mk(cfg.vocab_size, E, fan_in=E), "final_norm": ones(E),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = mk(E, cfg.vocab_size)
    return params


def pack_matmul_params(params: dict) -> dict:
    """Fuse per-layer QKV and gate/up weights into one matrix each (a concat
    over output columns: numerically the identity) — dense [L,E,F] and
    expert [L,NE,E,F] stacks alike. The fused decode kernels read this
    packed layout. Tensors of an already-packed tree are handed back as they
    are, so engines built on one tree share one copy of the weights."""
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
        return fam.convert(raw, fam.config, device=device), fam.name
    return random_params(fam.config, device=device, seed=seed), fam.name
