"""LoRA adapters: init, apply (merge) and trainable-mask utilities (port of
``train/lora.py``).

Adapters target the stacked matmul weights named in :data:`LORA_KEYS`, on
their unpacked names (``wq`` / ``wk`` / ``wv``, ``w_gate`` / ``w_up``), so
a JAX adapter maps leaf for leaf (``engine/weights.params_from_jax``).
Each adapted weight W[..., in, out] gets A[..., in, r] and B[..., r, out]
with W' = W + (alpha/r)·A@B; an expert stack [L, NE, E, F] gets lead dims
(L, NE). The tree mirrors the params: ``{"a", "b", "alpha", "rank"}`` on
adapted weights, ``None`` elsewhere.

:func:`merge_lora` is the serving engine's hot-load (``Engine.
load_lora_adapter``): JAX's unpack → :func:`apply_lora` → pack, written
straight into one new packed tensor per adapted leaf, one layer (and
expert) matrix at a time, so the load holds one new copy of the merged
leaves and one matrix's float32 scratch, never the old tree three times.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

LORA_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
             "d_gate", "d_up", "d_down", "w_qb", "w_kb", "w_vb")

# packed serving leaves → their unpacked parts, in column order
_PACKED = {"wqkv": ("wq", "wk", "wv"), "w_gateup": ("w_gate", "w_up")}


def _is_adapter(v) -> bool:
    return isinstance(v, dict) and "a" in v


def _path_seed(seed: int, path: str) -> int:
    """The draw's seed for the leaf at ``path``: fixed across processes
    (JAX folds in ``hash(str(path))``, which ``PYTHONHASHSEED`` changes)."""
    h = hashlib.sha256(f"{int(seed)}:{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def init_lora(params: dict, rank: int = 16, alpha: float = 32.0,
              seed: int = 0, keys: tuple[str, ...] = LORA_KEYS) -> dict:
    """Zero-initialized-B LoRA tree mirroring the target weights: A is
    normal·in^-½, drawn in float32 on the weight's device from a
    ``torch.Generator`` seeded from ``seed`` and the leaf's path, then
    cast to the weight's dtype."""

    def make(path: str, name: str, w):
        if isinstance(w, dict):
            return {k: make(f"{path}.{k}", k, v) for k, v in w.items()}
        if not isinstance(w, torch.Tensor) or name not in keys or w.dim() < 2:
            return None
        kin, kout = w.shape[-2], w.shape[-1]
        lead = tuple(w.shape[:-2])
        gen = torch.Generator(device=w.device).manual_seed(_path_seed(seed, path))
        a = (torch.randn(lead + (kin, rank), generator=gen, device=w.device,
                         dtype=torch.float32) * (kin ** -0.5)).to(w.dtype)
        b = torch.zeros(lead + (rank, kout), dtype=w.dtype, device=w.device)
        return {"a": a, "b": b, "alpha": alpha, "rank": rank}

    return {k: make(k, k, v) for k, v in params.items()}


def _delta(ad: dict, idx=()) -> torch.Tensor:
    """(alpha/r)·A@B in float32 (of matrix ``idx`` of the lead dims)."""
    d = torch.matmul(ad["a"][idx].float(), ad["b"][idx].float())
    return d.mul_(ad["alpha"] / ad["rank"])


def apply_lora(params: dict, lora: dict) -> dict:
    """Merge adapters into the weights: W + (alpha/r)·A@B in float32, cast
    back to W's dtype. A new tree: merged leaves are new tensors, the rest
    the params' own."""
    def merge(w, ad):
        if ad is None:
            return w
        if _is_adapter(ad):
            return (w.float() + _delta(ad)).to(w.dtype)
        return {k: merge(v, ad[k]) for k, v in w.items()}

    return merge(params, lora)


def lora_trainable_mask(params: dict, lora: dict):
    """Mask trees: False on every params leaf, and on the LoRA tree True
    only on the ``a`` / ``b`` leaves (JAX's optax mask)."""
    def frozen(t):
        if isinstance(t, dict):
            return {k: frozen(v) for k, v in t.items()}
        return None if t is None else False

    def trainable(ad):
        if ad is None:
            return None
        if _is_adapter(ad):
            return {"a": True, "b": True, "alpha": False, "rank": False}
        return {k: trainable(v) for k, v in ad.items()}

    return frozen(params), trainable(lora)


def rescale_lora(lora: dict, scale: float) -> dict:
    """Every adapter with ``alpha = scale·rank`` (``Engine.
    load_lora_adapter``'s ``scale``)."""
    if _is_adapter(lora):
        return {**lora, "alpha": scale * lora["rank"]}
    if isinstance(lora, dict):
        return {k: rescale_lora(v, scale) for k, v in lora.items()}
    return lora


def lora_to(lora: dict, device) -> dict:
    """The adapter tree with its tensors on ``device``."""
    if isinstance(lora, dict):
        return {k: lora_to(v, device) for k, v in lora.items()}
    if isinstance(lora, torch.Tensor):
        return lora.to(device)
    return lora


def _merge_columns(w: torch.Tensor, parts: list) -> torch.Tensor:
    """A new tensor like ``w`` whose column blocks (``parts``: (adapter or
    None, width) in column order) are merged: for each matrix of the lead
    dims and each adapted block, float32 W plus its delta, cast back; the
    other blocks copied. Scratch: one block's float32 W and delta."""
    out = torch.empty_like(w)
    for idx in np.ndindex(*w.shape[:-2]):
        c0 = 0
        for ad, n in parts:
            cols = slice(c0, c0 + n)
            c0 += n
            if ad is None:
                out[idx][..., cols].copy_(w[idx][..., cols])
            else:
                _merge_block(out[idx][..., cols], w[idx][..., cols], ad, idx)
    return out


def _merge_block(dst: torch.Tensor, src: torch.Tensor, ad: dict, idx) -> None:
    """dst = src + the delta of matrix ``idx``, in float32, cast to dst's
    dtype (its scratch freed on return)."""
    acc = src.float()
    acc.add_(_delta(ad, idx))
    dst.copy_(acc)


def merge_lora(params: dict, lora: dict, cfg) -> dict:
    """:func:`apply_lora` of an adapter tree on unpacked key names onto a
    tree in the engine's packed layout (``wqkv``, ``w_gateup``): the same
    numbers as unpack → :func:`apply_lora` → pack (JAX
    ``engine.py:1162-1170``), without unpacking or concatenating. A new
    tree; leaves without an adapter are the params' own tensors, and no
    tensor of ``params`` is written. int8 ``{q, scales}`` leaves raise
    JAX's ``ValueError``."""
    def walk(p: dict, ad: dict | None) -> dict:
        out = {}
        for k, w in p.items():
            if k in _PACKED:
                if isinstance(w, dict):
                    raise ValueError("cannot unpack int8-quantized packed weights")
                parts = list(zip([None if ad is None else ad[n] for n in _PACKED[k]],
                                 _packed_widths(k, w, cfg)))
            else:
                parts = [(None if ad is None else ad[k], None)]
            sub = parts[0][0]
            if all(a is None for a, _ in parts):
                out[k] = w
            elif isinstance(w, dict) and not _is_adapter(sub):
                out[k] = walk(w, sub)
            elif isinstance(w, dict):
                raise ValueError("cannot merge a LoRA adapter into int8-quantized weights")
            else:
                out[k] = _merge_columns(w, [(a, n or w.shape[-1]) for a, n in parts])
        return out

    return walk(params, lora)


def _packed_widths(key: str, w: torch.Tensor, cfg) -> list:
    """The column widths of a packed leaf's parts (q, k, v or gate, up)."""
    if key == "wqkv":
        hd, kd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        return [hd, kd, kd]
    return [w.shape[-1] // 2] * 2
