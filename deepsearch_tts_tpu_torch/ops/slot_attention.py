"""Decode attention over the contiguous-slot KV cache (port of
``ops/slot_attention.py:301 slot_attention``, kernel B1).

In slot mode batch row n IS pool row n: layer l's keys of row n lie at index
``l·N + n`` of the flattened ``[L·N, ps, K, D]`` pool (``ps`` =
``max_seq_len``). Row n attends keys ``< limit[n]`` (``min(seq_len,
pos+1)``, inactive rows clamped to 1 as in JAX) among the first
``slot_ctx`` positions. ``v_pool=None`` means v is k (the MLA shared
variant; the kernel reads the k pointer twice). The TPU kernel's K=1 sublane
squeeze is a Mosaic tiling artifact and has no counterpart.

On Hopper a slot row is one page of ``max_seq_len`` tokens, so the wrapper
launches the paged decode kernel K1 (``csrc/attention.cu``) with the
identity table ``row = layer·N + b`` and p rounded to bf16 before the value
product, the B1 round point (``slot_attention.py:98``). For a CPU tensor it
runs :func:`slot_attention_plain`. ``slot_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from .attention import NEG_INF


def _check_rows(B: int, n_rows: int) -> None:
    if B != n_rows:
        raise ValueError(f"slot_attention needs B == n_rows ({B} vs {n_rows})")


def slot_attention_plain(q, k_pool, v_pool, limit, layer, *, n_rows: int,
                         slot_ctx: int, scale: float | None = None):
    """Reference for B1 with the kernel's round points: float32 scores and
    softmax sum, p cast to the value dtype before PV, float32 accumulator."""
    B, H, D = q.shape
    _check_rows(B, n_rows)
    _, ps, K, _ = k_pool.shape
    v_pool = k_pool if v_pool is None else v_pool
    S = min(slot_ctx, ps)
    scale = scale if scale is not None else D ** -0.5
    rows = slice(int(layer) * n_rows, (int(layer) + 1) * n_rows)
    k = k_pool[rows, :S].float()
    v = v_pool[rows, :S]
    lim = limit.long().clamp(min=1)
    s = torch.einsum("bkgd,bskd->bkgs", (q.float() * scale).reshape(B, K, H // K, D), k)
    mask = (torch.arange(S, device=q.device)[None, :] < lim[:, None])[:, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    out = out / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def slot_attention(q, k_pool, v_pool, limit, layer, *, n_rows: int, slot_ctx: int,
                   scale: float | None = None):
    """B1: q [B,H,D] (this step's queries), pools [L·N,ps,K,D] (``v_pool``
    None: v is k), limit [B] int, ``layer`` int → [B,H,D]."""
    _check_rows(q.shape[0], n_rows)
    if q.device.type == "cpu":
        return slot_attention_plain(q, k_pool, v_pool, limit, layer, n_rows=n_rows,
                                    slot_ctx=slot_ctx, scale=scale)
    from .paged_attention import decode_attention_cuda

    B, H, D = q.shape
    out = decode_attention_cuda(
        q[:, None], k_pool, k_pool if v_pool is None else v_pool, limit.long(),
        row_offset=int(layer) * n_rows, min_one=True,
        max_keys=min(int(slot_ctx), k_pool.shape[1]), scale=scale, p_bf16=True)
    slot_attention.launches += 1
    return out[:, 0]


slot_attention.launches = 0
