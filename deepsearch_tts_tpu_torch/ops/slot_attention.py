"""Attention over the contiguous-slot KV cache (port of
``ops/slot_attention.py``): decode (``slot_attention``, kernel B1) and the
speculative verify window (``slot_window_attention``, kernel B9).

In slot mode batch row n IS pool row n: layer l's keys of row n lie at index
``l·N + n`` of the flattened ``[L·N, ps, K, D]`` pool (``ps`` =
``max_seq_len``), and only the first ``slot_ctx`` positions are read. B1:
row n attends keys ``< limit[n]`` (``min(seq_len, pos+1)``, inactive rows
clamped to 1 as in JAX). B9: query t of a W-token window sees keys
``< min(max(seq_len, 1), max(base_pos, 0) + 1 + t)``, so an inactive row
(``base_pos`` -1) still attends one key. ``v_pool=None`` means v is k (the
MLA shared variant; the kernel reads the k pointer twice). The TPU kernels'
K=1 sublane squeeze is a Mosaic tiling artifact and has no counterpart.

On Hopper a slot row is one page of ``max_seq_len`` tokens, so both wrappers
launch the paged decode kernel K1 (``csrc/attention.cu``) with the identity
table ``row = layer·N + b`` and p rounded to bf16 before the value product,
the B1 / B9 round point (``slot_attention.py:98`` / :178). B9 takes K1's
T-row mode: one block per (row, kv head, context split) holds all W·G query
rows of the window, so the window shares one read of the context, as B9
does on the TPU.
A block holds at most 64 query rows, so a longer window is split into pieces
of ⌊64/G⌋ queries, one launch each. B1's shared variant at MLA's latent
width (D = 576, one cache head, 128 or 64 query heads) is past K1's shapes:
:func:`slot_attention_latent` launches K3 instead (``latent_attention``,
one block per row and 16 heads, the value product over the first 512
columns only). For a CPU tensor each wrapper runs its plain version;
``launches`` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import torch

from .attention import NEG_INF


def _check_rows(B: int, n_rows: int) -> None:
    if B != n_rows:
        raise ValueError(f"slot attention needs B == n_rows ({B} vs {n_rows})")


def _slot_plain(q, k_pool, v_pool, limit, layer, n_rows: int, slot_ctx: int, scale):
    """q [B,T,H,D]; query t of row b attends keys ``< limit[b, t]`` of its
    slot row: float32 scores and softmax sum, p cast to the value dtype
    before PV, float32 accumulator."""
    B, T, H, D = q.shape
    _check_rows(B, n_rows)
    _, ps, K, _ = k_pool.shape
    v_pool = k_pool if v_pool is None else v_pool
    S = min(slot_ctx, ps)
    scale = scale if scale is not None else D ** -0.5
    rows = slice(int(layer) * n_rows, (int(layer) + 1) * n_rows)
    k = k_pool[rows, :S].float()
    v = v_pool[rows, :S]
    qg = (q.float() * scale).reshape(B, T, K, H // K, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k)
    key = torch.arange(S, device=q.device)
    mask = (key[None, None, :] < limit.long()[:, :, None])[:, None, None]   # [B,1,1,T,S]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    out = out / p.sum(-1).clamp(min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, H, D).to(q.dtype)


def slot_attention_plain(q, k_pool, v_pool, limit, layer, *, n_rows: int,
                         slot_ctx: int, scale: float | None = None, v_width=None):
    """Reference for B1 with the kernel's round points (``v_width``: the
    first ``v_width`` columns of the output)."""
    lim = limit.long().clamp(min=1)[:, None]
    return _slot_plain(q[:, None], k_pool, v_pool, lim, layer, n_rows, slot_ctx,
                       scale)[:, 0, ..., :v_width]


def slot_attention(q, k_pool, v_pool, limit, layer, *, n_rows: int, slot_ctx: int,
                   scale: float | None = None, v_width=None):
    """B1: q [B,H,D] (this step's queries), pools [L·N,ps,K,D] (``v_pool``
    None: v is k), limit [B] int, ``layer`` int → [B,H,D], or its first
    ``v_width`` columns. On the card v = k at MLA's latent width takes
    :func:`slot_attention_latent` (K3)."""
    _check_rows(q.shape[0], n_rows)
    if q.device.type == "cpu":
        return slot_attention_plain(q, k_pool, v_pool, limit, layer, n_rows=n_rows,
                                    slot_ctx=slot_ctx, scale=scale, v_width=v_width)
    from .paged_attention import HEAD_DIM, decode_attention_cuda

    if v_pool is None and q.shape[-1] != HEAD_DIM:
        return slot_attention_latent(q, k_pool, limit, layer, n_rows=n_rows,
                                     slot_ctx=slot_ctx, scale=scale, v_width=v_width)
    out = decode_attention_cuda(
        q[:, None], k_pool, k_pool if v_pool is None else v_pool, limit.long(),
        row_offset=int(layer) * n_rows, min_one=True,
        max_keys=min(int(slot_ctx), k_pool.shape[1]), scale=scale, p_bf16=True)
    slot_attention.launches += 1
    return out[:, 0, ..., :v_width]


slot_attention.launches = 0


def slot_attention_latent(q, pool, limit, layer, *, n_rows: int, slot_ctx: int,
                          scale: float | None = None, v_width=None):
    """B1's shared variant (``_slot_attn_kernel_shared``: v is k) at MLA's
    latent width: q [B,H,D], pool [L·N,ps,1,D], limit [B] → [B,H,v_width].
    On the card K3, which computes only the first ``LATENT_V`` (512)
    columns: ``v_width`` must be 512 there."""
    _check_rows(q.shape[0], n_rows)
    if q.device.type == "cpu":
        return slot_attention_plain(q, pool, None, limit, layer, n_rows=n_rows,
                                    slot_ctx=slot_ctx, scale=scale, v_width=v_width)
    from .paged_attention import LATENT_V, latent_attention_cuda

    if v_width != LATENT_V:
        raise ValueError(f"the latent slot kernel keeps v_width={LATENT_V} columns "
                         f"(got {v_width})")
    out = latent_attention_cuda(
        q.contiguous(), pool, limit.long(), row_offset=int(layer) * n_rows, min_one=True,
        max_keys=min(int(slot_ctx), pool.shape[1]), scale=scale, p_bf16=True)
    slot_attention_latent.launches += 1
    return out


slot_attention_latent.launches = 0


def _window_limits(seq_lens, base_pos, W: int):
    """[B, W] key limits of a verify window (JAX ``slot_attention.py:242-249``)."""
    cap = seq_lens.long().clamp(min=1)[:, None]
    t = torch.arange(1, W + 1, device=base_pos.device)[None, :]
    return torch.minimum(cap, base_pos.long().clamp(min=0)[:, None] + t)


def slot_window_attention_plain(q, k_pool, v_pool, seq_lens, base_pos, layer, *,
                                n_rows: int, slot_ctx: int, scale: float | None = None):
    """Reference for B9 with the kernel's round points."""
    return _slot_plain(q, k_pool, v_pool, _window_limits(seq_lens, base_pos, q.shape[1]),
                       layer, n_rows, slot_ctx, scale)


def slot_window_attention(q, k_pool, v_pool, seq_lens, base_pos, layer, *, n_rows: int,
                          slot_ctx: int, scale: float | None = None):
    """B9: q [B,W,H,D] (the verify window's queries, already written to the
    pools), pools [L·N,ps,K,D] (``v_pool`` None: v is k), seq_lens [B]
    (covering the window), base_pos [B] (position of window token 0; -1 on
    inactive rows), ``layer`` int → [B,W,H,D]."""
    _check_rows(q.shape[0], n_rows)
    if q.device.type == "cpu":
        return slot_window_attention_plain(q, k_pool, v_pool, seq_lens, base_pos, layer,
                                           n_rows=n_rows, slot_ctx=slot_ctx, scale=scale)
    from .paged_attention import MAX_QUERY_ROWS, decode_attention_cuda

    B, W, H, _ = q.shape
    q = q.contiguous()
    # K1 reads only column 0 of a piece's positions: base + the piece's offset
    qpos = base_pos.long().clamp(min=0)[:, None] + torch.arange(W, device=q.device)
    piece = max(1, MAX_QUERY_ROWS // (H // k_pool.shape[2]))
    v_pool = k_pool if v_pool is None else v_pool
    seq = seq_lens.long()
    outs = []
    for t0 in range(0, W, piece):
        outs.append(decode_attention_cuda(
            q[:, t0:t0 + piece], k_pool, v_pool, seq, q_positions=qpos[:, t0:t0 + piece],
            row_offset=int(layer) * n_rows, min_one=True,
            max_keys=min(int(slot_ctx), k_pool.shape[1]), scale=scale, p_bf16=True))
        slot_window_attention.launches += 1
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


slot_window_attention.launches = 0
