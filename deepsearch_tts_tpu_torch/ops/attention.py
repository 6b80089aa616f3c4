"""Attention paths (port of ``ops/attention.py``).

In the JAX package these are XLA code on the default paged serving path:
fresh prefill runs :func:`causal_attention`, decode runs the gather branch
of :func:`paged_attention`, and re-prefill over a cached prefix runs
:func:`prefix_chunk_attention`; they are plain torch here. The ``impl``
switch selects the kernels exactly where JAX selects its Pallas ones:
``causal_attention(impl="pallas")`` runs flash attention (B2,
``ops/flash_attention.py``), and ``paged_attention`` with ``impl`` in
``{"pallas", "pallas2", "clamp"}`` runs the paged kernels (B6,
``ops/paged_attention.py``) at T=1. At T>1 this module stays on the
gather, as in JAX; the serving layer (``models/qwen3.py``) takes K2's
paged mode (``flash_attention.flash_attention_paged``) for re-prefill
with ``impl="pallas"`` instead of :func:`prefix_chunk_attention`, and
MLA's (``models/deepseek_v3.py``) K3's prefill mode
(``paged_attention.latent_prefill``) for its fresh prefill, re-prefill and
slot windows.

GQA is computed by reshaping query heads into [kv_heads, group], as in JAX.
Scores and softmax are float32; the value product takes the probabilities
in the value dtype with a float32 accumulator, like the JAX einsums.

Prefill attention materialises its float32 scores, so it runs over blocks
of query rows sized to keep one block's scores within ``SCORES_BUDGET``
elements: an 8192-token prompt would otherwise need [H, T, S] = 8.6 GB of
scores, several times over, on top of the weights and the KV pool.

int8 KV: :func:`paged_attention` given the scales pools gathers the int8
pages and their scales, dequantizes in float32, rounds to q's dtype and
runs :func:`masked_context_attention` (``attention.py:122-135``; plain XLA
code in JAX, whose Pallas kernels read its int32-packed pages as bf16 and
are never given them). With ``impl`` in ``{"pallas", "pallas2", "clamp"}``
a T=1 call passes the scales to the B6 entry, which runs K1's int8 mode
(the port packs no int8 pages); the serving layer takes K2's int8 paged
mode for re-prefill.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
SCORES_BUDGET = 1 << 28     # float32 score elements per query block (1 GiB)


def _query_blocks(q: torch.Tensor, S: int, fn) -> torch.Tensor:
    """``fn(t0, t1)`` over blocks of query rows whose [B, H, rows, S]
    scores fit ``SCORES_BUDGET``, concatenated on the query axis."""
    B, T, H, _ = q.shape
    rows = max(1, SCORES_BUDGET // (B * H * S))
    outs = [fn(t0, min(t0 + rows, T)) for t0 in range(0, T, rows)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,T,H,D], k: [B,S,K,D] → scores [B,K,G,T,S] (float32)."""
    B, T, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, T, K, H // K, D)
    return torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """probs: [B,K,G,T,S], v: [B,S,K,D] → [B,T,H,D]."""
    B, K, G, T, S = probs.shape
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, T, K * G, v.shape[-1]).to(dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, scale: float | None = None, impl: str = "xla",
                     ring_mesh=None, ring_axis: str = "tp",
                     inner_impl: str = "xla") -> torch.Tensor:
    """Full causal self-attention. q,k,v: [B,T,{H|K},D] → [B,T,H,D].
    ``impl="pallas"`` runs :func:`.flash_attention.flash_attention`.

    ``impl="ring"`` / ``"ulysses"`` with a ``ring_mesh`` run sequence-
    parallel attention over ``ring_axis`` (JAX ``attention.py:42-56``):
    q, k, v are then this rank's sequence shard, as the ``shard_map`` body
    of JAX's functions receives them (``ops/ring_attention.py``,
    ``ops/ulysses.py``; ``inner_impl`` is Ulysses' per-rank attention)."""
    if impl == "ring" and ring_mesh is not None:
        from .ring_attention import ring_attention

        return ring_attention(q, k, v, mesh=ring_mesh, axis=ring_axis, scale=scale)
    if impl == "ulysses" and ring_mesh is not None:
        from .ulysses import ulysses_attention

        return ulysses_attention(q, k, v, mesh=ring_mesh, axis=ring_axis, scale=scale,
                                 inner_impl=inner_impl)
    if impl == "pallas":
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, scale=scale)
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    T, S = q.shape[1], k.shape[1]
    key = torch.arange(S, device=q.device)[None, :]

    def block(t0, t1):
        scores = _gqa_scores(q[:, t0:t1] * scale, k)
        rows = torch.arange(t0, t1, device=q.device)[:, None]
        scores = scores.masked_fill(key > rows + (S - T), NEG_INF)
        return _gqa_out(torch.softmax(scores, dim=-1), v, q.dtype)

    return _query_blocks(q, S, block)


def gather_kv_rows(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``pool[table]``: [L·N, ps, K, D] pool, [B, P] table → [B, P, ps, K, D].

    The JAX version unrolls dynamic slices behind an optimization barrier to
    dodge a slow TPU gather; plain indexing is the gather here."""
    return pool[table.long()]


def dequant_context(pages: torch.Tensor, scales: torch.Tensor, page_table: torch.Tensor,
                    dtype) -> torch.Tensor:
    """The ``[B, P·ps, K, D]`` context of the table's int8 pages in
    ``dtype``: ``(int8.float() * scale).to(dtype)``, JAX's dequantization
    (``attention.py:134-135``)."""
    B, P = page_table.shape
    _, ps, K, D = pages.shape
    x = gather_kv_rows(pages, page_table).reshape(B, P * ps, K, D)
    s = gather_kv_rows(scales, page_table).reshape(B, P * ps, K, 1)
    return (x.float() * s).to(dtype)


def paged_attention(
    q: torch.Tensor,            # [B, T, H, D] current-chunk queries
    k_pages: torch.Tensor,      # [N, ps, K, D] pages (flattened all-layer pool)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # [B, P] int page ids (already layer-offset)
    seq_lens: torch.Tensor,     # [B] valid tokens incl. the current chunk
    q_positions: torch.Tensor,  # [B, T] absolute position of each query
    *, scale: float | None = None, mask: torch.Tensor | None = None,
    impl: str = "xla",
    k_scales: torch.Tensor | None = None,   # [N, ps, K] int8-KV scales
    v_scales: torch.Tensor | None = None,
    v_width: int | None = None,
) -> torch.Tensor:
    """Attend queries over their sequence's paged KV (causal by position).

    The chunk's own KV must already be written to the pages. At T=1,
    ``impl`` "pallas" / "pallas2" / "clamp" runs ``pallas_paged_attention``
    / ``pallas_paged_decode`` / ``pallas_paged_decode_clamp`` (B6).
    Otherwise it gathers the table's pages — int8 pages dequantized with
    their scales — and runs :func:`masked_context_attention`, the XLA
    reference branch of the JAX function; T>1 always takes it, as in JAX.
    ``mask`` is :func:`context_mask` of the same arguments, when the caller
    already has it (it is the same for every layer). ``v_width``: only the
    first ``v_width`` columns of v and of the output (MLA's latent pool,
    passed as both k and v: the gather then reads them alone). With
    ``k_scales`` / ``v_scales`` the pages are int8: a kernel ``impl`` at T=1
    hands the scales to the B6 entry (K1's int8 mode), the gather
    dequantizes them."""
    if impl in ("pallas", "pallas2", "clamp") and q.shape[1] == 1:
        from . import paged_attention as pa

        kw = dict(scale=scale, v_width=v_width, k_scales=k_scales, v_scales=v_scales)
        if impl == "clamp":
            return pa.pallas_paged_decode_clamp(q, k_pages, v_pages, page_table,
                                                seq_lens, **kw)
        if impl == "pallas2":
            return pa.pallas_paged_decode(q, k_pages, v_pages, page_table, seq_lens, **kw)
        return pa.pallas_paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                                         q_positions, **kw)
    B, T, H, D = q.shape
    _, ps, K, _ = k_pages.shape
    S = page_table.shape[1] * ps
    if k_scales is not None:
        k_ctx = dequant_context(k_pages, k_scales, page_table, q.dtype)
        v_ctx = dequant_context(v_pages, v_scales, page_table, q.dtype)
    else:
        k_ctx = gather_kv_rows(k_pages, page_table).reshape(B, S, K, D)
        v_ctx = gather_kv_rows(v_pages[..., :v_width], page_table).reshape(B, S, K, -1)
    return masked_context_attention(q, k_ctx, v_ctx, seq_lens, q_positions,
                                    scale=scale, mask=mask)


def prefix_chunk_attention(
    q: torch.Tensor,            # [B, T, H, D] this chunk's queries
    k_old: torch.Tensor,        # [B, S, K, D] gathered cache (stale at
    v_old: torch.Tensor,        #   positions >= chunk_start — masked off)
    k_new: torch.Tensor,        # [B, T, K, D] this chunk's keys/values
    v_new: torch.Tensor,
    chunk_start: torch.Tensor,  # [B] first position of the chunk
    q_positions: torch.Tensor,  # [B, T] absolute positions; <0 = padding
    *, scale: float | None = None,
) -> torch.Tensor:
    """Re-prefill attention: cached prefix + the chunk itself, softmaxed
    jointly. The cache part is read before the chunk's KV is written; keys
    at positions >= chunk_start are masked off and replaced by the chunk's
    own keys, so the math does not depend on that order."""
    B, T, H, D = q.shape
    S = k_old.shape[1]
    scale = scale if scale is not None else D ** -0.5
    kpos_old = torch.arange(S, device=q.device)[None, :].expand(B, S)
    m_old = (kpos_old < chunk_start[:, None])[:, None, None, None, :]
    kpos_new = q_positions[:, None, :]

    def block(t0, t1):
        qs = q[:, t0:t1] * scale
        s_old = _gqa_scores(qs, k_old)                  # [B,K,G,t,S]
        s_new = _gqa_scores(qs, k_new)                  # [B,K,G,t,T]
        m_new = ((kpos_new <= q_positions[:, t0:t1, None])
                 & (kpos_new >= 0))[:, None, None, :, :]
        s = torch.cat([s_old.masked_fill(~m_old, NEG_INF),
                       s_new.masked_fill(~m_new, NEG_INF)], dim=-1)
        probs = torch.softmax(s, dim=-1)
        out = _gqa_out(probs[..., :S], v_old, torch.float32) \
            + _gqa_out(probs[..., S:], v_new, torch.float32)
        return out.to(q.dtype)

    return _query_blocks(q, S + T, block)


def context_mask(seq_lens: torch.Tensor, q_positions: torch.Tensor, S: int
                 ) -> torch.Tensor:
    """[B,1,1,T,S] mask of :func:`masked_context_attention`: context
    position < seq_len and <= the query's position."""
    ctx_pos = torch.arange(S, device=q_positions.device)[None, :]
    valid = ctx_pos < seq_lens[:, None]                      # [B,S]
    causal = ctx_pos[:, None, :] <= q_positions[:, :, None]  # [B,T,S]
    return (valid[:, None, :] & causal)[:, None, None, :, :]


def masked_context_attention(
    q: torch.Tensor,        # [B, T, H, D]
    k_ctx: torch.Tensor,    # [B, S, K, D] each row's own context
    v_ctx: torch.Tensor,
    seq_lens: torch.Tensor,
    q_positions: torch.Tensor,
    *, scale: float | None = None, mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal + length-masked GQA over per-row context buffers, in query
    blocks (a re-prefill over an int8 cache takes this path for the whole
    prompt)."""
    B, T, H, D = q.shape
    S = k_ctx.shape[1]
    scale = scale if scale is not None else D ** -0.5
    if mask is None:
        mask = context_mask(seq_lens, q_positions, S)

    def block(t0, t1):
        scores = _gqa_scores(q[:, t0:t1] * scale, k_ctx)     # [B,K,G,t,S]
        scores = scores.masked_fill(~mask[..., t0:t1, :], NEG_INF)
        return _gqa_out(torch.softmax(scores, dim=-1), v_ctx, q.dtype)

    return _query_blocks(q, S, block)
