"""Causal flash attention for prefill (port of ``ops/flash_attention.py:73
flash_attention``, kernel B2).

Causal GQA over q [B,T,H,D] and k, v [B,S,K,D] with scale D^-½. The mask is
the TPU kernel's, **top-left aligned**: query t sees keys ``j <= t`` and
``j < S`` (``flash_attention.py:49``) — not the bottom-right ``tril(k=S-T)``
of :func:`.attention.causal_attention`. The two agree for T == S, the only
case the engine and the no-cache forward use.

For a CUDA tensor the wrapper launches K2 of ``csrc/attention.cu`` (bf16,
head_dim 128, ``G <= 128``: a warp-specialised ``wgmma`` kernel fed by
TMA loads through an ``mbarrier`` ring, 128 tile rows a block on two
consumer warpgroups, the G query heads of a kv head folded into the tile
rows, ``floor(128 / G)`` query positions a block, online softmax in
registers); for a CPU tensor it
runs :func:`flash_attention_plain`, which holds the TPU kernel's numerics:
q scaled in float32, float32 scores, p kept in float32 for the value
product (the kernel rounds p to bf16 for its mma operand, within the bf16
tolerance). ``flash_attention.launches`` counts kernel launches.

:func:`flash_attention_paged` is K2's paged mode: a prefill chunk over its
row's pages after the chunk's own K/V was written to them — JAX's
re-prefill over a cached prefix (``ops/attention.py:167
prefix_chunk_attention``, XLA code in JAX, which reads the prefix before
the write and the chunk's keys from registers; the two agree because the
stored keys are the chunk's own and padding writes are dropped). Query t
of row b at position ``p = q_positions[b, t]`` sees keys ``j <= p`` (and
``j < seq_lens[b]``); a tail-padding query (``p < 0``) sees the cached
prefix, keys ``j < chunk_start = q_positions[b, 0]``, as JAX's old-key mask
does; a whole padding row (``chunk_start < 0``) sees no key and is 0 (JAX
averages stale values there; no result reads that row). Its plain version,
:func:`flash_attention_paged_plain`, gathers the table's pages and keeps
JAX's round points (q scaled in its dtype, float32 scores and softmax, p
in v's dtype). ``flash_attention_paged.launches`` counts its launches.
"""
from __future__ import annotations

import torch

from .attention import NEG_INF, _query_blocks, gather_kv_rows

HEAD_DIM = 128
TILE_ROWS = 128     # folded query rows t·G + g of one K2 block (csrc: FBM)


def flash_attention_plain(q, k, v, *, scale: float | None = None):
    """Reference for B2: [B,T,H,D] causal (top-left) GQA attention."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    kf, vf = k.float(), v.float()
    key = torch.arange(S, device=q.device)[None, :]

    def block(t0, t1):
        qs = (q[:, t0:t1].float() * scale).reshape(B, t1 - t0, K, H // K, D)
        s = torch.einsum("btkgd,bskd->bkgts", qs, kf)
        mask = key <= torch.arange(t0, t1, device=q.device)[:, None]     # [t,S]
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        out = torch.einsum("bkgts,bskd->btkgd", p, vf)
        out = out / p.sum(-1).clamp(min=1e-30).permute(0, 3, 1, 2)[..., None]
        return out.reshape(B, t1 - t0, H, D).to(q.dtype)

    return _query_blocks(q, S, block)


def flash_attention(q, k, v, *, scale: float | None = None):
    """B2: causal flash attention with GQA. Returns [B,T,H,D]."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale)
    from .fused_layer import _check, _raise_if
    from .paged_attention import _lib

    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if D != HEAD_DIM or H % K or H // K > TILE_ROWS or T < 1 or S < 1:
        raise ValueError(f"flash attention kernel needs head_dim={HEAD_DIM}, H % K == 0, "
                         f"H/K <= {TILE_ROWS} and T, S >= 1 (got D={D}, H={H}, K={K}, "
                         f"T={T}, S={S})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check("q", q, (B, T, H, D))
    _check("k", k, (B, S, K, D))
    _check("v", v, (B, S, K, D))
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    err = _lib().dstts_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H, K,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def paged_pages_ok(ps: int, pages: int) -> bool:
    """Whether K2's paged mode takes pages of ``ps`` keys, ``pages`` a row:
    each TMA box of 64, 32, 16 or 8 keys lies in one page, so ps is a
    multiple of 8; a row of one page (a slot row) takes any ps (a box that
    runs past it reads only keys past every limit)."""
    return pages == 1 or ps % 8 == 0


def paged_key_limits(seq_lens, q_positions, S: int):
    """[B, T] exclusive key limit of each query of :func:`flash_attention_paged`:
    ``p + 1`` at position ``p >= 0``, ``chunk_start`` for a tail-padding
    query, 0 in a row whose ``chunk_start < 0``; at most ``seq_lens[b]`` and
    ``S``."""
    pos = q_positions.long()
    cs = pos[:, :1]
    lim = torch.where(pos >= 0, pos + 1, cs)
    lim = torch.minimum(lim, seq_lens.long()[:, None].clamp(max=S))
    return torch.where(cs >= 0, lim, 0).clamp(min=0)


def flash_attention_paged_plain(q, k_pages, v_pages, page_table, seq_lens, q_positions, *,
                                scale: float | None = None):
    """Reference for K2's paged mode: q [B,T,H,D] over the pages [N,ps,K,D]
    of the ``[B,P]`` table (layer offset applied) after the chunk's write,
    each query's keys ``< paged_key_limits(...)``; JAX's round points
    (``prefix_chunk_attention``) in query blocks."""
    B, T, H, D = q.shape
    _, ps, K, _ = k_pages.shape
    S = page_table.shape[1] * ps
    scale = scale if scale is not None else D ** -0.5
    k = gather_kv_rows(k_pages, page_table).reshape(B, S, K, D)
    v = gather_kv_rows(v_pages, page_table).reshape(B, S, K, D)
    lim = paged_key_limits(seq_lens, q_positions, S)                 # [B,T]
    key = torch.arange(S, device=q.device)

    def block(t0, t1):
        qs = (q[:, t0:t1] * scale).reshape(B, t1 - t0, K, H // K, D)
        s = torch.einsum("btkgd,bskd->bkgts", qs.float(), k.float())
        mask = (key[None, None, :] < lim[:, t0:t1, None])[:, None, None]   # [B,1,1,t,S]
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1) * mask
        out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
        return out.reshape(B, t1 - t0, H, D).to(q.dtype)

    return _query_blocks(q, S, block)


def flash_attention_paged(q, k_pages, v_pages, page_table, seq_lens, q_positions, *,
                          scale: float | None = None):
    """K2's paged mode: [B,T,H,D] queries of one prefill chunk over their
    rows' pages [N,ps,K,D] (``page_table`` [B,P], layer offset applied;
    the chunk's K/V already written), per-query key limits as
    :func:`paged_key_limits`. Returns [B,T,H,D]. On the card: bf16,
    head_dim 128, ``G <= 128``, and with more than one page a row ps a
    multiple of 8 (:func:`paged_pages_ok`)."""
    if q.device.type == "cpu":
        return flash_attention_paged_plain(q, k_pages, v_pages, page_table, seq_lens,
                                           q_positions, scale=scale)
    from .fused_layer import _check, _raise_if, refuse_grad
    from .paged_attention import _check_index, _lib

    refuse_grad("flash_attention_paged q", q)
    B, T, H, D = q.shape
    R, ps, K, _ = k_pages.shape
    dev = q.device
    if D != HEAD_DIM or H % K or H // K > TILE_ROWS or T < 1:
        raise ValueError(f"paged flash attention kernel needs head_dim={HEAD_DIM}, H % K == 0, "
                         f"H/K <= {TILE_ROWS} and T >= 1 (got D={D}, H={H}, K={K}, T={T})")
    if not paged_pages_ok(ps, page_table.shape[1]):
        raise ValueError(f"paged flash attention kernel needs ps % 8 == 0 with more than one "
                         f"page a row (got ps={ps}, {page_table.shape[1]} pages)")
    q = q.contiguous()
    _check("q", q, (B, T, H, D))
    _check("k_pages", k_pages, (R, ps, K, D))
    _check("v_pages", v_pages, (R, ps, K, D))
    if k_pages.device != dev or v_pages.device != dev:
        raise ValueError("paged flash attention: q and the pools must share a device")
    page_table, q_positions = page_table.long().contiguous(), q_positions.long().contiguous()
    seq_lens = seq_lens.long()
    P = page_table.shape[1]
    _check_index("page_table", page_table, (B, P), dev)
    _check_index("seq_lens", seq_lens, (B,), dev)
    _check_index("q_positions", q_positions, (B, T), dev)
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    err = _lib().dstts_flash_attention_paged(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(), P,
        seq_lens.data_ptr(), q_positions.data_ptr(), out.data_ptr(), B, T, H, K, R, ps,
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "flash_attention_paged")
    flash_attention_paged.launches += 1
    return out


flash_attention_paged.launches = 0
