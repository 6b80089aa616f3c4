"""Causal flash attention for prefill (port of ``ops/flash_attention.py:73
flash_attention``, kernel B2).

Causal GQA over q [B,T,H,D] and k, v [B,S,K,D] with scale D^-½. The mask is
the TPU kernel's, **top-left aligned**: query t sees keys ``j <= t`` and
``j < S`` (``flash_attention.py:49``) — not the bottom-right ``tril(k=S-T)``
of :func:`.attention.causal_attention`. The two agree for T == S, the only
case the engine and the no-cache forward use.

For a CUDA tensor the wrapper launches K2 of ``csrc/attention.cu`` (bf16,
head_dim 128, ``G <= 128``: a warp-specialised ``wgmma`` kernel fed by
TMA loads through an ``mbarrier`` ring, 128 tile rows an item on two
consumer warpgroups, the G query heads of a kv head folded into the tile
rows, ``floor(128 / G)`` query positions an item, online softmax in
registers, one persistent block an SM taking (row, kv head, query block)
items longest first from a counter); for a CPU tensor it runs
:func:`flash_attention_plain`, which holds the TPU kernel's numerics:
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
does, unless every query of its block of ``floor(128 / G)`` positions is
padding: such a block sees no key and is 0 (JAX attends the prefix there;
no real token reads those rows). A whole padding row (``chunk_start <
0``) sees no key and is 0 (JAX averages stale values there). Its plain
version, :func:`flash_attention_paged_plain`, gathers the table's pages
and keeps JAX's round points (q scaled in its dtype, float32 scores and
softmax, p in v's dtype). On the card a plan kernel turns positions and
``seq_lens`` into each unit's key limit and a list of work items, a (row,
kv head, query block, key range) each, longest first (:func:`paged_plan`
is its model on the host); where few units would leave the card idle the
longest are cut into pieces whose float32 partials a merge kernel combines
(:func:`paged_merge`). ``flash_attention_paged.launches`` and
``paged_merge.launches`` count the launches.

Over int8 pages (``Engine(kv_quantize="int8")``) the paged mode takes the
pools' float32 scales (``k_scales`` / ``v_scales``, [N,ps,K]) and reads each
key and value as JAX's int8 branch of ``paged_attention`` dequantizes it
(``ops/attention.py:122-139``: ``(int8.float() * scale).to(q.dtype)``).
On the card this int8 paged mode is :func:`widen_kv_pages`, which widens
the pages of each row's keys into bf16 scratch pages, bit for bit the plain
path's values, then the bf16 paged mode over them; its plain version
gathers, dequantizes and attends as above.
``flash_attention_paged.i8_launches`` counts the widening launches.
"""
from __future__ import annotations

import torch

from .attention import NEG_INF, _query_blocks, dequant_context, gather_kv_rows

HEAD_DIM = 128
TILE_ROWS = 128     # folded query rows t·G + g of one K2 item (csrc: FBM)
KEY_TILE = 128      # keys of one K2 tile (csrc: FBN)
PLAN_HEADER = 8     # ints ahead of the plan's arrays (csrc: PLAN_HDR)
PIECE_MIN_TILES = 2   # a piece of a split unit holds at least 2 key tiles
PIECES_PER_SM = 2     # pieces hold at most total tiles / (2 · SMs) (csrc: PIECES_PER_SM)
SPLIT_UNITS_PER_SM = 4   # units are split only where fewer than 4 an SM
ORDER_BUCKETS = 4096     # items of 4095 key tiles and more share the plan's first bucket


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
    from .paged_attention import _lib, _sm_count

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
    counter = torch.empty(1, dtype=torch.int32, device=q.device)   # zeroed by the launch
    err = _lib().dstts_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H, K,
        float(scale), counter.data_ptr(), _sm_count(q.device),
        torch.cuda.current_stream(q.device).cuda_stream)
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


def query_block(G: int) -> int:
    """Query positions of one K2 item: ``floor(128 / G)``."""
    return TILE_ROWS // G


def paged_key_limits(seq_lens, q_positions, S: int, group: int = 1):
    """[B, T] exclusive key limit of each query of :func:`flash_attention_paged`
    (``group`` query heads a kv head): ``p + 1`` at position ``p >= 0``,
    ``chunk_start`` for a tail-padding query whose block of
    :func:`query_block` positions holds a real one, else 0; 0 in a row whose
    ``chunk_start < 0``; at most ``seq_lens[b]`` and ``S``."""
    pos = q_positions.long()
    B, T = pos.shape
    TQ = query_block(group)
    nqb = -(-T // TQ)
    real = pos >= 0
    blocks = torch.nn.functional.pad(real, (0, nqb * TQ - T)).view(B, nqb, TQ).any(-1)
    seen = blocks.repeat_interleave(TQ, 1)[:, :T]
    cs = pos[:, :1]
    lim = torch.where(real, pos + 1, torch.where(seen, cs, 0))
    lim = torch.minimum(lim, seq_lens.long()[:, None].clamp(max=S))
    return torch.where(cs >= 0, lim, 0).clamp(min=0)


def flash_attention_paged_plain(q, k_pages, v_pages, page_table, seq_lens, q_positions, *,
                                scale: float | None = None, k_scales=None, v_scales=None):
    """Reference for K2's paged mode: q [B,T,H,D] over the pages [N,ps,K,D]
    of the ``[B,P]`` table (layer offset applied) after the chunk's write,
    each query's keys ``< paged_key_limits(...)``; JAX's round points
    (``prefix_chunk_attention``) in query blocks. With ``k_scales`` /
    ``v_scales`` the int8 pages dequantized in q's dtype first (the int8
    branch of JAX's ``paged_attention``, whose ``masked_context_attention``
    has the same round points)."""
    B, T, H, D = q.shape
    _, ps, K, _ = k_pages.shape
    S = page_table.shape[1] * ps
    scale = scale if scale is not None else D ** -0.5
    if k_scales is not None:
        k = dequant_context(k_pages, k_scales, page_table, q.dtype)
        v = dequant_context(v_pages, v_scales, page_table, q.dtype)
    else:
        k = gather_kv_rows(k_pages, page_table).reshape(B, S, K, D)
        v = gather_kv_rows(v_pages, page_table).reshape(B, S, K, D)
    lim = paged_key_limits(seq_lens, q_positions, S, H // K)          # [B,T]
    key = torch.arange(S, device=q.device)

    def block(t0, t1):
        qs = (q[:, t0:t1] * scale).reshape(B, t1 - t0, K, H // K, D)
        s = torch.einsum("btkgd,bskd->bkgts", qs.float(), k.float())
        mask = (key[None, None, :] < lim[:, t0:t1, None])[:, None, None]   # [B,1,1,t,S]
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1) * mask
        out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
        return out.reshape(B, t1 - t0, H, D).to(q.dtype)

    return _query_blocks(q, S, block)


# ------------------------------------------------ the paged mode's work plan

def paged_splits_allowed(B: int, T: int, G: int, KV: int, S: int, sms: int) -> bool:
    """Whether the plan may cut a unit's keys into pieces, from static sizes
    alone: where the ``B·KV·ceil(T / query_block(G))`` units are fewer than
    ``SPLIT_UNITS_PER_SM`` an SM (a short follow-up chunk, a ragged group)
    and a row's ``S`` keys make more key tiles than a piece's least
    (``PIECE_MIN_TILES``: a unit must be longer than that to be cut); with
    more units the longest-first order balances them, and no merge runs."""
    return (B * KV * -(-T // query_block(G)) < SPLIT_UNITS_PER_SM * sms
            and -(-S // KEY_TILE) > PIECE_MIN_TILES)


def paged_plan_sizes(B: int, T: int, G: int, KV: int, sms: int, split: bool):
    """``(workspace ints, partial slots)`` of one call: the plan's header,
    four ints a split unit, each unit's limit and first slot, then from a
    16-byte boundary four ints an item (at most ``KV·U`` and, split, fewer
    than ``2·PIECES_PER_SM·sms`` pieces more); a slot holds one piece's
    partial rows."""
    U = B * -(-T // query_block(G))
    slots = 2 * PIECES_PER_SM * sms if split else 0
    return _items_at(U) + 4 * (KV * U + slots), slots


def _items_at(U: int) -> int:
    """Where the plan's items start in its workspace (ints; csrc: Plan)."""
    return -(-(PLAN_HEADER + 6 * U) // 4) * 4


def unit_pieces(tiles: int, C: int, thr: int) -> tuple[int, int]:
    """``(pieces, tiles a piece)`` of a unit of ``tiles`` key tiles: one
    piece up to ``thr`` tiles, else ``max(2, tiles // C)`` pieces of about
    ``C`` tiles or more, as evenly as whole tiles allow (none empty): all
    units' pieces number at most ``W / C``, so the split never makes more
    items than the card takes in ``PIECES_PER_SM`` rounds."""
    if tiles <= thr:
        return int(tiles > 0), tiles
    z = max(2, tiles // C)
    per = -(-tiles // z)
    return -(-tiles // per), per


def paged_plan(seq_lens, q_positions, S: int, G: int, KV: int, sms: int, split: bool) -> dict:
    """The host model of ``flash_paged_plan`` (``csrc/attention.cu``): units
    ``u = b·nqb + m`` (query block m of row b) end at ``ulim[u]``, the
    largest ``min(max(p + 1, chunk_start), seq_len, S)`` of their real
    queries (``p >= 0``, ``chunk_start >= 0``): the largest limit of
    :func:`paged_key_limits` over the unit where positions follow
    ``chunk_start``. A unit with ``ulim == 0`` (a padding row, a whole
    tail-padding block) takes no item and is written as zeros
    (``zero_units``). With ``W`` the key tiles of all units and kv heads
    and ``split``, a unit of more than ``thr = max(C, ceil(W / sms))``
    tiles (an SM's mean load) is cut into ``max(2, tiles // C)`` pieces
    (:func:`unit_pieces`), ``C = max(PIECE_MIN_TILES, ceil(W /
    (PIECES_PER_SM·sms)))``; every other unit is one piece. A split unit's
    pieces take partial slots ``(sbase[u] + z)·KV + kh`` in unit order.
    Items ``(b, m, kh, z, k0, kend, slot)`` (keys ``[k0, kend)``; slot -1:
    written out directly) come longest first (items of ``ORDER_BUCKETS -
    1`` tiles and more as one length); the kernel orders items of equal
    length in any order, this model by ``(u, kh, z)``."""
    pos = torch.as_tensor(q_positions).long().cpu()
    B, T = pos.shape
    TQ = query_block(G)
    nqb = -(-T // TQ)
    cs = pos[:, :1]
    cap = torch.as_tensor(seq_lens).long().cpu().clamp(max=S)[:, None]
    ul = torch.where((pos >= 0) & (cs >= 0), torch.minimum(torch.maximum(pos + 1, cs), cap), 0)
    padded = torch.nn.functional.pad(ul.clamp(min=0), (0, nqb * TQ - T))
    ulim = padded.view(B, nqb, TQ).amax(-1).reshape(-1).tolist()
    tiles = [-(-u // KEY_TILE) for u in ulim]
    W = KV * sum(tiles)
    C = max(PIECE_MIN_TILES, -(-W // (PIECES_PER_SM * sms)))
    thr = max(C, -(-W // sms)) if split else min(-(-S // KEY_TILE) + 1, ORDER_BUCKETS)
    items, sbase, split_units, slots = [], [], [], 0
    for u, (ul, t) in enumerate(zip(ulim, tiles)):
        z_u, per = unit_pieces(t, C, thr)
        sbase.append(slots if z_u > 1 else -1)
        if z_u > 1:
            split_units.append(u)
        for z in range(z_u):
            k0 = z * per * KEY_TILE
            kend = min(k0 + per * KEY_TILE, ul)
            for kh in range(KV):
                slot = (slots + z) * KV + kh if z_u > 1 else -1
                items.append((u // nqb, u % nqb, kh, z, k0, kend, slot))
        if z_u > 1:
            slots += z_u
    items.sort(key=lambda it: (-min(-(-(it[5] - it[4]) // KEY_TILE), ORDER_BUCKETS - 1),
                               it[0] * nqb + it[1], it[2], it[3]))
    return {"C": C, "thr": thr, "nqb": nqb, "ulim": ulim, "sbase": sbase,
            "split_units": split_units, "n_slots": slots * KV, "items": items,
            "zero_units": [(u // nqb, u % nqb) for u, ul in enumerate(ulim) if ul == 0]}


def _paged_args(q, k_pages, v_pages, page_table, seq_lens, q_positions, k_scales=None,
                v_scales=None):
    """Checks the paged mode's inputs; returns them as the kernel takes them."""
    from .fused_layer import _check, refuse_grad
    from .paged_attention import _check_index

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
    pool_dtype = torch.bfloat16 if k_scales is None else torch.int8
    _check("k_pages", k_pages, (R, ps, K, D), pool_dtype)
    _check("v_pages", v_pages, (R, ps, K, D), pool_dtype)
    if k_scales is not None:
        _check("k_scales", k_scales, (R, ps, K), torch.float32)
        _check("v_scales", v_scales, (R, ps, K), torch.float32)
        if k_scales.device != dev or v_scales.device != dev:
            raise ValueError("paged flash attention: q and the scales must share a device")
    if k_pages.device != dev or v_pages.device != dev:
        raise ValueError("paged flash attention: q and the pools must share a device")
    page_table, q_positions = page_table.long().contiguous(), q_positions.long().contiguous()
    seq_lens = seq_lens.long()
    _check_index("page_table", page_table, (B, page_table.shape[1]), dev)
    _check_index("seq_lens", seq_lens, (B,), dev)
    _check_index("q_positions", q_positions, (B, T), dev)
    return q, page_table, seq_lens, q_positions


def paged_plan_cuda(seq_lens, q_positions, S: int, G: int, KV: int, split: bool):
    """``flash_paged_plan`` alone on the card (the check of the kernel
    against :func:`paged_plan`): its workspace as a dict of CPU tensors,
    ``hdr`` (items, C, split units, counter, the split threshold),
    ``ulim``, ``sbase``, ``split_units`` [s, 4] (u, pieces, first slot, 0)
    and ``items`` [n, 4] (``u·KV + kh``, first key, key end, partial slot
    or -1)."""
    from .fused_layer import _raise_if
    from .paged_attention import _lib, _sm_count

    B, T = q_positions.shape
    dev = q_positions.device
    sms = _sm_count(dev)
    n, _ = paged_plan_sizes(B, T, G, KV, sms, split)
    ws = torch.empty(n, dtype=torch.int32, device=dev)
    err = _lib().dstts_flash_paged_plan(
        q_positions.long().contiguous().data_ptr(), seq_lens.long().contiguous().data_ptr(),
        B, T, S, G, KV, sms, int(split), ws.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "flash_paged_plan")
    ws = ws.cpu()
    U = B * -(-T // query_block(G))
    hdr = ws[:PLAN_HEADER]
    slist = ws[PLAN_HEADER:PLAN_HEADER + 4 * U].view(U, 4)[:int(hdr[2])]
    ulim, sbase = ws[PLAN_HEADER + 4 * U:PLAN_HEADER + 6 * U].view(2, U)
    return {"hdr": hdr, "ulim": ulim, "sbase": sbase, "split_units": slist,
            "items": ws[_items_at(U):_items_at(U) + 4 * int(hdr[0])].view(-1, 4)}


def flash_attention_paged(q, k_pages, v_pages, page_table, seq_lens, q_positions, *,
                          scale: float | None = None, k_scales=None, v_scales=None):
    """K2's paged mode: [B,T,H,D] queries of one prefill chunk over their
    rows' pages [N,ps,K,D] (``page_table`` [B,P], layer offset applied;
    the chunk's K/V already written), per-query key limits as
    :func:`paged_key_limits`. Returns [B,T,H,D]. On the card: bf16,
    head_dim 128, ``G <= 128``, and with more than one page a row ps a
    multiple of 8 (:func:`paged_pages_ok`). Three launches where
    :func:`paged_splits_allowed` (the plan, the attention kernel,
    :func:`paged_merge`), else two; nothing is read back to the host. With
    ``k_scales`` / ``v_scales`` ([N,ps,K] float32) over int8 pools: the
    int8 paged mode, :func:`widen_kv_pages` first (one launch more), then
    the same launches over its bf16 scratch pages."""
    if q.device.type == "cpu":
        return flash_attention_paged_plain(q, k_pages, v_pages, page_table, seq_lens,
                                           q_positions, scale=scale, k_scales=k_scales,
                                           v_scales=v_scales)
    from .fused_layer import _raise_if
    from .paged_attention import _lib, _sm_count

    q, page_table, seq_lens, q_positions = _paged_args(q, k_pages, v_pages, page_table,
                                                       seq_lens, q_positions, k_scales,
                                                       v_scales)
    B, T, H, D = q.shape
    R, ps, K, _ = k_pages.shape
    dev, P = q.device, page_table.shape[1]
    sms = _sm_count(dev)
    split = paged_splits_allowed(B, T, H // K, K, P * ps, sms)
    n_ws, n_slots = paged_plan_sizes(B, T, H // K, K, sms, split)
    ws = torch.empty(n_ws, dtype=torch.int32, device=dev)
    o_part = ml_part = None
    if split:
        o_part = torch.empty((n_slots * TILE_ROWS, D), dtype=torch.float32, device=dev)
        ml_part = torch.empty((n_slots * TILE_ROWS, 2), dtype=torch.float32, device=dev)
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = (None if o_part is None else o_part.data_ptr(),
             None if ml_part is None else ml_part.data_ptr())
    if k_scales is not None:
        # int8 pages: the rows' pages widened into bf16 scratch pages b·P + p
        k_pages, v_pages, page_table = widen_kv_pages(k_pages, v_pages, k_scales, v_scales,
                                                      page_table, seq_lens)
        R = B * P
    err = _lib().dstts_flash_attention_paged(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(), P,
        seq_lens.data_ptr(), q_positions.data_ptr(), out.data_ptr(), B, T, H, K, R, ps,
        float(scale), ws.data_ptr(), *parts, sms, int(split), stream)
    _raise_if(err, "flash_attention_paged")
    flash_attention_paged.launches += 1
    flash_attention_paged.i8_launches += k_scales is not None
    if split:
        paged_merge(o_part, ml_part, ws, out, K, sms)
    return out


flash_attention_paged.launches = flash_attention_paged.i8_launches = 0
def widen_kv_pages_plain(k_pages, v_pages, k_scales, v_scales, page_table, seq_lens):
    """Reference for :func:`widen_kv_pages`: every page of the table
    dequantized to bf16 as the plain path does (the kernel writes only the
    pages that hold a key below ``seq_lens``; the paged mode reads no
    other), as pages ``b·P + p``, and their table."""
    B, P = page_table.shape
    _, ps, K, D = k_pages.shape
    kw, vw = (dequant_context(pages, sc, page_table, torch.bfloat16).reshape(B * P, ps, K, D)
              for pages, sc in ((k_pages, k_scales), (v_pages, v_scales)))
    return kw, vw, torch.arange(B * P, device=k_pages.device).view(B, P)


def widen_kv_pages(k_pages, v_pages, k_scales, v_scales, page_table, seq_lens):
    """``widen_kv_pages``, the first launch of K2's int8 paged mode: the
    int8 pages [N,ps,K,D] that hold each row's keys below ``seq_lens``,
    dequantized as the plain path does (``(int8.float() * scale)`` rounded
    to bf16), into bf16 scratch pages ``b·P + p`` ([B·P,ps,K,D] for K and
    for V), and the table of them ([B,P] int64). Pages past a row's keys
    are left unwritten: the paged mode reads none of them. The scratch is
    allocated on each call (in a captured prefill, once, in the graph's
    pool). On the CPU: :func:`widen_kv_pages_plain`."""
    if k_pages.device.type == "cpu":
        return widen_kv_pages_plain(k_pages, v_pages, k_scales, v_scales, page_table, seq_lens)
    from .fused_layer import _raise_if
    from .paged_attention import _lib

    B, P = page_table.shape
    _, ps, K, D = k_pages.shape
    dev = k_pages.device
    kw = torch.empty((B * P, ps, K, D), dtype=torch.bfloat16, device=dev)
    vw = torch.empty_like(kw)
    wt = torch.empty((B, P), dtype=torch.long, device=dev)
    err = _lib().dstts_widen_kv_pages(
        k_pages.data_ptr(), v_pages.data_ptr(), k_scales.contiguous().data_ptr(),
        v_scales.contiguous().data_ptr(), page_table.data_ptr(), seq_lens.data_ptr(), B, P, ps,
        K, kw.data_ptr(), vw.data_ptr(), wt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "widen_kv_pages")
    return kw, vw, wt


def paged_merge(o_part, ml_part, ws, out, KV: int, sms: int) -> None:
    """``flash_paged_merge``: each split unit's rows of ``out`` [B,T,H,128]
    (``KV`` kv heads) from its pieces' float32 partials (``o_part``
    unnormalised, ``ml_part`` (m in log2 units, l)) as the plan in ``ws``
    lists them; a piece with m = -inf weighs nothing. Launched on the card
    after the attention kernel of the same call; ``paged_merge.launches``
    counts it."""
    from .fused_layer import _raise_if
    from .paged_attention import _lib

    B, T, H, _ = out.shape
    err = _lib().dstts_flash_paged_merge(
        o_part.data_ptr(), ml_part.data_ptr(), ws.data_ptr(), out.data_ptr(), B, T, H, KV, sms,
        torch.cuda.current_stream(out.device).cuda_stream)
    _raise_if(err, "flash_paged_merge")
    paged_merge.launches += 1


paged_merge.launches = 0
