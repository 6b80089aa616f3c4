"""Attention over a paged KV cache (port of ``ops/paged_attention.py``, B6).

Three entry points, each a Pallas kernel in the JAX package:

* :func:`pallas_paged_attention` — a T-token query chunk over the pages of a
  ``[B, P]`` table, causal by absolute position (query t of row b sits at
  ``q_positions[b, 0] + t``: the chunk is contiguous, as the TPU kernel
  assumes), keys ``< seq_len``.
* :func:`pallas_paged_decode` and :func:`pallas_paged_decode_clamp` — the
  same math at T=1, keys ``< seq_len``. On the TPU they differ only in how
  pages reach VMEM.

On Hopper all three launch one kernel, ``decode_attention`` in
``csrc/attention.cu`` (K1), which also serves the slot cache
(:mod:`.slot_attention`): one block per (row, kv head, context split)
walks its chunk of that row's pages up to the row's own limit, on the
tensor cores, and a small kernel merges the splits' partials. The split
(:func:`decode_splits`) is chosen from static sizes and the card's SM count
only. For a CPU tensor
each wrapper runs its plain version (``*_plain``), which holds the TPU
kernel's round points: float32
scores and softmax, and p kept in float32 for the value product
(``paged_attention.py:106``). Each wrapper counts its kernel launches in
its ``launches`` attribute.

MLA (``models/deepseek_v3.py``) calls the entries with the latent pool as
both k and v (``v_pages is k_pages``) at D = 576 and keeps the first
``v_width`` = 512 columns. K1 is written for D = 128 and 64 query rows a
block; MLA has 128 or 64 query heads over one cache head. On the card those
calls take K3 (``latent_attention`` in ``csrc/attention.cu``) through
:func:`paged_attention_latent`, which counts them; K3 computes only the
``v_width`` columns, 64 query heads a block on ``wgmma`` over TMA tiles,
the context split as :func:`latent_splits` chooses.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .attention import NEG_INF, gather_kv_rows

HEAD_DIM = 128        # head width the kernels are written for
MAX_QUERY_ROWS = 64   # T·H/K query rows one K1 block holds
KEY_TILE = 64         # keys of one K1 pipeline stage (csrc: DBK)
MIN_CHUNK_TILES = 4   # a K1 split holds at least 256 keys
BLOCKS_PER_SM = 2     # K1 blocks resident on one SM (its 104.4 KB ring)
LATENT_DIM = 576      # K3's row: DeepSeek-V3 / Kimi-K2 kv_lora_rank 512 + rope 64
LATENT_V = 512        # K3's value columns (kv_lora_rank)
LATENT_HEADS = 64     # query heads one K3 block holds: one wgmma m64 tile
LATENT_MIN_CHUNK_TILES = 4   # a K3 split holds at least 256 keys


# ----------------------------------------------------------------- plain torch

def _paged_plain(q, k_pages, v_pages, page_table, seq_lens, qpos0, scale, v_width=None):
    """Query t of row b attends keys ``< min(seq_len, qpos0 + t + 1)`` of
    the row's gathered pages; float32 scores, softmax and value product.
    ``v_width``: only the first ``v_width`` columns of v (and of the
    output)."""
    B, T, H, D = q.shape
    _, ps, K, _ = k_pages.shape
    S = page_table.shape[1] * ps
    scale = scale if scale is not None else D ** -0.5
    k = gather_kv_rows(k_pages, page_table).reshape(B, S, K, D).float()
    v = gather_kv_rows(v_pages[..., :v_width], page_table).reshape(B, S, K, -1).float()
    qg = (q.float() * scale).reshape(B, T, K, H // K, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k)
    key = torch.arange(S, device=q.device)
    lim = torch.minimum(seq_lens.long()[:, None],
                        qpos0.long()[:, None] + torch.arange(1, T + 1, device=q.device))
    mask = key[None, None, :] < lim[:, :, None]                     # [B,T,S]
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask[:, None, None], torch.exp(s - m), 0.0)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    out = out / p.sum(-1).clamp(min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, H, -1).to(q.dtype)


def pallas_paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                                 q_positions, *, scale=None, v_width=None):
    """Reference for :func:`pallas_paged_attention` (``_paged_kernel``)."""
    return _paged_plain(q, k_pages, v_pages, page_table, seq_lens,
                        q_positions[:, 0], scale, v_width)


def pallas_paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens, *,
                              scale=None, v_width=None):
    """Reference for :func:`pallas_paged_decode` (``_paged_decode_kernel``):
    T=1, keys ``< seq_len``."""
    if q.shape[1] != 1:
        raise ValueError(f"the paged decode entries take T=1, got T={q.shape[1]}")
    return _paged_plain(q, k_pages, v_pages, page_table, seq_lens,
                        seq_lens.long() - 1, scale, v_width)


def pallas_paged_decode_clamp_plain(q, k_pages, v_pages, page_table, seq_lens, *,
                                    scale=None, v_width=None):
    """Reference for :func:`pallas_paged_decode_clamp`
    (``_clamped_decode_kernel``): the same math as the decode kernel."""
    return pallas_paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens,
                                     scale=scale, v_width=v_width)


# ----------------------------------------------------- K1's split of the context

def _context_splits(base: int, fill: int, s_max: int, min_tiles: int) -> tuple[int, int]:
    """``(splits, chunk)`` for ``base`` blocks a split on a card that
    ``fill`` resident blocks fill: one split where ``base`` already fills
    it, otherwise enough to reach twice that, with chunks of whole key
    tiles and at least ``min_tiles`` of them; the chunks cover ``s_max``
    and none lies wholly past it."""
    tiles = max(1, -(-s_max // KEY_TILE))
    want = 1 if base >= fill else -(-2 * fill // base)
    s = max(1, min(want, tiles // min_tiles))
    per = -(-tiles // s)
    return -(-tiles // per), per * KEY_TILE


def decode_splits(B: int, KV: int, s_max: int, sms: int) -> tuple[int, int]:
    """``(splits, chunk)``: K1 cuts each row's context of at most ``s_max``
    keys into ``splits`` chunks of ``chunk`` keys, one block each, from
    static sizes alone (``seq_lens`` lie on the card and are never read
    here) on a card of ``sms`` SMs. One split where the ``B·KV`` blocks
    already fill it (``BLOCKS_PER_SM`` on each SM); otherwise enough to
    reach twice that, with chunks of whole key tiles and at least
    ``MIN_CHUNK_TILES`` of them; the chunks cover ``s_max`` and none lies
    wholly past it."""
    return _context_splits(B * KV, BLOCKS_PER_SM * sms, s_max, MIN_CHUNK_TILES)


def latent_splits(B: int, head_tiles: int, s_max: int, sms: int) -> tuple[int, int]:
    """``(splits, chunk)`` of K3 as :func:`decode_splits` chooses K1's, with
    the ``B·head_tiles`` blocks of 64 query heads in place of ``B·KV``, one
    block an SM (K3's 226 KB of shared memory) and chunks of at least
    ``LATENT_MIN_CHUNK_TILES`` key tiles: a split's float32 partial (64 ×
    512 × 4 B) is large next to its keys (256 keys × 1152 B)."""
    return _context_splits(B * head_tiles, sms, s_max, LATENT_MIN_CHUNK_TILES)


# ------------------------------------------------------------------- kernel K1

@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(dev) -> int:
    """Streaming multiprocessors of CUDA device ``dev`` (a static property,
    read once per card: no host sync)."""
    return _sm_count_of(dev.index if dev.index is not None else torch.cuda.current_device())


def _lib():
    from ._build import load_library

    lib = load_library("attention")
    if not getattr(lib, "_dstts_typed", False):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.dstts_decode_attention.argtypes = [p, ll, p, p, p, i, ll, p, p, i, i, i,
                                               p, i, i, i, i, i, f, i, i, i, p, p, p]
        lib.dstts_decode_attention.restype = i
        lib.dstts_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
        lib.dstts_flash_attention.restype = i
        lib.dstts_latent_attention.argtypes = [p, p, p, i, ll, p, p, i, i, i, p, i, i, ll,
                                               i, f, i, i, i, p, p, p]
        lib.dstts_latent_attention.restype = i
        lib.dstts_attention_occupancy.argtypes = [p]
        lib.dstts_attention_occupancy.restype = i
        lib._dstts_typed = True
    return lib


def attention_occupancy() -> dict:
    """Blocks an SM holds of each attention kernel, as the CUDA runtime
    computes them from registers, threads and shared memory (the build's
    ``-Xptxas -v`` report gives the registers)."""
    from .fused_layer import _raise_if

    out = (ctypes.c_int * 6)()
    _raise_if(_lib().dstts_attention_occupancy(out), "attention_occupancy")
    names = ("K1 (1 m-tile)", "K1 (2 m-tiles)", "K1 (4 m-tiles)", "K2", "K3 (bf16 p)",
             "K3 (float32 p)")
    return dict(zip(names, out))


def _check_index(name: str, t: torch.Tensor, shape: tuple, dev) -> None:
    if t.device != dev or t.dtype != torch.int64 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected int64 {tuple(shape)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")


def decode_attention_cuda(q, k_pool, v_pool, seq_lens, *, page_table=None,
                          row_offset: int = 0, q_positions=None, min_one=False,
                          max_keys: int | None = None, scale=None, p_bf16=False):
    """Launch K1. q [B,T,H,128] bf16 (any batch stride, the rest
    contiguous); pools [R,ps,K,128] bf16 (``v_pool`` may be ``k_pool``);
    ``page_table`` [B,P] int64 (None: the identity table, row
    ``row_offset + b``); seq_lens [B] int64; ``q_positions`` [B,T] int64
    (None: keys ``< seq_len`` at T=1). Query t of row b sees keys
    ``< min(seq_len (>= 1 if min_one), q_positions[b,0] + t + 1,
    max_keys)``. Returns [B,T,H,128] bf16."""
    from .fused_layer import _check, _raise_if

    B, T, H, D = q.shape
    R, ps, K, _ = k_pool.shape
    dev = q.device
    if D != HEAD_DIM or H % K or T * (H // K) > MAX_QUERY_ROWS:
        raise ValueError(f"decode attention kernel needs head_dim={HEAD_DIM} and "
                         f"T*H/K <= {MAX_QUERY_ROWS} (got D={D}, T={T}, H={H}, K={K})")
    if dev.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError(f"q: expected a CUDA bfloat16 tensor, got {q.dtype} on {dev}")
    if q.stride(3) != 1 or q.stride(2) != D or (T > 1 and q.stride(1) != H * D):
        raise ValueError(f"q: dimensions 1-3 must be contiguous, got strides {q.stride()}")
    _check("k_pool", k_pool, (R, ps, K, D))
    _check("v_pool", v_pool, (R, ps, K, D))
    if v_pool.device != dev or k_pool.device != dev:
        raise ValueError("decode attention: q and the pools must share a device")
    _check_index("seq_lens", seq_lens, (B,), dev)
    P = 1
    if page_table is not None:
        P = page_table.shape[1]
        _check_index("page_table", page_table, (B, P), dev)
        if not page_table.is_contiguous():
            raise ValueError("page_table: must be contiguous")
    qpos_stride = 0
    if q_positions is not None:
        _check_index("q_positions", q_positions, (B, T), dev)
        qpos_stride = q_positions.stride(0)
    elif T != 1:
        raise ValueError("decode attention without q_positions takes T=1")
    if max_keys is None:
        max_keys = P * ps
    scale = scale if scale is not None else D ** -0.5
    splits, chunk = decode_splits(B, K, min(int(max_keys), P * ps), _sm_count(dev))
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=dev)
    o_part = ml_part = None
    if splits > 1:
        rows = B * K * splits * T * (H // K)
        o_part = torch.empty((rows, D), dtype=torch.float32, device=dev)
        ml_part = torch.empty((rows, 2), dtype=torch.float32, device=dev)
    err = _lib().dstts_decode_attention(
        q.data_ptr(), q.stride(0), k_pool.data_ptr(), v_pool.data_ptr(),
        None if page_table is None else page_table.data_ptr(), P, int(row_offset),
        seq_lens.data_ptr(), None if q_positions is None else q_positions.data_ptr(),
        qpos_stride, int(bool(min_one)), int(max_keys), out.data_ptr(), B, T, H, K,
        ps, float(scale), int(bool(p_bf16)), splits, chunk,
        None if o_part is None else o_part.data_ptr(),
        None if ml_part is None else ml_part.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "decode_attention")
    return out


# ------------------------------------------------------------------- kernel K3

def latent_attention_cuda(q, pool, seq_lens, *, page_table=None, row_offset: int = 0,
                          q_positions=None, min_one=False, max_keys: int | None = None,
                          scale=None, p_bf16=False):
    """Launch K3. q [B,H,576] bf16 (H a multiple of 64); pool [R,ps,1,576]
    bf16, both k and v (MLA's latent rows); ``page_table`` [B,P] int64
    (None: the identity table, row ``row_offset + b``; with a table, ps a
    multiple of 64 or a multiple of 8 dividing 64: a 64-key tile is whole
    pages); seq_lens [B] int64; ``q_positions`` [B,1] int64 or None. Row
    b's heads see keys ``< min(seq_len (>= 1 if min_one), q_positions[b,0]
    + 1, max_keys)``. The context is split as :func:`latent_splits` says.
    Returns [B,H,512] bf16: the value product over the latent columns only
    (the 64 rope columns of v are never used by MLA)."""
    from .fused_layer import _check, _raise_if

    B, H, D = q.shape
    R, ps, K, _ = pool.shape
    dev = q.device
    if D != LATENT_DIM or K != 1 or H % LATENT_HEADS:
        raise ValueError(f"latent attention kernel needs D={LATENT_DIM}, one cache head "
                         f"and H % {LATENT_HEADS} == 0 (got D={D}, K={K}, H={H})")
    _check("q", q, (B, H, D))
    _check("pool", pool, (R, ps, 1, D))
    if pool.device != dev:
        raise ValueError("latent attention: q and the pool must share a device")
    _check_index("seq_lens", seq_lens, (B,), dev)
    P = 1
    if page_table is not None:
        if ps % KEY_TILE and (KEY_TILE % ps or ps % 8):
            raise ValueError(f"latent attention kernel over a page table needs ps % "
                             f"{KEY_TILE} == 0 or ps a multiple of 8 dividing {KEY_TILE} "
                             f"(got ps={ps})")
        P = page_table.shape[1]
        _check_index("page_table", page_table, (B, P), dev)
        if not page_table.is_contiguous():
            raise ValueError("page_table: must be contiguous")
    qpos_stride = 0
    if q_positions is not None:
        _check_index("q_positions", q_positions, (B, 1), dev)
        qpos_stride = q_positions.stride(0)
    if max_keys is None:
        max_keys = P * ps
    scale = scale if scale is not None else D ** -0.5
    splits, chunk = latent_splits(B, H // LATENT_HEADS, min(int(max_keys), P * ps),
                                  _sm_count(dev))
    out = torch.empty((B, H, LATENT_V), dtype=q.dtype, device=dev)
    o_part = ml_part = None
    if splits > 1:
        o_part = torch.empty((B * splits * H, LATENT_V), dtype=torch.float32, device=dev)
        ml_part = torch.empty((B * splits * H, 2), dtype=torch.float32, device=dev)
    err = _lib().dstts_latent_attention(
        q.data_ptr(), pool.data_ptr(), None if page_table is None else page_table.data_ptr(),
        P, int(row_offset), seq_lens.data_ptr(),
        None if q_positions is None else q_positions.data_ptr(), qpos_stride,
        int(bool(min_one)), int(max_keys), out.data_ptr(), B, H, R, ps, float(scale),
        int(bool(p_bf16)), splits, chunk, None if o_part is None else o_part.data_ptr(),
        None if ml_part is None else ml_part.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "latent_attention")
    return out


def _latent_kernel(q, k_pages, v_pages, v_width) -> bool:
    """Whether a CUDA call of a B6 entry takes K3: v is k at a width other
    than K1's (raises where K3 cannot take it either)."""
    if v_pages is not k_pages or q.shape[-1] == HEAD_DIM:
        return False
    if q.shape[1] != 1 or v_width != LATENT_V:
        raise ValueError(f"the latent paged kernel takes T=1 and v_width={LATENT_V} "
                         f"(got T={q.shape[1]}, v_width={v_width})")
    return True


def paged_attention_latent(q, pool, page_table, seq_lens, q_positions=None, *,
                           scale=None, v_width: int = LATENT_V):
    """The three B6 entries at MLA's latent width, v = k: q [B,1,H,D] over
    the pool's pages of the ``[B,P]`` table, keys ``< seq_lens[b]`` (and ``<=
    q_positions[b,0]`` when given), float32 p. Returns [B,1,H,v_width]. On
    the card K3, which computes only the first ``LATENT_V`` columns."""
    if q.device.type == "cpu":
        qpos0 = seq_lens.long() - 1 if q_positions is None else q_positions[:, 0]
        return _paged_plain(q, pool, pool, page_table, seq_lens, qpos0, scale, v_width)
    out = latent_attention_cuda(
        q[:, 0].contiguous(), pool, seq_lens.long(), page_table=page_table.long().contiguous(),
        q_positions=None if q_positions is None else q_positions.long()[:, :1],
        scale=scale)
    paged_attention_latent.launches += 1
    return out[:, None]


paged_attention_latent.launches = 0


# ------------------------------------------------------------------- wrappers

def pallas_paged_attention(q, k_pages, v_pages, page_table, seq_lens, q_positions,
                           *, scale=None, v_width=None):
    """B6 ``pallas_paged_attention``: q [B,T,H,D] over pages [N,ps,K,D] of
    the ``[B,P]`` table (layer offset applied), query t at position
    ``q_positions[b,0] + t``, keys ``< seq_lens[b]``. Returns [B,T,H,D]
    (``v_width``: the first ``v_width`` columns). With ``v_pages is
    k_pages`` at the latent width, :func:`paged_attention_latent` (K3)."""
    if q.device.type == "cpu":
        return pallas_paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                                            q_positions, scale=scale, v_width=v_width)
    if _latent_kernel(q, k_pages, v_pages, v_width):
        return paged_attention_latent(q, k_pages, page_table, seq_lens, q_positions,
                                      scale=scale, v_width=v_width)
    out = decode_attention_cuda(q, k_pages, v_pages, seq_lens.long(),
                                page_table=page_table.long().contiguous(),
                                q_positions=q_positions.long(), scale=scale)
    pallas_paged_attention.launches += 1
    return out[..., :v_width]


pallas_paged_attention.launches = 0


def pallas_paged_decode(q, k_pages, v_pages, page_table, seq_lens, *, scale=None,
                        v_width=None):
    """B6 ``pallas_paged_decode``: T=1, keys ``< seq_lens[b]``."""
    if q.device.type == "cpu":
        return pallas_paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens,
                                         scale=scale, v_width=v_width)
    if _latent_kernel(q, k_pages, v_pages, v_width):
        return paged_attention_latent(q, k_pages, page_table, seq_lens, scale=scale,
                                      v_width=v_width)
    out = decode_attention_cuda(q, k_pages, v_pages, seq_lens.long(),
                                page_table=page_table.long().contiguous(), scale=scale)
    pallas_paged_decode.launches += 1
    return out[..., :v_width]


pallas_paged_decode.launches = 0


def pallas_paged_decode_clamp(q, k_pages, v_pages, page_table, seq_lens, *,
                              scale=None, v_width=None):
    """B6 ``pallas_paged_decode_clamp``: T=1, keys ``< seq_lens[b]``; every
    K1 (K3) block reads exactly its row's used pages, the TPU kernel's clamp."""
    if q.device.type == "cpu":
        return pallas_paged_decode_clamp_plain(q, k_pages, v_pages, page_table,
                                               seq_lens, scale=scale, v_width=v_width)
    if _latent_kernel(q, k_pages, v_pages, v_width):
        return paged_attention_latent(q, k_pages, page_table, seq_lens, scale=scale,
                                      v_width=v_width)
    out = decode_attention_cuda(q, k_pages, v_pages, seq_lens.long(),
                                page_table=page_table.long().contiguous(), scale=scale)
    pallas_paged_decode_clamp.launches += 1
    return out[..., :v_width]


pallas_paged_decode_clamp.launches = 0
