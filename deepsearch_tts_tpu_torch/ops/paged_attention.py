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

int8 KV (``Engine(kv_quantize="int8")``): each entry takes the int8 pools'
float32 scales (``k_scales`` / ``v_scales``, [N,ps,K]) and then computes
the int8 branch of JAX's ``paged_attention`` (``ops/attention.py:122-139``:
XLA code there, no Pallas kernel reads int8 pages): each key and value
dequantized as ``(int8.float() * scale).to(q.dtype)``, the masked softmax
in float32, p in the value dtype. On the card that is K1's int8 mode,
``decode_i8`` (:func:`decode_i8_cuda`): a one-block plan kernel cuts each
row's visible keys, read from ``seq_lens`` on the card, into pieces
(:func:`decode_i8_plan` is its model), and a persistent grid takes them
longest first, a producer warp feeding each block's consumer warps by TMA;
it dequantizes bit for bit as the plain path does. Its plain version
(:func:`paged_int8_plain`) gathers, dequantizes and attends. ``launches``
counts every K1 launch of an entry, ``i8_launches`` those of the int8
mode.

MLA (``models/deepseek_v3.py``) calls the entries with the latent pool as
both k and v (``v_pages is k_pages``) at D = 576 and keeps the first
``v_width`` = 512 columns. K1 is written for D = 128 and 64 query rows a
block; MLA has 128 or 64 query heads over one cache head. On the card those
calls take K3 (``latent_attention`` in ``csrc/attention.cu``) through
:func:`paged_attention_latent`, which counts them; K3 computes only the
``v_width`` columns, 64 query heads a block on ``wgmma`` over TMA tiles,
the context split as :func:`latent_splits` chooses.

MLA's prefills (a fresh prefill, a re-prefill over a cached prefix, a slot
window at T > 1: XLA code in JAX, ``causal_attention``,
``prefix_chunk_attention`` and ``masked_context_attention``) call
:func:`latent_prefill` with ``impl="pallas"``, over the pool after the
chunk's rows were written. On the card that is K3's prefill mode: K3's
block for each (row, position, head block) item, in an order the plan
kernel sets on the card (rows longest first, each row's positions from the
last down, so the blocks running together share their key tiles in L2);
its plain version, :func:`latent_prefill_plain`, gathers and masks by
:func:`latent_key_limits`; :func:`latent_prefill_order` models the order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .attention import NEG_INF, dequant_context, gather_kv_rows, masked_context_attention

HEAD_DIM = 128        # head width the kernels are written for
MAX_QUERY_ROWS = 64   # T·H/K query rows one K1 block holds
KEY_TILE = 64         # keys of one K1 pipeline stage (csrc: DBK)
MIN_CHUNK_TILES = 4   # a K1 split holds at least 256 keys
BLOCKS_PER_SM = 2     # K1 blocks resident on one SM (its 104.4 KB ring)
LATENT_DIM = 576      # K3's row: DeepSeek-V3 / Kimi-K2 kv_lora_rank 512 + rope 64
LATENT_V = 512        # K3's value columns (kv_lora_rank)
LATENT_HEADS = 64     # query heads one K3 block holds: one wgmma m64 tile
LATENT_MIN_CHUNK_TILES = 4   # a K3 split holds at least 256 keys
I8_PIECES = 1         # K1's int8 mode: pieces of about W / (I8_PIECES * blocks) key tiles
I8_MIN_TILES = 2      # and at least this many (csrc: I8_PIECES, I8_MIN_TILES)
I8_BLOCKS_PER_SM = {8: 3, 16: 2}   # its resident blocks an SM by query rows an item


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


def paged_int8_plain(q, k_pages, v_pages, k_scales, v_scales, page_table, seq_lens,
                     q_positions, *, scale=None):
    """Plain version of K1's int8 mode: the int8 branch of JAX's
    ``paged_attention`` (``ops/attention.py:122-139``), the table's int8
    pages dequantized in q's dtype, query t of row b over keys ``<
    min(seq_len, q_positions[b, t] + 1)`` (``masked_context_attention``:
    float32 scores and softmax, p in the value dtype). A query that sees no
    key is 0, as in the kernel (JAX averages the row's values there, a row
    no decode step reads)."""
    k = dequant_context(k_pages, k_scales, page_table, q.dtype)
    v = dequant_context(v_pages, v_scales, page_table, q.dtype)
    out = masked_context_attention(q, k, v, seq_lens, q_positions, scale=scale)
    seen = torch.minimum(seq_lens.long()[:, None], q_positions.long() + 1) > 0   # [B,T]
    return torch.where(seen[:, :, None, None], out, torch.zeros_like(out))


def _i8_positions(q, qpos0):
    """[B, T] positions of a chunk that starts at ``qpos0``."""
    return qpos0.long()[:, None] + torch.arange(q.shape[1], device=q.device)


def pallas_paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                                 q_positions, *, scale=None, v_width=None, k_scales=None,
                                 v_scales=None):
    """Reference for :func:`pallas_paged_attention` (``_paged_kernel``;
    with the scales pools :func:`paged_int8_plain`)."""
    if k_scales is not None:
        return paged_int8_plain(q, k_pages, v_pages, k_scales, v_scales, page_table,
                                seq_lens, _i8_positions(q, q_positions[:, 0]), scale=scale)
    return _paged_plain(q, k_pages, v_pages, page_table, seq_lens,
                        q_positions[:, 0], scale, v_width)


def pallas_paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens, *,
                              scale=None, v_width=None, k_scales=None, v_scales=None):
    """Reference for :func:`pallas_paged_decode` (``_paged_decode_kernel``):
    T=1, keys ``< seq_len`` (with the scales pools :func:`paged_int8_plain`)."""
    if q.shape[1] != 1:
        raise ValueError(f"the paged decode entries take T=1, got T={q.shape[1]}")
    if k_scales is not None:
        return paged_int8_plain(q, k_pages, v_pages, k_scales, v_scales, page_table,
                                seq_lens, _i8_positions(q, seq_lens - 1), scale=scale)
    return _paged_plain(q, k_pages, v_pages, page_table, seq_lens,
                        seq_lens.long() - 1, scale, v_width)


def pallas_paged_decode_clamp_plain(q, k_pages, v_pages, page_table, seq_lens, *,
                                    scale=None, v_width=None, k_scales=None, v_scales=None):
    """Reference for :func:`pallas_paged_decode_clamp`
    (``_clamped_decode_kernel``): the same math as the decode kernel."""
    return pallas_paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens,
                                     scale=scale, v_width=v_width, k_scales=k_scales,
                                     v_scales=v_scales)


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


# ------------------------------------------------ K1's int8 mode: its plan

def i8_item_rows(rows: int) -> int:
    """Query rows one item of K1's int8 mode holds (csrc ``8 * NQ``): one
    mma n tile of 8 where a kv head's ``T·G`` rows fit in it, else 16."""
    return 8 if rows <= 8 else 16


def i8_plan_sizes(B: int, T: int, G: int, KV: int, sms: int) -> dict:
    """Static sizes of K1's int8 mode for ``B`` rows of ``T`` queries, ``G``
    query heads a kv head, ``KV`` kv heads, ``sms`` SMs: the query rows of
    an item, the row groups a row (``groups``), the units (row group × kv
    head), the persistent grid's blocks, the most partial slots and items
    the plan can make, and the plan's int32 workspace. From sizes only: no
    tensor is read, so a captured call replays with them."""
    rows = i8_item_rows(T * G)
    groups = -(-T * G // rows)
    units = B * groups * KV
    blocks = sms * I8_BLOCKS_PER_SM[rows]
    slots = 2 * I8_PIECES * blocks      # split pieces: < 4 W / (3 C) <= 2 * I8_PIECES * blocks
    items = units + slots               # pieces: <= units + W / C
    head = (8 + 6 * B * groups + units + units % 2 + 3) // 4 * 4
    return dict(rows=rows, groups=groups, units=units, blocks=blocks, slots=slots,
                items=items, ws_ints=head + 4 * items)


def i8_pieces(t: int, C: int, round_: bool = False) -> int:
    """Pieces of a unit of ``t`` key tiles: none where ``t`` is 0, else
    ``ceil(t / C)``, or (``round_``) ``t / C`` rounded to the nearest, at
    least 1. Piece ``zi`` holds tiles ``zi·t//z .. (zi+1)·t//z - 1``
    (:func:`i8_piece_tiles`), so a unit's pieces differ by one tile at
    most."""
    if t == 0:
        return 0
    return max(1, (2 * t + C) // (2 * C)) if round_ else -(-t // C)


def i8_long_pieces(t: int, C: int) -> int:
    """Of a unit's ``ceil(t / C)`` pieces, those longer than ``C / 2``."""
    z = i8_pieces(t, C)
    lo = t // z if z else 0
    hi = t - lo * z
    return (hi if 2 * (lo + 1) > C else 0) + (z - hi if 2 * lo > C else 0)


def i8_piece_tiles(t: int, z: int, zi: int) -> tuple[int, int]:
    """The first tile and the tile past the last of piece ``zi`` of ``z``."""
    return zi * t // z, (zi + 1) * t // z


def i8_row_limits(seq_lens, q_positions, T: int, G: int, *, min_one: bool = False,
                  max_keys: int) -> list[list[int]]:
    """[B][T·G] key limit of each folded query row r = t·G + g: query t of
    row b sees keys ``< min(seq_len (>= 1 with min_one), q_positions[b, 0]
    + t + 1, max_keys)`` (no ``q_positions``: ``seq_len - 1`` in its
    place). A host model: it reads the tensors."""
    out = []
    for b, sl in enumerate(int(x) for x in seq_lens.tolist()):
        sl = max(sl, 1) if min_one else sl
        q0 = sl - 1 if q_positions is None else int(q_positions[b, 0])
        out.append([max(0, min(q0 + r // G + 1, sl, max_keys)) for r in range(T * G)])
    return out


def decode_i8_plan(seq_lens, q_positions, *, T: int, G: int, KV: int, sms: int,
                   min_one: bool = False, max_keys: int) -> dict:
    """Host model of ``decode_i8_plan`` (``csrc/attention.cu``), the plan of
    K1's int8 mode, which the card computes from ``seq_lens`` /
    ``q_positions`` on the card. Row group ``rw = b·groups + qg`` (query
    rows ``qg·rows ..`` of row b) ends at its last query's key limit,
    ``lim``, and takes ``t = ceil(lim / 64)`` tiles a kv head; ``W`` = KV ×
    the groups' tiles; ``C = max(I8_MIN_TILES, ceil(W / (I8_PIECES ·
    blocks)))``; a group is cut into :func:`i8_pieces` balanced pieces,
    ``ceil(t / C)`` of them, or ``t / C`` rounded where the ceil pieces
    longer than ``C / 2`` would outnumber the blocks (their second wave would
    be long pieces: rows of one length); a split group's pieces take partial
    slots ``(sbase + zi)·KV + kh`` in group order, and a group with no key
    takes none. Returns ``C``, ``W``, ``round``, the groups' ``(lim, t, z,
    sbase)`` and the items ``(unit, first key, key end, slot or -1)``, unit
    = rw·KV + kh, longest first (the kernel orders pieces of one length as
    its atomics fall; here by unit, then piece)."""
    sz = i8_plan_sizes(len(seq_lens), T, G, KV, sms)
    rows, groups = sz["rows"], sz["groups"]
    lims = i8_row_limits(seq_lens, q_positions, T, G, min_one=min_one, max_keys=max_keys)
    R = T * G
    glim = [lims[b][min(qg * rows + rows, R) - 1] for b in range(len(lims))
            for qg in range(groups)]
    W = KV * sum(-(-x // KEY_TILE) for x in glim)
    C = max(I8_MIN_TILES, -(-W // (I8_PIECES * sz["blocks"])))
    nb = min(2 * C + 1, 2048)
    round_ = KV * sum(i8_long_pieces(-(-x // KEY_TILE), C) for x in glim) > sz["blocks"]
    recs, slot = [], 0
    for lim in glim:
        t = -(-lim // KEY_TILE)
        z = i8_pieces(t, C, round_)
        recs.append((lim, t, z, slot if z > 1 else -1))
        slot += z if z > 1 else 0
    items = []
    for u in range(len(glim) * KV):
        lim, t, z, sb = recs[u // KV]
        for zi in range(z):
            t0, t1 = i8_piece_tiles(t, z, zi)
            items.append((min(t1 - t0, nb - 1), (u, t0 * KEY_TILE, min(t1 * KEY_TILE, lim),
                                                 (sb + zi) * KV + u % KV if z > 1 else -1)))
    items.sort(key=lambda x: -x[0])
    return dict(C=C, W=W, round=round_, rows=recs, items=[it for _, it in items], sizes=sz)


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
        lib.dstts_decode_i8.argtypes = [p, ll, p, p, p, p, p, i, ll, p, p, i, i, i, p, i, i, i,
                                         i, i, f, p, p, p, i, p]
        lib.dstts_decode_i8.restype = i
        lib.dstts_decode_i8_plan.argtypes = [p, p, i, i, i, i, i, i, i, i, p, p]
        lib.dstts_decode_i8_plan.restype = i
        lib.dstts_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, f, p, i, p]
        lib.dstts_flash_attention.restype = i
        lib.dstts_flash_attention_paged.argtypes = [p, p, p, p, i, p, p, p, i, i, i, i, ll, i,
                                                    f, p, p, p, i, i, p]
        lib.dstts_flash_attention_paged.restype = i
        lib.dstts_widen_kv_pages.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p, p]
        lib.dstts_widen_kv_pages.restype = i
        lib.dstts_flash_paged_plan.argtypes = [p, p, i, i, i, i, i, i, i, p, p]
        lib.dstts_flash_paged_plan.restype = i
        lib.dstts_flash_paged_merge.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.dstts_flash_paged_merge.restype = i
        lib.dstts_latent_attention.argtypes = [p, p, p, i, ll, p, p, i, i, i, p, i, i, i, p,
                                               i, ll, i, f, i, i, i, p, p, p]
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

    out = (ctypes.c_int * 9)()
    _raise_if(_lib().dstts_attention_occupancy(out), "attention_occupancy")
    names = ("K1 (1 m-tile)", "K1 (2 m-tiles)", "K1 (4 m-tiles)", "K2", "K3 (bf16 p)",
             "K3 (float32 p)", "K2 paged", "K1 int8 (8 rows an item)",
             "K1 int8 (16 rows an item)")
    return dict(zip(names, out))


def _check_index(name: str, t: torch.Tensor, shape: tuple, dev) -> None:
    if t.device != dev or t.dtype != torch.int64 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected int64 {tuple(shape)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")


def decode_attention_cuda(q, k_pool, v_pool, seq_lens, *, page_table=None,
                          row_offset: int = 0, q_positions=None, min_one=False,
                          max_keys: int | None = None, scale=None, p_bf16=False,
                          k_scales=None, v_scales=None):
    """Launch K1. q [B,T,H,128] bf16 (any batch stride, the rest
    contiguous); pools [R,ps,K,128] bf16 (``v_pool`` may be ``k_pool``);
    ``page_table`` [B,P] int64 (None: the identity table, row
    ``row_offset + b``); seq_lens [B] int64; ``q_positions`` [B,T] int64
    (None: keys ``< seq_len`` at T=1). Query t of row b sees keys
    ``< min(seq_len (>= 1 if min_one), q_positions[b,0] + t + 1,
    max_keys)``. Returns [B,T,H,128] bf16. With ``k_scales`` / ``v_scales``
    ([R,ps,K] float32) K1's int8 mode (:func:`decode_i8_cuda`, which needs
    ``page_table`` and rounds p to bf16)."""
    from .fused_layer import _check, _raise_if, refuse_grad

    if k_scales is not None:
        if page_table is None:
            raise ValueError("K1's int8 mode needs a page table")
        return decode_i8_cuda(q, k_pool, v_pool, k_scales, v_scales, seq_lens, page_table,
                              q_positions=q_positions, min_one=min_one, max_keys=max_keys,
                              scale=scale)
    refuse_grad("decode_attention q", q)
    B, T, H, D = q.shape
    R, ps, K, _ = k_pool.shape
    dev = q.device
    _check_q(q, K)
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
    qpos_stride = _check_qpos(q_positions, B, T, dev)
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


def _check_q(q, K: int) -> None:
    """K1's q: [B,T,H,128] CUDA bf16, dimensions 1-3 contiguous, T·H/K <= 64."""
    B, T, H, D = q.shape
    if D != HEAD_DIM or H % K or T * (H // K) > MAX_QUERY_ROWS:
        raise ValueError(f"decode attention kernel needs head_dim={HEAD_DIM} and "
                         f"T*H/K <= {MAX_QUERY_ROWS} (got D={D}, T={T}, H={H}, K={K})")
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError(f"q: expected a CUDA bfloat16 tensor, got {q.dtype} on {q.device}")
    if q.stride(3) != 1 or q.stride(2) != D or (T > 1 and q.stride(1) != H * D):
        raise ValueError(f"q: dimensions 1-3 must be contiguous, got strides {q.stride()}")


def _check_qpos(q_positions, B: int, T: int, dev) -> int:
    """``q_positions`` [B,T] int64 on ``dev`` (or None at T=1); its row stride."""
    if q_positions is not None:
        _check_index("q_positions", q_positions, (B, T), dev)
        return q_positions.stride(0)
    if T != 1:
        raise ValueError("decode attention without q_positions takes T=1")
    return 0


def decode_i8_cuda(q, k_pool, v_pool, k_scales, v_scales, seq_lens, page_table, *,
                   q_positions=None, min_one=False, max_keys: int | None = None, scale=None):
    """Launch K1's int8 mode: its plan kernel, then the persistent
    ``decode_i8`` grid. q [B,T,H,128] bf16 (any batch stride, the rest
    contiguous); pools [R,ps,K,128] int8 with ``k_scales`` / ``v_scales``
    [R,ps,K] float32; ``page_table`` [B,P] int64 (with P > 1, ps a multiple
    of 8); seq_lens [B] int64; ``q_positions`` [B,T] int64 (None: keys ``<
    seq_len`` at T=1). Query t of row b sees keys ``< min(seq_len (>= 1 if
    min_one), q_positions[b,0] + t + 1, max_keys)``; one that sees none is
    0. p is rounded to bf16 (the int8 branch's value dtype). The scratch
    comes from :func:`i8_plan_sizes` (static sizes; nothing is read on the
    host). Returns [B,T,H,128] bf16."""
    from .fused_layer import _check, _raise_if, refuse_grad

    refuse_grad("decode_attention q", q)
    B, T, H, D = q.shape
    R, ps, K, _ = k_pool.shape
    dev = q.device
    _check_q(q, K)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        _check(name, t, (R, ps, K, D), torch.int8)
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        _check(name, t, (R, ps, K), torch.float32)
    if any(t.device != dev for t in (k_pool, v_pool, k_scales, v_scales)):
        raise ValueError("decode attention: q, the pools and the scales must share a device")
    _check_index("seq_lens", seq_lens, (B,), dev)
    P = page_table.shape[1]
    _check_index("page_table", page_table, (B, P), dev)
    if not page_table.is_contiguous():
        raise ValueError("page_table: must be contiguous")
    if P > 1 and ps % 8:
        raise ValueError(f"K1's int8 mode over more than one page a row needs ps a multiple "
                         f"of 8 (got ps={ps})")
    qpos_stride = _check_qpos(q_positions, B, T, dev)
    max_keys = P * ps if max_keys is None else min(int(max_keys), P * ps)
    scale = scale if scale is not None else D ** -0.5
    sms = _sm_count(dev)
    sz = i8_plan_sizes(B, T, H // K, K, sms)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=dev)
    ws = torch.empty((sz["ws_ints"],), dtype=torch.int32, device=dev)
    o_part = torch.empty((sz["slots"] * sz["rows"], D), dtype=torch.float32, device=dev)
    ml_part = torch.empty((sz["slots"] * sz["rows"], 2), dtype=torch.float32, device=dev)
    err = _lib().dstts_decode_i8(
        q.data_ptr(), q.stride(0), k_pool.data_ptr(), v_pool.data_ptr(), k_scales.data_ptr(),
        v_scales.data_ptr(), page_table.data_ptr(), P, R, seq_lens.data_ptr(),
        None if q_positions is None else q_positions.data_ptr(), qpos_stride,
        int(bool(min_one)), max_keys, out.data_ptr(), B, T, H, K, ps, float(scale),
        ws.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(), sms,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "decode_i8")
    return out


def decode_i8_plan_cuda(seq_lens, q_positions, *, T: int, G: int, KV: int,
                        min_one: bool = False, max_keys: int) -> dict:
    """The plan kernel of K1's int8 mode alone on the card (what
    :func:`decode_i8_cuda` launches first), read back and parsed as
    :func:`decode_i8_plan` returns it (the items in the kernel's order), to
    hold the kernel to its model."""
    from .fused_layer import _raise_if

    dev = seq_lens.device
    B = seq_lens.shape[0]
    sms = _sm_count(dev)
    sz = i8_plan_sizes(B, T, G, KV, sms)
    ws = torch.zeros((sz["ws_ints"],), dtype=torch.int32, device=dev)
    qpos_stride = 0 if q_positions is None else q_positions.stride(0)
    _raise_if(_lib().dstts_decode_i8_plan(
        seq_lens.data_ptr(), None if q_positions is None else q_positions.data_ptr(),
        qpos_stride, int(bool(min_one)), int(max_keys), B, T, G * KV, KV, sms, ws.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "decode_i8_plan")
    w = ws.cpu().tolist()
    RW = B * sz["groups"]
    head = (8 + 6 * RW + sz["units"] + sz["units"] % 2 + 3) // 4 * 4
    rows = [tuple(w[8 + 4 * i: 12 + 4 * i]) for i in range(RW)]
    items = [tuple(w[head + 4 * i: head + 4 * i + 4]) for i in range(w[0])]
    return dict(C=w[1], W=w[3], rows=rows, items=items, counter=w[2],
                cnt=w[8 + 4 * RW: 8 + 4 * RW + sz["units"]], sizes=sz)


# ------------------------------------------------------------------- kernel K3

def latent_pages_ok(ps: int) -> bool:
    """Whether K3 takes pages of ``ps`` keys under a page table: a 64-key
    tile is whole pages, or whole boxes of a page of 8, 16 or 32 keys."""
    return ps % KEY_TILE == 0 or (KEY_TILE % ps == 0 and ps % 8 == 0)


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
        if not latent_pages_ok(ps):
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
        int(bool(min_one)), int(max_keys), out.data_ptr(), B, 1, 0, None, H, R, ps,
        float(scale), int(bool(p_bf16)), splits, chunk,
        None if o_part is None else o_part.data_ptr(),
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


# ------------------------------------------------------ K3's prefill mode

def latent_key_limits(seq_lens, q_positions, max_keys: int):
    """[B, T] exclusive key limit of each query of K3's prefill mode: query
    t of row b at position p sees keys ``< min(p + 1, seq_lens[b],
    max_keys)``; a padding query (p < 0) sees none (0)."""
    lim = torch.minimum(q_positions.long() + 1, seq_lens.long()[:, None])
    return lim.clamp(min=0, max=int(max_keys))


def _latent_context(pool, B: int, page_table, row_offset: int):
    """[B, S, 1, D]: the table's pages of ``pool`` gathered, or (no table)
    the slot rows ``row_offset .. row_offset + B - 1``."""
    if page_table is None:
        return pool[row_offset: row_offset + B]
    P, (ps, K, D) = page_table.shape[1], pool.shape[1:]
    return gather_kv_rows(pool, page_table).reshape(B, P * ps, K, D)


def latent_prefill_plain(q, pool, seq_lens, q_positions, *, page_table=None,
                         row_offset: int = 0, max_keys: int | None = None, scale=None,
                         v_width: int = LATENT_V):
    """Plain version of K3's prefill mode: the latent rows of the ``[B, P]``
    table's pages of ``pool`` [R, ps, 1, D] (no table: slot row
    ``row_offset + b``), read after the chunk's rows were written, as k and
    their first ``v_width`` columns as v; query t of row b over the keys
    below :func:`latent_key_limits` (and below ``max_keys``). JAX's round
    points (``masked_context_attention``: q·scale in q's dtype, float32
    scores and softmax, p in the value dtype, a float32 sum); a query that
    sees no key gives 0 (JAX's three functions average stale rows or attend
    the prefix there, for padding queries only). Returns [B, T, H,
    v_width]."""
    B = q.shape[0]
    ctx = _latent_context(pool, B, page_table, row_offset)
    S = ctx.shape[1] if max_keys is None else min(int(max_keys), ctx.shape[1])
    ctx = ctx[:, :S]
    lim = latent_key_limits(seq_lens, q_positions, S)
    mask = (torch.arange(S, device=q.device)[None, None] < lim[:, :, None])[:, None, None]
    out = masked_context_attention(q, ctx, ctx[..., :v_width], seq_lens, q_positions,
                                   scale=scale, mask=mask)
    return torch.where((lim > 0)[:, :, None, None], out, torch.zeros_like(out))


def latent_prefill_order(q_positions, seq_lens, max_keys: int, heads: int, splits: int = 1):
    """Host model of the prefill mode's launch order: the items (b, t, head
    block, split) in the order of the kernel's 1-D grid. The plan
    (``latent_prefill_plan`` in ``csrc/attention.cu``) ranks the table rows
    by their longest query's key limit, the longest first (ties by row);
    each row's positions run from the last down (positions rise along a
    chunk, so its longest query first), each position's head blocks and
    splits together."""
    lim = latent_key_limits(seq_lens, q_positions, max_keys).tolist()
    B, T = len(lim), len(lim[0])
    rows = sorted(range(B), key=lambda b: (-max(lim[b]), b)) if B > 1 else [0]
    return [(b, t, h, z) for b in rows for t in reversed(range(T))
            for h in range(heads // LATENT_HEADS) for z in range(splits)]


def latent_prefill_cuda(q, pool, seq_lens, q_positions, *, page_table=None,
                        row_offset: int = 0, max_keys: int | None = None, scale=None):
    """Launch K3's prefill mode. q [B,T,H,576] bf16 contiguous (H a multiple
    of 64); pool [R,ps,1,576] bf16, k and v; ``page_table`` [B,P] int64 (ps
    as :func:`latent_pages_ok`) or None (slot rows ``row_offset + b``);
    seq_lens [B] int64; q_positions [B,T] int64 contiguous. The context is
    split as :func:`latent_splits` says for the ``B·T`` query rows (only
    where their head blocks cannot fill the card). Returns [B,T,H,512]
    bf16."""
    from .fused_layer import _check, _raise_if

    B, T, H, D = q.shape
    R, ps, K, _ = pool.shape
    dev = q.device
    if D != LATENT_DIM or K != 1 or H % LATENT_HEADS:
        raise ValueError(f"latent prefill kernel needs D={LATENT_DIM}, one cache head "
                         f"and H % {LATENT_HEADS} == 0 (got D={D}, K={K}, H={H})")
    _check("q", q, (B, T, H, D))
    _check("pool", pool, (R, ps, 1, D))
    if pool.device != dev:
        raise ValueError("latent prefill: q and the pool must share a device")
    _check_index("seq_lens", seq_lens, (B,), dev)
    _check_index("q_positions", q_positions, (B, T), dev)
    if not q_positions.is_contiguous():
        raise ValueError("q_positions: must be contiguous")
    P, S = 1, ps
    if page_table is not None:
        if not latent_pages_ok(ps):
            raise ValueError(f"latent prefill kernel over a page table needs ps % {KEY_TILE} "
                             f"== 0 or ps a multiple of 8 dividing {KEY_TILE} (got ps={ps})")
        P = page_table.shape[1]
        _check_index("page_table", page_table, (B, P), dev)
        if not page_table.is_contiguous():
            raise ValueError("page_table: must be contiguous")
        S = P * ps
    elif row_offset + B > R:
        raise ValueError(f"latent prefill: slot rows {row_offset} .. {row_offset + B - 1} "
                         f"past the pool's {R}")
    S = S if max_keys is None else min(int(max_keys), S)
    scale = scale if scale is not None else D ** -0.5
    splits, chunk = latent_splits(B * T, H // LATENT_HEADS, S, _sm_count(dev))
    out = torch.empty((B, T, H, LATENT_V), dtype=q.dtype, device=dev)
    o_part = ml_part = None
    if splits > 1:
        o_part = torch.empty((B * T * splits * H, LATENT_V), dtype=torch.float32, device=dev)
        ml_part = torch.empty((B * T * splits * H, 2), dtype=torch.float32, device=dev)
    rowof = torch.empty((B,), dtype=torch.int32, device=dev) if B > 1 else None
    err = _lib().dstts_latent_attention(
        q.data_ptr(), pool.data_ptr(), None if page_table is None else page_table.data_ptr(),
        P, int(row_offset), seq_lens.data_ptr(), q_positions.data_ptr(), 1, 0, int(S),
        out.data_ptr(), B, T, 1, None if rowof is None else rowof.data_ptr(), H, R, ps,
        float(scale), 1, splits, chunk, None if o_part is None else o_part.data_ptr(),
        None if ml_part is None else ml_part.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "latent_attention (prefill)")
    return out


def latent_prefill(q, pool, seq_lens, q_positions, *, page_table=None, row_offset: int = 0,
                   max_keys: int | None = None, scale=None, v_width: int = LATENT_V):
    """MLA's prefill attention over the latent pool after the chunk's rows
    were written (``models/deepseek_v3.py`` ``LatentAttention``: fresh
    prefill, re-prefill over a cached prefix, a slot window): q [B,T,H,D],
    the ``[B,P]`` table's pages of ``pool`` (None: slot rows ``row_offset +
    b``, keys below ``max_keys``), query t at ``q_positions[b,t]`` over
    keys ``< min(p + 1, seq_lens[b])``. Returns [B,T,H,v_width]. On the CPU
    :func:`latent_prefill_plain`; on the card K3's prefill mode, which
    computes the first ``LATENT_V`` columns (``v_width`` must be that), or
    a ValueError for what it cannot take."""
    if q.device.type == "cpu":
        return latent_prefill_plain(q, pool, seq_lens, q_positions, page_table=page_table,
                                    row_offset=row_offset, max_keys=max_keys, scale=scale,
                                    v_width=v_width)
    if v_width != LATENT_V:
        raise ValueError(f"the latent prefill kernel takes v_width={LATENT_V} (got {v_width})")
    out = latent_prefill_cuda(
        q, pool, seq_lens.long(), q_positions.long().contiguous(),
        page_table=None if page_table is None else page_table.long().contiguous(),
        row_offset=row_offset, max_keys=max_keys, scale=scale)
    latent_prefill.launches += 1
    return out


latent_prefill.launches = 0


# ------------------------------------------------------------------- wrappers

def _k1_entry(entry, q, k_pages, v_pages, page_table, seq_lens, q_positions, scale,
              v_width, k_scales, v_scales):
    """A CUDA call of a B6 entry: K3 at the latent width, else K1 (with the
    scales pools its int8 mode, :func:`decode_i8_cuda`, p in the value dtype
    as JAX's int8 branch has it); counts the launch on ``entry``."""
    if k_scales is None and _latent_kernel(q, k_pages, v_pages, v_width):
        return paged_attention_latent(q, k_pages, page_table, seq_lens, q_positions,
                                      scale=scale, v_width=v_width)
    out = decode_attention_cuda(
        q, k_pages, v_pages, seq_lens.long(), page_table=page_table.long().contiguous(),
        q_positions=None if q_positions is None else q_positions.long(), scale=scale,
        p_bf16=k_scales is not None, k_scales=k_scales, v_scales=v_scales)
    entry.launches += 1
    entry.i8_launches += k_scales is not None
    return out[..., :v_width]


def pallas_paged_attention(q, k_pages, v_pages, page_table, seq_lens, q_positions,
                           *, scale=None, v_width=None, k_scales=None, v_scales=None):
    """B6 ``pallas_paged_attention``: q [B,T,H,D] over pages [N,ps,K,D] of
    the ``[B,P]`` table (layer offset applied), query t at position
    ``q_positions[b,0] + t``, keys ``< seq_lens[b]``. Returns [B,T,H,D]
    (``v_width``: the first ``v_width`` columns). With ``v_pages is
    k_pages`` at the latent width, :func:`paged_attention_latent` (K3);
    with ``k_scales`` / ``v_scales`` over int8 pages, K1's int8 mode."""
    if q.device.type == "cpu":
        return pallas_paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                                            q_positions, scale=scale, v_width=v_width,
                                            k_scales=k_scales, v_scales=v_scales)
    return _k1_entry(pallas_paged_attention, q, k_pages, v_pages, page_table, seq_lens,
                     q_positions, scale, v_width, k_scales, v_scales)


def pallas_paged_decode(q, k_pages, v_pages, page_table, seq_lens, *, scale=None,
                        v_width=None, k_scales=None, v_scales=None):
    """B6 ``pallas_paged_decode``: T=1, keys ``< seq_lens[b]``."""
    if q.device.type == "cpu":
        return pallas_paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens,
                                         scale=scale, v_width=v_width, k_scales=k_scales,
                                         v_scales=v_scales)
    return _k1_entry(pallas_paged_decode, q, k_pages, v_pages, page_table, seq_lens, None,
                     scale, v_width, k_scales, v_scales)


def pallas_paged_decode_clamp(q, k_pages, v_pages, page_table, seq_lens, *,
                              scale=None, v_width=None, k_scales=None, v_scales=None):
    """B6 ``pallas_paged_decode_clamp``: T=1, keys ``< seq_lens[b]``; every
    K1 (K3) block reads exactly its row's used pages, the TPU kernel's clamp."""
    if q.device.type == "cpu":
        return pallas_paged_decode_clamp_plain(q, k_pages, v_pages, page_table,
                                               seq_lens, scale=scale, v_width=v_width,
                                               k_scales=k_scales, v_scales=v_scales)
    return _k1_entry(pallas_paged_decode_clamp, q, k_pages, v_pages, page_table, seq_lens,
                     None, scale, v_width, k_scales, v_scales)


pallas_paged_attention.launches = pallas_paged_attention.i8_launches = 0
pallas_paged_decode.launches = pallas_paged_decode.i8_launches = 0
pallas_paged_decode_clamp.launches = pallas_paged_decode_clamp.i8_launches = 0
