"""Paged KV cache: device pools + host page allocator (port of
``engine/kvcache.py``).

Device state: per-layer key/value page pools ``[L, N, ps, K, D]``. The JAX
version updates them functionally (donated through jit so XLA writes in
place); here :func:`write_kv_flat` writes into the pool tensors IN PLACE —
the pools are engine-owned and no caller keeps an older version.

Page 0 is the *null page*: unassigned page-table entries point at it, so
device code never branches on validity. Padding positions are dropped, as
in JAX: each pool's storage holds one spare row past its last token row,
outside the ``[L, N, ps, K, D]`` view, and padding writes land there. In
slot mode (``N`` = slots, ``ps`` = ``max_seq_len``) there is no null page —
row 0 is slot 0's token 0 — so a padding write anywhere readable would
corrupt a live sequence.

int8 KV (``Engine(kv_quantize="int8")``): the pools hold int8 rows
(:func:`quantize_kv_rows`, one symmetric scale per token and kv head) and
float32 scales pools ``[L, N, ps, K]`` (:func:`init_kv_scales`, with their
own spare row) that :func:`write_scales_flat` fills beside the rows. JAX
packs the int8 lanes into int32 words only because a raw int8 gather is
slow on its TPU (``ops/attention.py:123-127``); here they are stored as
int8, so its ``unpack_int8_rows`` has no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


def init_kv_pages(n_layers: int, n_pages: int, page_size: int, n_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, device="cpu"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed ``[L, N, ps, K, D]`` key and value pools, each a view of a
    storage with one spare ``[K, D]`` row at the end (the padding sink)."""
    shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
    return _pool(shape, dtype, device), _pool(shape, dtype, device)


def _pool(shape: tuple, dtype, device) -> torch.Tensor:
    """A zeroed ``[L, N, ps, K, D]`` pool viewing a storage with one spare
    ``[K, D]`` row at the end."""
    rows = shape[0] * shape[1] * shape[2] + 1
    flat = torch.zeros((rows,) + tuple(shape[3:]), dtype=dtype, device=device)
    return flat[:-1].view(shape)


def init_latent_pages(n_layers: int, n_pages: int, page_size: int, row_dim: int,
                      dtype=torch.bfloat16, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """MLA's pools (``latent_cache``): the latent rows ``[L, N, ps, 1, D]``
    (with the spare row), and a one-page ``[L, 1, ps, 1, D]`` dummy v pool
    that keeps the engine's (k, v) plumbing uniform — the MLA forward
    writes and reads k_pages only (JAX ``engine.py:440-445``)."""
    k = _pool((n_layers, n_pages, page_size, 1, row_dim), dtype, device)
    v = torch.zeros((n_layers, 1, page_size, 1, row_dim), dtype=dtype, device=device)
    return k, v


def init_kv_scales(n_layers: int, n_pages: int, page_size: int, n_kv_heads: int,
                   device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed float32 ``[L, N, ps, K]`` key and value scales pools of int8
    KV, each with one spare ``[K]`` row at the end of its storage."""
    rows = n_layers * n_pages * page_size + 1

    def pool():
        flat = torch.zeros((rows, n_kv_heads), dtype=torch.float32, device=device)
        return flat[:-1].view(n_layers, n_pages, page_size, n_kv_heads)

    return pool(), pool()


def _rows_with_spare(pool: torch.Tensor, row_dims: int = 2) -> torch.Tensor:
    """``[L·N·ps + 1, *row]`` view of a contiguous pool from
    :func:`init_kv_pages` (a row: the last ``row_dims`` dims, [K, D]) or
    :func:`init_kv_scales` ([K], ``row_dims=1``), its spare row included
    (raises for a pool whose storage has none)."""
    row = tuple(pool.shape[-row_dims:])
    width = pool[(0,) * (pool.dim() - row_dims)].numel()
    rows = pool.numel() // width
    strides = torch.empty(row).stride()
    return pool.as_strided((rows + 1,) + row, (width,) + strides, pool.storage_offset())


def kv_slots(positions: torch.Tensor, table_l: torch.Tensor, page_size: int,
             spare: int) -> torch.Tensor:
    """Row of each token in the flattened pool (``[L*N*ps]`` numbering):
    ``table_l[pos // ps] * ps + pos % ps``; padding (position < 0) → the
    spare row ``spare`` (= L·N·ps)."""
    pos = positions.clamp(min=0).long()
    page = torch.gather(table_l.long(), 1, pos // page_size)
    return torch.where(positions >= 0, page * page_size + pos % page_size, spare)


def write_kv_slots(k_flat: torch.Tensor, v_flat: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   slots: torch.Tensor) -> None:
    """Write [B, T, K, D] rows into the flattened pool at ``slots`` [B, T]
    (the spare row included), in place."""
    write_rows_slots(k_flat, k_new, slots)
    write_rows_slots(v_flat, v_new, slots)


def write_rows_slots(flat: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor) -> None:
    """Write [B, T, K, D] rows into ONE flattened pool at ``slots`` [B, T],
    in place: MLA's latent pool, where k and v are the same row."""
    K, D = flat.shape[-2:]
    _rows_with_spare(flat).index_put_((slots.reshape(-1),),
                                      rows.reshape(-1, K, D).to(flat.dtype))


def write_rows_flat(flat: torch.Tensor, rows: torch.Tensor, positions: torch.Tensor,
                    table_l: torch.Tensor) -> torch.Tensor:
    """Single-pool :func:`write_kv_flat` (JAX ``kvcache.py:107``): the MLA
    families' one latent row per token, padding to the spare row. Returns
    the same (mutated) pool."""
    LN, ps = flat.shape[:2]
    write_rows_slots(flat, rows, kv_slots(positions, table_l, ps, LN * ps))
    return flat


def quantize_kv_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, K, D] → (int8 [B, T, K, D], float32 scales [B, T, K]): one
    symmetric scale per (token, head), round to nearest (the values of
    ``engine/kvcache.py:63``, unpacked)."""
    x = rows.float()
    s = torch.clamp_min(x.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.round(x / s[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, s


def write_scales_flat(s_flat: torch.Tensor, s_new: torch.Tensor,
                      positions: torch.Tensor, table_l: torch.Tensor) -> torch.Tensor:
    """Scatter per-row scales [B, T, K] into the flattened [L*N, ps, K]
    scales pool beside :func:`write_kv_flat`, in place; padding lands in the
    spare row (``engine/kvcache.py:90``). Returns the same pool."""
    LN, ps = s_flat.shape[:2]
    write_scales_slots(s_flat, s_new, kv_slots(positions, table_l, ps, LN * ps))
    return s_flat


def write_scales_slots(s_flat: torch.Tensor, s_new: torch.Tensor,
                       slots: torch.Tensor) -> None:
    """Write [B, T, K] scales into the flattened scales pool at ``slots``."""
    K = s_flat.shape[-1]
    _rows_with_spare(s_flat, row_dims=1).index_put_(
        (slots.reshape(-1),), s_new.reshape(-1, K).to(s_flat.dtype))


def write_kv_flat(
    k_flat: torch.Tensor,     # [L*N, ps, K, D] all layers' pools, flattened view
    v_flat: torch.Tensor,
    k_new: torch.Tensor,      # [B, T, K, D]
    v_new: torch.Tensor,
    positions: torch.Tensor,  # [B, T]; <0 ⇒ padding
    table_l: torch.Tensor,    # [B, P] page ids ALREADY offset by layer*N
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a chunk's KV into the flattened all-layer pool, in place.

    The pools must come from :func:`init_kv_pages`: padding rows are sent
    to the spare row past the view instead of being filtered out (a boolean
    filter would sync the host with the device), so they land nowhere that
    can be read — JAX drops them out of bounds. Returns the same (mutated)
    pool tensors, mirroring the JAX signature."""
    LN, ps = k_flat.shape[:2]
    write_kv_slots(k_flat, v_flat, k_new, v_new,
                   kv_slots(positions, table_l, ps, LN * ps))
    return k_flat, v_flat


@dataclass
class PageAllocator:
    """Host-side page bookkeeping with refcounting for prefix sharing.

    Page 0 is never handed out. ``share`` bumps refcounts when a sequence
    adopts a cached prefix's pages; ``free`` returns pages whose refcount
    drops to zero.
    """

    n_pages: int
    page_size: int
    _free: list[int] = field(default_factory=list)
    _refs: dict[int, int] = field(default_factory=dict)

    def __post_init__(self):
        self._free = list(range(self.n_pages - 1, 0, -1))  # stack; excludes 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"KV cache exhausted: need {n} pages, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def share(self, pages: list[int]) -> list[int]:
        for p in pages:
            self._refs[p] += 1
        return list(pages)

    def free(self, pages: list[int]) -> None:
        for p in pages:
            r = self._refs.get(p, 0) - 1
            if r > 0:
                self._refs[p] = r
            elif r == 0:
                del self._refs[p]
                self._free.append(p)
            # r < 0 ⇒ double free; ignored (page already returned)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)
