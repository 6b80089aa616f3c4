"""Paged KV cache: device pools + host page allocator (port of
``engine/kvcache.py``).

Device state: per-layer key/value page pools ``[L, N, ps, K, D]``. The JAX
version updates them functionally (donated through jit so XLA writes in
place); here :func:`write_kv_flat` writes into the pool tensors IN PLACE —
the pools are engine-owned and no caller keeps an older version.

Page 0 is the *null page*: unassigned page-table entries point at it, so
device code never branches on validity; padding positions are dropped.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


def init_kv_pages(n_layers: int, n_pages: int, page_size: int, n_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, device="cpu"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def kv_slots(positions: torch.Tensor, table_l: torch.Tensor, page_size: int
             ) -> torch.Tensor:
    """Row of each token in the flattened pool (``[L*N*ps]`` numbering):
    ``table_l[pos // ps] * ps + pos % ps``; padding (position < 0) → 0."""
    pos = positions.clamp(min=0).long()
    page = torch.gather(table_l.long(), 1, pos // page_size)
    return torch.where(positions >= 0, page * page_size + pos % page_size, 0)


def write_kv_slots(k_flat: torch.Tensor, v_flat: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   slots: torch.Tensor) -> None:
    """Write [B, T, K, D] rows into the flattened pool at ``slots`` [B, T],
    in place."""
    LN, ps, K, D = k_flat.shape
    idx = slots.reshape(-1)
    k_flat.view(LN * ps, K, D).index_put_((idx,), k_new.reshape(-1, K, D).to(k_flat.dtype))
    v_flat.view(LN * ps, K, D).index_put_((idx,), v_new.reshape(-1, K, D).to(v_flat.dtype))


def write_kv_flat(
    k_flat: torch.Tensor,     # [L*N, ps, K, D] all layers' pools, flattened view
    v_flat: torch.Tensor,
    k_new: torch.Tensor,      # [B, T, K, D]
    v_new: torch.Tensor,
    positions: torch.Tensor,  # [B, T]; <0 ⇒ padding
    table_l: torch.Tensor,    # [B, P] page ids ALREADY offset by layer*N
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a chunk's KV into the flattened all-layer pool, in place.

    Padding rows are sent to row 0 of layer 0's null page instead of being
    filtered out (a boolean filter would sync the host with the device).
    The null page is only ever read under a mask, so its contents never
    reach an output. Returns the same (mutated) pool tensors, mirroring the
    JAX signature."""
    write_kv_slots(k_flat, v_flat, k_new, v_new,
                   kv_slots(positions, table_l, k_flat.shape[1]))
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
