"""Radix-tree prefix cache over KV pages (port of ``engine/prefix_cache.py``).

A trajectory that returns from a tool call re-enters the batch and reuses
the KV pages of its shared conversation prefix with zero recompute.
Granularity is one KV page: tree edges are page-sized token chunks, nodes
hold refcounted page ids. Matching only returns whole pages — a partially
filled tail page is re-prefilled by the caller. Eviction is LRU over leaves.

The C++ index is the port's ``native/`` module (host code, a copy of the
JAX package's); the pure-Python tree is the reference and what
:func:`make_prefix_cache` keeps when g++ cannot build the index.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .kvcache import PageAllocator


@dataclass
class _Node:
    children: dict[tuple, "_Node"] = field(default_factory=dict)
    page: int | None = None
    last_used: float = 0.0

    def touch(self):
        self.last_used = time.monotonic()


class PrefixCache:
    def __init__(self, allocator: PageAllocator):
        self.alloc = allocator
        self.root = _Node()
        self.page_size = allocator.page_size
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    def _chunks(self, tokens: list[int]) -> list[tuple]:
        ps = self.page_size
        n_full = len(tokens) // ps
        return [tuple(tokens[i * ps: (i + 1) * ps]) for i in range(n_full)]

    def match(self, tokens: list[int]) -> tuple[list[int], int]:
        """Longest cached prefix → (shared page ids, tokens covered).

        Bumps refcounts on the returned pages; the caller owns one reference
        and must ``allocator.free`` them when the sequence dies.
        """
        node, pages = self.root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None or child.page is None:
                break
            pages.append(child.page)
            child.touch()
            node = child
        if pages:
            self.alloc.share(pages)
            self.hits += 1
            self.tokens_reused += len(pages) * self.page_size
        else:
            self.misses += 1
        return pages, len(pages) * self.page_size

    def insert(self, tokens: list[int], pages: list[int]) -> None:
        """Record a sequence's full pages; takes one extra reference each.

        ``pages[i]`` must hold tokens ``[i*ps, (i+1)*ps)``.
        """
        node = self.root
        for i, chunk in enumerate(self._chunks(tokens)):
            if i >= len(pages):
                break
            child = node.children.get(chunk)
            if child is None:
                child = _Node(page=pages[i])
                self.alloc.share([pages[i]])
                node.children[chunk] = child
            child.touch()
            node = child

    def evict_lru(self, n_pages_needed: int) -> int:
        """Drop least-recently-used leaves until n pages are free.

        Returns the number of cache references released.
        """
        released = 0
        while self.alloc.num_free < n_pages_needed:
            victim = self._lru_leaf_path()
            if not victim:
                break
            parent, key, node = victim
            self.alloc.free([node.page])
            del parent.children[key]
            released += 1
        return released

    def _lru_leaf_path(self):
        best = None

        def walk(parent):
            nonlocal best
            for key, node in parent.children.items():
                if node.children:
                    walk(node)
                elif best is None or node.last_used < best[2].last_used:
                    best = (parent, key, node)

        walk(self.root)
        return best

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "tokens_reused": self.tokens_reused}


class NativePrefixCache:
    """Same contract as :class:`PrefixCache`, backed by the C++ radix index."""

    def __init__(self, allocator: PageAllocator):
        from ..native import NativeRadixIndex

        self.alloc = allocator
        self.page_size = allocator.page_size
        self.ix = NativeRadixIndex(allocator.page_size)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    def match(self, tokens: list[int]) -> tuple[list[int], int]:
        pages = self.ix.match(list(tokens))
        if pages:
            self.alloc.share(pages)
            self.hits += 1
            self.tokens_reused += len(pages) * self.page_size
        else:
            self.misses += 1
        return pages, len(pages) * self.page_size

    def insert(self, tokens: list[int], pages: list[int]) -> None:
        new_pages = self.ix.insert(list(tokens), list(pages))
        if new_pages:
            self.alloc.share(new_pages)

    def evict_lru(self, n_pages_needed: int) -> int:
        released = 0
        while self.alloc.num_free < n_pages_needed:
            page = self.ix.evict_lru()
            if page < 0:
                break
            self.alloc.free([page])
            released += 1
        return released

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "tokens_reused": self.tokens_reused, "backend": "native",
                "nodes": len(self.ix)}


def make_prefix_cache(allocator: PageAllocator, prefer_native: bool = True):
    """C++ index when g++ can build it, else the Python tree (host-side
    bookkeeping only: both give the same matches)."""
    if prefer_native:
        try:
            return NativePrefixCache(allocator)
        except RuntimeError:   # native library unavailable (no g++)
            pass
    return PrefixCache(allocator)
