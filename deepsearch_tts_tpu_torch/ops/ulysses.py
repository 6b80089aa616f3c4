"""Ulysses (DeepSpeed-style) sequence-parallel attention via all-to-all
(port of ``ops/ulysses.py``).

The second SP strategy beside ``ops/ring_attention.py``: two tiled
all-to-alls re-partition the sequence-sharded q/k/v into head-sharded ones
with the whole sequence local, one ordinary causal attention runs per rank
(:func:`.attention.causal_attention` with ``inner_impl``: ``"pallas"``
runs flash attention, K2, at H/n local heads), and a third all-to-all
restores sequence sharding.

GQA: with K kv heads on n ranks, the kv all-to-all needs K % n == 0;
otherwise (n % K == 0) the kv heads are all-gathered and each rank keeps the
one head its query-head block reads — the standard Ulysses KV replication.

As in ``ops/ring_attention.py``, each rank calls the function on its own
sequence shard (JAX's ``shard_map`` body).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import all_gather, all_to_all, group_size


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                      axis: str = "tp", scale: float | None = None,
                      inner_impl: str = "xla") -> torch.Tensor:
    """Causal attention of this rank's sequence shard over ``axis`` of
    ``mesh``: q [B, Tc, H, D], k/v [B, Tc, K, D] → [B, Tc, H, D]. Requires
    H % n == 0 and K % n == 0 or n % K == 0 (``ValueError``)."""
    from . import attention as attn_ops

    group = mesh.get_group(axis)
    n = group_size(group)
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    H, Kh = q.shape[2], k.shape[2]
    if H % n:
        raise ValueError(f"ulysses: n_heads {H} not divisible by mesh axis {n}")
    if Kh % n and n % Kh:
        raise ValueError(f"ulysses: kv heads {Kh} incompatible with axis {n}")
    # seq-sharded -> head-sharded with the full sequence
    qh = all_to_all(q, 2, 1, group)                      # [B, T, H/n, D]
    if Kh % n == 0:
        kh = all_to_all(k, 2, 1, group)                  # [B, T, K/n, D]
        vh = all_to_all(v, 2, 1, group)
    else:
        # n % K == 0: every kv head, then the one this query block reads
        hd = dist.get_rank(group) // (n // Kh)
        kh = all_gather(k, 1, group)[:, :, hd:hd + 1]
        vh = all_gather(v, 1, group)[:, :, hd:hd + 1]
    out = attn_ops.causal_attention(qh, kh, vh, scale=scale, impl=inner_impl)
    return all_to_all(out, 1, 2, group)                  # [B, Tc, H, D]
