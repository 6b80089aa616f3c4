"""Ring attention: sequence-parallel causal attention over a mesh axis (port
of ``ops/ring_attention.py``).

Each rank keeps its Q chunk resident while the K/V chunks rotate around the
ring (:func:`..parallel.collectives.ppermute`, one hop a step) and an
online-softmax accumulator folds each visiting block in; fully masked
(future) blocks are skipped. The per-block math is plain torch in float32,
as JAX's is XLA einsum, not Pallas.

JAX's function takes global arrays and runs its ``local`` body under
``shard_map``; here every rank calls :func:`ring_attention` on its own
sequence shard, which is that body: q [B, T/n, H, D], k/v [B, T/n, K, D]
(v may be narrower: MLA's latent rows), chunk i on rank i of the axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import group_size, ppermute

NEG_INF = -1e30


def _block_attend(q, k, q_block: int, k_block: int, chunk: int, scale: float):
    """Scores [B,K,G,Tq,Tk] (float32) of one visiting K/V block with
    block-causal masking (absolute positions ``block·chunk + i``)."""
    B, Tq, H, D = q.shape
    Kh = k.shape[2]
    qg = q.reshape(B, Tq, Kh, H // Kh, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float() * scale, k.float())
    q_pos = q_block * chunk + torch.arange(Tq, device=q.device)[:, None]
    k_pos = k_block * chunk + torch.arange(k.shape[1], device=q.device)[None, :]
    return s.masked_fill(~(k_pos <= q_pos), NEG_INF)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                   axis: str = "tp", scale: float | None = None) -> torch.Tensor:
    """Causal attention of this rank's sequence shard over ``axis`` of
    ``mesh`` (a ``DeviceMesh``): q [B, Tc, H, D], k [B, Tc, K, D], v [B, Tc,
    K, Dv] → [B, Tc, H, Dv] in q's dtype."""
    group = mesh.get_group(axis)
    n = group_size(group)
    my = dist.get_rank(group)
    B, Tq, H, D = q.shape
    Kh, Dv = k.shape[2], v.shape[-1]
    G = H // Kh
    scale = scale if scale is not None else D ** -0.5
    m = torch.full((B, Kh, G, Tq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Kh, G, Tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Tq, H, Dv), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for step in range(n):
        src = (my - step) % n            # whose K/V we hold now
        if src <= my:
            s = _block_attend(q, kb, my, src, Tq, scale)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bkgts,bskd->btkgd", p, vb.float()).reshape(B, Tq, H, Dv)
            acc = acc * alpha.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, 1) + pv
            m = m_new
        if step < n - 1:
            kb, vb = ppermute(kb, group), ppermute(vb, group)
    l_r = l.clamp(min=1e-30).permute(0, 3, 1, 2, 4).reshape(B, Tq, H, 1)
    return (acc / l_r).to(q.dtype)
