"""Causal flash attention for prefill (port of ``ops/flash_attention.py:73
flash_attention``, kernel B2).

Causal GQA over q [B,T,H,D] and k, v [B,S,K,D] with scale D^-½. The mask is
the TPU kernel's, **top-left aligned**: query t sees keys ``j <= t`` and
``j < S`` (``flash_attention.py:49``) — not the bottom-right ``tril(k=S-T)``
of :func:`.attention.causal_attention`. The two agree for T == S, the only
case the engine and the no-cache forward use.

For a CUDA tensor the wrapper launches K2 of ``csrc/attention.cu`` (bf16,
head_dim 128, ``128 % G == 0``: a warp-specialised ``wgmma`` kernel fed by
TMA loads through an ``mbarrier`` ring, 128 folded query rows a block on
two consumer warpgroups, the G query heads of a kv head folded into the
tile rows, online softmax in registers); for a CPU tensor it
runs :func:`flash_attention_plain`, which holds the TPU kernel's numerics:
q scaled in float32, float32 scores, p kept in float32 for the value
product (the kernel rounds p to bf16 for its mma operand, within the bf16
tolerance). ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .attention import NEG_INF, _query_blocks

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
    if D != HEAD_DIM or H % K or TILE_ROWS % (H // K) or T < 1 or S < 1:
        raise ValueError(f"flash attention kernel needs head_dim={HEAD_DIM}, H % K == 0, "
                         f"{TILE_ROWS} % (H/K) == 0 and T, S >= 1 (got D={D}, H={H}, K={K}, "
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
