"""Shared building blocks: RMSNorm, RoPE, SwiGLU (port of ``models/common.py``).

Same numerics as the JAX versions: norms and rope are computed in float32
and cast back to the input dtype at the same points.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for absolute positions [..., T] → [..., T, head_dim//2]."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (x[..., :half], x[..., half:]) — HF 'neox' convention.

    x: [B, T, H, D]; cos/sin: [B, T, half] (broadcast over heads).
    """
    half = x.shape[-1] // 2
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` with a float32 accumulator and a float32 result
    (``preferred_element_type=float32``). On the card ``torch.mm(...,
    out_dtype=float32)`` keeps the bf16 operands as they are; on the CPU,
    where that overload does not exist, the operands are widened."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def dot_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=bfloat16)``, the JAX package's
    layer matmul: float32 accumulation, result rounded to bfloat16 — for
    float32 configs as well."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt)).to(torch.bfloat16)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = dot_bf16(x, w_gate)
    u = dot_bf16(x, w_up)
    h = F.silu(g.float()).to(u.dtype) * u
    return dot_bf16(h, w_down).to(x.dtype)
