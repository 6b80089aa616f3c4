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


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)`` with a derivative, which that
    overload lacks: JAX's transpose of a ``preferred_element_type=float32``
    product, two products of the float32 cotangent with the other operand
    widened, each rounded once to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = (a.float().t() @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` with a float32 accumulator and a float32 result
    (``preferred_element_type=float32``). On the card ``torch.mm(...,
    out_dtype=float32)`` keeps the bf16 operands as they are (under
    autograd through :class:`_MatmulF32`); on the CPU, where that overload
    does not exist, the operands are widened."""
    if a.is_cuda and a.dtype != torch.float32:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``a @ b`` (2-D, bf16 operands) accumulated in float32 and
    rounded once to bf16."""
    if a.is_cuda:
        return torch.mm(a, b)
    return (a.float() @ b.float()).to(torch.bfloat16)


class _DotBF16(torch.autograd.Function):
    """:func:`dot_bf16` with JAX's transpose of a ``preferred_element_type=
    bfloat16`` product: the bf16 cotangent times the other operand rounded
    to bf16, accumulated in float32 and rounded to bf16, then cast to the
    operand's dtype (float32 configs included)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        dt = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(dt), w.to(dt)).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        bf = torch.bfloat16
        g2 = g.to(bf).reshape(-1, g.shape[-1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _mm_bf16(g2, w.to(bf).t()).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = _mm_bf16(x.to(bf).reshape(-1, x.shape[-1]).t(), g2).to(w.dtype)
        return gx, gw


def dot_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=bfloat16)``, the JAX package's
    layer matmul: float32 accumulation, result rounded to bfloat16 — for
    float32 configs as well. Under autograd (w a 2-D matrix) its
    derivative is JAX's (:class:`_DotBF16`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad) and w.dim() == 2:
        return _DotBF16.apply(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt)).to(torch.bfloat16)


def row_dot_bf16(x: torch.Tensor, w: torch.Tensor, par=None) -> torch.Tensor:
    """:func:`dot_bf16` of a row-parallel product (``par``: a
    ``parallel.collectives.Parallel`` over ``tp`` > 1 ranks, each holding
    its rows of w and columns of x): the float32 partial sums, summed over
    ``tp``, rounded once to bf16 — the unsharded product's rounding, in
    another summation order."""
    if par is None or par.tp == 1:
        return dot_bf16(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    part = matmul_f32(x.reshape(-1, x.shape[-1]).to(dt), w.to(dt))
    return par.reduce(part).to(torch.bfloat16).reshape(*x.shape[:-1], -1)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, par=None) -> torch.Tensor:
    """SwiGLU MLP; with ``par`` the gate / up columns and the down rows are
    this rank's (column- then row-parallel)."""
    if par is not None:
        x = par.enter(x)
    g = dot_bf16(x, w_gate)
    u = dot_bf16(x, w_up)
    h = F.silu(g.float()).to(u.dtype) * u
    return row_dot_bf16(h, w_down, par).to(x.dtype)
