"""int8 weights: per-channel quantization (kernel B12) and int8 products
(port of ``ops/quant.py``).

* :func:`quantize_int8` (B12, ``_quant_kernel``, ``quant.py:24-65``) — [K,N]
  float → (int8 [K,N], float32 scales [1,N]), one symmetric scale per output
  column, ``max(amax/127, 1e-8)``. Two rounding modes. Round to nearest
  (half to even, like ``jnp.round``) is what :func:`quantize_params` runs:
  JAX's ``quantize_params`` passes ``interpret=True`` (``quant.py:121``), so
  the stochastic Pallas body never runs on any JAX path. Stochastic
  rounding, ``floor(x/s + u)`` with u from 24 random bits, is the TPU
  kernel's own body.
* :func:`int8_matmul` (``quant.py:68``) — ``(bf16(x) @ w_q) * scales`` with
  a float32 accumulator, rounded to x's dtype (so an int8 ``lm_head`` gives
  bf16-rounded logits, as in JAX).
* :func:`quantize_params` / :func:`maybe_int8_dot` / ``QUANT_KEYS`` — a
  param tree's big matrices → ``{q, scales}`` leaves, and the product that
  takes either kind of leaf.

B12 on the card is Triton: one program per block of ``BLOCK_N`` columns
loops over K twice, first for the column amax, then to scale, round, clip
and store. What bounds it: bytes — it reads the matrix twice (2·2 B a bf16
element) and writes 1 B; a one-time cost when an engine is built. The
stochastic mode draws its bits from Triton's counter-based Philox stream
(``tl.randint(seed, offset)``, offset = the element's flat index), so the
same seed gives the same q. The plain version's stochastic mode draws from
a seeded ``torch.Generator``: the two streams differ, and the mode is held
to its properties (the round-to-nearest scales, q in {floor, floor+1} of
x/s, mean rounding error near 0, determinism per seed), not bit for bit.
``triton`` is imported inside the launching function.
"""
from __future__ import annotations

import torch

from ..models.common import dot_bf16, matmul_f32
from .fused_layer import _MAX_ROWS, int8_product

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "wqkv", "w_gateup",   # packed single-device serving layout
              "d_gate", "d_up", "d_down", "s_gate", "s_up", "s_down",
              "w_qb", "w_kb", "w_vb", "lm_head")

# int8_matmul runs B10's int8 product (ops/fused_layer.int8_product) for up
# to this many rows: decode steps and the lm_head of every forward; more
# rows (prefill) widen the weight to bf16 and take one library product
INT8_PRODUCT_ROWS = _MAX_ROWS
BLOCK_K, BLOCK_N = 64, 64
_kernel = None


def quantize_int8_plain(w: torch.Tensor, seed: int = 0, *, stochastic: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference for B12. Round to nearest: JAX's XLA branch
    (``quant.py:49-55``). Stochastic: ``floor(x/s + u)``, u = bits·2⁻²⁴ with
    24 bits from a ``torch.Generator`` seeded with ``seed``."""
    xf = w.float()
    amax = xf.abs().amax(dim=0, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which is not the IEEE quotient B12 computes
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
    y = xf / scale
    if stochastic:
        gen = torch.Generator(device=w.device).manual_seed(int(seed))
        bits = torch.randint(0, 1 << 24, y.shape, generator=gen, device=w.device,
                             dtype=torch.int32)
        q = torch.floor(y + bits.float() * 2.0 ** -24)
    else:
        q = torch.round(y)
    return q.clamp_(-127, 127).to(torch.int8), scale


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _quant_kernel(w_ptr, q_ptr, s_ptr, K, N, stride_k, stride_n, seed,
                      STOCHASTIC: tl.constexpr, BK: tl.constexpr, BN: tl.constexpr):
        cols = tl.program_id(0) * BN + tl.arange(0, BN)
        cmask = cols < N
        amax = tl.zeros([BN], tl.float32)
        for k0 in range(0, K, BK):
            rows = k0 + tl.arange(0, BK)
            m = (rows[:, None] < K) & cmask[None, :]
            x = tl.load(w_ptr + rows[:, None].to(tl.int64) * stride_k + cols[None, :] * stride_n,
                        mask=m, other=0.0).to(tl.float32)
            amax = tl.maximum(amax, tl.max(tl.abs(x), axis=0))
        # IEEE division, so the scales equal the plain version's bit for bit
        scale = tl.maximum(tl.math.div_rn(amax, tl.full([BN], 127.0, tl.float32)), 1e-8)
        tl.store(s_ptr + cols, scale, mask=cmask)
        for k0 in range(0, K, BK):
            rows = k0 + tl.arange(0, BK)
            m = (rows[:, None] < K) & cmask[None, :]
            x = tl.load(w_ptr + rows[:, None].to(tl.int64) * stride_k + cols[None, :] * stride_n,
                        mask=m, other=0.0).to(tl.float32)
            y = tl.math.div_rn(x, scale[None, :] + tl.zeros([BK, BN], tl.float32))
            if STOCHASTIC:
                bits = tl.randint(seed, rows[:, None] * N + cols[None, :])
                u = ((bits >> 8) & 0xFFFFFF).to(tl.float32) * (1.0 / 16777216.0)
                r = tl.floor(y + u)
            else:
                # round half to even: exact for |y| < 2^22 (here |y| <= 127)
                r = (y + 12582912.0) - 12582912.0
            r = tl.minimum(tl.maximum(r, -127.0), 127.0)
            tl.store(q_ptr + rows[:, None].to(tl.int64) * N + cols[None, :], r.to(tl.int8),
                     mask=m)

    return _quant_kernel


def quantize_int8(w: torch.Tensor, seed: int = 0, *, stochastic: bool = False,
                  out: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """B12: [K, N] float → (int8 [K, N], float32 scales [1, N]) per output
    column. ``out``: a contiguous int8 [K,N] and a float32 [1,N] tensor to
    write into (views of preallocated stacks), returned."""
    global _kernel
    K, N = w.shape
    if w.device.type == "cpu":
        q, s = quantize_int8_plain(w, seed, stochastic=stochastic)
        if out is None:
            return q, s
        out[0].copy_(q)
        out[1].copy_(s)
        return out
    if w.device.type != "cuda" or w.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"quantize_int8: expected a float CUDA matrix, got {w.dtype} "
                         f"on {w.device}")
    if stochastic and K * N >= 2 ** 31:
        raise ValueError("quantize_int8: stochastic mode numbers elements with int32 "
                         f"offsets (K*N = {K * N})")
    if out is None:
        out = (torch.empty((K, N), dtype=torch.int8, device=w.device),
               torch.empty((1, N), dtype=torch.float32, device=w.device))
    q, s = out
    if (q.dtype != torch.int8 or tuple(q.shape) != (K, N) or not q.is_contiguous()
            or s.dtype != torch.float32 or tuple(s.shape) != (1, N) or not s.is_contiguous()
            or q.device != w.device or s.device != w.device):
        raise ValueError("quantize_int8: out must be a contiguous int8 [K,N] and a "
                         "contiguous float32 [1,N] tensor on w's device")
    if _kernel is None:
        _kernel = _build_kernel()
    with torch.cuda.device(w.device):
        _kernel[(-(-N // BLOCK_N),)](w, q, s, K, N, w.stride(0), w.stride(1), int(seed),
                                     STOCHASTIC=bool(stochastic), BK=BLOCK_K, BN=BLOCK_N,
                                     num_warps=4)
    quantize_int8.launches += 1
    return q, s


quantize_int8.launches = 0


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor, *,
                plain: bool = False) -> torch.Tensor:
    """x [..., K] @ int8 w [K, N] with per-column scales [1, N] on the
    float32 accumulator, rounded to x's dtype (``quant.py:68-75``).

    On the card, up to ``INT8_PRODUCT_ROWS`` rows run B10's int8 product
    (:func:`.fused_layer.int8_product`); more rows (prefill) widen w to bf16
    (exact) and take one ``torch.mm`` with a float32 accumulator — XLA's
    product in JAX, so a library call, and the only route for that many
    rows. ``plain`` (any device) runs the kernel's plain version: a
    reference forward off the kernel."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    s2 = scales.reshape(1, -1)
    if x.device.type == "cuda" and not plain and x2.shape[0] <= INT8_PRODUCT_ROWS:
        out = int8_product(x2.contiguous(), w_q, s2)
    else:
        out = (matmul_f32(x2.to(torch.bfloat16), w_q.to(torch.bfloat16))
               * s2.float()).to(x.dtype)
    return out.reshape(*lead, -1)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def maybe_int8_dot(x: torch.Tensor, w, *, plain: bool = False) -> torch.Tensor:
    """The layer product for a plain weight (``dot_bf16``) or an int8
    ``{q, scales}`` leaf (:func:`int8_matmul`)."""
    if is_quantized(w):
        return int8_matmul(x, w["q"], w["scales"], plain=plain)
    return dot_bf16(x, w)


def quantize_stack(w: torch.Tensor, seed: int = 0) -> dict:
    """A stacked [..., K, N] matrix → ``{q: int8 [..., K, N], scales: f32
    [..., 1, N]}``, one matrix at a time into preallocated stacks (matrix i
    gets seed ``seed + i``, as in JAX; round to nearest ignores it)."""
    K, N = w.shape[-2:]
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-2] + (1, N), dtype=torch.float32, device=w.device)
    mats, qs, ss = w.reshape(-1, K, N), q.view(-1, K, N), s.view(-1, 1, N)
    for i in range(mats.shape[0]):
        quantize_int8(mats[i], seed + i, out=(qs[i], ss[i]))
    return {"q": q, "scales": s}


def quantize_params(params: dict, seed: int = 0,
                    keys: tuple[str, ...] = QUANT_KEYS) -> dict:
    """Quantize the big matmul weights named in ``keys`` to int8 ``{q,
    scales}``; everything else (norms, embeddings, router) passes through,
    and so do leaves that are already quantized. Leading (layer / expert)
    dims are kept: each [K, N] matrix is quantized on its own, rounding to
    nearest (``quant.py:107-128``)."""
    def walk(tree: dict) -> dict:
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                out[name] = walk(v)
            elif name in keys and v.ndim >= 2:
                out[name] = quantize_stack(v, seed)
            else:
                out[name] = v
        return out

    return walk(params)
