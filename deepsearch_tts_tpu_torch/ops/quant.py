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

B12 on the card is CUDA C++ (``csrc/quant.cu``, notes there): each column
strip ``[K, BN]`` is read once, by TMA, into the shared memory of a
thread-block cluster whose blocks split K; the blocks merge their column
amax through distributed shared memory, then quantize from shared memory.
What bounds it: bytes (2 B read and 1 B written a bf16 weight); a one-time
cost when an engine is built. :func:`quant_plan` picks the cluster size
and the rows a block for each shape (strips of 64-byte rows). The stochastic mode
draws its bits from Philox4x32-10 keyed by the seed at counter = the
element's flat index (:func:`philox4x32_10`, the same generator in plain
torch), so the plain version gives the kernel's q in both modes.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

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

# B12's plan (csrc/quant.cu): shared memory a block may take (the card's
# opt-in limit), an SM holds, and the runtime reserves a block; the
# kernel's own static shared memory (mbarriers, the warps' amax, the
# block's amax and scales: at most 2,944 bytes), rounded up; the most
# blocks a cluster (16: beyond the portable 8, which Hopper allows on
# request), boxes a block, rows a box (TMA's limit a dimension) and the
# alignment of a box in shared memory (TMA writes 128-byte aligned)
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232448, 233472, 1024
QUANT_STATIC = 3072
QUANT_CLUSTERS = (1, 2, 4, 8, 16)
QUANT_MAX_BOXES, QUANT_BOX_ROWS, QUANT_BOX_ALIGN = 16, 256, 128
# the most blocks an SM B12's plan aims at (three: one block's loads
# overlap the others' quantizing and stores; fewer only where a strip needs
# it) and the bytes of a strip's row; scripts/time_qkv_b12.py --plans times
# one to four blocks an SM by setting QUANT_PER_SM (PERF.md)
QUANT_PER_SM, QUANT_ROW_BYTES = 3, 64
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


class QuantPlan(NamedTuple):
    """B12's launch: strips of ``bn`` columns, each held by a cluster of
    ``cs`` blocks; block r of a cluster takes rows ``r·rows ..`` (a whole
    number of ``bh``-row TMA boxes) in ``smem`` bytes of dynamic shared
    memory."""
    bn: int
    cs: int
    rows: int
    bh: int
    smem: int

    def strips(self, N: int) -> int:
        return -(-N // self.bn)


def quant_plan(K: int, N: int, esize: int = 2) -> QuantPlan:
    """The least cluster size in (1, 2, 4, 8, 16) whose block's rows fit:
    ``rows`` = ceil(K / cs) rounded up to whole boxes of at most 256 rows (a
    multiple of 128 bytes each), times 64 bytes, within a block's share of
    shared memory at ``QUANT_PER_SM`` blocks an SM, else at fewer (down to
    one). Raises where no cluster of 16 holds a strip (bf16: K beyond
    ~57,000 rows)."""
    rb = QUANT_ROW_BYTES
    step = QUANT_BOX_ALIGN // math.gcd(QUANT_BOX_ALIGN, rb)   # rows a box is a multiple of
    for n in range(QUANT_PER_SM, 0, -1):
        budget = (SMEM_BLOCK if n == 1 else SMEM_SM // n - SMEM_RESERVED) - QUANT_STATIC
        for cs in QUANT_CLUSTERS:
            share = -(-K // cs)
            nbox = -(-share // QUANT_BOX_ROWS)
            bh = -(-share // nbox)
            bh = min(-(-bh // step) * step, QUANT_BOX_ROWS)
            rows = nbox * bh
            if rows * rb <= budget and (cs - 1) * rows < K:
                return QuantPlan(rb // esize, cs, rows, bh, rows * rb)
    raise ValueError(f"quantize_int8: a [{K}, {N}] matrix has columns too long for a "
                     f"cluster of {QUANT_CLUSTERS[-1]} blocks")


_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product m · c (c: int64
    tensor of 32-bit values) in int64 without overflow: c in 16-bit limbs."""
    a = m * (c >> 16)            # < 2^48
    b = m * (c & 0xFFFF)         # < 2^48
    lo = (((a & 0xFFFF) << 16) + b) & _MASK
    hi = (a + (b >> 16)) >> 16
    return hi & _MASK, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC 2011) on int64 tensors holding
    32-bit counter words, key (k0, k1): the four output words. B12's
    stochastic mode takes word 0 at counter (flat index lo, hi, 0, 0) and
    key (seed lo, seed hi), as ``csrc/quant.cu`` does."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def stochastic_uniform(K: int, N: int, seed: int, rows: slice, device) -> torch.Tensor:
    """B12's uniforms u = (word 0 >> 8) · 2⁻²⁴ of rows ``rows`` of a [K, N]
    matrix (float32)."""
    r0, r1 = rows.indices(K)[:2]
    idx = (torch.arange(r0, r1, device=device, dtype=torch.int64)[:, None] * N
           + torch.arange(N, device=device, dtype=torch.int64))
    zero = torch.zeros_like(idx)
    seed = int(seed) & ((1 << 64) - 1)
    w0 = philox4x32_10(idx & _MASK, idx >> 32, zero, zero, seed & _MASK, seed >> 32)[0]
    return (w0 >> 8).to(torch.float32) * 2.0 ** -24


def quantize_int8_plain(w: torch.Tensor, seed: int = 0, *, stochastic: bool = False,
                        scale: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference for B12. Round to nearest: JAX's XLA branch
    (``quant.py:49-55``). Stochastic: ``floor(x/s + u)`` with u from
    :func:`stochastic_uniform` (rows in chunks, so the counters of a large
    matrix never sit in memory at once). ``scale``: use these [1, N] scales
    instead of the amax's (a model of a wrong amax for the card's checks)."""
    xf = w.float()
    if scale is None:
        amax = xf.abs().amax(dim=0, keepdim=True)
        # a tensor divisor: CUDA divides by a Python scalar as a product with
        # its reciprocal, which is not the IEEE quotient B12 computes
        scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
    y = xf / scale
    if stochastic:
        K, N = y.shape
        q = torch.empty_like(y)
        step = max(1, (1 << 22) // max(N, 1))
        for r0 in range(0, K, step):
            rows = slice(r0, min(K, r0 + step))
            q[rows] = torch.floor(y[rows] + stochastic_uniform(K, N, seed, rows, w.device))
    else:
        q = torch.round(y)
    return q.clamp_(-127, 127).to(torch.int8), scale


def _lib():
    from ._build import load_library

    lib = load_library("quant")
    if not getattr(lib, "_dstts_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dstts_quantize_int8.argtypes = [p] * 3 + [i] * 8 + [ctypes.c_ulonglong, p]
        lib.dstts_quantize_int8.restype = i
        lib._dstts_typed = True
    return lib


def _launch_quant(w, q, s, plan: QuantPlan, seed: int, stochastic: bool) -> int:
    K, N = w.shape
    return _lib().dstts_quantize_int8(
        w.data_ptr(), q.data_ptr(), s.data_ptr(), K, N, _DTYPES[w.dtype], plan.cs,
        plan.rows, plan.bh, plan.smem, int(bool(stochastic)), int(seed) & ((1 << 64) - 1),
        torch.cuda.current_stream(w.device).cuda_stream)


def quantize_int8(w: torch.Tensor, seed: int = 0, *, stochastic: bool = False,
                  out: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """B12: [K, N] float → (int8 [K, N], float32 scales [1, N]) per output
    column. ``out``: a contiguous int8 [K,N] and a float32 [1,N] tensor to
    write into (views of preallocated stacks), returned."""
    K, N = w.shape
    if w.device.type == "cpu":
        q, s = quantize_int8_plain(w, seed, stochastic=stochastic)
        if out is None:
            return q, s
        out[0].copy_(q)
        out[1].copy_(s)
        return out
    if w.device.type != "cuda" or w.dtype not in _DTYPES or not w.is_contiguous():
        raise ValueError(f"quantize_int8: expected a contiguous float CUDA matrix, got "
                         f"{w.dtype} on {w.device}")
    if out is None:
        out = (torch.empty((K, N), dtype=torch.int8, device=w.device),
               torch.empty((1, N), dtype=torch.float32, device=w.device))
    q, s = out
    if (q.dtype != torch.int8 or tuple(q.shape) != (K, N) or not q.is_contiguous()
            or s.dtype != torch.float32 or tuple(s.shape) != (1, N) or not s.is_contiguous()
            or q.device != w.device or s.device != w.device):
        raise ValueError("quantize_int8: out must be a contiguous int8 [K,N] and a "
                         "contiguous float32 [1,N] tensor on w's device")
    plan = quant_plan(K, N, w.element_size())
    err = _launch_quant(w, q, s, plan, seed, stochastic)
    if err:
        raise RuntimeError(f"quantize_int8: CUDA launch failed with cudaError {err} "
                           f"(plan {plan})")
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
