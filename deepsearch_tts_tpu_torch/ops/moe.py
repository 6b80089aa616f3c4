"""Mixture-of-Experts routing, dispatch and expert compute (port of
``ops/moe.py``).

* :func:`route_topk` — softmax over the router logits in float32, top-k,
  renormalised selected probabilities (``norm_topk_prob``).
* :func:`moe_ragged` — sort the (token, expert) assignments by expert, run
  the grouped SwiGLU over the expert-sorted rows, un-sort and combine with
  the gate weights. The JAX package runs the grouped products through
  ``lax.ragged_dot`` (XLA); here :func:`_expert_ffn_ragged` runs them through
  the hand-written grouped expert kernels in ``csrc/fused_layer.cu``:
  :func:`grouped_gateup` (h = silu(x@Wg[e])·(x@Wu[e])) and
  :func:`grouped_down` (y = h@Wd[e]) each launch ``grouped_expert`` (decode:
  1-2 rows an expert, weights streamed once on ``mma.sync``) or
  ``grouped_expert_tc`` (prefill: 128-row tiles on ``wgmma`` over a TMA
  ring, a persistent grid over (expert, n-tile, m-tile) items built on the
  card), chosen by :func:`grouped_prefill` from static sizes alone.
* :func:`_expert_ffn_blocked` — the same SwiGLU over int8 ``{q, scales}``
  expert weights (JAX ``moe.py:56``, XLA: ``lax.ragged_dot`` has no int8
  path): each expert computes at most ``cap`` of its rows, the first in
  sorted order (:func:`expert_capacity`, JAX's rule); the output rows past
  it are 0. Both int8 entries, :func:`grouped_gateup_i8` and
  :func:`grouped_down_i8` (``csrc/moe_i8.cu``), launch
  ``grouped_expert_i8`` at decode (int8 tiles widened to bf16 in
  registers, ``mma.sync``, the weights streamed once) or
  ``grouped_expert_i8_tc`` at prefill (the bf16 prefill kernel's
  persistent ``wgmma`` over a TMA ring, 256-row tiles over each expert's
  first ``cap`` rows, the int8 stages widened into bf16 tiles by producer
  warps), chosen by :func:`grouped_prefill` as for bf16; the column scales
  multiply the float32 sums. JAX's round points there: g and u stay
  float32 (no bf16 rounding before ``silu``), h is rounded to x's dtype,
  y too.
* :func:`moe_capacity` — the GShard capacity-bounded one-hot dispatch, the
  other ``moe_impl`` (plain torch, int8 leaves too; tokens past an
  expert's capacity drop).

Round points are JAX's (``moe.py:81-128``): ``ragged_dot`` returns the
input dtype, so g and u are rounded to it before ``silu`` is taken in
float32, h and y are in it, and the gate weights are cast to it before the
weighted sum over the top-k.

On the card the routing glue is plain torch that never syncs with the host:
the group sizes are counted with ``scatter_add_`` (``torch.bincount`` on
CUDA reads its maximum back to size the output) and their exclusive cumsum
stays on the device, where each kernel block reads its expert's row range.
For a CUDA tensor the grouped wrappers launch a kernel or raise; for a CPU
tensor they run their plain versions, a per-expert loop that reads the
group offsets on the host. Each wrapper, bf16 or int8, counts its
launches of either kernel in ``launches`` and those of the prefill kernel
in ``prefill_launches``. Under autograd the bf16 pair runs through
``autograd.Function``s whose backward is the plain versions'
vector-Jacobian product (training the MoE families; JAX differentiates
XLA's ``lax.ragged_dot``); the int8 pair, like every other kernel, raises
when it is reached with a tensor that requires grad (int8 weights cannot
be trained, in JAX either).
Expert parallelism (``parallel/``): ``experts=(first, count)`` restricts
:func:`moe_ragged` / :func:`dispatch_ragged` / :func:`moe_capacity` to this
rank's experts, whose weight stacks are the local slices; the other
experts' rows contribute 0 and the caller sums the ranks' outputs (what
GSPMD does with JAX's expert-sharded leaves). :func:`moe_ep_alltoall` is
JAX's explicit all-to-all dispatch (``moe.py:131``) over an ``ep`` group.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import ctypes

from ..models.common import matmul_f32
from .fused_layer import _TILE, _check, _lib, _raise_if
from .paged_attention import _sm_count
from .quant import is_quantized

_ROWS = 64          # expert-sorted rows per block tile of the decode kernel (csrc: MAX_ROWS)
_MAX_ROW_SPLITS = 8
# experts the prefill kernel's tile table holds (csrc: XMAX_NE); its tiles
# (128 y columns, 64 gate and 64 up columns, 64-deep k stages) take the
# widths the decode kernel takes
_PREFILL_MAX_NE = 1024
# mean rows an expert from which the prefill kernel takes over
PREFILL_ROWS_PER_EXPERT = 16


def route_topk(router_logits: torch.Tensor, top_k: int, norm_topk_prob: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, NE] logits → (probs [T, k] float32, expert ids [T, k] int64)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_p, top_e


def group_offsets(flat_e: torch.Tensor, n_exp: int) -> torch.Tensor:
    """Exclusive cumsum of the per-expert assignment counts, [NE+1] int32,
    on ``flat_e``'s device and without a host sync."""
    counts = torch.zeros(n_exp, dtype=torch.int64, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.zeros(n_exp + 1, dtype=torch.int32, device=flat_e.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets


# ------------------------------------------------------- grouped expert FFN

def _split_gateup(w_gate, w_up):
    """(gate, up) [NE,E,F] views of either gate|up layout, plain or int8
    ``{q, scales}`` (per-column scales: the packed leaf's halves are the
    unpacked leaves)."""
    if w_up is not None:
        return w_gate, w_up
    if is_quantized(w_gate):
        Fi = w_gate["q"].shape[-1] // 2
        return ({k: w_gate[k][..., :Fi] for k in ("q", "scales")},
                {k: w_gate[k][..., Fi:] for k in ("q", "scales")})
    Fi = w_gate.shape[-1] // 2
    return w_gate[..., :Fi], w_gate[..., Fi:]


def _expert_rows(x, offsets) -> list:
    """x's rows split by expert (``offsets[0]`` = 0), then the rows past
    ``offsets[-1]``: one split, so that under autograd each operand gets
    one backward node and not one full-size gradient an expert."""
    bounds = offsets.tolist()
    sizes = [b - a for a, b in zip(bounds, bounds[1:])]
    return list(x.split(sizes + [x.shape[0] - bounds[-1]]))


def grouped_gateup_plain(x_sorted, w_gate, w_up, offsets):
    """Reference for entry 1 of the grouped expert kernel: per expert e,
    ``h = silu(g) · u`` over its rows with g, u = x@Wg[e], x@Wu[e] rounded to
    x's dtype (float32 accumulators) and silu in float32; rows past the
    last expert's are 0."""
    wg, wu = _split_gateup(w_gate, w_up)
    dt = x_sorted.dtype
    *chunks, rest = _expert_rows(x_sorted, offsets)
    hs = []
    for xs, g_w, u_w in zip(chunks, wg.unbind(0), wu.unbind(0)):
        if xs.shape[0] == 0:
            hs.append(xs.new_zeros((0, g_w.shape[-1])))
            continue
        g = matmul_f32(xs, g_w).to(dt)
        u = matmul_f32(xs, u_w).to(dt)
        hs.append((F.silu(g.float()) * u.float()).to(dt))
    return torch.cat(hs + [rest.new_zeros((rest.shape[0], wg.shape[-1]))])


def grouped_down_plain(h, w_down, offsets):
    """Reference for entry 2: ``y = h @ Wd[e]`` over expert e's rows,
    float32 accumulator, rounded to h's dtype; rows past the last
    expert's are 0."""
    *chunks, rest = _expert_rows(h, offsets)
    ys = [matmul_f32(hs, d_w).to(h.dtype) if hs.shape[0] else
          hs.new_zeros((0, d_w.shape[-1])) for hs, d_w in zip(chunks, w_down.unbind(0))]
    return torch.cat(ys + [rest.new_zeros((rest.shape[0], w_down.shape[-1]))])


def grouped_shapes_ok(hidden: int, moe_intermediate: int) -> bool:
    """Widths the grouped expert kernel takes: 64-column h tiles (one gate
    and one up half of a 128-column weight tile), 128-column y tiles and
    whole 32-row pipeline stages."""
    return hidden % _TILE == 0 and moe_intermediate % (_TILE // 2) == 0


def prefill_shapes_ok(hidden: int, moe_intermediate: int, n_exp: int) -> bool:
    """Whether the prefill kernel takes these widths: the decode kernel's
    widths, and no more experts than its tile table holds."""
    return grouped_shapes_ok(hidden, moe_intermediate) and n_exp <= _PREFILL_MAX_NE


def grouped_prefill(S: int, n_exp: int, hidden: int, moe_intermediate: int) -> bool:
    """Whether the grouped wrappers launch the prefill kernel for ``S``
    expert-sorted rows (T tokens x top-k) over ``n_exp`` experts: from
    static sizes alone (the group offsets stay on the card), where an
    expert gets ``PREFILL_ROWS_PER_EXPERT`` rows or more on average and the
    widths suit it; else the decode kernel."""
    return (S >= PREFILL_ROWS_PER_EXPERT * n_exp
            and prefill_shapes_ok(hidden, moe_intermediate, n_exp))


def _row_splits(S: int, n_exp: int) -> int:
    """Blocks per (column tile, expert) along the rows: twice the mean
    number of 64-row tiles an expert holds (so a skewed expert's rows are
    shared by several blocks), from 1 at decode to 8."""
    return max(1, min(_MAX_ROW_SPLITS, -(-2 * S // (_ROWS * n_exp))))


def _check_offsets(offsets, n_exp, dev):
    if (offsets.device != dev or offsets.dtype != torch.int32
            or tuple(offsets.shape) != (n_exp + 1,) or not offsets.is_contiguous()):
        raise ValueError(f"offsets: expected contiguous int32 ({n_exp + 1},) on {dev}, "
                         f"got {offsets.dtype} {tuple(offsets.shape)} on {offsets.device}")


def grouped_gateup(x_sorted, w_gate, w_up, offsets):
    """Entry 1: h [S,F] for expert-sorted rows x_sorted [S,E]; rows
    ``offsets[e] .. offsets[e+1]-1`` belong to expert e. ``w_up=None``:
    ``w_gate`` is the packed [NE,E,2F] gate|up stack (gate first);
    otherwise both are [NE,E,F]. The kernel is :func:`grouped_prefill`'s
    choice."""
    if x_sorted.device.type == "cpu":
        return grouped_gateup_plain(x_sorted, w_gate, w_up, offsets)
    S, E = x_sorted.shape
    NE = w_gate.shape[0]
    Fi = w_gate.shape[-1] // 2 if w_up is None else w_gate.shape[-1]
    if not grouped_shapes_ok(E, Fi):
        raise ValueError(f"grouped expert kernel needs E % {_TILE} == 0 and "
                         f"F % {_TILE // 2} == 0 (got E={E}, F={Fi})")
    dev = x_sorted.device
    _check("x_sorted", x_sorted, (S, E))
    _check("w_gate", w_gate, (NE, E, Fi if w_up is not None else 2 * Fi))
    if w_up is None:
        up_ptr, ldw = w_gate.data_ptr() + Fi * w_gate.element_size(), 2 * Fi
    else:
        _check("w_up", w_up, (NE, E, Fi))
        up_ptr, ldw = w_up.data_ptr(), Fi
    _check_offsets(offsets, NE, dev)
    prefill = grouped_prefill(S, NE, E, Fi)
    h = torch.empty((S, Fi), dtype=x_sorted.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if prefill:
        err = _lib().dstts_grouped_gateup_tc(
            x_sorted.data_ptr(), offsets.data_ptr(), w_gate.data_ptr(), up_ptr, ldw, NE, E,
            Fi, S, _sm_count(dev), h.data_ptr(), stream)
    else:
        err = _lib().dstts_grouped_gateup(
            x_sorted.data_ptr(), offsets.data_ptr(), w_gate.data_ptr(), up_ptr,
            E * ldw, ldw, NE, E, Fi, _row_splits(S, NE), h.data_ptr(), stream)
    _raise_if(err, "grouped_gateup")
    grouped_gateup.launches += 1
    grouped_gateup.prefill_launches += int(prefill)
    return h


grouped_gateup.launches = grouped_gateup.prefill_launches = 0


def grouped_down(h, w_down, offsets):
    """Entry 2: y [S,E] = h [S,F] @ Wd[e] [NE,F,E] over each expert's rows;
    the kernel as :func:`grouped_gateup` chooses it."""
    if h.device.type == "cpu":
        return grouped_down_plain(h, w_down, offsets)
    S, Fi = h.shape
    NE, _, E = w_down.shape
    if not grouped_shapes_ok(E, Fi):
        raise ValueError(f"grouped expert kernel needs E % {_TILE} == 0 and "
                         f"F % {_TILE // 2} == 0 (got E={E}, F={Fi})")
    dev = h.device
    _check("h", h, (S, Fi))
    _check("w_down", w_down, (NE, Fi, E))
    _check_offsets(offsets, NE, dev)
    prefill = grouped_prefill(S, NE, E, Fi)
    y = torch.empty((S, E), dtype=h.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if prefill:
        err = _lib().dstts_grouped_down_tc(
            h.data_ptr(), offsets.data_ptr(), w_down.data_ptr(), NE, Fi, E, S,
            _sm_count(dev), y.data_ptr(), stream)
    else:
        err = _lib().dstts_grouped_down(
            h.data_ptr(), offsets.data_ptr(), w_down.data_ptr(), NE, Fi, E,
            _row_splits(S, NE), y.data_ptr(), stream)
    _raise_if(err, "grouped_down")
    grouped_down.launches += 1
    grouped_down.prefill_launches += int(prefill)
    return y


grouped_down.launches = grouped_down.prefill_launches = 0


def grouped_occupancy() -> dict:
    """Blocks an SM holds of each grouped expert kernel, as the CUDA runtime
    computes them from registers, threads and shared memory."""
    out = (ctypes.c_int * 4)()
    _raise_if(_lib().dstts_grouped_occupancy(out), "grouped_occupancy")
    names = ("decode gate|up", "decode down", "prefill gate|up", "prefill down")
    return dict(zip(names, out))


# ------------------------------------------------ int8 grouped expert FFN

# JAX's capacity factor of the blocked int8 path (moe.py:56): twice the
# balanced load
BLOCKED_CAPACITY_FACTOR = 2.0


def expert_capacity(S: int, n_exp: int, capacity_factor: float = BLOCKED_CAPACITY_FACTOR
                    ) -> int:
    """Rows an expert computes of ``S`` expert-sorted rows on the int8 path
    (JAX ``moe.py:64-66``): ``ceil(int(cf·S) / NE)`` rounded up to a
    multiple of 8, at least 8. From static sizes: no host sync."""
    cap = -(-int(capacity_factor * S) // int(n_exp))
    return max(8, -(-cap // 8) * 8)


def _widened(w: dict, e: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert ``e`` of an int8 ``{q [NE,K,N], scales [NE,1,N]}`` stack: q
    widened to bf16 (exact: |q| <= 127) and the float32 scales."""
    return w["q"][e].to(torch.bfloat16), w["scales"][e].float()


def _capped_rows(bounds: list, e: int, cap: int) -> slice:
    """Expert ``e``'s computed rows: its first ``cap`` rows."""
    return slice(bounds[e], min(bounds[e + 1], bounds[e] + cap))


def grouped_gateup_i8_plain(x_sorted, w_gate, w_up, offsets, cap: int):
    """Reference for entry 1 of the int8 grouped expert kernel (JAX
    ``_expert_ffn_blocked``'s gate|up half): per expert e, over its first
    ``cap`` rows, g and u = (bf16(x) @ widened q) · scales with float32
    accumulators (left in float32), ``h = silu(g) · u`` rounded to x's
    dtype; rows past ``cap`` are 0."""
    wg, wu = _split_gateup(w_gate, w_up)
    h = x_sorted.new_zeros((x_sorted.shape[0], wg["q"].shape[-1]))
    xb = x_sorted.to(torch.bfloat16)
    bounds = offsets.tolist()
    for e in range(wg["q"].shape[0]):
        rows = _capped_rows(bounds, e, cap)
        if rows.start >= rows.stop:
            continue
        (qg, sg), (qu, su) = _widened(wg, e), _widened(wu, e)
        g = matmul_f32(xb[rows], qg) * sg
        u = matmul_f32(xb[rows], qu) * su
        h[rows] = (F.silu(g) * u).to(x_sorted.dtype)
    return h


def grouped_down_i8_plain(h, w_down, offsets, cap: int):
    """Reference for entry 2: ``y = (bf16(h) @ widened q) · scales`` over
    expert e's first ``cap`` rows, float32 accumulator, rounded to h's
    dtype; rows past ``cap`` are 0."""
    y = h.new_zeros((h.shape[0], w_down["q"].shape[-1]))
    hb = h.to(torch.bfloat16)
    bounds = offsets.tolist()
    for e in range(w_down["q"].shape[0]):
        rows = _capped_rows(bounds, e, cap)
        if rows.start < rows.stop:
            q, s = _widened(w_down, e)
            y[rows] = (matmul_f32(hb[rows], q) * s).to(h.dtype)
    return y


def _lib_i8():
    from ._build import load_library

    lib = load_library("moe_i8")
    if not getattr(lib, "_dstts_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dstts_grouped_gateup_i8.argtypes = [p, p, i] + [p] * 4 + [i] * 5 + [p, p]
        lib.dstts_grouped_gateup_i8.restype = i
        lib.dstts_grouped_down_i8.argtypes = [p, p, i, p, p] + [i] * 4 + [p, p]
        lib.dstts_grouped_down_i8.restype = i
        lib.dstts_grouped_gateup_i8_tc.argtypes = [p, p, i] + [p] * 4 + [i] * 6 + [p, p]
        lib.dstts_grouped_gateup_i8_tc.restype = i
        lib.dstts_grouped_down_i8_tc.argtypes = [p, p, i, p, p] + [i] * 5 + [p, p]
        lib.dstts_grouped_down_i8_tc.restype = i
        lib.dstts_grouped_i8_occupancy.argtypes = [p]
        lib.dstts_grouped_i8_occupancy.restype = i
        lib._dstts_typed = True
    return lib


def _check_i8(name: str, w: dict, shape: tuple) -> None:
    _check(name + "['q']", w["q"], shape, dtype=torch.int8)
    _check(name + "['scales']", w["scales"], shape[:-2] + (1, shape[-1]), dtype=torch.float32)


def grouped_gateup_i8(x_sorted, w_gate, w_up, offsets, cap: int):
    """Entry 1 of the int8 grouped expert kernel: h [S,F] for expert-sorted
    rows x_sorted [S,E] (bf16), each expert's first ``cap`` rows (the rest
    0). ``w_up=None``: ``w_gate`` is the packed ``{q [NE,E,2F], scales
    [NE,1,2F]}`` gate|up leaf (gate first); otherwise both are ``{q
    [NE,E,F], scales [NE,1,F]}``. The form is :func:`grouped_prefill`'s
    choice."""
    if x_sorted.device.type == "cpu":
        return grouped_gateup_i8_plain(x_sorted, w_gate, w_up, offsets, cap)
    S, E = x_sorted.shape
    q, s = w_gate["q"], w_gate["scales"]
    NE = q.shape[0]
    Fi = q.shape[-1] // 2 if w_up is None else q.shape[-1]
    if not grouped_shapes_ok(E, Fi):
        raise ValueError(f"int8 grouped expert kernel needs E % {_TILE} == 0 and "
                         f"F % {_TILE // 2} == 0 (got E={E}, F={Fi})")
    dev = x_sorted.device
    _check("x_sorted", x_sorted, (S, E))
    _check_i8("w_gate", w_gate, (NE, E, Fi if w_up is not None else 2 * Fi))
    if w_up is None:
        up_q, up_s, ldw = q.data_ptr() + Fi, s.data_ptr() + 4 * Fi, 2 * Fi
    else:
        _check_i8("w_up", w_up, (NE, E, Fi))
        up_q, up_s, ldw = w_up["q"].data_ptr(), w_up["scales"].data_ptr(), Fi
    _check_offsets(offsets, NE, dev)
    prefill = grouped_prefill(S, NE, E, Fi)
    h = torch.empty((S, Fi), dtype=x_sorted.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if prefill:
        err = _lib_i8().dstts_grouped_gateup_i8_tc(
            x_sorted.data_ptr(), offsets.data_ptr(), int(cap), q.data_ptr(), up_q,
            s.data_ptr(), up_s, ldw, NE, E, Fi, S, _sm_count(dev), h.data_ptr(), stream)
    else:
        err = _lib_i8().dstts_grouped_gateup_i8(
            x_sorted.data_ptr(), offsets.data_ptr(), int(cap), q.data_ptr(), up_q,
            s.data_ptr(), up_s, ldw, NE, E, Fi, _row_splits(S, NE), h.data_ptr(), stream)
    _raise_if(err, "grouped_gateup_i8")
    grouped_gateup_i8.launches += 1
    grouped_gateup_i8.prefill_launches += int(prefill)
    return h


grouped_gateup_i8.launches = grouped_gateup_i8.prefill_launches = 0


def grouped_down_i8(h, w_down, offsets, cap: int):
    """Entry 2: y [S,E] = (h [S,F] @ Wd[e]) · sd[e] over each expert's
    first ``cap`` rows (the rest 0); w_down ``{q [NE,F,E], scales
    [NE,1,E]}``; the form as :func:`grouped_gateup_i8` chooses it."""
    if h.device.type == "cpu":
        return grouped_down_i8_plain(h, w_down, offsets, cap)
    S, Fi = h.shape
    NE, _, E = w_down["q"].shape
    if not grouped_shapes_ok(E, Fi):
        raise ValueError(f"int8 grouped expert kernel needs E % {_TILE} == 0 and "
                         f"F % {_TILE // 2} == 0 (got E={E}, F={Fi})")
    dev = h.device
    _check("h", h, (S, Fi))
    _check_i8("w_down", w_down, (NE, Fi, E))
    _check_offsets(offsets, NE, dev)
    prefill = grouped_prefill(S, NE, E, Fi)
    y = torch.empty((S, E), dtype=h.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    q, sc = w_down["q"].data_ptr(), w_down["scales"].data_ptr()
    if prefill:
        err = _lib_i8().dstts_grouped_down_i8_tc(
            h.data_ptr(), offsets.data_ptr(), int(cap), q, sc, NE, Fi, E, S, _sm_count(dev),
            y.data_ptr(), stream)
    else:
        err = _lib_i8().dstts_grouped_down_i8(
            h.data_ptr(), offsets.data_ptr(), int(cap), q, sc, NE, Fi, E, _row_splits(S, NE),
            y.data_ptr(), stream)
    _raise_if(err, "grouped_down_i8")
    grouped_down_i8.launches += 1
    grouped_down_i8.prefill_launches += int(prefill)
    return y


grouped_down_i8.launches = grouped_down_i8.prefill_launches = 0


def grouped_i8_occupancy() -> dict:
    """Blocks an SM holds of each int8 grouped expert entry's kernel, as the
    CUDA runtime computes them."""
    out = (ctypes.c_int * 4)()
    _raise_if(_lib_i8().dstts_grouped_i8_occupancy(out), "grouped_i8_occupancy")
    names = ("int8 gate|up", "int8 down", "int8 prefill gate|up", "int8 prefill down")
    return dict(zip(names, out))


PREFILL_TILE_ROWS = 256   # expert-sorted rows a tile of either prefill kernel (csrc XBM, PBM)


def i8_prefill_items(offsets: list, cap: int, n_tiles: int) -> list[tuple[int, int, int, int, int]]:
    """The int8 prefill kernel's work list (csrc ``grouped_expert_i8_tc``'s
    ``item``), from the group offsets (read on the card, a host list here)
    and the capacity: item w → ``(expert, n-tile, m-tile, first row,
    rows)``. Expert e owns ceil(min(rows_e, cap) / 256) m-tiles; its items
    are n-tile-major; the item's rows are those of its tile before the
    expert's computed end min(offsets[e+1], offsets[e] + cap). Block b of a
    grid of G takes items b, b + G, ...; the item of an expert's last
    m-tile also writes its rows past the capacity as zeros."""
    from bisect import bisect_right

    NE = len(offsets) - 1
    cum = [0]
    for e in range(NE):
        cum.append(cum[-1] + -(-min(offsets[e + 1] - offsets[e], cap) // PREFILL_TILE_ROWS))
    firsts = [c * n_tiles for c in cum[:NE]]
    out = []
    for w in range(cum[NE] * n_tiles):
        e = bisect_right(firsts, w) - 1    # the last expert whose first item is <= w
        nt, mt = divmod(w - firsts[e], cum[e + 1] - cum[e])
        row0 = offsets[e] + mt * PREFILL_TILE_ROWS
        end = min(offsets[e + 1], offsets[e] + cap)
        out.append((e, nt, mt, row0, min(PREFILL_TILE_ROWS, end - row0)))
    return out


def _expert_ffn_blocked(x_sorted, w_gate, w_up, w_down, offsets, plain: bool = False,
                        n_exp: int | None = None):
    """Grouped SwiGLU over int8 expert weights (JAX ``moe.py:56``): each
    expert computes its first :func:`expert_capacity` rows (of S = T·k),
    the rows past it are 0; the int8 kernel's two entries, or with
    ``plain`` their plain versions. ``w_up=None``: the packed gate|up
    leaf. ``n_exp``: the global expert count the capacity is taken over
    (an expert-parallel rank's offsets cover its own experts only)."""
    cap = expert_capacity(x_sorted.shape[0], n_exp or offsets.shape[0] - 1)
    gateup, down = ((grouped_gateup_i8_plain, grouped_down_i8_plain) if plain
                    else (grouped_gateup_i8, grouped_down_i8))
    return down(gateup(x_sorted, w_gate, w_up, offsets, cap), w_down, offsets, cap)


def _plain_vjp(plain, ctx, grad_out) -> tuple:
    """The vector-Jacobian product of ``plain`` at the inputs ``ctx``
    saved: ``plain`` recomputed under autograd, then ``autograd.grad``
    (None for the inputs that need none)."""
    need = ctx.needs_input_grad
    args = [t.detach().requires_grad_(n) if isinstance(t, torch.Tensor) and n else t
            for t, n in zip(ctx.saved_tensors, need)]
    wrt = [a for a, n in zip(args, need) if n]
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(plain(*args), wrt, grad_out, allow_unused=True))
    return tuple(next(grads) if n else None for n in need)


class _GroupedGateUp(torch.autograd.Function):
    """:func:`grouped_gateup` under autograd: the kernel forward (on the
    card), and as backward the vector-Jacobian product of
    :func:`grouped_gateup_plain` at the same inputs (JAX differentiates
    ``lax.ragged_dot``, XLA, whose transpose is products too)."""

    @staticmethod
    def forward(ctx, x_sorted, w_gate, w_up, offsets):
        ctx.save_for_backward(x_sorted, w_gate, w_up, offsets)
        return grouped_gateup(x_sorted, w_gate, w_up, offsets)

    @staticmethod
    def backward(ctx, grad_h):
        return _plain_vjp(grouped_gateup_plain, ctx, grad_h)


class _GroupedDown(torch.autograd.Function):
    """:func:`grouped_down` under autograd, as :class:`_GroupedGateUp`."""

    @staticmethod
    def forward(ctx, h, w_down, offsets):
        ctx.save_for_backward(h, w_down, offsets)
        return grouped_down(h, w_down, offsets)

    @staticmethod
    def backward(ctx, grad_y):
        return _plain_vjp(grouped_down_plain, ctx, grad_y)


def _expert_ffn_ragged(x_sorted, w_gate, w_up, w_down, offsets, plain: bool = False,
                       n_exp: int | None = None):
    """Grouped SwiGLU over expert-sorted rows (JAX ``moe.py:81``; here the
    grouped expert kernel's two entries — under autograd through their
    ``autograd.Function``s, so that training gets gradients —, or with
    ``plain`` their plain versions on any device: a reference on the card);
    int8 ``{q, scales}`` experts take :func:`_expert_ffn_blocked`, as in
    JAX. ``w_up=None`` means ``w_gate`` is the packed [NE, E, 2F] gate|up
    layout."""
    if is_quantized(w_gate):
        return _expert_ffn_blocked(x_sorted, w_gate, w_up, w_down, offsets, plain, n_exp)
    if plain:
        gateup, down = grouped_gateup_plain, grouped_down_plain
    elif torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                         for t in (x_sorted, w_gate, w_up, w_down)):
        gateup, down = _GroupedGateUp.apply, _GroupedDown.apply
    else:   # serving: the kernels themselves, without autograd's dispatch
        gateup, down = grouped_gateup, grouped_down
    return down(gateup(x_sorted, w_gate, w_up, offsets), w_down, offsets)


# ---------------------------------------------------------------- dispatch

def moe_ragged(x, router_w, w_gate, w_up, w_down, top_k: int,
               norm_topk_prob: bool = True, router_logits=None, plain: bool = False,
               experts: tuple[int, int] | None = None):
    """x [T,E] tokens; router_w [E,NE] (None with ``router_logits`` [T,NE]
    given, as the fused decode path does); w_gate [NE,E,F] or packed
    [NE,E,2F] with ``w_up=None``; w_down [NE,F,E] → [T,E] in x's dtype.
    ``plain``: the expert FFN's plain versions (:func:`_expert_ffn_ragged`).
    ``experts``: this rank's (first, count) of an expert-parallel layer
    (:func:`dispatch_ragged`)."""
    if router_logits is None:
        router_logits = matmul_f32(x, router_w)
    top_p, top_e = route_topk(router_logits, top_k, norm_topk_prob)
    return dispatch_ragged(x, top_p, top_e, router_logits.shape[1], w_gate, w_up, w_down,
                           plain, experts)


def dispatch_ragged(x, top_w, top_e, n_exp: int, w_gate, w_up, w_down, plain: bool = False,
                    experts: tuple[int, int] | None = None):
    """The dispatch half of :func:`moe_ragged`, shared by both routers (the
    Qwen3-MoE softmax and DeepSeek-V3's sigmoid group routing): sort the
    (token, expert) assignments of ``top_e`` [T,k] by expert, run the
    grouped SwiGLU over the expert-sorted rows, un-sort and sum the k rows
    of each token weighted by ``top_w`` [T,k] (cast to x's dtype first).

    ``experts=(first, count)``: the weight stacks hold experts ``first ..
    first+count-1`` only (an expert-parallel rank). Assignments to other
    experts sort past the local ones (outside every group, so the kernels
    skip them) and contribute 0: the result is this rank's part of the
    sum over ranks. The capacity of int8 experts is still taken over all
    ``n_exp`` (JAX's rule on the global layer)."""
    T, E = x.shape
    top_k = top_e.shape[1]
    flat_e = top_e.reshape(-1)
    n_total = n_exp
    local = None
    if experts is not None:
        first, n_exp = experts
        flat_e = flat_e - first
        local = (flat_e >= 0) & (flat_e < n_exp)
        flat_e = torch.where(local, flat_e, n_exp)     # past every local group
    order = torch.argsort(flat_e, stable=True)         # assignments by expert
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    x_sorted = x[order // top_k]                        # [S, E]
    offsets = group_offsets(flat_e, n_exp + (local is not None))[:n_exp + 1]
    y_sorted = _expert_ffn_ragged(x_sorted, w_gate, w_up, w_down, offsets.contiguous(),
                                  plain, n_total)
    y = y_sorted[inv]
    if local is not None:   # the rows past the groups were never computed
        y = torch.where(local[:, None], y, 0)
    y = y.reshape(T, top_k, E)
    return (y * top_w.to(y.dtype)[..., None]).sum(1).to(x.dtype)


def _expert_dot(xe, w):
    """Batched per-expert ``[e,c,d] @ [e,d,f] -> [e,c,f]``, float32 out. An
    int8 ``{q, scales}`` leaf multiplies bf16(xe) by q (exact in float32)
    and applies the column scales to the float32 sums (JAX ``moe.py:40``)."""
    if is_quantized(w):
        return torch.bmm(xe.to(torch.bfloat16).float(), w["q"].float()) * w["scales"].float()
    return torch.bmm(xe.float(), w.float())


def moe_capacity(x, router_w, w_gate, w_up, w_down, top_k: int,
                 norm_topk_prob: bool = True, capacity_factor: float = 1.25,
                 experts: tuple[int, int] | None = None, router_logits=None, data=None):
    """Capacity-bounded one-hot dispatch (JAX ``moe.py:223``): each expert
    takes at most ``max(1, int(capacity_factor·T·k/NE))`` assignments in
    token order; the rest drop (their gate weight is 0). The expert weights
    may be int8 ``{q, scales}`` leaves (:func:`_expert_dot`).
    ``experts=(first, count)``: the weights are those experts' only (an
    expert-parallel rank); the dispatch is the global one, its columns of
    the other experts dropped, and the result this rank's part of the sum
    over ranks. ``router_logits``: x's router logits, computed already.
    ``data=(group, index, count)``: x is data rank ``index``'s rows of a
    batch split over ``count`` ranks (sharded training); the capacity and
    each assignment's place in its expert's buffer are the whole batch's,
    as JAX computes them on the global array."""
    T, E = x.shape
    n_exp = router_w.shape[1]
    T_all = T * (data[2] if data is not None else 1)
    cap = max(1, int(capacity_factor * T_all * top_k / n_exp))
    dt = x.dtype

    if router_logits is None:
        router_logits = matmul_f32(x, router_w)
    top_p, top_e = route_topk(router_logits, top_k, norm_topk_prob)
    onehot = F.one_hot(top_e, n_exp)                               # [T,k,NE]
    flat = onehot.reshape(T * top_k, n_exp)
    pos_in_expert = torch.cumsum(flat, 0) - flat
    if data is not None:   # the assignments of the data ranks before this one
        from ..parallel.collectives import all_gather

        group, index, _ = data
        counts = all_gather(flat.sum(0, keepdim=True), 0, group)
        pos_in_expert = pos_in_expert + counts[:index].sum(0)
    pos_in_expert = pos_in_expert.reshape(T, top_k, n_exp)
    pos = (pos_in_expert * onehot).sum(-1)                         # [T,k]
    keep = pos < cap
    gates = top_p * keep

    pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]   # [T,k,cap]
    disp = torch.einsum("tke,tkc->tec", onehot.to(dt), pos_oh.to(dt))
    comb = torch.einsum("tke,tkc,tk->tec", onehot.float(), pos_oh.float(),
                        gates).to(dt)
    if experts is not None:
        first, count = experts
        disp, comb = disp[:, first:first + count], comb[:, first:first + count]
    xe = torch.einsum("tec,td->ecd", disp, x)                      # [NE,cap,E]
    g = _expert_dot(xe, w_gate)
    u = _expert_dot(xe, w_up)
    h = (F.silu(g) * u).to(dt)
    ye = _expert_dot(h, w_down).to(dt)
    return torch.einsum("tec,ecd->td", comb, ye).to(dt)


def moe_ep_alltoall(x, router_w, w_gate, w_up, w_down, top_k: int, group,
                    norm_topk_prob: bool = True, capacity_factor: float = 2.0,
                    return_keep: bool = False):
    """Explicit expert-parallel MoE (JAX ``moe.py:131-225``): tokens and
    experts sharded over the ``ep`` ranks of ``group``, dispatch and return
    by all-to-all (:func:`..parallel.collectives.all_to_all`).

    Each rank calls it on its own tokens x [T_l,E] with the replicated
    router [E,NE] and its experts' weights [NE/n, ...] (JAX's ``shard_map``
    body): it routes its tokens, packs the assignments into fixed
    per-destination buckets of capacity ``ceil(int(cf·T_l·k) / n)``
    (overflow drops, in assignment order, as :func:`moe_capacity` drops),
    exchanges them, runs its local experts' SwiGLU capacity-style (float32
    products, h and y rounded to x's dtype), returns the results by a
    second all-to-all and combines them with the gate weights in float32.
    Returns [T_l,E] in x's dtype, and with ``return_keep`` also the
    assignments kept [T_l,k] (False = dropped)."""
    from ..parallel.collectives import all_to_all, group_size

    n_ep = group_size(group)
    n_exp = router_w.shape[1]
    if n_exp % n_ep:
        raise ValueError(f"{n_exp} experts do not split over {n_ep} ranks")
    per_dev = n_exp // n_ep
    T_l, E = x.shape
    dev = x.device
    cap = max(1, -(-int(capacity_factor * T_l * top_k) // n_ep))
    top_p, top_e = route_topk(matmul_f32(x, router_w), top_k, norm_topk_prob)   # [T_l,k]
    dest = (top_e // per_dev).reshape(-1)
    local_e = (top_e % per_dev).reshape(-1)
    # slot of each assignment within its destination bucket
    oh = F.one_hot(dest, n_ep)
    pos = (torch.cumsum(oh, 0) - oh)[torch.arange(T_l * top_k, device=dev), dest]
    keep = pos < cap
    slot = torch.where(keep, pos, cap)                  # cap = the drop row
    send_x = torch.zeros((n_ep, cap + 1, E), dtype=x.dtype, device=dev)
    send_x[dest, slot] = x.repeat_interleave(top_k, dim=0)
    send_e = torch.full((n_ep, cap + 1), -1, dtype=torch.int64, device=dev)
    send_e[dest, slot] = local_e
    recv_x = all_to_all(send_x[:, :cap].contiguous(), 0, 0, group)
    recv_e = all_to_all(send_e[:, :cap].contiguous(), 0, 0, group)
    # recv_*: [n_ep·cap, ...] rows for this rank's experts, by source
    rx = recv_x.reshape(n_ep * cap, E)
    re = recv_e.reshape(n_ep * cap)
    Cl = n_ep * cap
    valid = re >= 0
    rec = re.clamp(0, per_dev - 1)
    eoh = F.one_hot(torch.where(valid, re, per_dev), per_dev + 1)[:, :per_dev]
    epos = (torch.cumsum(eoh, 0) - eoh)[torch.arange(Cl, device=dev), rec]
    xe = torch.zeros((per_dev, Cl + 1, E), dtype=rx.dtype, device=dev)
    xe[rec, torch.where(valid, epos, Cl)] = rx
    xe = xe[:, :Cl]
    wg, wu = _split_gateup(w_gate, w_up)
    h = (F.silu(_expert_dot(xe, wg)) * _expert_dot(xe, wu)).to(rx.dtype)
    ye = _expert_dot(h, w_down).to(rx.dtype)                        # [pd,Cl,E]
    ry = torch.where(valid[:, None], ye[rec, epos.clamp(max=Cl - 1)], 0).reshape(n_ep, cap, E)
    back = all_to_all(ry.contiguous(), 0, 0, group)
    # back[d, s]: the result for the assignment packed into bucket d slot s
    got = back[dest, slot.clamp(max=cap - 1)]
    got = torch.where(keep[:, None], got, 0).reshape(T_l, top_k, E)
    out = (got.float() * top_p[..., None]).sum(1).to(x.dtype)
    return (out, keep.reshape(T_l, top_k)) if return_keep else out
