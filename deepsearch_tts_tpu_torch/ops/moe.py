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
* :func:`moe_capacity` — the GShard capacity-bounded one-hot dispatch, the
  other ``moe_impl`` (plain torch; tokens past an expert's capacity drop).

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
group offsets on the host. Each wrapper counts its launches of either
kernel in ``launches`` and those of the prefill kernel in
``prefill_launches``. ``_expert_ffn_blocked`` (int8 experts, ROADMAP A10) and
``moe_ep_alltoall`` (A13) are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import ctypes

from ..models.common import matmul_f32
from .fused_layer import _TILE, _check, _lib, _raise_if
from .paged_attention import _sm_count

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
    """(gate, up) [NE,E,F] views of either gate|up layout."""
    if w_up is None:
        Fi = w_gate.shape[-1] // 2
        return w_gate[..., :Fi], w_gate[..., Fi:]
    return w_gate, w_up


def grouped_gateup_plain(x_sorted, w_gate, w_up, offsets):
    """Reference for entry 1 of the grouped expert kernel: per expert e,
    ``h = silu(g) · u`` over its rows with g, u = x@Wg[e], x@Wu[e] rounded to
    x's dtype (float32 accumulators) and silu in float32."""
    wg, wu = _split_gateup(w_gate, w_up)
    h = x_sorted.new_empty((x_sorted.shape[0], wg.shape[-1]))
    bounds = offsets.tolist()
    for e in range(wg.shape[0]):
        rows = slice(bounds[e], bounds[e + 1])
        if rows.start == rows.stop:
            continue
        xs = x_sorted[rows]
        g = matmul_f32(xs, wg[e]).to(x_sorted.dtype)
        u = matmul_f32(xs, wu[e]).to(x_sorted.dtype)
        h[rows] = (F.silu(g.float()) * u.float()).to(x_sorted.dtype)
    return h


def grouped_down_plain(h, w_down, offsets):
    """Reference for entry 2: ``y = h @ Wd[e]`` over expert e's rows,
    float32 accumulator, rounded to h's dtype."""
    y = h.new_empty((h.shape[0], w_down.shape[-1]))
    bounds = offsets.tolist()
    for e in range(w_down.shape[0]):
        rows = slice(bounds[e], bounds[e + 1])
        if rows.start != rows.stop:
            y[rows] = matmul_f32(h[rows], w_down[e]).to(h.dtype)
    return y


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


def _expert_ffn_ragged(x_sorted, w_gate, w_up, w_down, offsets, plain: bool = False):
    """Grouped SwiGLU over expert-sorted rows (JAX ``moe.py:81``; here the
    grouped expert kernel's two entries, or with ``plain`` their plain
    versions on any device: a reference on the card). ``w_up=None`` means
    ``w_gate`` is the packed [NE, E, 2F] gate|up layout."""
    gateup, down = ((grouped_gateup_plain, grouped_down_plain) if plain
                    else (grouped_gateup, grouped_down))
    return down(gateup(x_sorted, w_gate, w_up, offsets), w_down, offsets)


# ---------------------------------------------------------------- dispatch

def moe_ragged(x, router_w, w_gate, w_up, w_down, top_k: int,
               norm_topk_prob: bool = True, router_logits=None, plain: bool = False):
    """x [T,E] tokens; router_w [E,NE] (None with ``router_logits`` [T,NE]
    given, as the fused decode path does); w_gate [NE,E,F] or packed
    [NE,E,2F] with ``w_up=None``; w_down [NE,F,E] → [T,E] in x's dtype.
    ``plain``: the expert FFN's plain versions (:func:`_expert_ffn_ragged`)."""
    if router_logits is None:
        router_logits = matmul_f32(x, router_w)
    top_p, top_e = route_topk(router_logits, top_k, norm_topk_prob)
    return dispatch_ragged(x, top_p, top_e, router_logits.shape[1], w_gate, w_up, w_down,
                           plain)


def dispatch_ragged(x, top_w, top_e, n_exp: int, w_gate, w_up, w_down, plain: bool = False):
    """The dispatch half of :func:`moe_ragged`, shared by both routers (the
    Qwen3-MoE softmax and DeepSeek-V3's sigmoid group routing): sort the
    (token, expert) assignments of ``top_e`` [T,k] by expert, run the
    grouped SwiGLU over the expert-sorted rows, un-sort and sum the k rows
    of each token weighted by ``top_w`` [T,k] (cast to x's dtype first)."""
    T, E = x.shape
    top_k = top_e.shape[1]
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)         # assignments by expert
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    x_sorted = x[order // top_k]                        # [S, E]
    y_sorted = _expert_ffn_ragged(x_sorted, w_gate, w_up, w_down,
                                  group_offsets(flat_e, n_exp), plain)
    y = y_sorted[inv].reshape(T, top_k, E)
    return (y * top_w.to(y.dtype)[..., None]).sum(1).to(x.dtype)


def _expert_dot(xe, w):
    """Batched per-expert ``[e,c,d] @ [e,d,f] -> [e,c,f]``, float32 out."""
    return torch.bmm(xe.float(), w.float())


def moe_capacity(x, router_w, w_gate, w_up, w_down, top_k: int,
                 norm_topk_prob: bool = True, capacity_factor: float = 1.25):
    """Capacity-bounded one-hot dispatch (JAX ``moe.py:223``): each expert
    takes at most ``max(1, int(capacity_factor·T·k/NE))`` assignments in
    token order; the rest drop (their gate weight is 0)."""
    T, E = x.shape
    n_exp = router_w.shape[1]
    cap = max(1, int(capacity_factor * T * top_k / n_exp))
    dt = x.dtype

    top_p, top_e = route_topk(matmul_f32(x, router_w), top_k, norm_topk_prob)
    onehot = F.one_hot(top_e, n_exp)                               # [T,k,NE]
    flat = onehot.reshape(T * top_k, n_exp)
    pos_in_expert = (torch.cumsum(flat, 0) - flat).reshape(T, top_k, n_exp)
    pos = (pos_in_expert * onehot).sum(-1)                         # [T,k]
    keep = pos < cap
    gates = top_p * keep

    pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]   # [T,k,cap]
    disp = torch.einsum("tke,tkc->tec", onehot.to(dt), pos_oh.to(dt))
    comb = torch.einsum("tke,tkc,tk->tec", onehot.float(), pos_oh.float(),
                        gates).to(dt)
    xe = torch.einsum("tec,td->ecd", disp, x)                      # [NE,cap,E]
    g = _expert_dot(xe, w_gate)
    u = _expert_dot(xe, w_up)
    h = (F.silu(g) * u).to(dt)
    ye = _expert_dot(h, w_down).to(dt)
    return torch.einsum("tec,ecd->td", comb, ye).to(dt)
