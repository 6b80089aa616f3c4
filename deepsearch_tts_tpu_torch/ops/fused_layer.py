"""Fused decode-layer functions (port of ``ops/fused_layer.py``, kernels
B3/B4/B7/B8/B10).

Each T=1 decode layer of a packed bf16 model runs two of them:

* :func:`fused_qkv_stacked` (B3, both families) — rmsnorm(x)·ln1[l] →
  x@wqkv[l] → per-head q/k RMSNorm → rotate-half RoPE (v passes through).
  Three launches (the input norm, the split-K product, the epilogue); cos
  / sin in float32 or bf16, read as stored.
* :func:`fused_out_mlp_stacked` (B4, dense) — x2 = x + a@wo[l] →
  rmsnorm(x2)·ln2[l] → SwiGLU over the packed gate|up stack → out = x2 +
  h@wd[l].
* :func:`fused_out_router_stacked` (B7, Qwen3-MoE) — x2 = x + a@wo[l], hn =
  rmsnorm(x2)·ln2[l], float32 router logits hn@router[l]; the expert FFN
  follows in ``ops/moe.py``. One cooperative launch of ``i8_stream`` over
  bf16 weights: wo streamed as B10's products are, a grid barrier, x2
  and its sums of squares by (row, tile), a grid barrier, then the norm
  and the router product by items of (8 expert columns, a few rows)
  (:func:`b7_router_plan`), each logit summed by one block.
* :func:`fused_mlp_stacked` (B8, DeepSeek-V3 / Kimi-K2) — ``[x +] (silu(xn
  @ wg[l]) · (xn @ wu[l])) @ wd[l]`` over unpacked gate and up stacks, xn =
  rmsnorm(x)·ln[l] or x: the MLA family's dense-layer MLPs (norm and
  residual) and shared experts (neither); its attention stays plain.
* :func:`fused_mlp` / :func:`fused_qkv` / :func:`fused_out_mlp` (B11) —
  the JAX package's one-layer forms, which only its tests call: B8, B3 and
  B4 at L = 1 over ``t[None]`` views of the single matrices; unpacked
  gate/up in ``fused_out_mlp`` take B4's x2 phase and then B8's
  two-pointer path (one C entry), so no packed copy is made.
* :func:`fused_qkv_stacked_i8` / :func:`fused_out_mlp_stacked_i8` (B10,
  dense, int8 weights) — B3 / B4 over int8 stacks ``[L,K,N]`` with float32
  per-column scales ``[L,1,N]`` (``ops/quant.quantize_params`` layout),
  the scales applied to the float32 accumulators. :func:`int8_product` is
  the bare product, ``bf16((x @ w_q) * scales)``, which
  ``ops/quant.int8_matmul`` runs at up to 64 rows. All three run one
  kernel, ``i8_stream``: a persistent grid over a stream-K split of
  (column tile, ring stage) pairs (``i8_partition``), the int8 widened in
  registers, split tiles summed and finished (epilogue included) inside
  the kernel.

All take the FULL layer stacks plus the layer index, as the JAX kernels do.
For a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/fused_layer.cu`` (bf16 only) or raises; for a CPU tensor it runs the
plain PyTorch version beside it (``*_plain``), which follows the dtype of
``x`` and holds the kernel's bf16 round points. Each wrapper counts its
kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models.common import apply_rope, matmul_f32, rms_norm

HEAD_DIM = 128     # head width the q/k epilogue kernel is written for
_TILE = 128        # output columns per product block (csrc: TILE)
_KT = 32           # k rows per pipeline stage (csrc: KT)
_MAX_ROWS = 64     # activation rows per product block (csrc: MAX_ROWS)
_TARGET_BLOCKS = 264  # >= 2 blocks per SM on a 132-SM H100
# B10's int8 product (csrc i8_stream, one persistent block an SM): the widest
# tile (columns), the k rows every product's K must be a multiple of (a
# 128-column tile's ring stage) and ring stages by m-tiles (16-row tiles
# that cover B); scripts/sweep_hopper_kernels.py times the last
I8_TILE = 256
I8_STAGE_ROWS = 64
I8_STAGES = {1: 6, 2: 6, 4: 4}
_I8_MAX_TILES = 4096   # 128-column tiles the ticket buffer holds (csrc I8_MAX_TILES)
B7_BAND = 8            # router columns a B7 phase-2 item (csrc RBW)
B7_ROWS = 16           # most rows a B7 phase-2 item (csrc RROWS)
B7_KC = 4096           # k rows a B7 phase-2 chunk (csrc B7_KC)
# the device's tickets: the int8 product's, one a tile, then B7's grid
# barrier count (one int64)
_i8_tickets: dict = {}


# ----------------------------------------------------------------- plain torch

def fused_qkv_stacked_plain(x, ln_all, wqkv_all, qn_all, kn_all, cos, sin, layer,
                            *, n_heads: int, n_kv: int, head_dim: int,
                            eps: float = 1e-6):
    """Reference for B3: same math and round points as
    ``_qkv_stacked_kernel`` (xn rounded to x's dtype, float32 accumulator,
    norm and rope in float32, one final rounding)."""
    xn = rms_norm(x, ln_all[layer], eps)
    return _qkv_epilogue(matmul_f32(xn, wqkv_all[layer]), x, qn_all[layer],
                         kn_all[layer], cos, sin, n_heads=n_heads, n_kv=n_kv,
                         head_dim=head_dim, eps=eps)


def _qkv_epilogue(y, x, qn, kn, cos, sin, *, n_heads: int, n_kv: int,
                  head_dim: int, eps: float):
    """B3's (and B10's) float32 epilogue over the projection y [B,C]:
    per-head q/k RMSNorm and rope in float32, one rounding to x's dtype."""
    B = y.shape[0]
    H, K, D = n_heads, n_kv, head_dim
    y = y.view(B, H + 2 * K, D)
    w = torch.cat([qn.expand(H, D), kn.expand(K, D)])
    roped = apply_rope(rms_norm(y[:, : H + K], w, eps), cos, sin)
    q = roped[:, :H].reshape(B, H * D).to(x.dtype)
    k = roped[:, H:].reshape(B, K * D).to(x.dtype)
    v = y[:, H + K:].reshape(B, K * D).to(x.dtype)
    return q, k, v


def fused_qkv_stacked_i8_plain(x, ln_all, wqkv_q, wqkv_s, qn_all, kn_all, cos, sin,
                               layer, *, n_heads: int, n_kv: int, head_dim: int,
                               eps: float = 1e-6):
    """Reference for B10-qkv: the round points of ``_qkv_stacked_kernel_i8``
    (``fused_layer.py:568``): xn rounded to x's dtype, xn @ widened int8
    (exact) with a float32 accumulator, times the column scales, then B3's
    epilogue."""
    xn = rms_norm(x, ln_all[layer], eps)
    y = matmul_f32(xn, wqkv_q[layer].to(xn.dtype)) * wqkv_s[layer].float()
    return _qkv_epilogue(y, x, qn_all[layer], kn_all[layer], cos, sin, n_heads=n_heads,
                         n_kv=n_kv, head_dim=head_dim, eps=eps)


def fused_out_mlp_stacked_i8_plain(attn_out, x, wo_q, wo_s, ln_all, gateup_q, gateup_s,
                                   wd_q, wd_s, layer, *, eps: float = 1e-6):
    """Reference for B10-out: the round points of
    ``_out_mlp_stacked_kernel_i8`` (``fused_layer.py:669``): each product
    over the widened int8 matrix in float32 times its column scales; g and
    u scaled before silu; x2, xn, h and out rounded to x's dtype."""
    dt = x.dtype
    Fi = gateup_q.shape[-1] // 2
    x2 = (x.float() + matmul_f32(attn_out, wo_q[layer].to(dt)) * wo_s[layer].float()).to(dt)
    xn = rms_norm(x2, ln_all[layer], eps)
    gu = matmul_f32(xn, gateup_q[layer].to(dt)) * gateup_s[layer].float()
    h = (F.silu(gu[:, :Fi]) * gu[:, Fi:]).to(dt)
    return (x2.float() + matmul_f32(h, wd_q[layer].to(dt)) * wd_s[layer].float()).to(dt)


def int8_product_plain(x, w_q, scales):
    """Reference for :func:`int8_product`: ``((bf16(x) @ w_q) * scales)``
    with a float32 accumulator, rounded to x's dtype (``quant.py:68-75``)."""
    acc = matmul_f32(x.to(torch.bfloat16), w_q.to(torch.bfloat16))
    return (acc * scales.float()).to(x.dtype)


def fused_out_mlp_stacked_plain(attn_out, x, wo_all, ln_all, gateup_all, wd_all,
                                layer, *, eps: float = 1e-6):
    """Reference for B4: same math and round points as
    ``_out_mlp_stacked_kernel`` (x2, xn, h and out rounded to x's dtype;
    float32 accumulators)."""
    dt = x.dtype
    Fi = gateup_all.shape[-1] // 2
    x2 = (x.float() + matmul_f32(attn_out, wo_all[layer])).to(dt)
    xn = rms_norm(x2, ln_all[layer], eps)
    gu = matmul_f32(xn, gateup_all[layer])
    h = (F.silu(gu[:, :Fi]) * gu[:, Fi:]).to(dt)
    return (x2.float() + matmul_f32(h, wd_all[layer])).to(dt)


def fused_mlp_stacked_plain(x, ln_all, wg_all, wu_all, wd_all, layer, *,
                            eps: float = 1e-6, residual: bool = True, norm: bool = True):
    """Reference for B8: the round points of ``_mlp_stacked_kernel``
    (``fused_layer.py:468-491``): xn = rmsnorm(x)·ln[l] rounded to x's dtype
    (x itself without ``norm``), g and u in float32, h = silu(g)·u rounded,
    float32 accumulator, out = x + acc (or acc) rounded once."""
    dt = x.dtype
    xn = rms_norm(x, ln_all[layer], eps) if norm else x
    h = (F.silu(matmul_f32(xn, wg_all[layer])) * matmul_f32(xn, wu_all[layer])).to(dt)
    acc = matmul_f32(h, wd_all[layer])
    return (x.float() + acc if residual else acc).to(dt)


def fused_out_router_stacked_plain(attn_out, x, wo_all, ln_all, router_all, layer,
                                   *, eps: float = 1e-6):
    """Reference for B7: the round points of ``_out_router_stacked_kernel``
    (``fused_layer.py:818-842``): x2 rounded to x's dtype, the norm in
    float32, hn rounded to x's dtype, logits = hn @ router in float32."""
    dt = x.dtype
    x2 = (x.float() + matmul_f32(attn_out, wo_all[layer])).to(dt)
    hn = rms_norm(x2, ln_all[layer], eps)
    return x2, hn, matmul_f32(hn, router_all[layer])


# ------------------------------------------------------------------- wrappers

def _lib():
    from ._build import load_library

    lib = load_library("fused_layer")
    if not getattr(lib, "_dstts_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dstts_fused_qkv.argtypes = [p] * 10 + [i] * 7 + [f, p]
        lib.dstts_fused_qkv.restype = i
        lib.dstts_fused_out_mlp.argtypes = [p] * 11 + [i] * 8 + [f, p]
        lib.dstts_fused_out_mlp.restype = i
        lib.dstts_fused_qkv_i8.argtypes = [p] * 12 + [i] * 7 + [f, p]
        lib.dstts_fused_qkv_i8.restype = i
        lib.dstts_fused_out_mlp_i8.argtypes = [p] * 15 + [i] * 7 + [f, p]
        lib.dstts_fused_out_mlp_i8.restype = i
        lib.dstts_int8_matmul.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.dstts_int8_matmul.restype = i
        lib.dstts_fused_out_router.argtypes = [p] * 11 + [i] * 9 + [f, p]
        lib.dstts_fused_out_router.restype = i
        lib.dstts_fused_mlp.argtypes = [p] * 9 + [i] * 8 + [f, p]
        lib.dstts_fused_mlp.restype = i
        lib.dstts_fused_out_mlp_split.argtypes = [p] * 12 + [i] * 7 + [f, p]
        lib.dstts_fused_out_mlp_split.restype = i
        ll = ctypes.c_longlong
        lib.dstts_grouped_gateup.argtypes = [p] * 4 + [ll] + [i] * 5 + [p, p]
        lib.dstts_grouped_gateup.restype = i
        lib.dstts_grouped_down.argtypes = [p] * 3 + [i] * 4 + [p, p]
        lib.dstts_grouped_down.restype = i
        lib.dstts_grouped_gateup_tc.argtypes = [p] * 4 + [i] * 6 + [p, p]
        lib.dstts_grouped_gateup_tc.restype = i
        lib.dstts_grouped_down_tc.argtypes = [p] * 3 + [i] * 5 + [p, p]
        lib.dstts_grouped_down_tc.restype = i
        lib.dstts_grouped_occupancy.argtypes = [p]
        lib.dstts_grouped_occupancy.restype = i
        lib._dstts_typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype=torch.bfloat16):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer must be 16-byte aligned")


def _splits(B: int, N: int, K: int) -> int:
    """K slices of one bf16 product: doubled until the grid holds
    ``_TARGET_BLOCKS`` blocks, while every slice stays a whole number of
    pipeline stages and the float32 partial sums (written and read once:
    8·B·N·s bytes) stay within a quarter of the weight bytes (2·K·N)."""
    base = (N // _TILE) * -(-B // _MAX_ROWS)
    cap = max(1, 2 * K // (32 * B))
    s = 1
    while base * s < _TARGET_BLOCKS and 2 * s <= cap and K % (2 * s * _KT) == 0:
        s *= 2
    return s


def i8_tile_cols(N: int, swiglu: bool = False) -> int:
    """Columns a tile of the int8 product (csrc i8_tile_cols): 256 for
    SwiGLU (its gate and up halves) and the widest products (N > 51200: the
    lm_head), else 128; a ring stage is 8 KB, so 8192 / width k rows."""
    return 128 if not swiglu and N <= 51200 else 256


def i8_tiles(K: int, N: int, swiglu: bool = False) -> tuple[int, int]:
    """(tiles, stages a tile) of an int8 product x @ w [K, N]: SwiGLU tiles
    hold width/2 gate columns and the matching up columns of N = 2F."""
    tw = i8_tile_cols(N, swiglu)
    cols, width = (N // 2, tw // 2) if swiglu else (N, tw)
    return -(-cols // width), K // (8192 // tw)


def i8_m_tiles(B: int) -> int:
    """16-row m-tiles of an int8 product block (csrc launch_i8): the fewest
    of 1, 2, 4 that cover B <= 64."""
    return 1 if B <= 16 else 2 if B <= 32 else 4


def i8_plan(B: int, device) -> tuple[int, int]:
    """(persistent blocks, ring stages) of an int8 product at B rows: one
    block an SM, and ``I8_STAGES`` by m-tiles."""
    from .paged_attention import _sm_count

    return _sm_count(device), I8_STAGES[i8_m_tiles(B)]


def _tickets(device) -> torch.Tensor:
    """The device's ticket counters (int32): one a tile of the int8
    product (zero between calls: the block that counts on one resets it),
    then two words of B7's grid barrier count (an int64 that only grows).
    One buffer a device, so they assume that the device's ``i8_stream``
    launches run on one stream, as the port's do."""
    t = _i8_tickets.get(device)
    if t is None:
        t = _i8_tickets[device] = torch.zeros(_I8_MAX_TILES + 2, dtype=torch.int32,
                                              device=device)
    return t


def i8_scratch(device, B: int, grid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 product's scratch: float32 split-K partial sums, one
    [B, I8_TILE] slot a block, and the device's tickets (:func:`_tickets`)."""
    return (torch.empty((grid, B, I8_TILE), dtype=torch.float32, device=device),
            _tickets(device))


def i8_block_of(i: int, total: int, grid: int) -> int:
    """The block whose share of the (tile, stage) sequence holds stage i
    (csrc i8_block_of): block b owns [b·total//grid, (b+1)·total//grid)."""
    return ((i + 1) * grid - 1) // total


def i8_partition(tiles: int, nk: int, grid: int, *,
                 whole_grid: bool = False) -> list[list[tuple[int, int, int]]]:
    """Each block's segments ``(tile, first stage, end stage)`` in the order
    ``i8_stream`` walks them: the tiles·nk (column tile, k stage) pairs,
    tile-major, split into ``min(grid, tiles·nk)`` runs whose lengths differ
    by at most one (``grid`` runs, some empty, with ``whole_grid``, as B7
    launches). A tile met by several blocks is finished by the block
    that holds its first stage (``i8_block_of(t·nk)``), for which the tile
    is the last segment of its run; for every other block that meets it,
    the tile is its first segment, whose sums it leaves in its one partial
    slot."""
    total = tiles * nk
    grid = grid if whole_grid else min(grid, total)
    out = []
    for b in range(grid):
        it, end = b * total // grid, (b + 1) * total // grid
        segs = []
        while it < end:
            t, kt0 = divmod(it, nk)
            kt1 = min(nk, kt0 + end - it)
            segs.append((t, kt0, kt1))
            it += kt1 - kt0
        out.append(segs)
    return out


def b7_tiles(E: int, HD: int) -> tuple[int, int]:
    """(tiles, stages a tile) of B7's wo product [HD, E]: 128-column tiles
    of bf16 weights, 8 KB ring stages of 32 k rows."""
    return -(-E // _TILE), HD // _KT


def b7_segs(E: int, HD: int, grid: int) -> int:
    """Slots a block of B7's grid keeps (csrc ``segs``): the most tiles
    that a share of ceil(tiles·nk / grid) stages meets."""
    tiles, nk = b7_tiles(E, HD)
    share = -(-tiles * nk // grid)
    return (share - 2) // nk + 2


def b7_router_plan(B: int, NE: int, grid: int) -> tuple[int, int, int]:
    """(bands, rows an item, row groups) of B7's phase 2 over B <= 64 rows
    on ``grid`` blocks: item w takes router columns ``B7_BAND`` * (w %
    bands) .. and rows ``rows`` * (w // bands) .. over the whole K, so each
    logit is summed by one block; block b takes items b, b + grid, ...;
    ``rows`` (at most ``B7_ROWS``, one mma m-tile) is the fewest that
    keeps bands * groups <= grid, or ``B7_ROWS`` where none does."""
    bands = -(-NE // B7_BAND)
    rows = next((r for r in range(1, B7_ROWS + 1) if bands * -(-B // r) <= grid), B7_ROWS)
    return bands, rows, -(-B // rows)


def shapes_ok(hidden: int, heads_dim: int, intermediate: int, head_dim: int) -> bool:
    """Can the CUDA kernels take these widths? (the q/k epilogue is written
    for head_dim 128; products need 128-column output tiles and whole
    32-row pipeline stages)"""
    return (head_dim == HEAD_DIM and hidden % _TILE == 0
            and heads_dim % _TILE == 0 and intermediate % _TILE == 0)


def _raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def fused_qkv_stacked(x, ln_all, wqkv_all, qn_all, kn_all, cos, sin, layer,
                      *, n_heads: int, n_kv: int, head_dim: int, eps: float = 1e-6):
    """B3: ``(q [B,H·D], k [B,K·D], v [B,K·D])`` for layer ``layer`` of the
    stacks. x [B,E]; ln_all [L,E]; wqkv_all [L,E,(H+2K)·D]; qn_all/kn_all
    [L,D]; cos/sin [B,D/2] float32 or bf16."""
    if x.device.type == "cpu":
        return fused_qkv_stacked_plain(x, ln_all, wqkv_all, qn_all, kn_all, cos,
                                       sin, layer, n_heads=n_heads, n_kv=n_kv,
                                       head_dim=head_dim, eps=eps)
    out = _launch_qkv("fused_qkv_stacked", x, ln_all, wqkv_all, qn_all, kn_all, cos,
                      sin, layer, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps)
    fused_qkv_stacked.launches += 1
    return out


fused_qkv_stacked.launches = 0


def _launch_qkv(name, x, ln_all, wqkv_all, qn_all, kn_all, cos, sin, layer, *,
                n_heads: int, n_kv: int, head_dim: int, eps: float):
    """B3's kernels on CUDA tensors (checks, scratch, launch). cos / sin
    may be float32 or bf16 (the epilogue widens them), both of one dtype."""
    B, E = x.shape
    L = wqkv_all.shape[0]
    D, H, K = head_dim, n_heads, n_kv
    C = (H + 2 * K) * D
    if not shapes_ok(E, H * D, _TILE, D) or not 0 <= int(layer) < L:
        raise ValueError(f"{name} kernel needs head_dim={HEAD_DIM}, "
                         f"E % {_TILE} == 0 and 0 <= layer < L (got D={D}, E={E}, "
                         f"layer={layer}, L={L})")
    _check("x", x, (B, E))
    _check("ln_all", ln_all, (L, E))
    _check("wqkv_all", wqkv_all, (L, E, C))
    _check("qn_all", qn_all, (L, D))
    _check("kn_all", kn_all, (L, D))
    cs_dtype = cos.dtype if cos.dtype in (torch.float32, torch.bfloat16) else torch.float32
    _check("cos", cos, (B, D // 2), cs_dtype)
    _check("sin", sin, (B, D // 2), cs_dtype)
    s = _splits(B, C, E)
    partial = torch.empty((s, B, C), dtype=torch.float32, device=x.device)
    xn = torch.empty((B, E), dtype=x.dtype, device=x.device)
    out = torch.empty((B, C), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().dstts_fused_qkv(
        x.data_ptr(), ln_all.data_ptr(), wqkv_all.data_ptr(), qn_all.data_ptr(),
        kn_all.data_ptr(), cos.data_ptr(), sin.data_ptr(), partial.data_ptr(),
        xn.data_ptr(), out.data_ptr(), int(layer), B, E, H, K, s,
        int(cs_dtype == torch.bfloat16), float(eps), stream)
    _raise_if(err, name)
    HD, KD = H * D, K * D
    return out[:, :HD], out[:, HD:HD + KD], out[:, HD + KD:]


def fused_out_mlp_stacked(attn_out, x, wo_all, ln_all, gateup_all, wd_all, layer,
                          *, eps: float = 1e-6):
    """B4: ``x2 + swiglu(rmsnorm(x2)·ln2[l]) @ wd[l]`` with
    ``x2 = x + attn_out @ wo[l]``. attn_out [B,H·D]; x [B,E]; wo_all
    [L,H·D,E]; ln_all [L,E]; gateup_all [L,E,2F] (gate first); wd_all
    [L,F,E] → [B,E]."""
    if x.device.type == "cpu":
        return fused_out_mlp_stacked_plain(attn_out, x, wo_all, ln_all, gateup_all,
                                           wd_all, layer, eps=eps)
    out = _launch_out_mlp("fused_out_mlp_stacked", attn_out, x, wo_all, ln_all,
                          gateup_all, wd_all, layer, eps=eps)
    fused_out_mlp_stacked.launches += 1
    return out


fused_out_mlp_stacked.launches = 0


def _launch_out_mlp(name, attn_out, x, wo_all, ln_all, gateup_all, wd_all, layer, *,
                    eps: float):
    """B4's kernel on CUDA tensors (checks, scratch, launch)."""
    B, E = x.shape
    HD = attn_out.shape[1]
    L, _, F2 = gateup_all.shape
    Fi = F2 // 2
    if not shapes_ok(E, HD, Fi, HEAD_DIM) or not 0 <= int(layer) < L:
        raise ValueError(f"{name} kernel needs E, H·D, F % {_TILE} "
                         f"== 0 and 0 <= layer < L (got E={E}, HD={HD}, F={Fi}, "
                         f"layer={layer}, L={L})")
    _check("attn_out", attn_out, (B, HD))
    _check("x", x, (B, E))
    _check("wo_all", wo_all, (L, HD, E))
    _check("ln_all", ln_all, (L, E))
    _check("gateup_all", gateup_all, (L, E, 2 * Fi))
    _check("wd_all", wd_all, (L, Fi, E))
    s_o, s_gu, s_d = _splits(B, E, HD), _splits(B, 2 * Fi, E), _splits(B, E, Fi)
    dev = x.device
    partial = torch.empty((max(s_o * E, s_gu * 2 * Fi, s_d * E) * B,),
                          dtype=torch.float32, device=dev)
    x2 = torch.empty((B, E), dtype=x.dtype, device=dev)
    xn = torch.empty((B, E), dtype=x.dtype, device=dev)
    h = torch.empty((B, Fi), dtype=x.dtype, device=dev)
    out = torch.empty((B, E), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().dstts_fused_out_mlp(
        attn_out.data_ptr(), x.data_ptr(), wo_all.data_ptr(), ln_all.data_ptr(),
        gateup_all.data_ptr(), wd_all.data_ptr(), partial.data_ptr(),
        x2.data_ptr(), xn.data_ptr(), h.data_ptr(), out.data_ptr(), int(layer),
        B, HD, E, Fi, s_o, s_gu, s_d, float(eps), stream)
    _raise_if(err, name)
    return out


def fused_out_router_stacked(attn_out, x, wo_all, ln_all, router_all, layer,
                             *, eps: float = 1e-6):
    """B7: ``(x2, hn, logits)`` with ``x2 = x + attn_out @ wo[l]``, ``hn =
    rmsnorm(x2)·ln2[l]`` (the expert FFN's input) and float32 router
    ``logits = hn @ router[l]``. attn_out [B,H·D]; x [B,E]; wo_all
    [L,H·D,E]; ln_all [L,E]; router_all [L,E,NE] → [B,E], [B,E], [B,NE]."""
    if x.device.type == "cpu":
        return fused_out_router_stacked_plain(attn_out, x, wo_all, ln_all,
                                              router_all, layer, eps=eps)
    B, E = x.shape
    HD = attn_out.shape[1]
    L, _, NE = router_all.shape
    if not shapes_ok(E, HD, NE, HEAD_DIM) or not 0 <= int(layer) < L:
        raise ValueError(f"fused_out_router_stacked kernel needs E, H·D, NE % {_TILE} "
                         f"== 0 and 0 <= layer < L (got E={E}, HD={HD}, NE={NE}, "
                         f"layer={layer}, L={L})")
    _check("attn_out", attn_out, (B, HD))
    _check("x", x, (B, E))
    _check("wo_all", wo_all, (L, HD, E))
    _check("ln_all", ln_all, (L, E))
    _check("router_all", router_all, (L, E, NE))
    from .paged_attention import _sm_count

    dev = x.device
    grid = _sm_count(dev)
    Bg = min(B, _MAX_ROWS)
    n_part = grid * b7_segs(E, HD, grid) * Bg * _TILE
    scratch = torch.empty((n_part + E // _TILE * Bg,), dtype=torch.float32, device=dev)
    count = _tickets(dev)[_I8_MAX_TILES:]
    x2hn = torch.empty((2, B, E), dtype=x.dtype, device=dev)
    logits = torch.empty((B, NE), dtype=torch.float32, device=dev)
    lib, stream = _lib(), torch.cuda.current_stream(dev).cuda_stream
    for r0 in range(0, B, _MAX_ROWS):   # groups of 64 rows, one launch each
        rows = slice(r0, r0 + _MAX_ROWS)
        n = min(_MAX_ROWS, B - r0)
        err = lib.dstts_fused_out_router(
            attn_out[rows].data_ptr(), x[rows].data_ptr(), wo_all.data_ptr(), ln_all.data_ptr(),
            router_all.data_ptr(), scratch.data_ptr(), scratch[n_part:].data_ptr(),
            count.data_ptr(), x2hn[0, rows].data_ptr(), x2hn[1, rows].data_ptr(),
            logits[rows].data_ptr(), int(layer), n, HD, E, NE, grid, I8_STAGES[i8_m_tiles(n)],
            b7_router_plan(n, NE, grid)[1], b7_segs(E, HD, grid), float(eps), stream)
        _raise_if(err, "fused_out_router_stacked")
    fused_out_router_stacked.launches += 1
    return x2hn[0], x2hn[1], logits


fused_out_router_stacked.launches = 0


def mlp_shapes_ok(hidden: int, intermediate: int) -> bool:
    """Can B8 take these widths? (128-column output tiles of each product,
    whole 32-row pipeline stages)"""
    return hidden % _TILE == 0 and intermediate % _TILE == 0


def fused_mlp_stacked(x, ln_all, wg_all, wu_all, wd_all, layer, *, eps: float = 1e-6,
                      residual: bool = True, norm: bool = True):
    """B8: ``[x +] (silu(xn @ wg[l]) · (xn @ wu[l])) @ wd[l]`` with ``xn =
    rmsnorm(x)·ln[l]`` (``norm``) or x. x [B,E]; ln_all [L,E] (read only
    with ``norm``); wg_all / wu_all [L,E,F]; wd_all [L,F,E] → [B,E]. MLA's
    dense-layer MLPs take norm and residual, its shared experts neither."""
    if x.device.type == "cpu":
        return fused_mlp_stacked_plain(x, ln_all, wg_all, wu_all, wd_all, layer, eps=eps,
                                       residual=residual, norm=norm)
    out = _launch_mlp("fused_mlp_stacked", x, ln_all, wg_all, wu_all, wd_all, layer,
                      eps=eps, residual=residual, norm=norm)
    fused_mlp_stacked.launches += 1
    return out


fused_mlp_stacked.launches = 0


def _launch_mlp(name, x, ln_all, wg_all, wu_all, wd_all, layer, *, eps: float,
                residual: bool, norm: bool):
    """B8's kernel on CUDA tensors (checks, scratch, launch)."""
    B, E = x.shape
    L, _, Fi = wg_all.shape
    if not mlp_shapes_ok(E, Fi) or not 0 <= int(layer) < L:
        raise ValueError(f"{name} kernel needs E, F % {_TILE} == 0 and "
                         f"0 <= layer < L (got E={E}, F={Fi}, layer={layer}, L={L})")
    _check("x", x, (B, E))
    _check("ln_all", ln_all, (L, E))
    _check("wg_all", wg_all, (L, E, Fi))
    _check("wu_all", wu_all, (L, E, Fi))
    _check("wd_all", wd_all, (L, Fi, E))
    s_gu, s_d = _splits(B, Fi, E), _splits(B, E, Fi)
    dev = x.device
    partial = torch.empty((max(2 * s_gu * Fi, s_d * E) * B,), dtype=torch.float32,
                          device=dev)
    xn = torch.empty((B, E), dtype=x.dtype, device=dev) if norm else x
    h = torch.empty((B, Fi), dtype=x.dtype, device=dev)
    out = torch.empty((B, E), dtype=x.dtype, device=dev)
    err = _lib().dstts_fused_mlp(
        x.data_ptr(), ln_all.data_ptr(), wg_all.data_ptr(), wu_all.data_ptr(),
        wd_all.data_ptr(), partial.data_ptr(), xn.data_ptr(), h.data_ptr(), out.data_ptr(),
        int(layer), B, E, Fi, s_gu, s_d, int(bool(norm)), int(bool(residual)), float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, name)
    return out


# ------------------------------------------------- B11: the one-layer forms

def fused_mlp_plain(x, ln_w, w_gate, w_up, w_down, *, eps: float = 1e-6,
                    block_f: int | None = None):
    """Reference for B11 ``fused_mlp`` (``_mlp_kernel``, ``fused_layer.py:92``):
    B8's round points at L = 1."""
    return fused_mlp_stacked_plain(x, ln_w[None], w_gate[None], w_up[None], w_down[None],
                                   0, eps=eps)


def fused_qkv_plain(x, ln_w, wqkv, q_norm, k_norm, cos, sin, *, n_heads: int, n_kv: int,
                    head_dim: int, eps: float = 1e-6):
    """Reference for B11 ``fused_qkv`` (``_qkv_traced_kernel``,
    ``fused_layer.py:207``): B3's round points at L = 1, cos/sin widened to
    float32 (exact from bf16), as the kernel widens them."""
    return fused_qkv_stacked_plain(x, ln_w[None], wqkv[None], q_norm[None], k_norm[None],
                                   cos.float(), sin.float(), 0, n_heads=n_heads,
                                   n_kv=n_kv, head_dim=head_dim, eps=eps)


def _gate_up(w_gate, w_up, packed_gateup: bool):
    """The [E,F] gate and up matrices: the halves of the packed [E,2F]
    passed as both, or the two matrices as they are."""
    if not packed_gateup:
        return w_gate, w_up
    Fi = w_gate.shape[1] // 2
    return w_gate[:, :Fi].contiguous(), w_up[:, Fi:].contiguous()


def fused_out_mlp_plain(attn_out, x, wo, ln_w, w_gate, w_up, w_down, *,
                        eps: float = 1e-6, packed_gateup: bool = False):
    """Reference for B11 ``fused_out_mlp`` (``_out_mlp_kernel``,
    ``fused_layer.py:930-972``): x2, xn, h and out rounded to x's dtype,
    float32 accumulators. Packed and unpacked gate/up give the same bits."""
    dt = x.dtype
    wg, wu = _gate_up(w_gate, w_up, packed_gateup)
    x2 = (x.float() + matmul_f32(attn_out, wo)).to(dt)
    xn = rms_norm(x2, ln_w, eps)
    h = (F.silu(matmul_f32(xn, wg)) * matmul_f32(xn, wu)).to(dt)
    return (x2.float() + matmul_f32(h, w_down)).to(dt)


def fused_mlp(x, ln_w, w_gate, w_up, w_down, *, eps: float = 1e-6,
              block_f: int | None = None):
    """B11 ``fused_mlp``: ``x + swiglu(rmsnorm(x)·ln_w) @ w_down``. x [B,E];
    ln_w [E]; w_gate / w_up [E,F]; w_down [F,E] → [B,E]. On the card B8's
    kernel at L = 1 over ``t[None]`` views (no copy). ``block_f`` is the TPU
    kernel's VMEM tiling: accepted and ignored."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, ln_w, w_gate, w_up, w_down, eps=eps)
    out = _launch_mlp("fused_mlp", x, ln_w[None], w_gate[None], w_up[None], w_down[None],
                      0, eps=eps, residual=True, norm=True)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


def fused_qkv(x, ln_w, wqkv, q_norm, k_norm, cos, sin, *, n_heads: int, n_kv: int,
              head_dim: int, eps: float = 1e-6):
    """B11 ``fused_qkv``: ``(q [B,H·D], k [B,K·D], v [B,K·D])`` of one layer.
    x [B,E]; ln_w [E]; wqkv [E,(H+2K)·D]; q_norm / k_norm [D]; cos / sin
    [B,D/2] in any float dtype. On the card B3's kernels at L = 1, which
    read float32 and bf16 cos / sin as they are (other dtypes and layouts
    are converted to contiguous float32 first)."""
    if x.device.type == "cpu":
        return fused_qkv_plain(x, ln_w, wqkv, q_norm, k_norm, cos, sin, n_heads=n_heads,
                               n_kv=n_kv, head_dim=head_dim, eps=eps)
    if not (cos.dtype == sin.dtype and cos.dtype in (torch.float32, torch.bfloat16)
            and cos.is_contiguous() and sin.is_contiguous()):
        cos, sin = cos.float().contiguous(), sin.float().contiguous()
    out = _launch_qkv("fused_qkv", x, ln_w[None], wqkv[None], q_norm[None], k_norm[None],
                      cos, sin, 0, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps)
    fused_qkv.launches += 1
    return out


fused_qkv.launches = 0


def fused_out_mlp(attn_out, x, wo, ln_w, w_gate, w_up, w_down, *, eps: float = 1e-6,
                  packed_gateup: bool = False):
    """B11 ``fused_out_mlp``: ``x2 + swiglu(rmsnorm(x2)·ln_w) @ w_down`` with
    ``x2 = x + attn_out @ wo``. attn_out [B,H·D]; x [B,E]; wo [H·D,E];
    ln_w [E]; w_gate / w_up [E,F], or with ``packed_gateup`` the packed
    [E,2F] passed as both; w_down [F,E] → [B,E]. On the card packed gate/up
    is B4's kernel at L = 1; unpacked, ``dstts_fused_out_mlp_split`` (B4's
    x2 phase, then B8's two-pointer gate/up path), so no gate|up copy is
    made."""
    if x.device.type == "cpu":
        return fused_out_mlp_plain(attn_out, x, wo, ln_w, w_gate, w_up, w_down, eps=eps,
                                   packed_gateup=packed_gateup)
    if packed_gateup:
        if w_up.data_ptr() != w_gate.data_ptr() or w_up.shape != w_gate.shape:
            raise ValueError("fused_out_mlp with packed_gateup takes the packed [E,2F] "
                             "matrix as both w_gate and w_up")
        out = _launch_out_mlp("fused_out_mlp", attn_out, x, wo[None], ln_w[None],
                              w_gate[None], w_down[None], 0, eps=eps)
    else:
        out = _launch_out_mlp_split(attn_out, x, wo, ln_w, w_gate, w_up, w_down, eps=eps)
    fused_out_mlp.launches += 1
    return out


fused_out_mlp.launches = 0


def _launch_out_mlp_split(attn_out, x, wo, ln_w, w_gate, w_up, w_down, *, eps: float):
    """``dstts_fused_out_mlp_split`` on CUDA tensors: B11's out-MLP over
    unpacked gate and up."""
    B, E = x.shape
    HD = attn_out.shape[1]
    Fi = w_gate.shape[1]
    if not shapes_ok(E, HD, Fi, HEAD_DIM):
        raise ValueError(f"fused_out_mlp kernel needs E, H·D, F % {_TILE} == 0 (got E={E}, "
                         f"HD={HD}, F={Fi})")
    _check("attn_out", attn_out, (B, HD))
    _check("x", x, (B, E))
    _check("wo", wo, (HD, E))
    _check("ln_w", ln_w, (E,))
    _check("w_gate", w_gate, (E, Fi))
    _check("w_up", w_up, (E, Fi))
    _check("w_down", w_down, (Fi, E))
    s_o, s_gu, s_d = _splits(B, E, HD), _splits(B, Fi, E), _splits(B, E, Fi)
    dev = x.device
    partial = torch.empty((max(s_o * E, 2 * s_gu * Fi, s_d * E) * B,), dtype=torch.float32,
                          device=dev)
    x2, xn = (torch.empty((B, E), dtype=x.dtype, device=dev) for _ in range(2))
    h = torch.empty((B, Fi), dtype=x.dtype, device=dev)
    out = torch.empty((B, E), dtype=x.dtype, device=dev)
    err = _lib().dstts_fused_out_mlp_split(
        attn_out.data_ptr(), x.data_ptr(), wo.data_ptr(), ln_w.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), partial.data_ptr(),
        x2.data_ptr(), xn.data_ptr(), h.data_ptr(), out.data_ptr(), B, HD, E, Fi, s_o, s_gu,
        s_d, float(eps), torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "fused_out_mlp")
    return out


def _check_i8(B: int, K: int, N: int) -> None:
    """Raise unless the int8 product takes x [B,K] @ w [K,N]: 1..64 rows,
    whole ring stages, N a multiple of 128 (the last ``I8_TILE``-column
    tile may be half full), at most ``_I8_MAX_TILES`` 128-column tiles."""
    if not (1 <= B <= _MAX_ROWS and K % I8_STAGE_ROWS == 0 and N % _TILE == 0
            and N // _TILE <= _I8_MAX_TILES):
        raise ValueError(f"int8 product kernel needs 1..{_MAX_ROWS} rows, K % "
                         f"{I8_STAGE_ROWS} == 0 and N % {_TILE} == 0, N / {_TILE} <= "
                         f"{_I8_MAX_TILES} (got B={B}, K={K}, N={N})")


def fused_qkv_stacked_i8(x, ln_all, wqkv_q, wqkv_s, qn_all, kn_all, cos, sin, layer,
                         *, n_heads: int, n_kv: int, head_dim: int, eps: float = 1e-6):
    """B10-qkv: :func:`fused_qkv_stacked` over an int8 stack. wqkv_q
    [L,E,C] int8; wqkv_s [L,1,C] float32; the rest as B3."""
    if x.device.type == "cpu":
        return fused_qkv_stacked_i8_plain(x, ln_all, wqkv_q, wqkv_s, qn_all, kn_all,
                                          cos, sin, layer, n_heads=n_heads, n_kv=n_kv,
                                          head_dim=head_dim, eps=eps)
    B, E = x.shape
    L = wqkv_q.shape[0]
    D, H, K = head_dim, n_heads, n_kv
    C = (H + 2 * K) * D
    if not shapes_ok(E, H * D, _TILE, D) or not 0 <= int(layer) < L:
        raise ValueError(f"fused_qkv_stacked_i8 kernel needs head_dim={HEAD_DIM}, "
                         f"E % {_TILE} == 0 and 0 <= layer < L (got D={D}, E={E}, "
                         f"layer={layer}, L={L})")
    _check("x", x, (B, E))
    _check("ln_all", ln_all, (L, E))
    _check("wqkv_q", wqkv_q, (L, E, C), torch.int8)
    _check("wqkv_s", wqkv_s, (L, 1, C), torch.float32)
    _check("qn_all", qn_all, (L, D))
    _check("kn_all", kn_all, (L, D))
    _check("cos", cos, (B, D // 2), torch.float32)
    _check("sin", sin, (B, D // 2), torch.float32)
    _check_i8(B, E, C)
    grid, stages = i8_plan(B, x.device)
    partial, tickets = i8_scratch(x.device, B, grid)
    xn = torch.empty((B, E), dtype=x.dtype, device=x.device)
    out = torch.empty((B, C), dtype=x.dtype, device=x.device)
    err = _lib().dstts_fused_qkv_i8(
        x.data_ptr(), ln_all.data_ptr(), wqkv_q.data_ptr(), wqkv_s.data_ptr(),
        qn_all.data_ptr(), kn_all.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        partial.data_ptr(), tickets.data_ptr(), xn.data_ptr(), out.data_ptr(), int(layer), B,
        E, H, K, grid, stages, float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if(err, "fused_qkv_stacked_i8")
    fused_qkv_stacked_i8.launches += 1
    HD, KD = H * D, K * D
    return out[:, :HD], out[:, HD:HD + KD], out[:, HD + KD:]


fused_qkv_stacked_i8.launches = 0


def fused_out_mlp_stacked_i8(attn_out, x, wo_q, wo_s, ln_all, gateup_q, gateup_s, wd_q,
                             wd_s, layer, *, eps: float = 1e-6):
    """B10-out: :func:`fused_out_mlp_stacked` over int8 stacks. wo_q
    [L,H·D,E], gateup_q [L,E,2F] (gate first), wd_q [L,F,E] int8; wo_s
    [L,1,E], gateup_s [L,1,2F], wd_s [L,1,E] float32 → [B,E]."""
    if x.device.type == "cpu":
        return fused_out_mlp_stacked_i8_plain(attn_out, x, wo_q, wo_s, ln_all, gateup_q,
                                              gateup_s, wd_q, wd_s, layer, eps=eps)
    B, E = x.shape
    HD = attn_out.shape[1]
    L, _, F2 = gateup_q.shape
    Fi = F2 // 2
    if not shapes_ok(E, HD, Fi, HEAD_DIM) or not 0 <= int(layer) < L:
        raise ValueError(f"fused_out_mlp_stacked_i8 kernel needs E, H·D, F % {_TILE} "
                         f"== 0 and 0 <= layer < L (got E={E}, HD={HD}, F={Fi}, "
                         f"layer={layer}, L={L})")
    _check("attn_out", attn_out, (B, HD))
    _check("x", x, (B, E))
    _check("ln_all", ln_all, (L, E))
    for name, t, shape in (("wo_q", wo_q, (L, HD, E)), ("gateup_q", gateup_q, (L, E, F2)),
                           ("wd_q", wd_q, (L, Fi, E))):
        _check(name, t, shape, torch.int8)
    for name, t, n in (("wo_s", wo_s, E), ("gateup_s", gateup_s, F2), ("wd_s", wd_s, E)):
        _check(name, t, (L, 1, n), torch.float32)
    for kd, nd in ((HD, E), (E, F2), (Fi, E)):
        _check_i8(B, kd, nd)
    dev = x.device
    grid, stages = i8_plan(B, dev)
    partial, tickets = i8_scratch(dev, B, grid)
    x2, xn, out = (torch.empty((B, E), dtype=x.dtype, device=dev) for _ in range(3))
    h = torch.empty((B, Fi), dtype=x.dtype, device=dev)
    err = _lib().dstts_fused_out_mlp_i8(
        attn_out.data_ptr(), x.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(),
        ln_all.data_ptr(), gateup_q.data_ptr(), gateup_s.data_ptr(), wd_q.data_ptr(),
        wd_s.data_ptr(), partial.data_ptr(), tickets.data_ptr(), x2.data_ptr(), xn.data_ptr(),
        h.data_ptr(), out.data_ptr(), int(layer), B, HD, E, Fi, grid, stages, float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "fused_out_mlp_stacked_i8")
    fused_out_mlp_stacked_i8.launches += 1
    return out


fused_out_mlp_stacked_i8.launches = 0


def int8_product(x, w_q, scales):
    """B10's bare product: ``bf16((x @ w_q) * scales)``. x [B,K] bf16, B <=
    64; w_q [K,N] int8; scales [1,N] float32 → [B,N] in x's dtype."""
    if x.device.type == "cpu":
        return int8_product_plain(x, w_q, scales)
    B, Kd = x.shape
    N = w_q.shape[1]
    _check("x", x, (B, Kd))
    _check("w_q", w_q, (Kd, N), torch.int8)
    _check("scales", scales, (1, N), torch.float32)
    _check_i8(B, Kd, N)
    grid, stages = i8_plan(B, x.device)
    partial, tickets = i8_scratch(x.device, B, grid)
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    err = _lib().dstts_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), partial.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), B, Kd, N, grid, stages,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if(err, "int8_product")
    int8_product.launches += 1
    return out


int8_product.launches = 0
