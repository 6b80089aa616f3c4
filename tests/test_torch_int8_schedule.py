"""B10's int8 product (``ops/csrc/fused_layer.cu`` ``i8_stream``): the
host-side schedule and the bit-level pieces of the kernel, in plain Python
and torch.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to the
plain versions there). Here: the stream-K split of the (column tile, ring
stage) sequence over the persistent grid, from sizes and the SM count only
(``fused_layer.i8_partition`` / ``i8_block_of``, the kernel's formulas),
and the split-K fix-up's roles; the byte-permute widening of int8 to bf16,
modelled on int32 words; and the column interleave of the widened
fragments, modelled through ``ldmatrix.trans`` and ``mma.m16n8k16``'s
fragment layouts, which the epilogue's column map undoes.
"""
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu_torch.ops import fused_layer as fl

torch.set_num_threads(1)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
# (model, product): (K, N, SwiGLU tile) of each int8 product of a decode step
PRODUCTS = {
    ("qwen3-32b", "wqkv"): (5120, 10240, False),
    ("qwen3-32b", "wo"): (8192, 5120, False),
    ("qwen3-32b", "w_gateup"): (5120, 51200, True),
    ("qwen3-32b", "w_down"): (25600, 5120, False),
    ("qwen3-32b", "lm_head"): (5120, 151936, False),
    ("qwen3-8b", "wqkv"): (4096, 6144, False),
    ("qwen3-8b", "wo"): (4096, 4096, False),
    ("qwen3-8b", "w_gateup"): (4096, 24576, True),
    ("qwen3-8b", "w_down"): (12288, 4096, False),
    ("qwen3-8b", "lm_head"): (4096, 151936, False),
}


def _grid(sms: int) -> int:
    return sms   # one persistent block an SM (fused_layer.i8_plan)


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("key", sorted(PRODUCTS))
def test_partition_covers_every_stage_once(key, B, sms):
    K, N, swiglu = PRODUCTS[key]
    fl._check_i8(B, K, 2 * N if swiglu else N)   # the wrappers take these widths
    tiles, nk = fl.i8_tiles(K, N, swiglu)
    runs = fl.i8_partition(tiles, nk, _grid(sms))
    seen = np.zeros((tiles, nk), dtype=np.int64)
    for segs in runs:
        for t, k0, k1 in segs:
            assert 0 <= k0 < k1 <= nk
            seen[t, k0:k1] += 1
    assert (seen == 1).all()
    lengths = [sum(k1 - k0 for _, k0, k1 in segs) for segs in runs]
    assert len(runs) == min(_grid(sms), tiles * nk)
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1   # no wave tail


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("key", sorted(PRODUCTS))
def test_fixup_roles(key, sms):
    """Every stage's owner is ``i8_block_of`` of it; a split tile is
    finished by the block of its first stage, for which it is the last
    segment, and every other block meets it as its first segment, so one
    partial slot a block holds every sum the finisher reads."""
    K, N, swiglu = PRODUCTS[key]
    tiles, nk = fl.i8_tiles(K, N, swiglu)
    total, grid = tiles * nk, min(_grid(sms), tiles * nk)
    runs = fl.i8_partition(tiles, nk, grid)
    blocks_of = {}
    for b, segs in enumerate(runs):
        for i, (t, k0, k1) in enumerate(segs):
            for it in (t * nk + k0, t * nk + k1 - 1):
                assert fl.i8_block_of(it, total, grid) == b
            blocks_of.setdefault(t, []).append((b, i, len(segs)))
    slots = {}
    for t, meets in blocks_of.items():
        b_lo = fl.i8_block_of(t * nk, total, grid)
        b_hi = fl.i8_block_of(t * nk + nk - 1, total, grid)
        assert [b for b, _, _ in meets] == list(range(b_lo, b_hi + 1))
        for b, i, n in meets[1:]:
            assert i == 0                       # its first segment
            slots[b] = slots.get(b, 0) + 1
        if len(meets) > 1:
            b, i, n = meets[0]
            assert b == b_lo and i == n - 1     # the finisher's last segment
    assert all(v == 1 for v in slots.values())


def test_partition_reads_sizes_only():
    """The same split from keywords and positions, and the tile widths
    the kernel picks: 256 for the lm_head and SwiGLU (its gate and up
    halves), 128 otherwise, 8 KB ring stages either way."""
    assert fl.i8_partition(tiles=40, nk=160, grid=132) == fl.i8_partition(40, 160, 132)
    assert fl.i8_tile_cols(10240) == 128 and fl.i8_tile_cols(5120) == 128
    assert fl.i8_tile_cols(51200) == 128 and fl.i8_tile_cols(151936) == 256
    assert fl.i8_tile_cols(10240, swiglu=True) == 256
    for K, N, sw in PRODUCTS.values():
        tw = fl.i8_tile_cols(N, sw)
        assert (8192 // tw) * tw == 8192 and K % (8192 // tw) == 0
    # lm_head: 593 whole 256-column tiles and a last one half full
    assert fl.i8_tiles(5120, 151936) == (594, 160)


def test_partition_of_small_and_odd_sizes():
    """Fewer stages than blocks: one stage a block; any sizes: every stage
    once, lengths within one of each other."""
    assert fl.i8_partition(1, 3, 132) == [[(0, 0, 1)], [(0, 1, 2)], [(0, 2, 3)]]
    rng = np.random.default_rng(0)
    for _ in range(200):
        tiles, nk, grid = (int(v) for v in rng.integers(1, 300, 3))
        runs = fl.i8_partition(tiles, nk, grid)
        flat = [(t, k) for segs in runs for t, k0, k1 in segs for k in range(k0, k1)]
        assert flat == [(t, k) for t in range(tiles) for k in range(nk)]


# ------------------------------------------------- the widening, bit by bit

def prmt(a: int, b: int, sel: int) -> int:
    """PTX ``prmt.b32`` (default mode): byte i of the result is byte
    ``(sel >> 4i) & 7`` of the eight bytes {b, a} (a the low four)."""
    src = a | (b << 32)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def widen4(w: int) -> tuple[int, int]:
    """The kernel's ``widen4``: a word of four int8 → the bf16 pairs of
    bytes (0, 2) and (1, 3), as two int32 words."""
    u = w ^ 0x80808080
    f = []
    for i in range(4):
        bits = prmt(u, 0x4B000000, 0x7440 | i)
        v = np.array([bits], dtype=np.uint32).view(np.float32) - np.float32(8388736.0)
        f.append(int(v.view(np.uint32)[0]))
    return prmt(f[0], f[2], 0x7632), prmt(f[1], f[3], 0x7632)


def _bf16_bits(q) -> int:
    return int(torch.tensor([q], dtype=torch.bfloat16).view(torch.int16)[0]) & 0xFFFF


@pytest.mark.parametrize("pos", [0, 1, 2, 3])
def test_widen4_exact_for_every_int8_in_every_byte(pos):
    rng = np.random.default_rng(pos)
    for q in range(-128, 128):
        others = rng.integers(-128, 128, 4)
        others[pos] = q
        word = int.from_bytes(bytes(int(v) & 0xFF for v in others), "little")
        even, odd = widen4(word)
        halves = [even & 0xFFFF, odd & 0xFFFF, even >> 16, odd >> 16]   # bytes 0, 1, 2, 3
        assert [h for h in halves] == [_bf16_bits(float(v)) for v in others]


# ---------------------------------------- the column interleave, end to end

def _ldmatrix_trans_words(W8, khalf: int, G: int):
    """``ldmatrix.x4.trans`` of the int8 tile read as 16-bit pairs: the
    word lane (g, t4) gets from matrix (k half, 16-byte chunk G) — bytes
    W[k, 16G + 2g], W[k, 16G + 2g + 1], W[k+1, 16G + 2g], W[k+1, 16G +
    2g + 1] with k = 8·khalf + 2·t4."""
    out = {}
    for g in range(8):
        for t4 in range(4):
            k = 8 * khalf + 2 * t4
            b = [W8[k, 16 * G + 2 * g], W8[k, 16 * G + 2 * g + 1],
                 W8[k + 1, 16 * G + 2 * g], W8[k + 1, 16 * G + 2 * g + 1]]
            out[g, t4] = int.from_bytes(bytes(int(v) & 0xFF for v in b), "little")
    return out


def _pair(word: int) -> tuple[float, float]:
    """(low, high) bf16 halves of a word as floats."""
    h = torch.tensor([word & 0xFFFF, word >> 16], dtype=torch.int32).to(torch.int16)
    v = h.view(torch.bfloat16).float()
    return float(v[0]), float(v[1])


def test_column_interleave_is_undone_by_the_epilogue():
    """A warp's 32 columns over one 16-row k step: B fragments from
    ldmatrix.trans + widen4 (n8 block 2G + e holds columns 16G + 2i + e),
    mma.m16n8k16's fragment semantics, and the epilogue's float4 at
    columns 16G + 4·t4 (acc[2G][0], acc[2G+1][0], acc[2G][1], acc[2G+1][1])
    give A @ W exactly."""
    rng = np.random.default_rng(7)
    W8 = rng.integers(-127, 128, (16, 32)).astype(np.int8)
    A = torch.tensor(rng.integers(-8, 9, (16, 16)), dtype=torch.float32)  # exact in bf16
    words = {(kh, G): _ldmatrix_trans_words(W8, kh, G) for kh in (0, 1) for G in (0, 1)}
    # b[nb][kh] at lane (g, t4): widen4 of the matrix (kh, G = nb // 2)
    Bblk = torch.zeros(4, 16, 8)          # n8 block nb as mma's B [k, n]
    for g in range(8):
        for t4 in range(4):
            for G in (0, 1):
                for kh in (0, 1):
                    even, odd = widen4(words[kh, G][g, t4])
                    for e, word in ((0, even), (1, odd)):
                        lo, hi = _pair(word)   # b0 / b1: k = 2·t4 (+1) (+8·kh), n = g
                        Bblk[2 * G + e, 8 * kh + 2 * t4, g] = lo
                        Bblk[2 * G + e, 8 * kh + 2 * t4 + 1, g] = hi
    D = torch.einsum("rk,bkn->brn", A, Bblk)   # [nb, 16 rows, 8]
    got = torch.zeros(16, 32)
    for g in range(8):
        for t4 in range(4):
            for G in (0, 1):
                for h in (0, 1):
                    # acc[nb][2h + i] = D[nb][g + 8h][2·t4 + i]
                    acc = lambda nb, i: D[nb, g + 8 * h, 2 * t4 + i]
                    got[g + 8 * h, 16 * G + 4 * t4:16 * G + 4 * t4 + 4] = torch.stack(
                        [acc(2 * G, 0), acc(2 * G + 1, 0), acc(2 * G, 1), acc(2 * G + 1, 1)])
    assert torch.equal(got, A @ torch.tensor(W8, dtype=torch.float32))


def test_swizzled_ldmatrix_rows_hit_distinct_banks():
    """The kernel's ``swz`` (TMA's 32/64/128-byte swizzle: the 16-byte
    chunk XOR the address bits above it): the eight 16-byte rows of one
    ldmatrix phase (eight consecutive rows, one chunk) land in eight
    different 16-byte bank groups, for every row width the kernel uses."""
    def swz(r, c, rb):
        return r * rb + ((c ^ (((r * rb) >> 7) & (rb // 16 - 1))) << 4)

    for rb in (32, 64, 128):
        for r0 in range(0, 64, 8):
            for c in range(rb // 16):
                groups = {(swz(r0 + i, c, rb) % 128) // 16 for i in range(8)}
                assert len(groups) == 8


# --------------------------------------------------- row groups (ROADMAP C4)

@pytest.mark.parametrize("B", [1, 16, 63, 64, 65, 80, 96, 127, 128, 129, 200, 256])
def test_i8_row_groups_cover_every_row_once(B):
    """B10 takes any row count as launches of at most 64 rows (csrc
    MAX_ROWS): the groups are in order, cover each row once, and only the
    last is short."""
    groups = fl.i8_row_groups(B)
    rows = np.concatenate([np.arange(B)[g] for g in groups])
    assert np.array_equal(rows, np.arange(B))
    sizes = [g.stop - g.start for g in groups]
    assert all(1 <= n <= fl._MAX_ROWS for n in sizes)
    assert sizes[:-1] == [fl._MAX_ROWS] * (len(sizes) - 1)
    assert len(groups) == -(-B // fl._MAX_ROWS)
    fl._check_i8(B, 5120, 151936)    # the wrappers take every count


def _i8_stack(gen, L, K, N):
    q = torch.randint(-127, 128, (L, K, N), dtype=torch.int8, generator=gen)
    return q, torch.rand((L, 1, N), generator=gen) / 200


@pytest.mark.parametrize("B", [80, 96, 128])
def test_i8_plain_by_row_groups_equals_all_rows(B):
    """What a launch a group computes: each of B10's three plain versions
    applied group by group equals it over all B rows (every row's result
    depends on that row alone)."""
    gen = torch.Generator().manual_seed(B)
    L, E, H, Kv, D, F = 2, 256, 2, 1, 128, 384
    C = (H + 2 * Kv) * D
    bf = torch.bfloat16
    x = torch.randn((B, E), generator=gen).to(bf)
    a = torch.randn((B, H * D), generator=gen).to(bf)
    ln = (1 + 0.1 * torch.randn((L, E), generator=gen)).to(bf)
    qn = (1 + 0.1 * torch.randn((L, D), generator=gen)).to(bf)
    cos, sin = torch.rand((B, D // 2), generator=gen), torch.rand((B, D // 2), generator=gen)
    wqkv, wo, gu, wd = (_i8_stack(gen, L, k, n) for k, n in
                        ((E, C), (H * D, E), (E, 2 * F), (F, E)))
    groups = fl.i8_row_groups(B)
    kw = dict(n_heads=H, n_kv=Kv, head_dim=D, eps=1e-6)

    def qkv(r):
        return fl.fused_qkv_stacked_i8_plain(x[r], ln, *wqkv, qn, qn, cos[r], sin[r], 1, **kw)

    def out(r):
        return fl.fused_out_mlp_stacked_i8_plain(a[r], x[r], *wo, ln, *gu, *wd, 1, eps=1e-6)

    def product(r):
        return fl.int8_product_plain(x[r], wqkv[0][0], wqkv[1][0])

    for fn in (qkv, out, product):
        whole = fn(slice(None))
        whole = whole if isinstance(whole, tuple) else (whole,)
        parts = [fn(g) for g in groups]
        parts = [p if isinstance(p, tuple) else (p,) for p in parts]
        for i, w in enumerate(whole):
            assert torch.equal(torch.cat([p[i] for p in parts]), w), (fn.__name__, i)
