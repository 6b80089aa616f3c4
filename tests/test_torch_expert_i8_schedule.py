"""The int8 grouped expert kernel's prefill form (``ops/csrc/moe_i8.cu``
``grouped_expert_i8_tc``): its plan and the bit-level piece it adds to the
bf16 prefill kernel, in plain Python and numpy.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to the
plain versions there). Here: the work list the kernel builds on the card
from the group offsets and the capacity (``moe.i8_prefill_items``, the
kernel's ``item``), which must cover every row of an expert below its
capacity exactly once for each n-tile, store no row past it and zero each
row past it once, on skewed routings, walked by grids of 132 and 114
blocks; the choice between the decode and the prefill form, from static
sizes alone (the offsets never leave the device); and the widening of an
int8 ring stage into the bf16 tile ``wgmma`` reads, modelled on int32
words through the byte permutes and TMA's 128-byte swizzle.
"""
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu_torch.ops import moe

torch.set_num_threads(1)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
NE, E, F, TOPK = 128, 2048, 768, 8      # qwen3-30b-a3b's experts
TILE_ROWS = 256                          # rows a prefill tile (csrc PBM)
N_TILES = {"gate|up": F // 64, "down": E // 128}   # h: 64 columns a tile, y: 128


def _offsets(kind: str, T: int, seed: int) -> list:
    """Group offsets of T tokens x top-8 over 128 experts (the order the
    dispatch sorts them in), for a routing of the given kind."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, NE)) * 2
    if kind == "skewed":        # expert 5: 500 rows, past cap and past one tile
        logits[:500, 5] += 30.0
    elif kind == "piled":       # experts 0-3 take every token: T rows each
        logits[:, :4] += 30.0
    elif kind == "few":         # nine experts share all the rows, the rest none
        logits[:, :9] += 30.0
    elif kind == "tail":        # the last 40 experts never routed to
        logits[:, -40:] -= 30.0
    top = np.argsort(-logits, axis=1, kind="stable")[:, :TOPK]
    counts = np.bincount(top.reshape(-1), minlength=NE)
    return [0] + np.cumsum(counts).tolist()


KINDS = [("random", 3072), ("skewed", 3072), ("piled", 3072), ("few", 3072), ("tail", 3072),
         ("random", 256), ("skewed", 600)]


@pytest.mark.parametrize("kind,T", KINDS)
@pytest.mark.parametrize("part", sorted(N_TILES))
def test_work_list_covers_each_capped_row_once(kind, T, part):
    """Every row of expert e below min(offsets[e+1], offsets[e] + cap) is
    stored by exactly one item of each n-tile; every row past the capacity
    is stored by none and zeroed by exactly one (the expert's last m-tile);
    an item's rows are one tile of at most 256 rows of one expert, whose
    64-row boxes the producer loads."""
    off = _offsets(kind, T, seed=len(kind) + T)
    S = T * TOPK
    cap = moe.expert_capacity(S, NE)
    n_tiles = N_TILES[part]
    items = moe.i8_prefill_items(off, cap, n_tiles)
    stored = np.zeros((S, n_tiles), dtype=np.int64)
    zeroed = np.zeros((S, n_tiles), dtype=np.int64)
    for e, nt, mt, row0, rows in items:
        end = min(off[e + 1], off[e] + cap)
        m_tiles = -(-min(off[e + 1] - off[e], cap) // TILE_ROWS)
        assert 0 <= mt < m_tiles and 0 <= nt < n_tiles
        assert row0 == off[e] + TILE_ROWS * mt and 0 < rows <= TILE_ROWS
        assert row0 + rows <= end and (rows == TILE_ROWS or row0 + rows == end)
        assert -(-rows // 64) <= 4                    # the row boxes of a stage
        stored[row0:row0 + rows, nt] += 1
        if mt == m_tiles - 1:
            zeroed[off[e] + cap:off[e + 1], nt] += 1
    eid = np.repeat(np.arange(NE), np.diff(off))
    kept = (np.arange(S) - np.asarray(off)[eid]) < cap
    assert (stored[kept] == 1).all() and (zeroed[kept] == 0).all()
    assert (stored[~kept] == 0).all() and (zeroed[~kept] == 1).all()
    if kind in ("skewed", "piled"):
        assert (~kept).any()          # the routing does reach past the capacity


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("kind", ["random", "piled", "few"])
def test_blocks_walk_the_items_once(kind, sms):
    """The persistent grid: block b walks items b, b + G, ... (the producer,
    the widening warps and the consumers alike, so their ring stages stay in
    step); every item has one block, the blocks' counts differ by at most
    one, and the item → expert lookup (the last expert whose first item is
    at most w) never lands on an expert without rows."""
    off = _offsets(kind, 3072, seed=1)
    cap = moe.expert_capacity(3072 * TOPK, NE)
    for n_tiles in N_TILES.values():
        items = moe.i8_prefill_items(off, cap, n_tiles)
        walks = [list(range(b, len(items), sms)) for b in range(sms)]
        seen = sorted(w for walk in walks for w in walk)
        assert seen == list(range(len(items)))
        lengths = {len(walk) for walk in walks}
        assert max(lengths) - min(lengths) <= 1
        assert all(off[e + 1] > off[e] for e, *_ in items)


class _FakeLib:
    """Records which entry of ``moe_i8`` a wrapper called, and with what."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dstts_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.mark.parametrize("T", [1, 16, 255, 256, 3072])
def test_form_from_static_sizes_only(monkeypatch, T):
    """The wrappers take the prefill form where ``grouped_prefill`` (S, NE,
    E, F: sizes only) says so and count it in ``prefill_launches``; the
    offsets are a tensor on a device without data (``meta``), so any read of
    them on the host would raise."""
    lib = _FakeLib()
    monkeypatch.setattr(moe, "_lib_i8", lambda: lib)
    monkeypatch.setattr(moe, "_sm_count", lambda dev: H100_SXM_SMS)
    for name in ("_check", "_check_i8", "_check_offsets"):
        monkeypatch.setattr(moe, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {
        "cuda_stream": 0})())
    meta = torch.device("meta")
    S = T * TOPK
    xs = torch.empty((S, E), dtype=torch.bfloat16, device=meta)
    hs = torch.empty((S, F), dtype=torch.bfloat16, device=meta)
    offsets = torch.empty((NE + 1,), dtype=torch.int32, device=meta)
    gu = {"q": torch.empty((NE, E, 2 * F), dtype=torch.int8, device=meta),
          "scales": torch.empty((NE, 1, 2 * F), dtype=torch.float32, device=meta)}
    wd = {"q": torch.empty((NE, F, E), dtype=torch.int8, device=meta),
          "scales": torch.empty((NE, 1, E), dtype=torch.float32, device=meta)}
    cap = moe.expert_capacity(S, NE)
    monkeypatch.setattr(moe.grouped_gateup_i8, "prefill_launches", 0)
    monkeypatch.setattr(moe.grouped_down_i8, "prefill_launches", 0)
    moe.grouped_gateup_i8(xs, gu, None, offsets, cap)
    moe.grouped_down_i8(hs, wd, offsets, cap)
    prefill = moe.grouped_prefill(S, NE, E, F)
    assert prefill == (S >= moe.PREFILL_ROWS_PER_EXPERT * NE)
    want = (["dstts_grouped_gateup_i8_tc", "dstts_grouped_down_i8_tc"] if prefill
            else ["dstts_grouped_gateup_i8", "dstts_grouped_down_i8"])
    assert [c[0] for c in lib.calls] == want
    assert moe.grouped_gateup_i8.prefill_launches == moe.grouped_down_i8.prefill_launches == int(
        prefill)
    if prefill:   # the prefill entries take S (the row map) and the grid: the SM count
        (_, a_gu), (_, a_dn) = lib.calls
        assert a_gu[-5:-2] == (F, S, H100_SXM_SMS) and a_gu[2] == cap
        assert a_dn[-5:-2] == (E, S, H100_SXM_SMS) and a_dn[2] == cap


# --------------------------------------------- the widening, bit by bit

def prmt(a: int, b: int, sel: int) -> int:
    """PTX ``prmt.b32`` (default mode): byte i of the result is byte
    ``(sel >> 4i) & 7`` of the eight bytes {b, a} (a the low four)."""
    src = a | (b << 32)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _f32_sub(bits: int) -> int:
    v = np.array([bits], dtype=np.uint32).view(np.float32) - np.float32(8388736.0)
    return int(v.view(np.uint32)[0])


def widen_pair(u: int, i: int) -> int:
    """The kernel's ``widen_pair``: bytes i and i + 1 of the sign-flipped
    word u → one word of two bf16, byte i in the low half."""
    a = _f32_sub(prmt(u, 0x4B000000, 0x7440 | i))
    b = _f32_sub(prmt(u, 0x4B000000, 0x7440 | (i + 1)))
    return prmt(a, b, 0x7632)


def widen16(words):
    """The kernel's ``widen16``: four words of int8 → eight words of bf16
    pairs in order (lo: bytes 0-7, hi: bytes 8-15)."""
    u = [w ^ 0x80808080 for w in words]
    return [widen_pair(u[j // 2], 2 * (j % 2)) for j in range(8)]


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy(
    ).astype(np.uint16)


@pytest.mark.parametrize("seed", [0, 1])
def test_widened_tile_is_the_bf16_tile_wgmma_reads(seed):
    """An int8 stage as TMA lands it (two unswizzled [64 k][64 B] boxes: the
    tile's columns 0-63 and 64-127), widened 16 bytes at a time by the
    kernel's loop (chunk c: half c >> 8, k row (c >> 2) & 63, columns
    16 (c & 3) ..) into 16-byte chunks 2 (c & 3) and 2 (c & 3) + 1 of row k
    of bf16 box h, swizzled (chunk j at j ^ (k & 7)): read back as wgmma
    reads an MN-major operand in 128-byte swizzle atoms (element (k, n) in
    box n // 64, row k, chunk ((n % 64) // 8) ^ (k & 7), halfword n % 8),
    every element is the bf16 of its int8 value, every int8 value
    included."""
    rng = np.random.default_rng(seed)
    W8 = rng.integers(-128, 128, size=(64, 128), dtype=np.int64)
    W8[0, :128] = np.arange(-128, 0)
    W8[1, :128] = np.arange(0, 128)
    stage = np.concatenate([W8[:, :64].reshape(-1), W8[:, 64:].reshape(-1)]).astype(np.int8)
    raw = stage.view(np.uint8)
    tile = np.zeros(2 * 64 * 128, dtype=np.uint8)        # two 64 x 64 bf16 boxes
    for c in range(len(raw) // 16):
        h, r, c16 = c >> 8, (c >> 2) & 63, c & 3
        words = [int.from_bytes(raw[16 * c + 4 * i:16 * c + 4 * i + 4].tobytes(), "little")
                 for i in range(4)]
        out = widen16(words)
        row = h * 64 * 128 + r * 128
        for half, ws in ((0, out[:4]), (1, out[4:])):
            j = (2 * c16 + half) ^ (r & 7)
            tile[row + 16 * j:row + 16 * j + 16] = np.frombuffer(
                b"".join(w.to_bytes(4, "little") for w in ws), dtype=np.uint8)
    halfwords = tile.view(np.uint16)
    got = np.zeros((64, 128), dtype=np.uint16)
    for k in range(64):
        for n in range(128):
            byte = (n // 64) * 64 * 128 + k * 128 + ((((n % 64) // 8) ^ (k & 7)) << 4) + 2 * (n % 8)
            got[k, n] = halfwords[byte // 2]
    np.testing.assert_array_equal(got, _bf16_bits(W8))


def test_widening_stores_fill_every_bank_group_evenly():
    """A warp's 32 widening threads (chunks c .. c + 31: 8 k rows x 4
    column chunks) store 16-byte pieces whose swizzled chunks hit each of
    the eight 16-byte bank groups four times: the fewest wavefronts a
    512-byte store can take."""
    for c0 in range(0, 512, 32):
        for half in (0, 1):
            groups = np.zeros(8, dtype=np.int64)
            for c in range(c0, c0 + 32):
                r, c16 = (c >> 2) & 63, c & 3
                groups[(2 * c16 + half) ^ (r & 7)] += 1
            assert (groups == 4).all()
