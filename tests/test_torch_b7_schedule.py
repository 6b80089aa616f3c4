"""B7 (``fused_out_router_stacked``: one launch of ``i8_stream<128, MT,
I8_ROUTER>`` in ``ops/csrc/fused_layer.cu``): its host-side plan and the
algebra of its phases, in plain Python and torch.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to the
plain version there). Here, from sizes and the SM count only: the stream-K
split of wo's (column tile, ring stage) pairs over the whole persistent grid
(``fused_layer.b7_tiles`` / ``i8_partition(whole_grid=True)``), the
segment slots each block writes (``b7_segs`` a block) and the one warp that
finishes each (row, tile) unit from them, and phase 2's items
(``b7_router_plan``), which cover every logit and every hn element once.
Besides the served widths, widths the fused layer's gate (``shapes_ok``)
takes that need the kernel's general paths: more phase-2 items than
blocks, more than one K chunk, blocks with empty shares, and a few SMs.
Then the arithmetic in the kernel's order: x2 from the segments' float32
sums added in block order, each row's norm from the per-tile sums of
squares of the rounded x2 added in tile order, and the logits of each item
from its warps' k-step pairs over the K chunks, against
``fused_out_router_stacked_plain``.
"""
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu_torch.models.common import matmul_f32
from deepsearch_tts_tpu_torch.ops import fused_layer as fl

torch.set_num_threads(1)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
# (E, H·D, NE) of the Qwen3-MoE configs' fused decode layer
WIDTHS = {"qwen3-30b-a3b": (2048, 4096, 128), "qwen3-235b-a22b": (4096, 8192, 128),
          "qwen3-moe-test": (64, 64, 8)}
# (E, H·D, NE) that shapes_ok takes beyond the served ones: 64 phase-2 bands
# and E % 1024 != 0; two K chunks; wo of 16 stages, fewer than the blocks
ODD_WIDTHS = {"e2560-ne512": (2560, 4096, 512), "e5120": (5120, 1024, 128),
              "e256": (256, 256, 128)}
WARPS = 4   # consumer warps of a block (csrc QCW at 128-column tiles)
# bf16 outputs that round at the same points in both orders: a float32
# summation-order difference can flip one bf16 rounding (2^-8 relative) —
# the bound chip_smoke.py holds the kernel to (BF16_RTOL / BF16_ATOL)
RTOL, ATOL = 2e-2, 1e-2


def _groups(B):
    """The wrapper's row groups of at most 64 rows (csrc: one launch each)."""
    return [min(64, B - r0) for r0 in range(0, B, 64)]


def _segments(E, HD, sms):
    tiles, nk = fl.b7_tiles(E, HD)
    return tiles, nk, fl.i8_partition(tiles, nk, sms, whole_grid=True)


def _check_partition(E, HD, sms):
    """Every (tile, stage) pair of wo once over ``sms`` runs (some empty
    where wo has fewer stages than the grid), each meeting at most
    ``b7_segs`` tiles."""
    tiles, nk, runs = _segments(E, HD, sms)
    seen = np.zeros((tiles, nk), dtype=np.int64)
    for segs in runs:
        for t, k0, k1 in segs:
            seen[t, k0:k1] += 1
    assert (seen == 1).all()
    assert len(runs) == sms and max(len(segs) for segs in runs) <= fl.b7_segs(E, HD, sms)
    assert all(segs for segs in runs) == (tiles * nk >= sms)


def _check_slots(E, HD, sms):
    """The slots b7_x2 reads for tile t — block b_lo's slot t - (its first
    tile), then slot 0 of b_lo + 1 .. b_hi, in block order — are the slots
    the blocks wrote for t, and the blocks among them with an empty share
    (which leave zeros in slot 0); every slot index is below ``b7_segs``;
    the warps of the grid (unit u = blk * 4 + warp, then + grid * 4)
    finish every (row, tile) unit once."""
    tiles, nk, runs = _segments(E, HD, sms)
    grid, total = len(runs), tiles * nk
    segs_a_block = fl.b7_segs(E, HD, grid)
    written = {}
    for b, segs in enumerate(runs):
        for i, (t, _, _) in enumerate(segs):
            written.setdefault(t, []).append((b, i))
    for t in range(tiles):
        b_lo = fl.i8_block_of(t * nk, total, grid)
        b_hi = fl.i8_block_of(t * nk + nk - 1, total, grid)
        seg_lo = t - b_lo * total // grid // nk   # the kernel's index
        read = [(b_lo, seg_lo)] + [(b, 0) for b in range(b_lo + 1, b_hi + 1)]
        assert [(b, i) for b, i in read if runs[b]] == written[t]
        assert all(i < segs_a_block for _, i in read)
    for B in _groups(80) + [1, 16, 64]:
        units = tiles * B
        done = np.zeros(units, dtype=np.int64)
        for blk in range(grid):
            for warp in range(WARPS):
                done[blk * WARPS + warp::grid * WARPS] += 1
        assert (done == 1).all()


def _check_router_items(E, NE, B, sms):
    """Phase 2 of each row group: items (band, row group) hold at most one
    mma m-tile of rows (the fewest that keep the items within the grid,
    else a whole m-tile), block b takes items b, b + grid, ..., and
    together they sum every logit once and write every hn element once
    (band c: 8-column pieces E / 8 * c // bands ..)."""
    for n in _groups(B):
        bands, rows, groups = fl.b7_router_plan(n, NE, sms)
        assert 1 <= rows <= fl.B7_ROWS
        if rows > 1:   # the fewest rows that fit, or an m-tile where none does
            assert bands * -(-n // (rows - 1)) > sms
        assert rows == fl.B7_ROWS or bands * groups <= sms
        logit = np.zeros((n, NE), dtype=np.int64)
        hn = np.zeros((n, E), dtype=np.int64)
        for blk in range(sms):
            for w in range(blk, bands * groups, sms):
                c, r0 = w % bands, w // bands * rows
                r1 = min(n, r0 + rows)
                logit[r0:r1, fl.B7_BAND * c:fl.B7_BAND * (c + 1)] += 1
                hn[r0:r1, 8 * (E // 8 * c // bands):8 * (E // 8 * (c + 1) // bands)] += 1
        assert (logit == 1).all() and (hn == 1).all()


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("B", [1, 16, 64, 80])
@pytest.mark.parametrize("model", sorted(WIDTHS))
def test_wo_partition_covers_every_stage_once(model, B, sms):
    """Every (tile, stage) pair of wo once over the whole grid; at the
    served widths every block streams and meets at most two tiles. The row
    groups do not change the split."""
    E, HD, _ = WIDTHS[model]
    _check_partition(E, HD, sms)
    assert sum(_groups(B)) == B and max(_groups(B)) <= 64
    if model != "qwen3-moe-test":
        assert fl.b7_segs(E, HD, sms) == 2


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("model", sorted(WIDTHS))
def test_each_unit_has_one_finishing_warp(model, sms):
    """The slots each (row, tile) unit adds are the ones written for its
    tile, and one warp finishes each unit."""
    _check_slots(*WIDTHS[model][:2], sms)


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("B", [1, 16, 64, 80])
@pytest.mark.parametrize("model", sorted(WIDTHS))
def test_router_blocks_cover_every_logit_once(model, B, sms):
    """Phase 2 sums every logit once and writes every hn element once; at
    the served widths the items fit the grid, one a block."""
    E, _, NE = WIDTHS[model]
    _check_router_items(E, NE, B, sms)
    if model != "qwen3-moe-test":
        for n in _groups(B):
            bands, _, groups = fl.b7_router_plan(n, NE, sms)
            assert bands * groups <= sms


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
def test_kernel_takes_the_served_widths(sms):
    """The engine's gate for the fused MoE decode layer on a card is
    ``shapes_ok``, the widths JAX fuses, whatever the card's SM count: the
    served Qwen3-MoE configs pass it, the test config (head_dim 16) does
    not, and B7's plan covers wo, the slots and the logits at every width
    it takes here, on this card and on one of 8 SMs."""
    from deepsearch_tts_tpu_torch.models.qwen3_moe import QWEN3_MOE_CONFIGS

    for name, cfg in QWEN3_MOE_CONFIGS.items():
        fits = cfg.fused_decode_fits(torch.device("cuda"))
        assert fits == fl.shapes_ok(*cfg.fused_decode_widths(), cfg.head_dim)
        assert fits == (name != "qwen3-moe-test")
    for E, HD, NE in [WIDTHS["qwen3-30b-a3b"], WIDTHS["qwen3-235b-a22b"], *ODD_WIDTHS.values()]:
        assert fl.shapes_ok(E, HD, NE, 128)
        for grid in (sms, 8):
            _check_partition(E, HD, grid)
            _check_slots(E, HD, grid)
            _check_router_items(E, NE, 64, grid)


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS, 8])
@pytest.mark.parametrize("B", [1, 16, 64, 80])
@pytest.mark.parametrize("width", sorted(ODD_WIDTHS))
def test_odd_widths_plan(width, B, sms):
    """At the widths beyond the served ones: wo once over the grid (blocks
    with empty shares at e256), the slots, and the phase-2 items over
    every logit and hn element once, more items than blocks at
    e2560-ne512 and 64 rows."""
    E, HD, NE = ODD_WIDTHS[width]
    _check_partition(E, HD, sms)
    _check_slots(E, HD, sms)
    _check_router_items(E, NE, B, sms)
    if width == "e2560-ne512" and B >= 64:
        bands, _, groups = fl.b7_router_plan(64, NE, sms)
        assert bands * groups > sms


def _inputs(seed, B, E, HD, NE):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)

    return (rnd(B, HD), rnd(B, E), rnd(1, HD, E, scale=HD ** -0.5),
            (rnd(1, E, scale=0.1).float() + 1).to(torch.bfloat16),
            rnd(1, E, NE, scale=E ** -0.5))


def _b7_model(a, x, wo, ln, router, sms, eps=1e-6):
    """B7 in the kernel's order: each block's segment sums of a @ wo
    (float32), x2 = bf16(x + the tile's slots in block order), each (row,
    tile)'s sum of squares of the rounded x2, each row's 1/rms from them in
    tile order, hn = bf16((x2 * 1/rms) * ln), and the logits of each phase-2
    block from its warps' k-step pairs (warp w: pairs w, w + 4, ...; a sum
    for each k-step of a pair), the eight sums added in order."""
    B, E = x.shape
    HD = a.shape[1]
    NE = router.shape[-1]
    tiles, nk, runs = _segments(E, HD, sms)
    af, wf = a.float(), wo[0].float()
    slots = {}
    for b, segs in enumerate(runs):
        for t, k0, k1 in segs:
            rows = slice(k0 * fl._KT, k1 * fl._KT)
            cols = slice(t * fl._TILE, (t + 1) * fl._TILE)
            slots[(t, b)] = af[:, rows] @ wf[rows, cols]
    x2 = torch.empty_like(x)
    ss = torch.empty((tiles, B))
    for t in range(tiles):
        cols = slice(t * fl._TILE, (t + 1) * fl._TILE)
        y = None
        for b in sorted(bb for tt, bb in slots if tt == t):
            y = slots[(t, b)] if y is None else y + slots[(t, b)]
        x2[:, cols] = (x[:, cols].float() + y).to(x.dtype)
        ss[t] = x2[:, cols].float().square().sum(-1)
    total = torch.zeros(B)
    for t in range(tiles):
        total = total + ss[t]
    inv = torch.rsqrt(total / E + eps)
    hn = ((x2.float() * inv[:, None]) * ln[0].float()).to(x.dtype)
    bands, rows, groups = fl.b7_router_plan(B, NE, sms)
    logits = torch.empty((B, NE))
    hf, rf = hn.float(), router[0].float()
    for w in range(bands * groups):
        c, r0 = w % bands, w // bands * rows
        r1, cols = min(B, r0 + rows), slice(fl.B7_BAND * c, fl.B7_BAND * (c + 1))
        acc = torch.zeros((WARPS, 2, r1 - r0, fl.B7_BAND))
        for k0 in range(0, E, fl.B7_KC):   # K chunks; warp w: pairs w, w + 4, ... of each
            for kp in range(min(fl.B7_KC, E - k0) // 32):
                for h in range(2):
                    k = slice(k0 + kp * 32 + 16 * h, k0 + kp * 32 + 16 * h + 16)
                    acc[kp % WARPS, h] += hf[r0:r1, k] @ rf[k, cols]
        s = torch.zeros((r1 - r0, fl.B7_BAND))
        for w in range(WARPS):
            for h in range(2):
                s = s + acc[w, h]
        logits[r0:r1, cols] = s
    return x2, hn, logits


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("B", [1, 16])
def test_phase_algebra_matches_the_plain_version(B, sms):
    """The kernel's order of sums at qwen3-30b-a3b's widths equals
    ``fused_out_router_stacked_plain`` within the bound."""
    E, HD, NE = WIDTHS["qwen3-30b-a3b"]
    args = _inputs(B, B, E, HD, NE)
    got = _b7_model(*args, sms)
    want = fl.fused_out_router_stacked_plain(*args, 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("width", ["e2560-ne512", "e5120"])
def test_phase_algebra_at_odd_widths(width):
    """The kernel's order of sums with several items a block (e2560-ne512
    at 64 rows on 132 blocks) and with two K chunks (e5120) equals the
    plain version within the bound; H·D cut to 512 (the stream's order of
    its sums is the served widths' test)."""
    E, _, NE = ODD_WIDTHS[width]
    B = 64 if width == "e2560-ne512" else 4
    args = _inputs(7, B, E, 512, NE)
    got = _b7_model(*args, H100_SXM_SMS)
    want = fl.fused_out_router_stacked_plain(*args, 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=RTOL, atol=ATOL)


def test_router_fault_is_outside_the_bound():
    """A phase-2 block that left out one warp's k-step pairs (as
    ``chip_smoke._b7_faults`` drops them) is far outside the bound at the
    reduced widths too."""
    E, HD, NE = 256, 512, 16
    a, x, wo, ln, router = _inputs(3, 4, E, HD, NE)
    x2, hn, logits = fl.fused_out_router_stacked_plain(a, x, wo, ln, router, 0)
    r = router.clone()
    r[0, (torch.arange(E) // 32) % WARPS == 1, fl.B7_BAND:] = 0
    faulty = matmul_f32(hn, r[0])
    bound = ATOL + RTOL * logits.abs()
    assert bool(((faulty - logits).abs() > bound).any())
