"""The wgmma form of the bf16 decode-layer products (``ops/csrc/
fused_layer.cu`` ``gemm_tc``: B3's, B4's and B8's products past 64 rows in
one weight pass): its host-side plan, in plain Python.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds B3 / B4 to
their plain versions there at 1 to 256 rows). Here, from sizes and the SM
count only: a product of up to 256 rows is one launch whose grid is the
persistent blocks alone (no row-group dimension); its (128-column tile,
k-slice) items cover every (tile, 64-row k stage) pair once, each slice a
whole number of stages; the row boxes of a launch cover each row once
across the consumer warpgroups; the k-slice count (``tc_splits``) is
counted per weight tile; and the wrappers' choice between the two forms
reads the row count only.
"""
import pytest
import torch

from deepsearch_tts_tpu_torch.ops import fused_layer as fl

torch.set_num_threads(1)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
# (K, N) of each bf16 product a decode layer runs on gemm_tc
PRODUCTS = {
    ("qwen3-8b", "wqkv"): (4096, 6144),
    ("qwen3-8b", "wo"): (4096, 4096),
    ("qwen3-8b", "w_gateup"): (4096, 24576),
    ("qwen3-8b", "w_down"): (12288, 4096),
    ("qwen3-30b-a3b", "wqkv"): (2048, 5120),
    ("deepseek-v3", "w_gate"): (7168, 18432),
    ("deepseek-v3", "w_down"): (18432, 7168),
    ("deepseek-v3", "shared_down"): (2048, 7168),
}
ROWS = [1, 16, 63, 64, 65, 80, 128, 129, 200, 256]


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("key", sorted(PRODUCTS))
def test_one_launch_covers_every_stage_once(key, sms):
    """Up to 256 rows: one launch (``tc_launches``), min(grid, items)
    blocks in one dimension; its items cover every (tile, stage) pair once,
    each slice whole stages, at least one, the slices in order."""
    K, N = PRODUCTS[key]
    tiles, nk = N // 128, K // fl.TC_STAGE
    for B in ROWS:
        assert fl.tc_launches(B) == [(0, B)]
        s = fl.tc_splits(B, N, K, sms)
        assert 1 <= s <= max(1, nk // 4)
        walks = fl.tc_items(N, K, s, sms)
        assert len(walks) == min(sms, tiles * s)
        seen = {}
        for walk in walks:
            for t, z, k0, k1 in walk:
                assert k0 == z * nk // s and k1 == (z + 1) * nk // s and k1 > k0
                for kt in range(k0, k1):
                    assert (t, kt) not in seen
                    seen[(t, kt)] = z
        assert len(seen) == tiles * nk
        lengths = {len(walk) for walk in walks}
        assert max(lengths) - min(lengths) <= 1


@pytest.mark.parametrize("B", ROWS + [257, 300, 512, 1000])
def test_row_boxes_cover_every_row_once(B):
    """A launch holds up to 256 rows as 64-row boxes (1, 2 or 4 a stage:
    the rows rounded up to 64); box i belongs to consumer warpgroup i % cw
    (cw = 1 up to 64 rows, else 2); every row below B lies in exactly one
    box of one launch, and a box past the rows is never loaded. More rows
    than 256 take a launch a 256-row group."""
    rows_seen = []
    launches = fl.tc_launches(B)
    assert len(launches) == -(-B // fl.TC_ROWS)
    for r0, rows in launches:
        mb = 1 if rows <= 64 else 2 if rows <= 128 else 4
        cw = 1 if mb < 2 else 2
        nbox = -(-rows // 64)
        assert nbox <= mb
        per_wg = [[i for i in range(nbox) if i % cw == wg] for wg in range(cw)]
        assert sorted(i for boxes in per_wg for i in boxes) == list(range(nbox))
        assert all(len(boxes) <= mb // cw for boxes in per_wg)
        for i in range(nbox):
            rows_seen += [r0 + 64 * i + r for r in range(64) if 64 * i + r < rows]
    assert rows_seen == list(range(B))


def test_splits_counted_per_weight_tile():
    """The k slices depend on the row count only through the partials'
    bytes: a call past 64 rows gets as many as one of 64 rows where those
    stay small (the parent's ``_splits`` halved them for a second row
    group), and the partials never exceed the weight bytes."""
    for (K, N), sms in ((PRODUCTS[("qwen3-8b", k)], s) for k in ("wo", "w_gateup", "w_down")
                        for s in (H100_SXM_SMS, H100_PCIE_SMS)):
        assert fl.tc_splits(80, N, K, sms) == fl.tc_splits(64, N, K, sms)
        for B in ROWS:
            s = fl.tc_splits(B, N, K, sms)
            assert 4 * B * N * s <= 2 * K * N
    assert fl._splits(80, 2 * 12288, 4096) < fl._splits(64, 2 * 12288, 4096)


def test_form_reads_the_row_count_only(monkeypatch):
    """``product_plan``: the wgmma form over the SM count from
    ``TC_MIN_ROWS`` rows on (its slices from ``tc_splits``), else
    ``gemm_partial`` (0 blocks) with ``_splits``; every lane step (16
    slots + a 16-row lane and more) and verify step past 16 rows takes
    the wgmma form."""
    monkeypatch.setattr("deepsearch_tts_tpu_torch.ops.paged_attention._sm_count",
                        lambda dev: H100_SXM_SMS)
    assert 16 < fl.TC_MIN_ROWS <= 32
    for K, N in PRODUCTS.values():
        for B in ROWS:
            s, grid = fl.product_plan(B, N, K, None)
            if B >= fl.TC_MIN_ROWS:
                assert (s, grid) == (fl.tc_splits(B, N, K, H100_SXM_SMS), H100_SXM_SMS)
            else:
                assert (s, grid) == (fl._splits(B, N, K), 0)
