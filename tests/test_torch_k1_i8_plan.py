"""K1's int8 mode's plan (``ops/paged_attention.py`` ``decode_i8_plan``, the
host model of the ``decode_i8_plan`` kernel in ``csrc/attention.cu``) and
the split / merge algebra of its pieces.

The plan cuts each (row group, kv head)'s visible keys, from ``seq_lens``
and ``q_positions`` read on the card, into pieces of at most ``C`` 64-key
tiles and lists them longest first for a persistent grid. Here, over the
smoke's decode shapes at 132 and 114 SMs and over ragged chunks with
``q_positions``: every visible (row group, kv head, key tile) lies in
exactly one piece, the pieces run longest first, groups with no key take
none, slots and items stay within the static sizes the wrapper allocates,
and those sizes (and the launch) come from shapes alone. Then each piece's
float32 partial (m, l, O), p rounded to bf16 against the piece's maximum
as the kernel rounds it, merged as the kernel's last piece merges them,
equals ``paged_int8_plain`` and the int8 branch of JAX's
``paged_attention`` (``deepsearch_tts_tpu/ops/attention.py:122-139``) at
small sizes: rtol 5e-2 / atol 2e-2, the suite's bf16 bound (p and the
output are rounded to bf16 at other points than the plain versions'), on
the queries that see a key (JAX averages a row with none; the kernel and
the plain version write 0).

The kernel itself runs on the card only: ``python3 chip_smoke.py`` holds
it, and the plan kernel against this model, at qwen3-32b's widths.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.ops import attention as jattn
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.ops import fused_layer
from deepsearch_tts_tpu_torch.ops import paged_attention as pa

TILE = pa.KEY_TILE
SMS = (132, 114)     # H100 SXM, H100 PCIe
# the smoke's B6 rows (chip_smoke.SEQS), K1's own (LIMITS: two with no key)
SEQS = [1, 17, 500, 4095, 64, 65, 4096, 2048, 129, 1000, 3000, 256, 7, 4000, 333, 2]
LIMITS = [1, 17, 500, 4095, 0, 4096, 2048, 64, 65, 1000, 3000, 129, 256, 4000, 7, 0]
# (label, row lengths, T, G, KV, max_keys): T = 1 decode at qwen3-32b's (G =
# 8) and qwen3-14b's (G = 5) heads, one long row, sixteen full rows, a
# G = 64 head group (four groups of 16 rows), chunks of T > 1 (16 and 64
# folded rows a kv head)
CASES = [
    ("SEQS", SEQS, 1, 8, 8, 4096),
    ("LIMITS", LIMITS, 1, 8, 8, 4096),
    ("G=5", SEQS, 1, 5, 8, 4096),
    ("B=1 4096", [4096], 1, 8, 8, 4096),
    ("B=16 x 4096", [4096] * 16, 1, 8, 8, 4096),
    ("G=64", [3000, 0, 129], 1, 64, 1, 4096),
    ("T=2 G=8", [1, 700, 4096, 65], 2, 8, 8, 4096),
    ("T=16 G=4", [16, 1000, 300, 0], 16, 4, 2, 1024),
]


def _qpos(lens, T):
    """The chunk's positions: its last query at the row's last key."""
    seq = torch.tensor(lens)
    return seq, (seq - T).clamp(min=0)[:, None] + torch.arange(T)[None]


def _plan(case, sms):
    _, lens, T, G, KV, max_keys = case
    seq, qpos = _qpos(lens, T)
    return pa.decode_i8_plan(seq, qpos, T=T, G=G, KV=KV, sms=sms, max_keys=max_keys), seq, qpos


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_every_visible_tile_in_one_piece(case, sms):
    """Each folded query row's visible key tiles, for each kv head, lie in
    exactly one item of its row group; items hold whole tiles from a tile
    edge and end at the group's key limit or a tile edge."""
    _, lens, T, G, KV, max_keys = case
    plan, seq, qpos = _plan(case, sms)
    rows, groups = plan["sizes"]["rows"], plan["sizes"]["groups"]
    lims = pa.i8_row_limits(seq, qpos, T, G, max_keys=max_keys)
    want = set()
    for b, row in enumerate(lims):
        for r, lim in enumerate(row):
            for kh in range(KV):
                want |= {((b * groups + r // rows) * KV + kh, j) for j in range(-(-lim // TILE))}
    got = []
    for u, k0, k1, _ in plan["items"]:
        assert k0 % TILE == 0 and k1 > k0
        glim = plan["rows"][u // KV][0]
        assert k1 == glim or k1 % TILE == 0, (u, k0, k1, glim)
        got += [(u, j) for j in range(k0 // TILE, -(-k1 // TILE))]
    assert len(got) == len(set(got)) and set(got) == want
    assert plan["W"] == len(got)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pieces_longest_first_within_static_sizes(case, sms):
    """Items run longest first (tile counts past the last bucket count as
    one); a group's pieces differ by one tile at most and hold fewer than
    1.5 C tiles (C = 2 and a group of 2 tiles: 2); split groups' pieces take
    distinct slots ``(sbase + zi)·KV + kh``; slots and items fit the
    wrapper's static sizes."""
    _, lens, T, G, KV, max_keys = case
    plan, _, _ = _plan(case, sms)
    C, sz = plan["C"], plan["sizes"]
    assert C == max(pa.I8_MIN_TILES, -(-plan["W"] // (pa.I8_PIECES * sz["blocks"])))
    lengths = [-(-(k1 - k0) // TILE) for _, k0, k1, _ in plan["items"]]
    assert all(n < 1.5 * C or n <= 2 for n in lengths)
    assert lengths == sorted(lengths, reverse=True)
    per_unit: dict = {}
    for (u, *_), n in zip(plan["items"], lengths):
        per_unit.setdefault(u, []).append(n)
    assert all(max(v) - min(v) <= 1 for v in per_unit.values())
    slots = [s for *_, s in plan["items"] if s >= 0]
    assert len(slots) == len(set(slots)) and all(s < sz["slots"] for s in slots)
    assert len(plan["items"]) <= sz["items"]
    for lim, t, z, sbase in plan["rows"]:
        assert (z > 1) == (sbase >= 0) and (z > 0) == (lim > 0) and t == -(-lim // TILE)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_groups_without_keys_take_no_piece(case):
    """A row group whose queries see no key (a row of length 0, a group of
    queries past every limit) has no item; its zeros come from the producer
    warps."""
    _, lens, T, G, KV, max_keys = case
    plan, _, _ = _plan(case, 132)
    empty = {rw for rw, (lim, *_) in enumerate(plan["rows"]) if lim == 0}
    assert all(u // KV not in empty for u, *_ in plan["items"])
    if 0 in lens:
        assert empty


def test_splits_where_the_card_would_idle():
    """At the SEQS shape the long rows are cut into pieces of about C
    tiles (C from W and the grid alone); one row of 4096 keys into pieces
    of I8_MIN_TILES; sixteen such rows into as many pieces as the grid has
    blocks or fewer (one wave)."""
    plan, _, _ = _plan(CASES[0], 132)
    assert plan["W"] == 8 * sum(-(-x // TILE) for x in SEQS)
    assert max(z for *_, z, _ in plan["rows"]) > 1
    one, _, _ = _plan(CASES[3], 132)
    assert one["C"] == pa.I8_MIN_TILES and len(one["items"]) == 8 * 64 // pa.I8_MIN_TILES
    full, _, _ = _plan(CASES[4], 132)
    assert len(full["items"]) <= full["sizes"]["blocks"]


class _FakeLib:
    """Records the C entry a wrapper called, and with what."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dstts_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.mark.parametrize("B,T,H,KV", [(16, 1, 64, 8), (80, 1, 40, 8), (1, 16, 32, 8),
                                      (3, 1, 64, 1)])
def test_launch_from_static_sizes_only(monkeypatch, B, T, H, KV):
    """``decode_i8_cuda`` (through the B6 entry's ``_k1_entry``) allocates
    its scratch from :func:`i8_plan_sizes` and launches ``dstts_decode_i8``
    with tensors on a device without data (``meta``): any read of
    ``seq_lens``, the positions or the table on the host would raise."""
    lib = _FakeLib()
    monkeypatch.setattr(pa, "_lib", lambda: lib)
    monkeypatch.setattr(pa, "_sm_count", lambda dev: 132)
    for mod, name in ((pa, "_check_q"), (pa, "_check_index"), (fused_layer, "_check")):
        monkeypatch.setattr(mod, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    meta = torch.device("meta")
    ps, P, N = 64, 64, 4096
    q = torch.empty((B, T, H, 128), dtype=torch.bfloat16, device=meta)
    k = torch.empty((N, ps, KV, 128), dtype=torch.int8, device=meta)
    s = torch.empty((N, ps, KV), dtype=torch.float32, device=meta)
    table = torch.empty((B, P), dtype=torch.int64, device=meta)
    seq = torch.empty((B,), dtype=torch.int64, device=meta)
    qpos = torch.empty((B, T), dtype=torch.int64, device=meta)
    monkeypatch.setattr(pa.pallas_paged_attention, "i8_launches", 0)
    out = pa.pallas_paged_attention(q, k, k, table, seq, qpos, k_scales=s, v_scales=s)
    assert out.shape == (B, T, H, 128) and out.device == meta
    assert pa.pallas_paged_attention.i8_launches == 1
    [(name, args)] = lib.calls
    assert name == "dstts_decode_i8"
    sz = pa.i8_plan_sizes(B, T, H // KV, KV, 132)
    assert args[7:9] == (P, N) and args[13] == P * ps and args[15:20] == (B, T, H, KV, ps)
    assert args[-2] == 132
    # the three scratch buffers are the last tensors allocated: their sizes
    assert sz["rows"] == pa.i8_item_rows(T * H // KV)
    assert sz["ws_ints"] >= 8 + 6 * B * sz["groups"] + sz["units"] + 4 * sz["items"]


# ------------------------------------------- pieces merged against the plain

D = 128


def _pools(rng, n_pages, ps, kv):
    rows = [rng.standard_normal((n_pages, ps, kv, D)).astype(np.float32) for _ in range(2)]
    jq = [jkv.quantize_kv_rows(jnp.asarray(r)) for r in rows]
    tq = [tkv.quantize_kv_rows(torch.from_numpy(r)) for r in rows]
    return (jq[0][0], jq[1][0], jq[0][1], jq[1][1]), (tq[0][0], tq[1][0], tq[0][1], tq[1][1])


def _piece_partials(plan, q, kd, vd, lims, T, G, KV, scale):
    """Each item's float32 partial (m in log2 units, l, unnormalised O) of
    its group's query rows over its keys, p rounded to bf16 against the
    piece's maximum (the kernel's round point), and the unsplit items' and
    split units' outputs merged as the kernel merges them."""
    B = q.shape[0]
    rows, groups = plan["sizes"]["rows"], plan["sizes"]["groups"]
    R = T * G
    out = torch.zeros((B, T, G * KV, D))
    parts: dict = {}
    for u, k0, k1, slot in plan["items"]:
        rw, kh = divmod(u, KV)
        b, qg = divmod(rw, groups)
        for r in range(qg * rows, min(qg * rows + rows, R)):
            t, g = divmod(r, G)
            lim = lims[b][r]
            hi = min(k1, lim)
            qv = q[b, t, kh * G + g].float()
            if hi <= k0:
                part = (-np.inf, 0.0, torch.zeros(D))
            else:
                s = (kd[b, k0:hi, kh].float() @ qv) * scale * np.log2(np.e)
                m = float(s.max())
                p = torch.exp2(s - m)
                o = p.to(torch.bfloat16).float() @ vd[b, k0:hi, kh].float()
                part = (m, float(p.sum()), o)
            if slot < 0:
                out[b, t, kh * G + g] = part[2] / max(part[1], 1e-30)
            else:
                parts.setdefault((b, t, kh * G + g), []).append(part)
    for (b, t, h), ps_ in parts.items():
        M, L, acc = -np.inf, 0.0, torch.zeros(D)
        for m, l_, o in ps_:
            if m == -np.inf:
                continue
            mn = max(M, m)
            a, wz = 2.0 ** (M - mn), 2.0 ** (m - mn)
            M, L, acc = mn, L * a + l_ * wz, acc * a + o * wz
        out[b, t, h] = acc / max(L, 1e-30)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("G,ps,T", [(8, 8, 1), (5, 48, 1), (8, 64, 1), (4, 16, 4)])
def test_split_pieces_merged_equal_plain_and_jax(G, ps, T):
    """At 8 SMs the plan splits the longer rows; the pieces' partials merged
    equal ``paged_int8_plain`` and (T = 1) JAX's int8 branch on every query
    that sees a key."""
    KV, P, B = 2, 512 // ps, 4
    rng = np.random.default_rng(100 * G + ps + T)
    n_pages = 1 + B * P
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pools(rng, n_pages, ps, KV)
    table = (1 + rng.permutation(n_pages - 1)[: B * P]).reshape(B, P)
    lens = [1, 3 * ps + 5, P * ps, 0 if T == 1 else 2]
    seq = torch.tensor(lens)
    qpos = (seq - T).clamp(min=0)[:, None] + torch.arange(T)[None]
    q = torch.from_numpy(rng.standard_normal((B, T, G * KV, D)).astype(np.float32)).to(
        torch.bfloat16)
    tt = torch.from_numpy(table).long()
    plan = pa.decode_i8_plan(seq, qpos, T=T, G=G, KV=KV, sms=8, max_keys=P * ps)
    assert any(s >= 0 for *_, s in plan["items"])   # some rows are split
    kd = pa.dequant_context(tk, tks, tt, torch.bfloat16)
    vd = pa.dequant_context(tv, tvs, tt, torch.bfloat16)
    lims = pa.i8_row_limits(seq, qpos, T, G, max_keys=P * ps)
    got = _piece_partials(plan, q, kd, vd, lims, T, G, KV, D ** -0.5)
    plain = pa.paged_int8_plain(q, tk, tv, tks, tvs, tt, seq, qpos)
    seen = torch.tensor(lims).reshape(B, T, G).amax(-1) > 0          # [B, T]
    mask = seen[:, :, None, None].expand_as(got)
    torch.testing.assert_close(got.float()[mask], plain.float()[mask], rtol=5e-2, atol=2e-2)
    assert bool((got.float()[~mask] == 0).all())
    if T == 1:
        want = jattn.paged_attention(jnp.asarray(q.float().numpy()).astype(jnp.bfloat16), jk, jv,
                                     jnp.asarray(table.astype(np.int32)),
                                     jnp.asarray(np.array(lens, np.int32)),
                                     jnp.asarray(qpos.numpy().astype(np.int32)),
                                     k_scales=jks, v_scales=jvs)
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        torch.testing.assert_close(got.float()[mask], want[mask], rtol=5e-2, atol=2e-2)
