"""K2's paged mode's work plan (``ops/flash_attention.py`` ``paged_plan``,
the host model of ``flash_paged_plan`` in ``csrc/attention.cu``), the
algebra of its split pieces and their merge, and its tail-padding rule,
on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds the plan kernel
to this model and the attention kernel to its plain version there). Here:

(a) over every ``PAGED_PREFILLS`` shape of ``chip_smoke.py`` (the long
    prompt, the two follow-up chunks after a 3000-token prefix, the ragged
    group, the slot layouts, G = 5 and 8, ps = 16 and 48), at 132 and 114
    SMs: each (query, key) pair the plain version computes lies in exactly
    one item; items run longest first; whole tail-padding blocks and
    padding rows take no item; partial slots are distinct and within the
    wrapper's static sizes; splitting shortens the greedy schedule where the
    gate allows it.
(b) the pieces' partials (m in log2 units, l, unnormalised O) merged in
    plain torch equal ``flash_attention_paged_plain`` in float32 (rtol /
    atol 1e-5: two orders of float32 summation), and on a small case JAX's
    ``prefix_chunk_attention`` on the real queries.
(c) the deliberate difference from JAX (ROADMAP C): a block of
    ``floor(128 / G)`` positions that are all tail padding is 0, where JAX
    attends the cached prefix; a tail-padding query beside a real one in
    its block still sees the prefix.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.ops import attention as jattn
from deepsearch_tts_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
SHAPES = SMOKE.PAGED_PREFILLS
FOLLOW_UPS = [s for s in SHAPES if "new tokens after a 3000-token prefix" in s[0]]


def _positions(B, T, starts, valid):
    """Positions and seq_lens as ``chip_smoke._paged_prefill_inputs`` makes them."""
    pos = torch.full((B, T), -1, dtype=torch.int64)
    for b, (s0, n) in enumerate(zip(starts, valid)):
        if s0 >= 0:
            pos[b, :n] = s0 + torch.arange(n)
    seq = torch.tensor([s0 + n if s0 >= 0 else 0 for s0, n in zip(starts, valid)])
    return pos, seq


def _plan(shape, sms):
    label, B, T, starts, valid, ps, P, (h, kv), slot = shape
    G, S = h // kv, P * ps
    pos, seq = _positions(B, T, starts, valid)
    lim = fa.paged_key_limits(seq, pos, S, G)
    split = fa.paged_splits_allowed(B, T, G, kv, S, sms)
    return fa.paged_plan(seq, pos, S, G, kv, sms, split), lim, pos, split


def _tiles(item):
    return -(-(item[5] - item[4]) // fa.KEY_TILE)


def _greedy_makespan(work, sms):
    """Longest-first greedy on ``sms`` workers: the schedule's length."""
    load = np.zeros(sms)
    for w in sorted(work, reverse=True):
        load[load.argmin()] += w
    return load.max()


# ----------------------------------------------------------- (a) the plan

@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS], ids=["132", "114"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_every_visible_pair_lies_in_exactly_one_item(shape, sms):
    _, B, T, _, _, ps, P, (h, kv), _ = shape
    plan, lim, _, _ = _plan(shape, sms)
    TQ, nqb, S = fa.query_block(h // kv), plan["nqb"], P * ps
    cover = np.zeros((B, nqb, kv, S), np.int32)
    for b, m, kh, z, k0, kend, slot in plan["items"]:
        assert 0 <= k0 < kend <= S
        cover[b, m, kh, k0:kend] += 1
    lim_np = lim.numpy()
    for b in range(B):
        for t in range(T):
            m, n = t // TQ, lim_np[b, t]
            # the keys the plain version gives query t, in every kv head: once
            assert (cover[b, m, :, :n] == 1).all(), (b, t, n)
    # and no key past the unit's largest limit is in any item
    ulim = np.asarray(plan["ulim"]).reshape(B, nqb)
    beyond = np.arange(S)[None, None, None] >= ulim[:, :, None, None]
    assert not (cover * beyond).any()


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS], ids=["132", "114"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_items_run_longest_first_within_the_static_sizes(shape, sms):
    _, B, T, _, _, ps, P, (h, kv), _ = shape
    plan, _, _, split = _plan(shape, sms)
    tiles = [_tiles(it) for it in plan["items"]]
    assert tiles == sorted(tiles, reverse=True) and min(tiles) >= 1
    n_ws, n_slots = fa.paged_plan_sizes(B, T, h // kv, kv, sms, split)
    U = B * plan["nqb"]
    assert n_ws == -(-(fa.PLAN_HEADER + 6 * U) // 4) * 4 + 4 * (kv * U + n_slots)
    assert len(plan["items"]) <= kv * U + n_slots
    slots = [it[6] for it in plan["items"] if it[6] >= 0]
    assert len(set(slots)) == len(slots) == plan["n_slots"] <= n_slots
    if not split:
        assert plan["split_units"] == [] and not slots
    C, thr = plan["C"], plan["thr"]
    assert C >= fa.PIECE_MIN_TILES and (C <= thr or not split)
    for u, ul in enumerate(plan["ulim"]):
        pieces = [it for it in plan["items"] if it[0] * plan["nqb"] + it[1] == u]
        if u in plan["split_units"]:   # longer than an SM's mean: ~C tiles a piece
            t = -(-ul // fa.KEY_TILE)
            assert t > thr and 2 * kv <= len(pieces) <= kv * max(2, t // C)
            assert max(_tiles(it) for it in pieces) < 2 * C
        else:
            assert len(pieces) == (kv if ul else 0)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_units_with_no_key_take_no_item(shape):
    """Padding rows and blocks whose every position is tail padding are
    zero units: no item, and the kernel's spare warps write their zeros."""
    _, B, T, starts, valid, ps, P, (h, kv), _ = shape
    plan, lim, pos, _ = _plan(shape, H100_SXM_SMS)
    TQ, nqb = fa.query_block(h // kv), plan["nqb"]
    with_item = {(it[0], it[1]) for it in plan["items"]}
    for b in range(B):
        for m in range(nqb):
            block = pos[b, m * TQ:(m + 1) * TQ]
            whole_padding = bool((block < 0).all())
            assert ((b, m) in plan["zero_units"]) == whole_padding
            assert ((b, m) in with_item) == (not whole_padding)
            if whole_padding:
                assert not lim[b, m * TQ:(m + 1) * TQ].any()


def test_follow_up_chunks_split_and_shorten_the_schedule():
    """The two follow-up chunks after a 3000-token prefix (100 new tokens
    padded to 128, 300 padded to 512): few units, each ~24 key tiles. The
    gate allows pieces; the greedy schedule of the pieces is within the
    greedy bound (the mean load an SM plus one piece of C tiles) and well
    under the longest unit, which the unsplit grid took; the 512-token chunk's
    padding blocks (positions 320 .. 511 at G = 4) take no item."""
    assert len(FOLLOW_UPS) == 2
    for shape in FOLLOW_UPS:
        _, B, T, starts, valid, ps, P, (h, kv), _ = shape
        plan, lim, _, split = _plan(shape, H100_SXM_SMS)
        assert split and plan["split_units"]
        units = [-(-u // fa.KEY_TILE) for u in plan["ulim"]] * kv
        pieces = [_tiles(it) for it in plan["items"]]
        assert sum(pieces) == sum(units)
        span = _greedy_makespan(pieces, H100_SXM_SMS)
        assert span <= sum(units) / H100_SXM_SMS + plan["C"] and span < 0.75 * max(units)
    _, _, T, _, valid, *_ = FOLLOW_UPS[1]
    plan, *_ = _plan(FOLLOW_UPS[1], H100_SXM_SMS)
    TQ = fa.query_block(SMOKE.H // SMOKE.KV)
    assert len(plan["zero_units"]) == T // TQ - -(-valid[0] // TQ) > 0


def test_long_prompt_is_not_split():
    """The 3044-token prompt: 768 units of one row at G = 4, more than four
    an SM: no pieces, no merge, longest first."""
    plan, *_ = _plan(SHAPES[0], H100_SXM_SMS)
    assert not fa.paged_splits_allowed(1, 3044, SMOKE.H // SMOKE.KV, SMOKE.KV, 3072, H100_SXM_SMS)
    assert plan["split_units"] == [] and len(plan["items"]) == 96 * SMOKE.KV


def test_ragged_group_splits_its_long_rows():
    """The ragged 16 x 64 group: the row that starts at 3000 holds units of
    24 key tiles against a mean of ~13.5 an SM; its pieces bring the greedy
    schedule under that longest unit."""
    shape = next(s for s in SHAPES if s[0].startswith("B=16 T=64"))
    plan, *_ = _plan(shape, H100_SXM_SMS)
    kv = SMOKE.KV
    units = [-(-u // fa.KEY_TILE) for u in plan["ulim"]] * kv
    pieces = [_tiles(it) for it in plan["items"]]
    assert max(units) == 24 and max(pieces) < max(units)
    assert _greedy_makespan(pieces, H100_SXM_SMS) < _greedy_makespan(units, H100_SXM_SMS)


def test_plan_reads_no_tensor_value_on_the_host():
    """The wrapper's sizes and the split gate take static sizes only: the
    limits, the items and the pieces are the card's (a captured prefill
    replays them)."""
    import inspect

    assert list(inspect.signature(fa.paged_splits_allowed).parameters) == [
        "B", "T", "G", "KV", "S", "sms"]
    # a fresh short prompt (one page of 64 keys a row) never needs a merge
    assert not fa.paged_splits_allowed(1, 32, 4, 8, 64, H100_SXM_SMS)
    assert fa.paged_splits_allowed(1, 32, 4, 8, 4096, H100_SXM_SMS)
    assert list(inspect.signature(fa.paged_plan_sizes).parameters) == [
        "B", "T", "G", "KV", "sms", "split"]


@pytest.mark.parametrize("tiles,C,thr", [(1, 2, 2), (2, 2, 2), (3, 2, 2), (9, 4, 6),
                                         (10, 3, 3), (24, 3, 6), (25, 7, 15), (24, 100, 100),
                                         (20, 3, 24)])
def test_unit_pieces_are_even_and_never_empty(tiles, C, thr):
    z, per = fa.unit_pieces(tiles, C, thr)
    if tiles <= thr:
        assert (z, per) == (1, tiles)
        return
    assert 2 <= z <= max(2, tiles // C) and per < 2 * C
    assert (z - 1) * per < tiles <= z * per
    assert z == -(-tiles // per)


# --------------------------------------------------- (b) split and merge

def _pieces_plain(q, k, v, lim, plan, G, KV):
    """The kernel's arithmetic in plain float32 torch: each item's rows over
    its keys ``[k0, kend)`` as (m log2 units, l, unnormalised O), written
    out directly (unsplit) or merged over the unit's pieces."""
    B, T, H, D = q.shape
    TQ = fa.query_block(G)
    scale = D ** -0.5
    out = torch.zeros(B, T, H, D)
    parts = {}
    for b, m, kh, z, k0, kend, slot in plan["items"]:
        t0, t1 = m * TQ, min(m * TQ + TQ, T)
        qs = q[b, t0:t1, kh * G:(kh + 1) * G].float()                  # [t,G,D]
        s = torch.einsum("tgd,sd->tgs", qs, k[b, k0:kend, kh].float()) * scale / np.log(2.0)
        keys = torch.arange(k0, kend)
        mask = (keys[None, :] < lim[b, t0:t1, None])[:, None, :]       # [t,1,s]
        s = s.masked_fill(~mask, -torch.inf)
        mx = s.amax(-1)
        p = torch.exp2(s - torch.where(mx == -torch.inf, 0.0, mx)[..., None])
        o = torch.einsum("tgs,sd->tgd", p, v[b, k0:kend, kh].float())
        if slot < 0:
            out[b, t0:t1, kh * G:(kh + 1) * G] = o / p.sum(-1).clamp(min=1e-30)[..., None]
        else:
            parts.setdefault((b, m, kh), []).append((mx, p.sum(-1), o))
    for (b, m, kh), pl in parts.items():
        t0, t1 = m * TQ, min(m * TQ + TQ, T)
        M = torch.stack([x[0] for x in pl]).amax(0)
        w = [torch.exp2(x[0] - torch.where(M == -torch.inf, 0.0, M)) for x in pl]
        L = sum(x[1] * wz for x, wz in zip(pl, w))
        acc = sum(torch.where(wz[..., None] > 0, x[2] * wz[..., None], 0.0)
                  for x, wz in zip(pl, w))
        out[b, t0:t1, kh * G:(kh + 1) * G] = acc / L.clamp(min=1e-30)[..., None]
    return out


def _small_case(G, K, starts, valid, T, ps, P, D=16, seed=0):
    rng = np.random.default_rng(seed)
    B, H = len(starts), K * G
    N = 1 + B * P
    table = torch.from_numpy(1 + rng.permutation(N - 1)[: B * P].reshape(B, P))
    kp, vp = (torch.from_numpy(rng.standard_normal((N, ps, K, D), dtype=np.float32))
              for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, T, H, D), dtype=np.float32))
    pos, seq = _positions(B, T, starts, valid)
    return q, kp, vp, table, seq, pos


@pytest.mark.parametrize("G", [1, 2, 5, 64])
def test_split_pieces_merge_to_the_plain_version(G):
    """Rows that start at 0, mid-tile and past several tiles, tail padding
    and a padding row, on a card of 16 SMs (pieces of 2 tiles): the pieces
    merged in plain torch equal ``flash_attention_paged_plain`` in float32."""
    K, T, ps, P = 2, 9, 64, 20
    starts, valid = (0, 300, 1000, -1), (9, 5, 9, 0)
    q, kp, vp, table, seq, pos = _small_case(G, K, starts, valid, T, ps, P, seed=G)
    S = P * ps
    lim = fa.paged_key_limits(seq, pos, S, G)
    plan = fa.paged_plan(seq, pos, S, G, K, 16, split=True)
    assert plan["split_units"], "the case must cut units into pieces"
    k = kp[table].reshape(len(starts), S, K, -1)
    v = vp[table].reshape(len(starts), S, K, -1)
    got = _pieces_plain(q, k, v, lim, plan, G, K)
    want = fa.flash_attention_paged_plain(q, kp, vp, table, seq, pos)
    torch.testing.assert_close(got, want, **F32_TOL)
    assert not got[3].any()     # the padding row


def test_split_pieces_merge_to_jax_prefix_chunk_attention():
    """On a small case the merged pieces equal JAX's re-prefill on the real
    queries (JAX reads the prefix before the chunk's write and the chunk's
    keys from registers: the pages after the write hold the same keys)."""
    G, K, T, ps, P, D = 2, 2, 6, 64, 12, 16
    starts, valid = (500, 0), (6, 4)
    q, kp, vp, table, seq, pos = _small_case(G, K, starts, valid, T, ps, P, D, seed=7)
    S, B = P * ps, len(starts)
    rng = np.random.default_rng(8)
    kn, vn = (rng.standard_normal((B, T, K, D), dtype=np.float32) for _ in range(2))
    k_old = kp[table].reshape(B, S, K, D).numpy()
    v_old = vp[table].reshape(B, S, K, D).numpy()
    want = np.asarray(jattn.prefix_chunk_attention(
        *(jnp.asarray(x) for x in (q.numpy(), k_old, v_old, kn, vn)),
        jnp.asarray(pos[:, 0].numpy(), jnp.int32), jnp.asarray(pos.numpy(), jnp.int32)))
    for b in range(B):      # the chunk's write: real positions only
        for t in range(T):
            p = int(pos[b, t])
            if p >= 0:
                kp[table[b, p // ps], p % ps] = torch.from_numpy(kn[b, t])
                vp[table[b, p // ps], p % ps] = torch.from_numpy(vn[b, t])
    lim = fa.paged_key_limits(seq, pos, S, G)
    plan = fa.paged_plan(seq, pos, S, G, K, 4, split=True)
    assert plan["split_units"]
    got = _pieces_plain(q, kp[table].reshape(B, S, K, D), vp[table].reshape(B, S, K, D), lim,
                        plan, G, K)
    real = (pos >= 0).numpy()
    np.testing.assert_allclose(got.numpy()[real], want[real], **F32_TOL)


# ------------------------------------------- (c) whole tail-padding blocks

def test_key_limits_zero_whole_tail_padding_blocks():
    """Blocks of ``floor(128 / G)`` positions: at G = 64, two. A padding
    query beside a real one sees the prefix; a block of padding sees
    nothing; G = 1 (one block of 128) keeps every padding query on the
    prefix, as before."""
    pos = torch.tensor([[10, 11, 12, -1, -1, -1, -1], [0, 1, -1, -1, -1, -1, -1]])
    seq = torch.tensor([13, 2])
    assert fa.paged_key_limits(seq, pos, 64, group=64).tolist() == [
        [11, 12, 13, 10, 0, 0, 0], [1, 2, 0, 0, 0, 0, 0]]
    assert fa.paged_key_limits(seq, pos, 64).tolist() == [
        [11, 12, 13, 10, 10, 10, 10], [1, 2, 0, 0, 0, 0, 0]]


def test_whole_tail_padding_block_is_zero_where_jax_attends_the_prefix():
    """The deliberate difference (ROADMAP C, K2's paged mode): at G = 64 a
    block holds two positions. A 3-token chunk after a 10-token prefix,
    padded to 7: position 3 shares its block with a real query and sees the
    prefix as in JAX; positions 4 .. 6 are whole padding blocks: 0 in the
    port, JAX's softmax over the prefix there."""
    G, K, D, T, ps = 64, 1, 16, 7, 8
    rng = np.random.default_rng(3)
    H, B, P = K * G, 1, 2
    table = np.array([[1, 2]])
    kp, vp = (rng.standard_normal((3, ps, K, D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, T, K, D)).astype(np.float32) for _ in range(2))
    pos = np.array([[10, 11, 12, -1, -1, -1, -1]])
    want = np.asarray(jattn.prefix_chunk_attention(
        *(jnp.asarray(x) for x in (q, kp[table].reshape(B, P * ps, K, D),
                                    vp[table].reshape(B, P * ps, K, D), kn, vn)),
        jnp.asarray(pos[:, 0], jnp.int32), jnp.asarray(pos, jnp.int32)))
    for t in range(3):
        p = pos[0, t]
        kp[table[0, p // ps], p % ps], vp[table[0, p // ps], p % ps] = kn[0, t], vn[0, t]
    got = fa.flash_attention_paged(
        *(torch.from_numpy(x) for x in (q, kp, vp)), torch.from_numpy(table),
        torch.tensor([13]), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got[0, :4], want[0, :4], **F32_TOL)
    assert not got[0, 4:].any()
    assert np.abs(want[0, 4:]).min() > 0
