"""K3's prefill mode (``ops/paged_attention.latent_prefill``): MLA's prefill
attention over the latent pool, against the JAX package on the CPU.

(a) ``latent_prefill_plain`` against the three JAX functions MLA's prefill
    branches call (``models/deepseek_v3.py:368-408``) at the latent width D
    = 576, v = the first 512 columns, H = 64 and 128: re-prefill against
    ``prefix_chunk_attention`` (JAX reads the gathered prefix before the
    chunk's write and the chunk's rows from registers, the port the pages
    after the write: only the softmax's order differs), a fresh prefill
    against ``causal_attention``, slot rows against
    ``masked_context_attention``; ps = 8, 16, 64; seeded numpy inputs; B = 3
    rows (full, tail padding, a whole padding row). Real queries equal
    JAX's within rtol 5e-2 / atol 2e-2 in bf16 (1e-5 in float32), padding
    queries are 0 (JAX averages stale rows or attends the prefix there).
(b) The key limits, and the host model of the launch order
    (``latent_prefill_order``, with ``latent_splits``): every (row,
    position, head block, key tile) of a real query in exactly one item,
    rows longest first, each row's positions longest first, over the chip
    smoke's shapes at 132 and 114 SMs.
(c) The wrapper off the CPU (meta tensors): it raises for what the kernel
    cannot take and for what it can, and never reaches the plain version.
(d) ``deepseek-v3-test`` engines with ``attn_impl="pallas"`` are in
    ``tests/test_torch_deepseek.py::test_engine_greedy_streams_match_jax``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.ops import attention as jattn
from deepsearch_tts_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=2e-2)
D, KL, T = 576, 512, 6
# MLA's scale 192^-1/2 as bf16 holds it: JAX rounds a Python scale to q's
# dtype before ``q * scale`` (weak typing), torch multiplies in float32 and
# rounds the product; at D = 576 that 0.13 % difference alone moves scores
# by ~0.01, which is JAX's rounding of the scale and not the algorithm
SCALE = 0.072265625
assert abs(SCALE - 192 ** -0.5) < 2 ** -11


def _bf16(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _inputs(H, ps, cs, dtype, seed, slot=False):
    """Pools of stale rows, each row's pages (slot: rows 1 .. B of a B + 2
    row pool), q and the chunk's new rows, T queries from ``cs``: row 0
    full, row 1 with two tail-padding queries, row 2 padding."""
    rng = np.random.default_rng(seed)
    B = 3
    if slot:
        P, N, ps = 1, B + 2, cs + T + 5
        table = 1 + np.arange(B)[:, None]
    else:
        P = -(-(cs + T) // ps) + 1
        N = 1 + B * P
        table = 1 + rng.permutation(N - 1)[: B * P].reshape(B, P)
    pool = rng.standard_normal((N, ps, 1, D)).astype(np.float32)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    rows = rng.standard_normal((B, T, 1, D)).astype(np.float32)
    if dtype == torch.bfloat16:
        pool, q, rows = map(_bf16, (pool, q, rows))
    valid = [T, T - 2, 0]
    pos = np.full((B, T), -1, np.int64)
    for b, n in enumerate(valid):
        pos[b, :n] = cs + np.arange(n)
    seq = np.array([cs + n if n else 0 for n in valid], np.int64)
    after = pool.copy()   # the chunk's write: real positions only
    for b in range(B):
        for t in range(valid[b]):
            p = pos[b, t]
            after[table[b, p // ps], p % ps] = rows[b, t]
    return q, pool, after, rows, table, pos, seq


def _port(q, after, table, pos, seq, dtype, **kw):
    tt = lambda x: torch.from_numpy(x).to(dtype)   # noqa: E731
    out = tpa.latent_prefill(tt(q), tt(after), torch.from_numpy(seq), torch.from_numpy(pos),
                             scale=SCALE, v_width=KL, **kw)
    return out.float().numpy()


def _jax(fn, *arrays, dtype, **kw):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = fn(*(jnp.asarray(a, jnp.int32 if a.dtype == np.int64 else jd) for a in arrays),
             scale=SCALE, **kw)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _hold(got, want, pos, dtype):
    valid = pos >= 0
    np.testing.assert_allclose(got[valid], want[valid][..., :KL],
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))
    assert not got[~valid].any()                   # padding queries: 0
    assert not got[2].any()                        # the whole padding row


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
HEADS = pytest.mark.parametrize("H", [64, 128])


@DTYPES
@HEADS
@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("cs", [0, 11, 16])
def test_plain_matches_prefix_chunk_attention(cs, ps, H, dtype):
    """Re-prefill: JAX over the prefix gathered before the write and the
    chunk's rows as k and v, the port over the pages after the write."""
    q, pool, after, rows, table, pos, seq = _inputs(H, ps, cs, dtype, seed=H + ps + cs)
    S = table.shape[1] * ps
    old = pool[table].reshape(3, S, 1, D)
    want = _jax(lambda q_, o, r, c, p, scale: jattn.prefix_chunk_attention(
        q_, o, o, r, r, c, p, scale=scale), q, old, rows, pos[:, 0], pos, dtype=dtype)
    got = _port(q, after, table, pos, seq, dtype, page_table=torch.from_numpy(table))
    _hold(got, want, pos, dtype)


@DTYPES
@HEADS
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_plain_matches_causal_attention(ps, H, dtype):
    """A fresh prefill: JAX's causal attention over the chunk's own rows,
    the port over the pages they were written to."""
    q, _, after, rows, table, pos, seq = _inputs(H, ps, 0, dtype, seed=7 * H + ps)
    want = _jax(lambda q_, r, scale: jattn.causal_attention(q_, r, r[..., :KL], scale=scale),
                q, rows, dtype=dtype)
    got = _port(q, after, table, pos, seq, dtype, page_table=torch.from_numpy(table))
    _hold(got, want, pos, dtype)


@DTYPES
@HEADS
@pytest.mark.parametrize("cs,slot_ctx", [(0, None), (9, None), (9, 12)])
def test_plain_matches_masked_context_attention_slot_layout(cs, slot_ctx, H, dtype):
    """Slot rows (``row_offset + b``, no table), keys below ``slot_ctx``:
    JAX's slot branch at T > 1, ``masked_context_attention`` over each
    row's first ``slot_ctx`` keys at ``max(position, 0)``."""
    q, _, after, _, table, pos, seq = _inputs(H, 0, cs, dtype, seed=3 * H + cs, slot=True)
    ctx = after[1:4] if slot_ctx is None else after[1:4, :slot_ctx]
    want = _jax(lambda q_, c, s, p, scale: jattn.masked_context_attention(
        q_, c, c[..., :KL], s, p, scale=scale), q, ctx, seq, np.maximum(pos, 0), dtype=dtype)
    got = _port(q, after, table, pos, seq, dtype, row_offset=1, max_keys=slot_ctx)
    if slot_ctx is not None:   # a query past the window sees its first slot_ctx keys
        assert (pos[0] >= slot_ctx).any()
    _hold(got, want, pos, dtype)


def test_key_limits():
    pos = torch.tensor([[5, 6, 7, -1], [0, 1, -1, -1], [-1, -1, -1, -1], [3, 4, 5, 6]])
    seq = torch.tensor([8, 2, 0, 6])
    lim = tpa.latent_key_limits(seq, pos, 16)
    assert lim.tolist() == [[6, 7, 8, 0], [1, 2, 0, 0], [0, 0, 0, 0], [4, 5, 6, 6]]
    assert tpa.latent_key_limits(seq, pos, 5)[0].tolist() == [5, 5, 5, 0]


def test_plain_counts_no_launch():
    n0 = tpa.latent_prefill.launches
    q, _, after, _, table, pos, seq = _inputs(64, 8, 3, torch.float32, seed=1)
    _port(q, after, table, pos, seq, torch.float32, page_table=torch.from_numpy(table))
    assert tpa.latent_prefill.launches == n0


# ------------------------------------------------------ (b) the launch order

def _shape(B, T, starts, valid):
    pos = torch.full((B, T), -1, dtype=torch.int64)
    for b, (s0, n) in enumerate(zip(starts, valid)):
        if s0 >= 0:
            pos[b, :n] = s0 + torch.arange(n)
    seq = torch.tensor([s0 + n if s0 >= 0 else 0 for s0, n in zip(starts, valid)])
    return pos, seq


# the chip smoke's shapes: (B, T, starts, valid, S)
SHAPES = {
    "3044 from 0": (1, 3044, (0,), (3044,), 48 * 64),
    "4096 bucket": (1, 4096, (0,), (4096,), 64 * 64),
    "100 after 3000": (1, 128, (3000,), (100,), 64 * 64),
    "300 after 3000": (1, 512, (3000,), (300,), 64 * 64),
    "ragged 16 x 64": (16, 64, (0, 5, 64, 100, 127, 128, 300, 511, 700, 1000, 1023, 1500,
                                2000, 2047, 3000, -1),
                       (64, 64, 60, 64, 33, 64, 64, 1, 64, 64, 64, 50, 64, 64, 64, 0), 48 * 64),
    "15 slot rows x 64": (15, 64, tuple(range(0, 3000, 200)), (64,) * 15, 4096),
    "a verify window": (4, 4, (100, 2000, 7, -1), (4, 4, 3, 0), 4096),
}


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_launch_order_covers_every_key_tile_once_longest_first(shape, H, sms):
    B, T, starts, valid, S = SHAPES[shape]
    pos, seq = _shape(B, T, starts, valid)
    HB = H // tpa.LATENT_HEADS
    splits, chunk = tpa.latent_splits(B * T, HB, S, sms)
    if B * T * HB >= sms:
        assert splits == 1     # split only where the items cannot fill the card
    items = tpa.latent_prefill_order(pos, seq, S, H, splits)
    assert len(items) == B * T * HB * splits == len(set(items))
    lim = tpa.latent_key_limits(seq, pos, S)
    seen = {}
    for b, t, h, z in items:
        lo, hi = z * chunk, min((z + 1) * chunk, int(lim[b, t]))
        for tile in range(lo // 64, -(-hi // 64) if hi > lo else lo // 64):
            key = (b, t, h, tile)
            assert key not in seen, key
            seen[key] = True
    want = {(b, t, h, tile) for b in range(B) for t in range(T) for h in range(HB)
            for tile in range(-(-int(lim[b, t]) // 64))}
    assert set(seen) == want
    # rows by their longest query, the longest first; within a row the
    # real queries longest first; a position's head blocks and splits
    # together
    rows = list(dict.fromkeys(b for b, *_ in items))
    longest = [int(lim[b].max()) for b in rows]
    assert longest == sorted(longest, reverse=True)
    for b in rows:
        mine = [int(lim[b, t]) for bb, t, h, z in items if bb == b and h == 0 and z == 0]
        real = [x for x in mine if x > 0]
        assert real == sorted(real, reverse=True)
    for i in range(0, len(items), HB * splits):
        assert len({(b, t) for b, t, *_ in items[i: i + HB * splits]}) == 1


# ---------------------------------------------------------- (c) refusals

def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["D=512", "H=96", "ps=12", "ps=100", "v_width=256",
                                  "pool float32", "takes the shape"])
def test_wrapper_never_falls_back_off_cpu(case, monkeypatch):
    """Off the CPU the wrapper launches K3's prefill mode or raises: here
    (meta tensors, neither CPU nor CUDA) it raises for every case, shapes
    K3 takes included, and the plain version is never called."""
    def refuse(*a, **k):
        raise AssertionError("the plain version was reached")

    monkeypatch.setattr(tpa, "latent_prefill_plain", refuse)
    B, P, Tq = 2, 3, 5
    H = 96 if case == "H=96" else 128
    Dq = 512 if case == "D=512" else D
    ps = {"ps=12": 12, "ps=100": 100}.get(case, 16)
    pool = _meta(1 + B * P, ps, 1, Dq,
                 dtype=torch.float32 if case == "pool float32" else torch.bfloat16)
    kw = dict(page_table=_meta(B, P, dtype=torch.int64), scale=SCALE,
              v_width=256 if case == "v_width=256" else KL)
    with pytest.raises((ValueError, TypeError)):
        tpa.latent_prefill(_meta(B, Tq, H, Dq), pool, _meta(B, dtype=torch.int64),
                           _meta(B, Tq, dtype=torch.int64), **kw)
