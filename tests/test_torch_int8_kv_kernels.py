"""The int8-KV slice of the port's attention: the int8 pools and their
scales against JAX's, and the plain versions of K1's int8 mode
(``ops/paged_attention.py`` ``paged_int8_plain`` and the three B6 entries
given the scales pools) and of K2's int8 paged mode
(``ops/flash_attention.py`` ``flash_attention_paged_plain`` given them)
against the int8 branch of JAX's ``paged_attention``
(``deepsearch_tts_tpu/ops/attention.py:122-139``: XLA code, no Pallas site).

The pools are made from numpy rows drawn from a seed, quantized with each
package's own ``quantize_kv_rows`` (JAX packs four int8 a 32-bit word, the
port keeps them unpacked). Tolerances: 1e-5 in float32 (the same
arithmetic summed in another order), the suite's rtol 5e-2 / atol 2e-2 in
bf16. JAX's int8 branch clamps a padding query's position to 0 and
averages a row with no key; K2's paged mode gives such queries its own
limits and K1 writes 0 where a query sees no key, so only real queries
(position >= 0, at least one key) are compared.

The kernels themselves run on the card only: ``python3 chip_smoke.py``
holds them to these plain versions at qwen3-32b widths.
"""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.ops import attention as jattn
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.ops import attention as tattn
from deepsearch_tts_tpu_torch.ops import flash_attention as tflash
from deepsearch_tts_tpu_torch.ops import paged_attention as tpaged

D = 64
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=2e-2)
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _pools(rng, n_pages: int, ps: int, kv: int, np_dtype):
    """Random K and V rows [n_pages, ps, kv, D] in ``np_dtype``, quantized by
    both packages: (JAX's packed k, v and scales; the port's int8 k, v and
    scales)."""
    rows = [rng.standard_normal((n_pages, ps, kv, D)).astype(np_dtype) for _ in range(2)]
    jax_q = [jkv.quantize_kv_rows(jnp.asarray(r)) for r in rows]
    t_q = [tkv.quantize_kv_rows(torch.from_numpy(np.asarray(r, np.float32)).to(
        torch.bfloat16 if np_dtype == ml_dtypes.bfloat16 else torch.float32)) for r in rows]
    return ((jax_q[0][0], jax_q[1][0], jax_q[0][1], jax_q[1][1]),
            (t_q[0][0], t_q[1][0], t_q[0][1], t_q[1][1]))


def _table(rng, B: int, P: int, n_pages: int) -> np.ndarray:
    """Distinct random pages for each row (page 0, JAX's null page, in none)."""
    return (1 + rng.permutation(n_pages - 1)[: B * P]).reshape(B, P).astype(np.int32)


def _jax_int8(q, pools, table, seq, pos, jdt):
    jk, jv, jks, jvs = pools
    out = jattn.paged_attention(jnp.asarray(q).astype(jdt), jk, jv, jnp.asarray(table),
                                jnp.asarray(seq), jnp.asarray(np.maximum(pos, 0)),
                                k_scales=jks, v_scales=jvs)
    return np.asarray(out.astype(jnp.float32))


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, np.float32) if dtype is not None else np.asarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps,kv", [(8, 2), (48, 1), (64, 3)])
def test_int8_pools_and_scales_equal_jax(dtype, ps, kv):
    """The port's int8 pools equal JAX's ``unpack_int8_rows`` of its packed
    pools, and the scales are equal, from the same rows."""
    np_dtype = DTYPES[dtype][0]
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pools(np.random.default_rng(ps + kv), 5, ps, kv,
                                                    np_dtype)
    for jp, tp in ((jk, tk), (jv, tv)):
        assert tp.dtype == torch.int8 and tuple(tp.shape) == (5, ps, kv, D)
        np.testing.assert_array_equal(np.asarray(jkv.unpack_int8_rows(jp)), tp.numpy())
    for js, ts in ((jks, tks), (jvs, tvs)):
        assert ts.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())


# (G query heads a kv head, ps keys a page)
SHAPES = [(1, 8), (5, 48), (8, 64), (8, 8), (1, 64), (5, 8)]


def _decode_case(rng, G, ps, np_dtype):
    """A ragged T = 1 batch: rows of 1 key, a partial page, whole pages."""
    kv, P = 2, 4
    B = 4
    n_pages = 1 + B * P
    jpools, tpools = _pools(rng, n_pages, ps, kv, np_dtype)
    table = _table(rng, B, P, n_pages)
    seq = np.array([1, ps + 3, P * ps, 2 * ps], np.int32)
    q = rng.standard_normal((B, 1, G * kv, D)).astype(np_dtype)
    return q, jpools, tpools, table, seq, (seq - 1)[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,ps", SHAPES)
def test_k1_int8_plain_matches_jax_decode(G, ps, dtype):
    """K1's int8 mode, T = 1: ``paged_int8_plain`` and the three B6 entries'
    plain versions given the scales against JAX's int8 branch."""
    np_dtype, tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(10 * G + ps)
    q, jpools, tpools, table, seq, qpos = _decode_case(rng, G, ps, np_dtype)
    want = _jax_int8(q, jpools, table, seq, qpos, jdt)
    tk, tv, tks, tvs = tpools
    tq, tt, ts, tp = _t(q, tdt), _t(table).long(), _t(seq).long(), _t(qpos).long()
    sc = dict(k_scales=tks, v_scales=tvs)
    outs = {
        "paged_int8_plain": tpaged.paged_int8_plain(tq, tk, tv, tks, tvs, tt, ts, tp),
        "pallas_paged_attention": tpaged.pallas_paged_attention_plain(tq, tk, tv, tt, ts, tp,
                                                                      **sc),
        "pallas_paged_decode": tpaged.pallas_paged_decode_plain(tq, tk, tv, tt, ts, **sc),
        "pallas_paged_decode_clamp": tpaged.pallas_paged_decode_clamp_plain(tq, tk, tv, tt, ts,
                                                                            **sc),
    }
    for name, got in outs.items():
        assert got.dtype == tdt, name
        np.testing.assert_allclose(got.float().numpy(), want, **tol, err_msg=name)


def _prefill_case(rng, G, ps, np_dtype, case):
    """A re-prefill chunk over int8 pages after its own write: ``"prefix"``
    one row of T new tokens after a cached prefix (mid-page), ``"ragged"``
    rows of other prefixes, one with tail padding, one from position 0."""
    kv, P, T = 2, 5, 7
    B = 1 if case == "prefix" else 3
    n_pages = 1 + B * P
    jpools, tpools = _pools(rng, n_pages, ps, kv, np_dtype)
    table = _table(rng, B, P, n_pages)
    starts = [3 * ps + 5] if case == "prefix" else [ps - 1, 0, 2 * ps]
    valid = [T] if case == "prefix" else [T, T, 4]
    pos = np.full((B, T), -1, np.int64)
    for b, (s0, n) in enumerate(zip(starts, valid)):
        pos[b, :n] = s0 + np.arange(n)
    seq = np.array([s0 + n for s0, n in zip(starts, valid)], np.int32)
    q = rng.standard_normal((B, T, G * kv, D)).astype(np_dtype)
    return q, jpools, tpools, table, seq, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["prefix", "ragged"])
@pytest.mark.parametrize("G,ps", SHAPES)
def test_k2_int8_paged_plain_matches_jax(G, ps, case, dtype):
    """K2's int8 paged mode: ``flash_attention_paged_plain`` given the scales
    against JAX's int8 branch over the same pages, on every real query;
    ``paged_int8_plain`` (K1's plain version) agrees on them too."""
    np_dtype, tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(100 * G + ps + len(case))
    q, jpools, tpools, table, seq, pos = _prefill_case(rng, G, ps, np_dtype, case)
    want = _jax_int8(q, jpools, table, seq, pos, jdt)
    tk, tv, tks, tvs = tpools
    tq, tt, ts, tp = _t(q, tdt), _t(table).long(), _t(seq).long(), _t(pos)
    real = pos >= 0
    got = tflash.flash_attention_paged_plain(tq, tk, tv, tt, ts, tp, k_scales=tks, v_scales=tvs)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy()[real], want[real], **tol)
    k1 = tpaged.paged_int8_plain(tq, tk, tv, tks, tvs, tt, ts, tp.clamp(min=0))
    np.testing.assert_allclose(k1.float().numpy()[real], want[real], **tol)


def test_wrappers_on_the_cpu_run_the_plain_versions():
    """On CPU tensors the B6 entries and K2's paged mode, given the scales,
    return their plain versions' results exactly (no kernel, no launch)."""
    rng = np.random.default_rng(7)
    q, _, (tk, tv, tks, tvs), table, seq, qpos = _decode_case(rng, 4, 16, ml_dtypes.bfloat16)
    tq, tt, ts, tp = _t(q, torch.bfloat16), _t(table).long(), _t(seq).long(), _t(qpos).long()
    sc = dict(k_scales=tks, v_scales=tvs)
    before = (tpaged.pallas_paged_attention.launches, tpaged.pallas_paged_attention.i8_launches)
    assert torch.equal(tpaged.pallas_paged_attention(tq, tk, tv, tt, ts, tp, **sc),
                       tpaged.pallas_paged_attention_plain(tq, tk, tv, tt, ts, tp, **sc))
    assert torch.equal(tpaged.pallas_paged_decode(tq, tk, tv, tt, ts, **sc),
                       tpaged.pallas_paged_decode_plain(tq, tk, tv, tt, ts, **sc))
    assert torch.equal(tpaged.pallas_paged_decode_clamp(tq, tk, tv, tt, ts, **sc),
                       tpaged.pallas_paged_decode_clamp_plain(tq, tk, tv, tt, ts, **sc))
    assert (tpaged.pallas_paged_attention.launches,
            tpaged.pallas_paged_attention.i8_launches) == before
    q, _, (tk, tv, tks, tvs), table, seq, pos = _prefill_case(rng, 4, 16, ml_dtypes.bfloat16,
                                                              "ragged")
    args = (_t(q, torch.bfloat16), tk, tv, _t(table).long(), _t(seq).long(), _t(pos))
    n = tflash.flash_attention_paged.i8_launches
    assert torch.equal(tflash.flash_attention_paged(*args, k_scales=tks, v_scales=tvs),
                       tflash.flash_attention_paged_plain(*args, k_scales=tks, v_scales=tvs))
    assert tflash.flash_attention_paged.i8_launches == n


@pytest.mark.parametrize("case", ["prefix", "ragged"])
@pytest.mark.parametrize("G,ps", SHAPES)
def test_k2_int8_paged_is_widen_then_bf16_paged(G, ps, case):
    """K2's int8 paged mode on the card is ``widen_kv_pages`` (the rows'
    pages into bf16 pages ``b·P + p``), then the bf16 paged mode over them:
    in bf16 that composition, run on the plain versions, equals the int8
    plain version bit for bit on every row, padding rows included."""
    rng = np.random.default_rng(300 + 10 * G + ps + len(case))
    q, _, (tk, tv, tks, tvs), table, seq, pos = _prefill_case(rng, G, ps, ml_dtypes.bfloat16,
                                                              case)
    tq, tt, ts, tp = _t(q, torch.bfloat16), _t(table).long(), _t(seq).long(), _t(pos)
    kw, vw, wt = tflash.widen_kv_pages(tk, tv, tks, tvs, tt, ts)
    B, P = tt.shape
    assert kw.dtype == vw.dtype == torch.bfloat16 and kw.shape == (B * P, *tk.shape[1:])
    assert torch.equal(wt, torch.arange(B * P).view(B, P))
    assert torch.equal(tflash.flash_attention_paged_plain(tq, kw, vw, wt, ts, tp),
                       tflash.flash_attention_paged_plain(tq, tk, tv, tt, ts, tp,
                                                          k_scales=tks, v_scales=tvs))


def _widen_kernel_model(k8, s, table, seq, out):
    """``csrc/attention.cu`` ``widen_kv_pages``' indexing, thread by thread
    (vectorized over a block's threads): block (b·P + p, y), thread t takes
    16-byte piece i = y·256 + t of the page's K (int8 bytes ``src·128 +
    16·i``, scale ``src + i / 8``, ``src = table[b·P + p]·ps·KV``) and writes
    its 16 bf16 at ``(b·P + p)·ps·KV·128 + 16·i`` of ``out``, for pages that
    hold a key below the row's seq_len. ``k8`` [N,ps,KV,128] int8, ``s``
    [N,ps,KV], ``out`` flat bf16 of B·P pages (written in place)."""
    B, P = table.shape
    _, ps, KV, HD = k8.shape
    rows, th = ps * KV, 256
    flat8, flat_s = k8.reshape(-1, 16), s.reshape(-1)
    out16 = out.view(-1, 16)
    for bp in range(B * P):
        b, p = divmod(bp, P)
        if p * ps >= seq[b]:
            continue
        src = int(table.reshape(-1)[bp]) * rows
        for y in range(-(-rows * (HD // 16) // th)):
            i = y * th + torch.arange(th)
            i = i[i < rows * (HD // 16)]
            x = flat8[src * HD // 16 + i].float() * flat_s[src + i // (HD // 16)][:, None]
            out16[bp * rows * HD // 16 + i] = x.to(torch.bfloat16)


@pytest.mark.parametrize("ps,kv", [(8, 1), (48, 8), (64, 8), (16, 3)])
def test_widen_kernel_indexing_fills_each_needed_page(ps, kv):
    """The widening kernel's per-thread indexing (:func:`_widen_kernel_model`,
    head_dim 128) writes, on every page that holds a key below its row's
    seq_len, the plain version's bf16 page bit for bit, and nothing on the
    others (they keep the NaN they started with)."""
    rng = np.random.default_rng(ps + kv)
    B, P, N = 3, 4, 16
    rows = torch.from_numpy(rng.standard_normal((N, ps, kv, 128)).astype(np.float32))
    k8, s = tkv.quantize_kv_rows(rows)
    table = torch.from_numpy(_table(rng, B, P, N)).long()
    seq = torch.tensor([1, ps * P, ps + 1])
    out = torch.full((B * P, ps, kv, 128), float("nan"), dtype=torch.bfloat16)
    _widen_kernel_model(k8, s, table, seq, out)
    want, _, _ = tflash.widen_kv_pages_plain(k8, k8, s, s, table, seq)
    need = (torch.arange(P)[None] * ps < seq[:, None]).reshape(-1)
    assert torch.equal(out[need], want[need])
    assert torch.isnan(out[~need].float()).all()


def test_paged_attention_routes_int8_to_the_entries():
    """``ops/attention.paged_attention`` with the scales pools: a kernel
    ``impl`` at T = 1 goes to its B6 entry (K1's int8 mode's plain version
    on the CPU), which agrees with the gather within the bf16 tolerance
    (p rounded after the normalisation in both; the gather's mask keeps
    key 0 for a padding query, which no row here has)."""
    rng = np.random.default_rng(8)
    q, _, (tk, tv, tks, tvs), table, seq, qpos = _decode_case(rng, 8, 64, ml_dtypes.bfloat16)
    tq, tt, ts, tp = _t(q, torch.bfloat16), _t(table).long(), _t(seq).long(), _t(qpos).long()
    want = tattn.paged_attention(tq, tk, tv, tt, ts, tp, k_scales=tks, v_scales=tvs)
    for impl in ("pallas", "pallas2", "clamp"):
        got = tattn.paged_attention(tq, tk, tv, tt, ts, tp, impl=impl, k_scales=tks,
                                    v_scales=tvs)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **BF16_TOL,
                                   err_msg=impl)
