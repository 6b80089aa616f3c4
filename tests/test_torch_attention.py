"""Parity of the port's attention kernels' plain versions with the JAX
Pallas kernels, and the KV-write repair.

The same inputs, made from a seed with numpy, go through the JAX kernel (in
Pallas interpret mode, as the JAX suite runs it on the CPU) and the port's
wrapper, which takes its plain PyTorch version because the tensors lie on
the CPU. float32 inputs are held at atol 1e-5, where the point is the
algorithm (online softmax over blocks against one softmax: only the order
of float32 sums differs); one bf16 case per kernel at rtol 5e-2 / atol
2e-2, the JAX suite's own bound for these kernels
(``tests/test_kernels.py:131,166``). The CUDA kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.ops import flash_attention as jflash
from deepsearch_tts_tpu.ops import paged_attention as jpaged
from deepsearch_tts_tpu.ops import slot_attention as jslot
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.ops import attention as tattn
from deepsearch_tts_tpu_torch.ops import flash_attention as tflash
from deepsearch_tts_tpu_torch.ops import paged_attention as tpaged
from deepsearch_tts_tpu_torch.ops import slot_attention as tslot

torch.set_num_threads(1)

BF16 = np.dtype(ml_dtypes.bfloat16)
F32_TOL = dict(rtol=0, atol=1e-5)      # float32: summation order only
BF16_TOL = dict(rtol=5e-2, atol=2e-2)  # tests/test_kernels.py:131,166
CASES = [(np.float32, F32_TOL), (BF16, BF16_TOL)]


def _np(rng, *shape, dtype=np.float32, scale=0.5):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(dtype)


def _t(a):
    a = np.array(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------- KV-write repair

@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_write_kv_flat_drops_padding_like_jax(layout):
    """Padding positions are dropped, as JAX drops them out of bounds
    (``kvcache.py:51-54``): the pools equal JAX's exactly, row 0 included.
    In the slot layout row 0 is slot 0's token 0, a live key."""
    rng = np.random.default_rng(0)
    L, K, D = 2, 2, 8
    if layout == "paged":
        N, ps = 8, 4
        table_l = np.array([[1, 2, 3], [4, 5, 6]], np.int64) + N     # layer 1
        positions = np.array([[3, 4, 5, 6, 7], [0, 1, 2, -1, -1]], np.int64)
    else:   # slot: page = max_seq_len, identity table
        N, ps = 2, 16
        table_l = np.arange(N, dtype=np.int64)[:, None]               # layer 0
        positions = np.array([[5, 6, 7, -1, -1], [-1, -1, -1, -1, -1]], np.int64)
    kpool = _np(rng, L * N, ps, K, D)
    vpool = _np(rng, L * N, ps, K, D)
    knew = _np(rng, 2, 5, K, D)
    vnew = _np(rng, 2, 5, K, D)
    jk, jv = jkv.write_kv_flat(jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(knew),
                               jnp.asarray(vnew), jnp.asarray(positions, jnp.int32),
                               jnp.asarray(table_l, jnp.int32))
    tk5, tv5 = tkv.init_kv_pages(L, N, ps, K, D, dtype=torch.float32)
    tk, tv = tk5.view(L * N, ps, K, D), tv5.view(L * N, ps, K, D)
    tk.copy_(torch.from_numpy(kpool))
    tv.copy_(torch.from_numpy(vpool))
    out = tkv.write_kv_flat(tk, tv, torch.from_numpy(knew), torch.from_numpy(vnew),
                            torch.from_numpy(positions), torch.from_numpy(table_l))
    assert out[0] is tk and out[1] is tv
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tk.numpy()[0, 0], kpool[0, 0])   # token row 0 kept


# ---------------------------------------------------------------------- B1

@pytest.mark.parametrize("dtype,tol", CASES)
@pytest.mark.parametrize("shared", [False, True])
def test_slot_attention_plain_matches_jax(dtype, tol, shared):
    """Mixed limits (short, block-crossing, at the bucket edge, past it) and
    an inactive row (limit 0 → clamped to 1), every layer of the pool, a
    slot_ctx bucket narrower than the row; ``v_pool=None`` is the shared
    (MLA) variant where v is k."""
    rng = np.random.default_rng(1)
    L, B, ps, K, G, D = 2, 8, 64, 2, 2, 32
    H = K * G
    slot_ctx = 48
    kp = _np(rng, L * B, ps, K, D, dtype=dtype)
    vp = None if shared else _np(rng, L * B, ps, K, D, dtype=dtype)
    q = _np(rng, B, H, D, dtype=dtype)
    limit = np.array([1, 5, 17, 48, 0, 33, 60, 16], np.int32)
    for layer in range(L):
        want = jslot.slot_attention(jnp.asarray(q), jnp.asarray(kp),
                                    None if shared else jnp.asarray(vp),
                                    jnp.asarray(limit), jnp.int32(layer), n_rows=B,
                                    slot_ctx=slot_ctx, interpret=True)
        got = tslot.slot_attention(_t(q), _t(kp), None if shared else _t(vp),
                                   torch.from_numpy(limit), layer, n_rows=B,
                                   slot_ctx=slot_ctx)
        assert got.dtype == _t(q).dtype and got.shape == (B, H, D)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_slot_attention_rejects_row_mismatch():
    q = torch.zeros(3, 4, 32)
    kp = torch.zeros(8, 64, 2, 32)
    with pytest.raises(ValueError, match="n_rows"):
        tslot.slot_attention(q, kp, kp, torch.ones(3, dtype=torch.int32), 0,
                             n_rows=4, slot_ctx=64)


# ---------------------------------------------------------------------- B6

def _paged_inputs(rng, dtype, B, T, ps=4, P=4, NP=16, K=2, G=2, D=32):
    H = K * G
    kp = _np(rng, NP, ps, K, D, dtype=dtype)
    vp = _np(rng, NP, ps, K, D, dtype=dtype)
    q = _np(rng, B, T, H, D, dtype=dtype)
    table = rng.permutation(np.arange(1, NP))[: B * P].reshape(B, P).astype(np.int32)
    return q, kp, vp, table


@pytest.mark.parametrize("dtype,tol", CASES)
@pytest.mark.parametrize("chunk", ["decode", "fresh4", "resume4"])
def test_pallas_paged_attention_plain_matches_jax(dtype, tol, chunk):
    """T=1 decode over mixed lengths, a T=4 chunk from position 0, and a
    resumed T=4 chunk whose positions start mid-sequence
    (``tests/test_kernels.py:50-85``)."""
    rng = np.random.default_rng(2)
    if chunk == "decode":
        q, kp, vp, table = _paged_inputs(rng, dtype, B=3, T=1)
        lens = np.array([6, 11, 16], np.int32)
        qpos = (lens - 1)[:, None]
    else:
        start = 0 if chunk == "fresh4" else 6
        q, kp, vp, table = _paged_inputs(rng, dtype, B=2, T=4)
        lens = np.array([start + 4, start + 3], np.int32)   # row 1: last query padded
        qpos = (start + np.arange(4, dtype=np.int32))[None, :].repeat(2, 0)
    want = jpaged.pallas_paged_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                         jnp.asarray(table), jnp.asarray(lens),
                                         jnp.asarray(qpos), interpret=True)
    got = tpaged.pallas_paged_attention(_t(q), _t(kp), _t(vp), torch.from_numpy(table),
                                        torch.from_numpy(lens), torch.from_numpy(qpos))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("dtype,tol", CASES)
@pytest.mark.parametrize("entry", ["pallas_paged_decode", "pallas_paged_decode_clamp"])
def test_paged_decode_plain_matches_jax(dtype, tol, entry):
    """The two T=1 entry points: partial, full and single-page rows."""
    rng = np.random.default_rng(3)
    q, kp, vp, table = _paged_inputs(rng, dtype, B=3, T=1)
    lens = np.array([5, 16, 2], np.int32)
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
            jnp.asarray(lens))
    want = getattr(jpaged, entry)(*args, interpret=True)
    got = getattr(tpaged, entry)(_t(q), _t(kp), _t(vp), torch.from_numpy(table),
                                 torch.from_numpy(lens))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("impl", ["pallas", "pallas2", "clamp"])
def test_paged_attention_impl_switch_matches_gather(impl, monkeypatch):
    """At T=1 the impl switch reaches the B6 entries, which agree with the
    gather path; T>1 always stays on the gather (as in JAX)."""
    rng = np.random.default_rng(4)
    q, kp, vp, table = _paged_inputs(rng, np.float32, B=3, T=1)
    lens = torch.tensor([6, 11, 16])
    qpos = (lens - 1)[:, None]
    args = (_t(q), _t(kp), _t(vp), torch.from_numpy(table).long(), lens, qpos)
    want = tattn.paged_attention(*args)
    name = {"pallas": "pallas_paged_attention", "pallas2": "pallas_paged_decode",
            "clamp": "pallas_paged_decode_clamp"}[impl]
    calls = []
    orig = getattr(tpaged, name)
    monkeypatch.setattr(tpaged, name, lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = tattn.paged_attention(*args, impl=impl)
    q4 = _t(_np(rng, 3, 4, 4, 32))
    tattn.paged_attention(q4, *args[1:5], qpos + torch.arange(4) - 3, impl=impl)
    assert calls == [1]
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


# ---------------------------------------------------------------------- B2

@pytest.mark.parametrize("T", [64, 100])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_attention_plain_matches_jax(T, G):
    rng = np.random.default_rng(5)
    B, K, D = 2, 2, 32
    q = _np(rng, B, T, K * G, D)
    k = _np(rng, B, T, K, D)
    v = _np(rng, B, T, K, D)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  interpret=True)
    got = tflash.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    # T == S: the causal_attention switch and the gather path agree with it
    np.testing.assert_allclose(_f32(tattn.causal_attention(_t(q), _t(k), _t(v),
                                                           impl="pallas")),
                               _f32(got), atol=0, rtol=0)
    np.testing.assert_allclose(_f32(tattn.causal_attention(_t(q), _t(k), _t(v))),
                               _f32(got), **F32_TOL)


def test_flash_attention_plain_bf16_and_top_left_mask():
    """bf16 at the kernel tolerance, and S > T: the mask is top-left
    aligned (``k_pos <= q_pos``), as in the TPU kernel."""
    rng = np.random.default_rng(6)
    B, T, S, K, G, D = 1, 40, 56, 2, 4, 32
    q = _np(rng, B, T, K * G, D, dtype=BF16)
    k = _np(rng, B, S, K, D, dtype=BF16)
    v = _np(rng, B, S, K, D, dtype=BF16)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  interpret=True)
    got = tflash.flash_attention(_t(q), _t(k), _t(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)
    # query 0 attends key 0 alone: its output is v[0]
    np.testing.assert_allclose(_f32(got)[:, 0], _f32(v)[:, 0].repeat(G, axis=1),
                               **BF16_TOL)


# ------------------------------------------------------------------ resolver

@pytest.mark.parametrize("cache_mode,device,want", [
    ("slot", "cuda", "pallas"), ("slot", "cpu", "xla"),
    ("paged", "cuda", "xla"), ("paged", "cpu", "xla"),
])
def test_attn_impl_resolves_like_jax(cache_mode, device, want):
    """``attn_impl=None``: the slot kernel on the accelerator for the slot
    cache, the plain gather otherwise (``engine.py:260-273``)."""
    assert tengine.resolve_attn_impl(None, cache_mode, torch.device(device)) == want
    assert tengine.resolve_attn_impl("clamp", cache_mode, torch.device(device)) == "clamp"
    with pytest.raises(ValueError, match="attn_impl"):
        tengine.resolve_attn_impl("flash", cache_mode, torch.device(device))
