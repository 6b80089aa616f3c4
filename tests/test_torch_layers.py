"""Parity of the torch port's layer functions with the JAX package.

The same inputs, made from a seed with numpy, go through the JAX function
and its counterpart in ``deepsearch_tts_tpu_torch``. The JAX fused kernels
run as the JAX suite runs them on the CPU (Pallas ``interpret=True``); the
port's wrappers take their plain PyTorch versions because the tensors lie on
the CPU. The CUDA kernels themselves are checked on the card by
``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.models import common as jcommon
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.ops import attention as jattn
from deepsearch_tts_tpu.ops import fused_layer as jfused
from deepsearch_tts_tpu_torch.models import common as tcommon
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.ops import attention as tattn
from deepsearch_tts_tpu_torch.ops import fused_layer as tfused

torch.set_num_threads(1)

# kernel-test widths: E=256, D=64, F=512, L=2, B=3
B, E, H, K, D, F, L = 3, 256, 4, 2, 64, 512, 2
EPS = 1e-6
# the JAX suite's own bound for the stacked fused kernels
# (tests/test_fused_layer.py:181,190)
RTOL, ATOL = 2e-2, 1e-2
BF16 = np.dtype(ml_dtypes.bfloat16)


def _np(rng, *shape, scale=1.0, dtype=np.float32):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(dtype)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    a = np.array(a)   # a writable copy (JAX hands out read-only buffers)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------- common

@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (BF16, 1e-2)])
def test_common_ops_match_jax(dtype, tol):
    rng = np.random.default_rng(0)
    x = _np(rng, 2, 5, H, D, dtype=dtype)
    w = (1 + _np(rng, D, scale=0.1)).astype(dtype)
    np.testing.assert_allclose(_f32(tcommon.rms_norm(_t(x), _t(w), EPS)),
                               _f32(jcommon.rms_norm(_j(x), _j(w), EPS)),
                               rtol=tol, atol=tol)

    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    cj, sj = jcommon.rope_angles(_j(pos), D, 1_000_000.0)
    ct, st = tcommon.rope_angles(_t(pos), D, 1_000_000.0)
    # float32 trig of angles up to 5000 rad: agree to a few float32 ulps
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-4)

    np.testing.assert_allclose(_f32(tcommon.apply_rope(_t(x), _t(np.asarray(cj)),
                                                       _t(np.asarray(sj)))),
                               _f32(jcommon.apply_rope(_j(x), cj, sj)),
                               rtol=tol, atol=tol)

    xs = _np(rng, 3, E, dtype=dtype)
    wg, wu = _np(rng, E, F, scale=E ** -0.5, dtype=dtype), _np(rng, E, F, scale=E ** -0.5, dtype=dtype)
    wd = _np(rng, F, E, scale=F ** -0.5, dtype=dtype)
    np.testing.assert_allclose(
        _f32(tcommon.swiglu(_t(xs), _t(wg), _t(wu), _t(wd))),
        _f32(jcommon.swiglu(_j(xs), _j(wg), _j(wu), _j(wd))),
        rtol=RTOL, atol=ATOL)


def test_matmul_f32_keeps_float32_accumulator():
    rng = np.random.default_rng(1)
    a, b = _np(rng, 4, E, dtype=BF16), _np(rng, E, 8, dtype=BF16)
    out = tcommon.matmul_f32(_t(a), _t(b))
    assert out.dtype == torch.float32
    ref = np.asarray(jnp.dot(_j(a), _j(b), preferred_element_type=jnp.float32))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- prefill attention

@pytest.mark.parametrize("budget", [None, 80])   # one block; blocks of 1-2 rows
def test_prefill_attention_matches_jax(monkeypatch, budget):
    """Fresh (causal) and re-prefill (cached prefix + chunk) attention
    against the JAX XLA paths, float32, whole and split into query blocks."""
    if budget is not None:
        monkeypatch.setattr(tattn, "SCORES_BUDGET", budget)
    rng = np.random.default_rng(4)
    Bq, T, S, Hq, Kq, Dq = 2, 5, 8, 4, 2, 16
    q, k, v = (_np(rng, Bq, T, n, Dq) for n in (Hq, Kq, Kq))
    k_old, v_old = _np(rng, Bq, S, Kq, Dq), _np(rng, Bq, S, Kq, Dq)
    start = np.array([6, 3], np.int32)
    pos = np.stack([np.arange(6, 11), [3, 4, 5, -1, -1]]).astype(np.int32)
    want = jattn.causal_attention(_j(q), _j(k), _j(v))
    got = tattn.causal_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = jattn.prefix_chunk_attention(_j(q), _j(k_old), _j(v_old), _j(k), _j(v),
                                        _j(start), _j(pos))
    got = tattn.prefix_chunk_attention(_t(q), _t(k_old), _t(v_old), _t(k), _t(v),
                                       _t(start).long(), _t(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- fused B3 / B4

def _layer_inputs(seed=0):
    rng = np.random.default_rng(seed)
    C = (H + 2 * K) * D
    return {
        "x": _np(rng, B, E, dtype=BF16),
        "ln1": (1 + _np(rng, L, E, scale=0.1)).astype(BF16),
        "wqkv": _np(rng, L, E, C, scale=E ** -0.5, dtype=BF16),
        "qn": (1 + _np(rng, L, D, scale=0.1)).astype(BF16),
        "kn": (1 + _np(rng, L, D, scale=0.1)).astype(BF16),
        "pos": rng.integers(0, 3000, (B,)).astype(np.int32),
        "a": _np(rng, B, H * D, dtype=BF16),
        "wo": _np(rng, L, H * D, E, scale=(H * D) ** -0.5, dtype=BF16),
        "ln2": (1 + _np(rng, L, E, scale=0.1)).astype(BF16),
        "gateup": _np(rng, L, E, 2 * F, scale=E ** -0.5, dtype=BF16),
        "wd": _np(rng, L, F, E, scale=F ** -0.5, dtype=BF16),
    }


@pytest.mark.parametrize("layer", [0, 1])
def test_fused_qkv_plain_matches_jax_kernel(layer):
    p = _layer_inputs()
    cos, sin = jcommon.rope_angles(_j(p["pos"]), D, 1_000_000.0)
    kw = dict(n_heads=H, n_kv=K, head_dim=D, eps=EPS)
    want = jfused.fused_qkv_stacked(
        _j(p["x"]), _j(p["ln1"]), _j(p["wqkv"]), _j(p["qn"]), _j(p["kn"]),
        cos, sin, jnp.int32(layer), interpret=True, **kw)
    args = (_t(p["x"]), _t(p["ln1"]), _t(p["wqkv"]), _t(p["qn"]), _t(p["kn"]),
            _t(np.asarray(cos)), _t(np.asarray(sin)), layer)
    got = tfused.fused_qkv_stacked(*args, **kw)            # CPU → plain version
    plain = tfused.fused_qkv_stacked_plain(*args, **kw)
    for g, pl_, w in zip(got, plain, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        assert torch.equal(g, pl_)
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_fused_out_mlp_plain_matches_jax_kernel(layer):
    p = _layer_inputs(seed=1)
    want = jfused.fused_out_mlp_stacked(
        _j(p["a"]), _j(p["x"]), _j(p["wo"]), _j(p["ln2"]), _j(p["gateup"]),
        _j(p["wd"]), jnp.int32(layer), eps=EPS, interpret=True)
    args = (_t(p["a"]), _t(p["x"]), _t(p["wo"]), _t(p["ln2"]), _t(p["gateup"]),
            _t(p["wd"]), layer)
    got = tfused.fused_out_mlp_stacked(*args, eps=EPS)
    assert torch.equal(got, tfused.fused_out_mlp_stacked_plain(*args, eps=EPS))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, E)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)


def test_fused_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU never reaches the plain version: off
    the CPU the wrapper launches its CUDA kernel or raises (here: a meta
    tensor, which is neither) — B3, B4, B7, both entries of the grouped
    expert kernel and B11's three one-layer forms."""
    from deepsearch_tts_tpu_torch.ops import moe as tmoe_ops

    p = _layer_inputs()
    cos, sin = tcommon.rope_angles(_t(p["pos"]), D, 1_000_000.0)
    meta = lambda a: _t(a).to("meta")
    with pytest.raises(ValueError):
        tfused.fused_qkv_stacked(meta(p["x"]), meta(p["ln1"]), meta(p["wqkv"]),
                                 meta(p["qn"]), meta(p["kn"]), cos.to("meta"),
                                 sin.to("meta"), 0, n_heads=H, n_kv=K,
                                 head_dim=D)
    with pytest.raises(ValueError):
        tfused.fused_out_mlp_stacked(meta(p["a"]), meta(p["x"]), meta(p["wo"]),
                                     meta(p["ln2"]), meta(p["gateup"]),
                                     meta(p["wd"]), 0)
    router = torch.zeros((L, E, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tfused.fused_out_router_stacked(meta(p["a"]), meta(p["x"]), meta(p["wo"]),
                                        meta(p["ln2"]), router, 0)
    NE = 4
    offsets = torch.zeros((NE + 1,), dtype=torch.int32, device="meta")
    w_gateup = torch.zeros((NE, E, 2 * F), dtype=torch.bfloat16, device="meta")
    w_down = torch.zeros((NE, F, E), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tmoe_ops.grouped_gateup(meta(p["x"]), w_gateup, None, offsets)
    with pytest.raises(ValueError):
        tmoe_ops.grouped_down(torch.zeros((B, F), dtype=torch.bfloat16, device="meta"),
                              w_down, offsets)
    # B11's one-layer forms: fused_mlp, fused_qkv, fused_out_mlp packed and not
    one = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16, device="meta")  # noqa: E731
    wg, wu, wd = one(E, F), one(E, F), one(F, E)
    with pytest.raises(ValueError):
        tfused.fused_mlp(meta(p["x"]), one(E), wg, wu, wd)
    with pytest.raises(ValueError):
        tfused.fused_qkv(meta(p["x"]), one(E), one(E, (H + 2 * K) * D), one(D), one(D),
                         cos.to("meta"), sin.to("meta"), n_heads=H, n_kv=K, head_dim=D)
    gu = one(E, 2 * F)
    for args, packed in (((wg, wu), False), ((gu, gu), True)):
        with pytest.raises(ValueError):
            tfused.fused_out_mlp(meta(p["a"]), meta(p["x"]), one(H * D, E), one(E), *args,
                                 wd, packed_gateup=packed)
    assert tfused.fused_qkv_stacked.launches == 0
    assert tfused.fused_out_mlp_stacked.launches == 0
    assert tfused.fused_out_router_stacked.launches == 0
    assert tmoe_ops.grouped_gateup.launches == tmoe_ops.grouped_down.launches == 0
    assert tmoe_ops.grouped_gateup.prefill_launches == tmoe_ops.grouped_down.prefill_launches == 0
    assert tfused.fused_mlp.launches == tfused.fused_qkv.launches == 0
    assert tfused.fused_out_mlp.launches == 0


def test_fused_split_choice_covers_k_exactly():
    """The K split the CUDA wrapper picks always cuts K into whole pipeline
    stages, keeps the partial sums within a quarter of the weight bytes, and
    fills the grid at decode batch unless one of those limits stops it."""
    for b in (1, 8, 16, 64):
        for n, k in ((6144, 4096), (4096, 4096), (24576, 4096), (4096, 12288)):
            s = tfused._splits(b, n, k)
            assert k % (s * tfused._KT) == 0
            assert 8 * b * n * s <= 2 * k * n / 4 or s == 1
            blocks = (n // tfused._TILE) * s
            assert (blocks >= tfused._TARGET_BLOCKS or 2 * s > k // (16 * b)
                    or k % (2 * s * tfused._KT))
    assert tfused.shapes_ok(4096, 4096, 12288, 128)
    assert not tfused.shapes_ok(128, 128, 256, 32)     # qwen3-test: plain only


@pytest.mark.parametrize("B", [1, 16, 64, 80])
@pytest.mark.parametrize("model", ["qwen3-8b", "qwen3-30b-a3b", "qwen3-test"])
def test_fused_split_choice_at_qkv_widths(model, B):
    """The same limits at B3's product, x [B, E] @ wqkv [E, (H + 2 KV) D],
    of each model, beyond 64 rows too (two 64-row groups of blocks)."""
    from deepsearch_tts_tpu_torch.models.qwen3_moe import QWEN3_MOE_CONFIGS

    cfg = {**tqwen3.QWEN3_CONFIGS, **QWEN3_MOE_CONFIGS}[model]
    k, n = cfg.hidden, (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    s = tfused._splits(B, n, k)
    assert k % (s * tfused._KT) == 0                 # whole pipeline stages a slice
    assert 8 * B * n * s <= 2 * k * n / 4 or s == 1
    blocks = (n // tfused._TILE) * -(-B // tfused._MAX_ROWS) * s
    assert (blocks >= tfused._TARGET_BLOCKS or 2 * s > k // (16 * B)
            or k % (2 * s * tfused._KT))


# ------------------------------------------------------------------- config

def test_qwen3_configs_equal_jax_fields():
    assert set(tqwen3.QWEN3_CONFIGS) == set(jqwen3.QWEN3_CONFIGS)
    for name, jcfg in jqwen3.QWEN3_CONFIGS.items():
        assert dataclasses.asdict(tqwen3.QWEN3_CONFIGS[name]) == dataclasses.asdict(jcfg), name
    assert ([f.name for f in dataclasses.fields(tqwen3.Qwen3Config)]
            == [f.name for f in dataclasses.fields(jqwen3.Qwen3Config)])
