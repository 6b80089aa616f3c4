"""The int8 slice of the port against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its counterpart in ``deepsearch_tts_tpu_torch``: B12's round to nearest
and ``quantize_params`` bit for bit (JAX's ``interpret=True`` path, the one
its ``quantize_params`` runs), the int8 products within rtol 2e-2, B10's
plain versions against JAX's int8 fused kernels in Pallas interpret mode
(rtol 2e-2 / atol 1e-2, the JAX suite's bound for the stacked fused
kernels, ``tests/test_fused_layer.py:181,190``), int8 KV rows and scales
exactly, the int8 branch of ``paged_attention`` within the bf16 bounds, and
the engines' greedy streams exactly, on float32 configs registered in both
registries (tie-free logits, ROADMAP C "Greedy ties"). The CUDA and Triton
kernels are held to the plain versions on the card by ``chip_smoke.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.models.common import rope_angles as jrope
from deepsearch_tts_tpu.ops import attention as jattn
from deepsearch_tts_tpu.ops import fused_layer as jfused
from deepsearch_tts_tpu.ops import quant as jquant
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.engine import weights as tweights
from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.models import registry as tregistry
from deepsearch_tts_tpu_torch.ops import attention as tattn
from deepsearch_tts_tpu_torch.ops import fused_layer as tfused
from deepsearch_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

BF16 = np.dtype(ml_dtypes.bfloat16)
RTOL, ATOL = 2e-2, 1e-2          # tests/test_fused_layer.py:181,190
ATTN_TOL = dict(rtol=5e-2, atol=2e-2)   # tests/test_kernels.py:131,166
EPS = 1e-6
# B10 parity widths: E=128, D=128 (the kernels' head width), F=256
E, D, F, H, K, L = 128, 128, 256, 2, 1, 2


def _np(rng, *shape, scale=1.0, dtype=np.float32):
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


def _tree_t(tree):
    return jax.tree.map(lambda a: _t(np.asarray(a)), tree)


# ------------------------------------------------------------------- B12

@pytest.mark.parametrize("dtype", [np.float32, BF16])
@pytest.mark.parametrize("shape,scale", [((64, 96), 1.0), ((256, 40), 0.02), ((7, 130), 30.0)])
def test_quantize_int8_round_to_nearest_matches_jax(dtype, shape, scale):
    rng = np.random.default_rng(sum(shape))
    w = _np(rng, *shape, scale=scale, dtype=dtype)
    w[:, 3] = 0.0        # an all-zero column: the 1e-8 scale floor
    jq, js = jquant.quantize_int8(jnp.asarray(w), interpret=True)
    q, s = tquant.quantize_int8(_t(w))          # CPU → plain version
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (1, shape[1])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # into preallocated views, as the weight loaders call it
    out = (torch.empty(shape, dtype=torch.int8), torch.empty((1, shape[1])))
    assert tquant.quantize_int8(_t(w), out=out) is out
    assert torch.equal(out[0], q) and torch.equal(out[1], s)


def test_quantize_int8_stochastic_plain_properties():
    rng = np.random.default_rng(5)
    w = _t(_np(rng, 96, 64, scale=0.1, dtype=BF16))
    q_rn, s_rn = tquant.quantize_int8(w)
    q1, s1 = tquant.quantize_int8_plain(w, seed=1, stochastic=True)
    assert torch.equal(s1, s_rn)
    y = w.float() / s1
    d = q1.float() - torch.floor(y).clamp(-127, 127)
    assert bool(((d == 0) | (d == 1)).all())
    # unbiased: 6144 draws, std of the mean < 0.5 / sqrt(6144) = 6.4e-3
    assert abs(float((q1.float() - y).mean())) < 0.03
    assert torch.equal(tquant.quantize_int8_plain(w, seed=1, stochastic=True)[0], q1)
    assert not torch.equal(tquant.quantize_int8_plain(w, seed=2, stochastic=True)[0], q1)
    assert not torch.equal(q1, q_rn)


# B12's plan and the kernel's arithmetic (csrc/quant.cu), modelled on the CPU

# every shape a qwen3-32b and a qwen3-8b int8 build quantizes, and the odd
# widths of this file's other tests
PLAN_SHAPES = [(5120, 10240), (8192, 5120), (5120, 51200), (25600, 5120), (5120, 151936),
               (4096, 6144), (4096, 4096), (4096, 24576), (12288, 4096), (4096, 151936),
               (64, 96), (256, 40), (7, 130), (16, 48), (24, 16), (16, 64), (32, 16),
               (16, 32), (96, 64)]


# deeper columns, each at another number of blocks an SM: three up to
# ~18,000 rows, two up to ~28,000, one up to 57,344 (clusters of 16)
DEEP_SHAPES = [(16000, 96), (18000, 64), (18432, 130), (20000, 64), (28000, 32),
               (30000, 40), (40000, 64), (57344, 32)]


def _blocks_an_sm(plan) -> int:
    """The most blocks (at most ``QUANT_PER_SM``) an SM's shared memory
    holds at this plan's bytes a block."""
    for n in range(tquant.QUANT_PER_SM, 0, -1):
        budget = (tquant.SMEM_BLOCK if n == 1 else tquant.SMEM_SM // n - tquant.SMEM_RESERVED)
        if plan.smem + tquant.QUANT_STATIC <= budget:
            return n
    return 0


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES + DEEP_SHAPES)
def test_quant_plan_covers_every_element_once(shape, esize):
    K, N = shape
    plan = tquant.quant_plan(K, N, esize)
    assert plan.bn * esize == tquant.QUANT_ROW_BYTES == 64       # rows of 64 bytes
    assert plan.cs in tquant.QUANT_CLUSTERS
    assert 1 <= plan.bh <= tquant.QUANT_BOX_ROWS and plan.rows % plan.bh == 0
    assert plan.rows // plan.bh <= tquant.QUANT_MAX_BOXES
    assert plan.bh * plan.bn * esize % tquant.QUANT_BOX_ALIGN == 0
    assert plan.smem == plan.rows * plan.bn * esize
    assert plan.smem + tquant.QUANT_STATIC <= tquant.SMEM_BLOCK      # 232,448
    assert _blocks_an_sm(plan) >= 1
    # the blocks (strip, cluster rank) cover every element of [K, N] once,
    # and no block of a cluster is empty: a block is the product of a row
    # range and a column strip, so the rows of the ranks and the columns of
    # the strips must each be covered once
    rows = np.zeros(K, dtype=np.int8)
    for rank in range(plan.cs):
        r0, r1 = rank * plan.rows, min(K, (rank + 1) * plan.rows)
        assert r1 > r0
        rows[r0:r1] += 1
    cols = np.zeros(N, dtype=np.int8)
    for strip in range(plan.strips(N)):
        cols[strip * plan.bn:(strip + 1) * plan.bn] += 1
    assert (rows == 1).all() and (cols == 1).all()


@pytest.mark.parametrize("K,blocks", [(7, 3), (5120, 3), (18000, 3), (18432, 2), (28000, 2),
                                      (30000, 1), (57344, 1)])
def test_quant_plan_takes_fewer_blocks_an_sm_only_where_a_strip_needs_it(K, blocks):
    """Three blocks an SM wherever a cluster of 16 holds the strip at a
    third of an SM's shared memory; two, then one, only past that (and then
    in clusters of 16); beyond 57,344 rows no plan (it raises)."""
    plan = tquant.quant_plan(K, 64)
    assert _blocks_an_sm(plan) == blocks
    if blocks < tquant.QUANT_PER_SM:
        assert plan.cs == tquant.QUANT_CLUSTERS[-1]
    with pytest.raises(ValueError):
        tquant.quant_plan(57345, 64)


def test_quant_plan_fits_two_blocks_an_sm():
    """At the default plan every qwen3-32b and qwen3-8b shape fits at least
    two blocks an SM (w_down's 25,600 rows in a cluster of 16 blocks of
    64-byte rows), and those of 5,120 rows or fewer three."""
    for K, N in PLAN_SHAPES[:10]:
        plan = tquant.quant_plan(K, N)
        per_sm = 3 if K <= 8192 else 2
        budget = tquant.SMEM_SM // per_sm - tquant.SMEM_RESERVED - tquant.QUANT_STATIC
        assert plan.smem <= budget, (K, N, plan)


def _cluster_scales(w: torch.Tensor, plan) -> torch.Tensor:
    """The kernel's scales, in plain torch: each cluster block's column
    amax over its rows (zeros past K, as TMA reads them), merged across the
    cluster with max, then max(amax / 127, 1e-8)."""
    K, N = w.shape
    xa = w.float().abs()
    pad = torch.zeros((plan.cs * plan.rows, plan.strips(N) * plan.bn))
    pad[:K, :N] = xa
    parts = pad.view(plan.cs, plan.rows, -1).amax(dim=1)      # [cs, columns]
    amax = parts.amax(dim=0)[:N][None]
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)


@pytest.mark.parametrize("shape,scale", [((5120, 64), 0.02), ((25600, 16), 1.0), ((7, 130), 30.0),
                                         ((300, 96), 0.1)])
def test_cluster_amax_merge_matches_plain_and_jax(shape, scale):
    rng = np.random.default_rng(shape[0])
    w = _np(rng, *shape, scale=scale, dtype=BF16)
    w[:, 3] = 0.0
    t = _t(w)
    K = shape[0]
    plans = [tquant.quant_plan(*shape)]
    for cs in tquant.QUANT_CLUSTERS:   # every cluster size whose blocks all hold rows
        rows = -(-K // cs)
        if (cs - 1) * rows < K:
            plans.append(tquant.QuantPlan(32, cs, rows, rows, rows * 64))
    want = np.asarray(jquant.quantize_int8(jnp.asarray(w), interpret=True)[1])
    for plan in plans:
        s = _cluster_scales(t, plan)
        assert torch.equal(s, tquant.quantize_int8_plain(t)[1]), plan
        np.testing.assert_array_equal(s.numpy(), want)


def _round_quotient(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """csrc/quant.cu round_quotient in float32 torch: rint(x * RN(1/s)),
    unless that product lies within 2^-15 of a half-integer, where the IEEE
    quotient decides."""
    r = 1.0 / s
    y = x * r
    n = torch.round(y)
    near = (y - n).abs() >= 0.5 - 2.0 ** -15
    return torch.where(near, torch.round(x / s), n)


def test_divide_free_rounding_equals_the_quotients():
    """B12's round to nearest without a division a value: equal to
    round(x / s) on random weights and on exact and near ties."""
    rng = np.random.default_rng(11)
    w = _t(_np(rng, 512, 256, scale=0.05, dtype=BF16)).float()
    s = tquant.quantize_int8_plain(w)[1]
    assert torch.equal(_round_quotient(w, s), torch.round(w / s))
    # exact ties k + 1/2 and their neighbours one float32 ulp either side
    s2 = torch.tensor([2.0 ** -7, 3.0 * 2.0 ** -9, 0.0123, 1e-8])[:, None]
    k = torch.arange(-127, 127, dtype=torch.float32)[None] + 0.5
    x = (k * s2).float()
    for xx in (x, torch.nextafter(x, x + 1), torch.nextafter(x, x - 1)):
        assert torch.equal(_round_quotient(xx, s2), torch.round(xx / s2))


def test_philox_model_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    def t(*v):
        return [torch.tensor([c], dtype=torch.int64) for c in v]
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((0xffffffff,) * 4, (0xffffffff,) * 2,
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))):
        got = tquant.philox4x32_10(*t(*ctr), *key)
        assert [int(g[0]) for g in got] == list(want)


def test_philox_stream_is_deterministic_per_seed_and_unbiased():
    K, N = 300, 257
    u1 = tquant.stochastic_uniform(K, N, 1, slice(None), "cpu")
    assert u1.shape == (K, N) and float(u1.min()) >= 0.0 and float(u1.max()) < 1.0
    assert torch.equal(u1, tquant.stochastic_uniform(K, N, 1, slice(None), "cpu"))
    assert torch.equal(u1[100:200], tquant.stochastic_uniform(K, N, 1, slice(100, 200), "cpu"))
    u2 = tquant.stochastic_uniform(K, N, 2, slice(None), "cpu")
    assert float((u1 != u2).float().mean()) > 0.99
    # a uniform's mean, 77,100 draws: std of the mean 0.29 / 278 = 1.0e-3
    assert abs(float(u1.mean()) - 0.5) < 5e-3
    # seeds past 32 bits reach the second key word
    assert not torch.equal(u1, tquant.stochastic_uniform(K, N, 1 + (1 << 32), slice(None), "cpu"))
    # the plain stochastic mode draws this stream: floor(x/s + u), unbiased
    rng = np.random.default_rng(3)
    w = _t(_np(rng, K, N, scale=0.1, dtype=BF16))
    q, s = tquant.quantize_int8_plain(w, seed=1, stochastic=True)
    y = w.float() / s
    assert torch.equal(q, torch.floor(y + u1).clamp(-127, 127).to(torch.int8))
    assert abs(float((q.float() - y).mean())) < 5e-3


def test_quantize_int8_never_falls_back_off_cpu():
    w = torch.zeros((64, 96), dtype=torch.bfloat16, device="meta")
    tquant.quantize_int8.launches = 0
    with pytest.raises(ValueError):
        tquant.quantize_int8(w)
    assert tquant.quantize_int8.launches == 0


def _tree(rng, dtype=BF16):
    return {
        "embed": _np(rng, 32, 16, dtype=dtype),
        "final_norm": np.ones((16,), dtype),
        "lm_head": _np(rng, 16, 32, scale=0.25, dtype=dtype),
        "layers": {
            "ln1": np.ones((L, 16), dtype),
            "wqkv": _np(rng, L, 16, 48, scale=0.25, dtype=dtype),
            "wo": _np(rng, L, 24, 16, scale=0.2, dtype=dtype),
            "w_gateup": _np(rng, L, 16, 64, scale=0.25, dtype=dtype),
            "w_down": _np(rng, L, 32, 16, scale=0.2, dtype=dtype),
            "router": _np(rng, L, 16, 4, dtype=dtype),
        },
    }


def test_quantize_params_matches_jax_bit_for_bit():
    tree = _tree(np.random.default_rng(0))
    want = jquant.quantize_params(jax.tree.map(jnp.asarray, tree))
    got = tquant.quantize_params(_tree_t(tree))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.dtype == _t(np.asarray(w)).dtype, path
        np.testing.assert_array_equal(_f32(g), np.asarray(w, np.float32), err_msg=str(path))
    assert got["layers"]["wqkv"]["scales"].shape == (L, 1, 48)
    assert got["lm_head"]["scales"].shape == (1, 32)
    # norms, embeddings and the router pass through; so do int8 leaves
    assert isinstance(got["layers"]["router"], torch.Tensor)
    again = tquant.quantize_params(got)
    assert again["layers"]["wqkv"]["q"] is got["layers"]["wqkv"]["q"]


# ------------------------------------------------------- int8 products

@pytest.mark.parametrize("dtype", [np.float32, BF16])
@pytest.mark.parametrize("lead", [(3,), (2, 5), (70,)])
def test_int8_matmul_and_maybe_int8_dot_match_jax(dtype, lead):
    rng = np.random.default_rng(len(lead))
    x = _np(rng, *lead, 64, dtype=dtype)
    w = _np(rng, 64, 48, scale=0.125)
    jq, js = jquant.quantize_int8(jnp.asarray(w), interpret=True)
    want = jquant.int8_matmul(jnp.asarray(x), jq, js)
    got = tquant.int8_matmul(_t(x), _t(np.asarray(jq)), _t(np.asarray(js)))
    assert got.dtype == _t(x).dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=RTOL)
    leaf = {"q": _t(np.asarray(jq)), "scales": _t(np.asarray(js))}
    assert torch.equal(tquant.maybe_int8_dot(_t(x), leaf), got)
    # a plain weight takes the bf16 product
    wb = w.astype(BF16)
    np.testing.assert_allclose(
        _f32(tquant.maybe_int8_dot(_t(x), _t(wb))),
        _f32(jquant.maybe_int8_dot(jnp.asarray(x), jnp.asarray(wb))), rtol=RTOL, atol=RTOL)


def test_int8_product_wrapper_is_its_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    x = _t(_np(rng, 5, 64, dtype=BF16))
    q = torch.randint(-127, 128, (64, 128), dtype=torch.int8)
    s = torch.rand((1, 128)) / 100
    got = tfused.int8_product(x, q, s)
    assert torch.equal(got, tfused.int8_product_plain(x, q, s))
    assert tfused.int8_product.launches == 0
    with pytest.raises(ValueError):      # off the CPU: the kernel or a raise
        tfused.int8_product(x.to("meta"), q.to("meta"), s.to("meta"))
    # the int8 product's split-K partials (the scratch the wrapper allocates,
    # float32, written and read once) stay within a quarter of the int8
    # weight bytes, at qwen3-32b's narrowest product (wo) on 132 SMs
    part, tickets = tfused.i8_scratch(torch.device("cpu"), 16, 132)
    assert part.dtype == torch.float32 and tickets.dtype == torch.int32
    assert part.numel() * 8 <= 8192 * 5120 // 4


# -------------------------------------------------------------------- B10

def _i8_layer_inputs(seed):
    rng = np.random.default_rng(seed)
    C = (H + 2 * K) * D
    mats = {"wqkv": _np(rng, L, E, C, scale=E ** -0.5, dtype=BF16),
            "wo": _np(rng, L, H * D, E, scale=(H * D) ** -0.5, dtype=BF16),
            "w_gateup": _np(rng, L, E, 2 * F, scale=E ** -0.5, dtype=BF16),
            "w_down": _np(rng, L, F, E, scale=F ** -0.5, dtype=BF16)}
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, mats))
    return {
        "j": jq, "t": _tree_t(jq),
        "ln1": (1 + _np(rng, L, E, scale=0.1)).astype(BF16),
        "ln2": (1 + _np(rng, L, E, scale=0.1)).astype(BF16),
        "qn": (1 + _np(rng, L, D, scale=0.1)).astype(BF16),
        "kn": (1 + _np(rng, L, D, scale=0.1)).astype(BF16),
        "pos": rng.integers(0, 3000, (4,)).astype(np.int32),
        "x": _np(rng, 4, E, dtype=BF16),
        "a": _np(rng, 4, H * D, dtype=BF16),
    }


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("layer", [0, 1])
def test_fused_qkv_i8_plain_matches_jax_kernel(B, layer):
    p = _i8_layer_inputs(0)
    cos, sin = jrope(jnp.asarray(p["pos"][:B]), D, 1_000_000.0)
    kw = dict(n_heads=H, n_kv=K, head_dim=D, eps=EPS)
    jw, tw = p["j"]["wqkv"], p["t"]["wqkv"]
    want = jfused.fused_qkv_stacked_i8(
        jnp.asarray(p["x"][:B]), jnp.asarray(p["ln1"]), jw["q"], jw["scales"],
        jnp.asarray(p["qn"]), jnp.asarray(p["kn"]), cos, sin, jnp.int32(layer),
        interpret=True, **kw)
    args = (_t(p["x"][:B]), _t(p["ln1"]), tw["q"], tw["scales"], _t(p["qn"]),
            _t(p["kn"]), _t(np.asarray(cos)), _t(np.asarray(sin)), layer)
    got = tfused.fused_qkv_stacked_i8(*args, **kw)          # CPU → plain version
    plain = tfused.fused_qkv_stacked_i8_plain(*args, **kw)
    for g, pl_, w in zip(got, plain, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        assert torch.equal(g, pl_)
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("layer", [0, 1])
def test_fused_out_mlp_i8_plain_matches_jax_kernel(B, layer):
    p = _i8_layer_inputs(1)
    j, t = p["j"], p["t"]
    want = jfused.fused_out_mlp_stacked_i8(
        jnp.asarray(p["a"][:B]), jnp.asarray(p["x"][:B]), j["wo"]["q"], j["wo"]["scales"],
        jnp.asarray(p["ln2"]), j["w_gateup"]["q"], j["w_gateup"]["scales"],
        j["w_down"]["q"], j["w_down"]["scales"], jnp.int32(layer), eps=EPS, interpret=True)
    args = (_t(p["a"][:B]), _t(p["x"][:B]), t["wo"]["q"], t["wo"]["scales"], _t(p["ln2"]),
            t["w_gateup"]["q"], t["w_gateup"]["scales"], t["w_down"]["q"],
            t["w_down"]["scales"], layer)
    got = tfused.fused_out_mlp_stacked_i8(*args, eps=EPS)
    assert torch.equal(got, tfused.fused_out_mlp_stacked_i8_plain(*args, eps=EPS))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, E)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)


def test_fused_i8_wrappers_never_fall_back_off_cpu():
    p = _i8_layer_inputs(2)
    t = p["t"]
    meta = lambda a: (_t(a) if isinstance(a, np.ndarray) else a).to("meta")  # noqa: E731
    cos = torch.zeros((4, D // 2), device="meta")
    with pytest.raises(ValueError):
        tfused.fused_qkv_stacked_i8(meta(p["x"]), meta(p["ln1"]), meta(t["wqkv"]["q"]),
                                    meta(t["wqkv"]["scales"]), meta(p["qn"]),
                                    meta(p["kn"]), cos, cos, 0, n_heads=H, n_kv=K,
                                    head_dim=D)
    with pytest.raises(ValueError):
        tfused.fused_out_mlp_stacked_i8(
            meta(p["a"]), meta(p["x"]), meta(t["wo"]["q"]), meta(t["wo"]["scales"]),
            meta(p["ln2"]), meta(t["w_gateup"]["q"]), meta(t["w_gateup"]["scales"]),
            meta(t["w_down"]["q"]), meta(t["w_down"]["scales"]), 0)
    assert tfused.fused_qkv_stacked_i8.launches == tfused.fused_out_mlp_stacked_i8.launches == 0


# ----------------------------------------------------------------- int8 KV

@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_quantize_kv_rows_matches_jax_unpacked(dtype):
    rng = np.random.default_rng(7)
    rows = (_np(rng, 2, 5, 3, 32) * rng.uniform(0.01, 4, (2, 5, 3, 1))).astype(dtype)
    rows[0, 1, 2] = 0.0
    packed, js = jkv.quantize_kv_rows(jnp.asarray(rows))
    q, s = tkv.quantize_kv_rows(_t(rows))
    assert q.dtype == torch.int8 and tuple(q.shape) == rows.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jkv.unpack_int8_rows(packed)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_write_scales_flat_matches_jax():
    """Pools equal JAX's exactly; padding (position < 0) lands in the spare
    row past the view, where JAX drops it."""
    rng = np.random.default_rng(8)
    Lp, N, ps, Kh = 2, 6, 4, 3
    table_l = np.array([[1, 2, 3], [4, 5, 0]], np.int64) + N      # layer 1
    positions = np.array([[3, 4, 5, 6, 7], [0, 1, 2, -1, -1]], np.int64)
    pool = np.abs(_np(rng, Lp * N, ps, Kh))
    new = np.abs(_np(rng, 2, 5, Kh))
    want = jkv.write_scales_flat(jnp.asarray(pool), jnp.asarray(new),
                                 jnp.asarray(positions, jnp.int32),
                                 jnp.asarray(table_l, jnp.int32))
    ks, _ = tkv.init_kv_scales(Lp, N, ps, Kh)
    flat = ks.view(Lp * N, ps, Kh)
    flat.copy_(_t(pool))
    out = tkv.write_scales_flat(flat, _t(new), _t(positions), _t(table_l))
    assert out is flat
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    spare = tkv._rows_with_spare(flat, row_dims=1)[-1]
    np.testing.assert_array_equal(spare.numpy(), new[1, 4])   # the last padding row


@pytest.mark.parametrize("dtype,tol", [(np.float32, dict(rtol=0, atol=1e-5)), (BF16, ATTN_TOL)])
@pytest.mark.parametrize("T", [1, 3])
def test_paged_attention_int8_matches_jax(dtype, tol, T):
    rng = np.random.default_rng(9 + T)
    NP, ps, Kh, G, Dh, B, P = 12, 4, 2, 2, 32, 2, 3
    kq = rng.integers(-127, 128, (NP, ps, Kh, Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (NP, ps, Kh, Dh)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (NP, ps, Kh)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (NP, ps, Kh)).astype(np.float32)
    q = _np(rng, B, T, Kh * G, Dh, scale=0.5, dtype=dtype)
    table = np.array([[3, 7, 1], [5, 2, 0]], np.int32)
    seq = np.array([11, 6], np.int32)
    qpos = (seq[:, None] - T + np.arange(T)[None]).astype(np.int32)
    # JAX stores int8 KV int32-packed: hand it the same bytes
    kp = jnp.asarray(kq.view(np.int32).reshape(NP, ps, Kh, Dh // 4))
    vp = jnp.asarray(vq.view(np.int32).reshape(NP, ps, Kh, Dh // 4))
    want = jattn.paged_attention(jnp.asarray(q), kp, vp, jnp.asarray(table), jnp.asarray(seq),
                                 jnp.asarray(qpos), k_scales=jnp.asarray(ks),
                                 v_scales=jnp.asarray(vs))
    got = tattn.paged_attention(_t(q), _t(kq), _t(vq), _t(table).long(), _t(seq).long(),
                                _t(qpos).long(), k_scales=_t(ks), v_scales=_t(vs))
    assert got.dtype == _t(q).dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    if T == 1:     # the kernel switch hands the scales to K1's int8 mode (its plain version)
        got = tattn.paged_attention(_t(q), _t(kq), _t(vq), _t(table).long(), _t(seq).long(),
                                    _t(qpos).long(), impl="pallas", k_scales=_t(ks),
                                    v_scales=_t(vs))
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)


# ---------------------------------------------------------------- weights

def _dense_cfg(**kw):
    base = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=2, n_kv_heads=2,
                head_dim=64, intermediate=256, tie_embeddings=False)
    base.update(kw)
    return tqwen3.Qwen3Config(**base)


def test_random_params_int8_equals_quantized_random_params():
    cfg = _dense_cfg()
    want = tquant.quantize_params(tweights.random_params(cfg, seed=3))
    got = tweights.random_params(cfg, seed=3, quantize="int8")
    for key in ("wqkv", "wo", "w_gateup", "w_down"):
        for part in ("q", "scales"):
            assert torch.equal(got["layers"][key][part], want["layers"][key][part]), key
    assert torch.equal(got["lm_head"]["q"], want["lm_head"]["q"])
    assert torch.equal(got["embed"], want["embed"]) and got["embed"].dtype == torch.bfloat16
    assert tquant.quantize_params(got)["layers"]["wo"]["q"] is got["layers"]["wo"]["q"]


def test_converter_int8_equals_quantized_packed_tree():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "golden", "qwen3-test")
    cfg = tregistry.get_model("qwen3-test").config
    raw = tweights._load_safetensors_dir(path)
    plain = tweights.convert_qwen3_dense(raw, cfg)
    # one converter: bf16 comes out in the packed layout the int8 one writes
    assert {"wqkv", "w_gateup"} <= set(plain["layers"])
    assert not {"wq", "wk", "wv", "w_gate", "w_up"} & set(plain["layers"])
    assert tweights.pack_matmul_params(plain)["layers"]["wqkv"] is plain["layers"]["wqkv"]
    want = tquant.quantize_params(plain)
    got = tweights.convert_qwen3_dense(raw, cfg, quantize="int8")
    assert sorted(got["layers"]) == sorted(want["layers"])
    for key, w in want["layers"].items():
        g = got["layers"][key]
        if isinstance(w, dict):
            assert torch.equal(g["q"], w["q"]) and torch.equal(g["scales"], w["scales"]), key
        else:
            assert torch.equal(g, w), key
    assert "lm_head" not in got       # qwen3-test ties its embeddings


def test_pack_and_params_from_jax_carry_int8_leaves():
    """Packing unpacked int8 leaves equals quantizing the packed matrix (one
    scale per column), and a quantized JAX tree converts leaf by leaf."""
    rng = np.random.default_rng(11)
    unpacked = {k: _np(rng, L, 16, n, scale=0.3, dtype=BF16)
                for k, n in (("wq", 32), ("wk", 16), ("wv", 16), ("w_gate", 24), ("w_up", 24))}
    jq = jquant.quantize_params({"layers": jax.tree.map(jnp.asarray, unpacked)})
    tree = tweights.params_from_jax(jax.tree.map(np.asarray, jq))
    assert tree["layers"]["wq"]["q"].dtype == torch.int8
    packed = tweights.pack_matmul_params(tree)["layers"]
    want = tquant.quantize_params(tweights.pack_matmul_params(
        {"layers": {k: _t(v) for k, v in unpacked.items()}}))["layers"]
    for key in ("wqkv", "w_gateup"):
        assert torch.equal(packed[key]["q"], want[key]["q"])
        assert torch.equal(packed[key]["scales"], want[key]["scales"])


def test_int8_lm_head_logits_are_bf16_rounded():
    """An int8 lm_head rounds its product to x's dtype before widening
    (``qwen3.py:530-533``): bf16 values on a bf16 model; a bf16 head gives
    float32 logits that are not."""
    cfg = _dense_cfg(n_layers=1)
    params = tweights.random_params(cfg, seed=1)
    tokens = torch.tensor([[5, 9, 200, 17]])
    pos = torch.arange(4)[None]
    bf16_logits, _ = tqwen3.forward(params, cfg, tokens, pos)
    qparams = dict(params, lm_head=tquant.quantize_params({"lm_head": params["lm_head"]})["lm_head"])
    i8_logits, _ = tqwen3.forward(qparams, cfg, tokens, pos)
    assert i8_logits.dtype == bf16_logits.dtype == torch.float32
    assert torch.equal(i8_logits, i8_logits.to(torch.bfloat16).float())
    assert not torch.equal(bf16_logits, bf16_logits.to(torch.bfloat16).float())
    torch.testing.assert_close(i8_logits, bf16_logits, rtol=5e-2, atol=5e-2)


# ----------------------------------------------------------------- engines

def _greedy(ids, n):
    return dict(prompt_ids=list(ids), max_tokens=n, temperature=0.0, top_k=0,
                top_p=1.0, min_p=0.0, repetition_penalty=1.0)


def _engine_pair(name, jcfg, tcfg, jkw, tkw):
    """A JAX and a torch engine on the same params (registered in both)."""
    jregistry.register(name, jcfg, jqwen3.init_params, jqwen3.forward,
                       lambda: jqwen3.logical_axes(jcfg))
    tregistry.register(name, tcfg, tqwen3.forward)
    jp = jqwen3.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tweights.params_from_jax(jax.tree.map(np.asarray, jp))
    kw = dict(max_slots=4, page_size=4, n_pages=128, max_seq_len=128,
              decode_chunk_len=4, seed=0)
    tok = ByteTokenizer()
    je = jengine.Engine(name, tok, params=jp, **kw, **jkw)
    te = tengine.Engine(name, tok, params=tp, device="cpu", **kw, **tkw)
    return je, te


def _both(engines, reqs):
    out = []
    for mod, eng in zip((jengine, tengine), engines):
        futs = eng.submit_many([mod.GenerationRequest(**r) for r in reqs])
        out.append([f.result(timeout=300) for f in futs])
    return out


def _f32_cfgs(name):
    j = dataclasses.replace(jqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    t = dataclasses.replace(tqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    return j, t


def test_int8_engine_greedy_streams_match_jax():
    """quantize='int8' on qwen3-test, unfused in both engines (every product
    through int8_matmul), concurrent requests and a prefix-cache hit."""
    je, te = _engine_pair("qwen3-i8-parity", *_f32_cfgs("qwen3-test"),
                          dict(quantize="int8", layer_fusion=False),
                          dict(quantize="int8", layer_fusion=False))
    try:
        assert te.params["layers"]["wqkv"]["q"].dtype == torch.int8
        rng = np.random.default_rng(0)
        reqs = [_greedy(rng.integers(0, 256, n), 12) for n in (9, 21)]
        jres, tres = _both((je, te), reqs)
        for j, t in zip(jres, tres):
            assert len(t.token_ids) >= 8 and t.token_ids == j.token_ids
        follow = reqs[1]["prompt_ids"] + tres[1].token_ids + [3, 4, 5]
        jres, tres = _both((je, te), [_greedy(follow, 8)])
        assert tres[0].cached_prompt_tokens == jres[0].cached_prompt_tokens > 0
        assert tres[0].token_ids == jres[0].token_ids
    finally:
        je.shutdown()
        te.shutdown()


def test_int8_fused_engine_greedy_streams_match_jax():
    """layer_fusion=True with int8 weights: B10's plain versions against
    JAX's int8 kernels in interpret mode, on the 128-wide config of
    ``tests/test_ring_quant.py:203-205`` (head_dim 128)."""
    kw = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=2, n_kv_heads=2,
              head_dim=128, intermediate=256, tie_embeddings=True, dtype="float32")
    je, te = _engine_pair("qwen3-i8fuse-parity", jqwen3.Qwen3Config(**kw),
                          tqwen3.Qwen3Config(**kw), dict(quantize="int8", layer_fusion=True),
                          dict(quantize="int8", layer_fusion=True))
    try:
        assert te.layer_fusion and je.layer_fusion
        rng = np.random.default_rng(1)
        reqs = [_greedy(rng.integers(0, 256, n), 10) for n in (6, 13)]
        jres, tres = _both((je, te), reqs)
        for j, t in zip(jres, tres):
            assert len(t.token_ids) >= 8 and t.token_ids == j.token_ids
    finally:
        je.shutdown()
        te.shutdown()


I8KV_KW = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=4, n_kv_heads=2,
               head_dim=128, intermediate=256, tie_embeddings=True, dtype="float32")


def _by_hand(eng, first, later, n_first=16, n_later=6):
    """``first`` decodes alone for one chunk, then the ``later`` prompts
    arrive (a lane engine takes them whole on its decode steps): the
    engine's scheduler driven by hand. Returns the results in order."""
    from concurrent.futures import Future

    def queue(prompts, n):
        futs = []
        for p in prompts:
            fut = Future()
            eng._queue.put((tengine.GenerationRequest(**_greedy(p, n)), fut))
            futs.append(fut)
        return futs

    futs, chunks = queue([first], n_first), 0
    while not all(f.done() for f in futs):
        if chunks == 1:
            futs += queue(later, n_later)
        eng._admit()
        if any(s.active for s in eng.slots) or eng._lane:
            eng._decode_chunk()
        chunks += 1
        assert chunks < 200
    return [f.result(timeout=0) for f in futs]


def _int8_kv_kernel_streams(quantize):
    """The port's int8-KV engine on its kernels' path (``attn_impl=
    "pallas"``: K2's int8 paged mode for re-prefill, K1's int8 mode for
    decode; their plain versions on the CPU) on a head_dim-128 config they
    take (G = 2, 8-key pages), against JAX's int8-KV engine on the gather:
    concurrent greedy requests, a prefix-cache follow-up, and prompts that
    ride the port's prefill lane (its rows attend over their unquantized
    k / v) against JAX's lane-less engine."""
    name = f"qwen3-i8kv-kernels-{quantize}"
    jcfg, tcfg = jqwen3.Qwen3Config(**I8KV_KW), tqwen3.Qwen3Config(**I8KV_KW)
    jregistry.register(name, jcfg, jqwen3.init_params, jqwen3.forward,
                       lambda: jqwen3.logical_axes(jcfg))
    tregistry.register(name, tcfg, tqwen3.forward)
    jp = jqwen3.init_params(jcfg, jax.random.PRNGKey(3))
    tp = tweights.params_from_jax(jax.tree.map(np.asarray, jp))
    kw = dict(max_slots=4, page_size=8, n_pages=64, max_seq_len=128, decode_chunk_len=4,
              seed=0, quantize=quantize, layer_fusion=False)
    tok = ByteTokenizer()
    je = jengine.Engine(name, tok, params=jp, kv_quantize="int8-force", **kw)
    te = tengine.Engine(name, tok, params=tp, device="cpu", kv_quantize="int8",
                        attn_impl="pallas", **kw)
    tl = tengine.Engine(name, tok, params=tp, device="cpu", kv_quantize="int8",
                        attn_impl="pallas", prefill_lane=16, **kw)
    try:
        assert te.attn_impl == tl.attn_impl == "pallas" and te.k_pages.dtype == torch.int8
        assert tengine.attention_kernels_take(dataclasses.replace(tcfg, dtype="bfloat16"),
                                              "paged", 8, 16)
        rng = np.random.default_rng(4)
        first = list(rng.integers(0, 256, 21))
        reqs = [_greedy(first, 8), _greedy(rng.integers(0, 256, 11), 8)]
        jres, tres = _both((je, te), reqs)
        for j, t in zip(jres, tres):
            assert len(t.token_ids) >= 6 and t.token_ids == j.token_ids
        follow = first + tres[0].token_ids + [5, 6, 7, 8, 9, 10, 11, 12, 13]
        jres, tres = _both((je, te), [_greedy(follow, 8)])
        assert tres[0].cached_prompt_tokens == jres[0].cached_prompt_tokens > 0
        assert tres[0].token_ids == jres[0].token_ids
        later = [list(range(30, 30 + n)) for n in (5, 9, 14)]
        got = _by_hand(tl, list(range(1, 7)), later)
        assert tl.stats["lane_tokens"] == 5 + 9 + 14
        jfuts = [je.submit(jengine.GenerationRequest(**_greedy(list(range(1, 7)), 16)))]
        jfuts += [je.submit(jengine.GenerationRequest(**_greedy(p, 6))) for p in later]
        want = [f.result(timeout=600) for f in jfuts]
        assert [r.token_ids for r in got] == [r.token_ids for r in want]
    finally:
        je.shutdown()
        te.shutdown()
        tl.shutdown()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_int8_kv_engine_greedy_streams_match_jax(quantize):
    """kv_quantize: int8 pools and scales in both engines, fused decode on,
    covering a prefix-cache re-prefill (which reads the int8 pages through
    paged_attention, not prefix_chunk_attention); then the port's engine
    on the kernels' path (:func:`_int8_kv_kernel_streams`)."""
    je, te = _engine_pair(f"qwen3-i8kv-parity-{quantize}", *_f32_cfgs("qwen3-test"),
                          dict(kv_quantize="int8-force", layer_fusion=True, quantize=quantize),
                          dict(kv_quantize="int8", layer_fusion=True, quantize=quantize))
    try:
        assert te.k_pages.dtype == torch.int8 and te.k_scales.dtype == torch.float32
        assert tuple(te.k_scales.shape) == tuple(te.k_pages.shape[:-1])
        rng = np.random.default_rng(2)
        first = list(rng.integers(0, 256, 19))
        jres, tres = _both((je, te), [_greedy(first, 8), _greedy(rng.integers(0, 256, 7), 8)])
        for j, t in zip(jres, tres):
            assert len(t.token_ids) >= 6 and t.token_ids == j.token_ids
        follow = first + tres[0].token_ids + [7, 8, 9, 10, 11]
        jres, tres = _both((je, te), [_greedy(follow, 8)])
        assert tres[0].cached_prompt_tokens == jres[0].cached_prompt_tokens > 0
        assert tres[0].token_ids == jres[0].token_ids
    finally:
        je.shutdown()
        te.shutdown()
    _int8_kv_kernel_streams(quantize)


def test_engine_takes_a_quantized_tree_unchanged():
    cfg = tregistry.get_model("qwen3-test").config
    params = tweights.random_params(cfg, seed=4, quantize="int8")
    eng = tengine.Engine("qwen3-test", ByteTokenizer(), params=params, device="cpu",
                         max_slots=1, quantize="int8")
    try:
        for key in ("wqkv", "wo", "w_gateup", "w_down"):
            assert eng.params["layers"][key]["q"] is params["layers"][key]["q"]
        assert eng.layer_fusion    # the dense family keeps fusion under int8
    finally:
        eng.shutdown()


@pytest.mark.parametrize("model,kw,exc,match", [
    ("qwen3-test", dict(cache_mode="slot", kv_quantize="int8"), ValueError, "paged cache"),
    ("qwen3-test", dict(attn_impl="pallas", kv_quantize="int8"), ValueError, "attn_impl"),
    ("qwen3-test", dict(attn_impl="clamp", kv_quantize="int8-force"), ValueError, "attn_impl"),
    ("qwen3-test", dict(kv_quantize="fp8"), ValueError, "kv_quantize"),
    ("qwen3-test", dict(quantize="fp8"), ValueError, "quantize"),
    ("deepseek-v3-test", dict(quantize="int8"), NotImplementedError, "deepseek_v3.py:283"),
    ("qwen3-moe-test", dict(kv_quantize="int8"), ValueError, "int8 KV"),
])
def test_int8_refusals(model, kw, exc, match):
    """What the port refuses around int8. A kernel ``attn_impl`` with int8 KV
    is no longer among it (JAX refuses it: its kernels read its int32-packed
    pages as bf16; K1 and K2 have int8 modes over the port's unpacked
    pools): the engine builds with it, int8 pools and their scales, and only
    an unknown ``attn_impl`` is refused."""
    if kw.get("attn_impl") and kw.get("kv_quantize"):
        eng = tengine.Engine(model, ByteTokenizer(), device="cpu", max_slots=1, **kw)
        try:
            assert eng.attn_impl == kw["attn_impl"]
            assert eng.k_pages.dtype == torch.int8 and eng.k_scales.dtype == torch.float32
        finally:
            eng.shutdown()
        kw = dict(kw, attn_impl="flash")
    with pytest.raises(exc, match=match):
        tengine.Engine(model, ByteTokenizer(), device="cpu", max_slots=1, **kw)
    if exc is NotImplementedError:
        with pytest.raises(exc, match="deepseek_v3.py:283"):
            tweights.random_params(tregistry.get_model(model).config, quantize="int8")
