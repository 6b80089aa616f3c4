"""Parity of the torch port's int8 Qwen3-MoE slice with the JAX package, on the CPU.

``Engine(model, quantize="int8")`` quantizes every ``QUANT_KEYS`` matrix, the
routed experts included, which then run JAX's blocked grouped matmul
(``ops/moe.py`` ``_expert_ffn_blocked``: each expert computes its first
``cap`` expert-sorted rows, the rows past it are 0). The same inputs, made
from a seed with numpy, go through the JAX function and its counterpart in
``deepsearch_tts_tpu_torch``: the packed int8 leaf, the blocked FFN (packed
and unpacked, with a skewed routing that drops rows), both dispatches, the
MLA routed experts, the ``qwen3-moe-test`` forwards, the golden checkpoint
through the int8 converter, the int8 random init, and greedy streams of the
paged, slot, capacity, speculative and prefill-lane engines. The CUDA kernel
(``csrc/moe_i8.cu``) is held against the plain versions on the card by
``chip_smoke.py``.

Two defects of the reference are recorded here, as its behaviour:
``Engine(..., quantize="int8")`` with JAX's default ``pack_weights`` (on off
the TPU) crashes on the packed int8 expert leaf (``w_up=None`` reaches
``_expert_dot``), so the JAX side runs ``pack_weights=False`` — the port
serves the packed leaf, equal to the unpacked leaves side by side (one
scale a column); and the MLA family cannot serve int8 at all (its attention
reshapes the quantized ``w_kb`` leaf), so the port refuses it.

Tolerances: integer outputs (q, the dropped rows, greedy tokens, expert
ids) exactly; scales to one float32 ulp (the same quotient); bf16 values
within the JAX suite's bounds: RTOL / ATOL for one operation (a float32
summation-order difference can flip one bf16 rounding), FWD_TOL for whole
forwards, the golden checkpoint's HF logits within 0.2 at most.
"""
import dataclasses
import json
import os
import traceback

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.engine import weights as jweights
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.models import deepseek_v3 as jds
from deepsearch_tts_tpu.models import qwen3_moe as jmoe
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.ops import moe as jmoe_ops
from deepsearch_tts_tpu.ops import quant as jquant
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.engine import weights as tweights
from deepsearch_tts_tpu_torch.models import deepseek_v3 as tds
from deepsearch_tts_tpu_torch.models import qwen3_moe as tmoe
from deepsearch_tts_tpu_torch.models import registry as tregistry
from deepsearch_tts_tpu_torch.ops import moe as tmoe_ops
from deepsearch_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

BF16 = np.dtype(ml_dtypes.bfloat16)
CFG = "qwen3-moe-test"
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden", CFG)
# one bf16 operation: a float32 summation-order difference can flip one bf16
# rounding (the JAX suite's bound for the fused kernels, tests/test_fused_layer.py:181)
RTOL, ATOL = 2e-2, 1e-2
# whole forwards: ROADMAP.md's forward bound (tests/test_torch_model.py TOL)
FWD_TOL = 5e-2
# the JAX suite's golden-logit bound (tests/test_weights.py:410-414)
GOLDEN_MAX_ERR = 0.2
QKEYS = ("q", "scales")


def _np(rng, *shape, scale=1.0, dtype=np.float32):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(dtype)


def _t(a):
    a = np.array(a)   # a writable copy (JAX hands out read-only buffers)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tree(jtree):
    """A JAX param tree (int8 leaves included) as the port's tensors."""
    return tweights.params_from_jax(jax.tree.map(np.asarray, jtree))


def _assert_leaf_equal(got: dict, want_q, want_s, name: str) -> None:
    """q bit-equal; scales within one float32 ulp."""
    assert got["q"].dtype == torch.int8 and got["scales"].dtype == torch.float32, name
    assert np.array_equal(got["q"].numpy(), np.asarray(want_q)), name
    np.testing.assert_array_max_ulp(got["scales"].numpy(), np.asarray(want_s, np.float32), 1)


def _quantized_experts(rng, NE=8, E=32, F=48, L=None):
    """JAX's quantize_params of bf16 gate / up [NE,E,F] and down [NE,F,E]
    stacks (a leading layer axis with ``L``)."""
    lead = () if L is None else (L,)
    ws = {"w_gate": _np(rng, *lead, NE, E, F, scale=E ** -0.5, dtype=BF16),
          "w_up": _np(rng, *lead, NE, E, F, scale=E ** -0.5, dtype=BF16),
          "w_down": _np(rng, *lead, NE, F, E, scale=F ** -0.5, dtype=BF16)}
    return jquant.quantize_params(jax.tree.map(jnp.asarray, ws))


def _packed(tq: dict) -> dict:
    """The port's packed gate|up leaf of unpacked int8 leaves."""
    return {k: torch.cat([tq["w_gate"][k], tq["w_up"][k]], -1) for k in QKEYS}


# ------------------------------------------------------------ (a) quantize

def test_packed_int8_leaf_equals_jax_unpacked_leaves():
    """The packed ``w_gateup`` leaf ``{q [L,NE,E,2F], scales [L,NE,1,2F]}``
    that the port's ``quantize_params`` makes of the packed bf16 stack is
    JAX's ``quantize_params`` of ``w_gate`` and ``w_up``, side by side."""
    rng = np.random.default_rng(0)
    L, NE, E, F = 2, 4, 32, 48
    wg, wu = _np(rng, L, NE, E, F, dtype=BF16), _np(rng, L, NE, E, F, scale=3.0, dtype=BF16)
    jq = jquant.quantize_params({"layers": {"w_gate": jnp.asarray(wg), "w_up": jnp.asarray(wu)}})
    packed = tweights.pack_matmul_params({"layers": {"w_gate": _t(wg), "w_up": _t(wu)}})
    got = tquant.quantize_params(packed)["layers"]["w_gateup"]
    assert tuple(got["q"].shape) == (L, NE, E, 2 * F)
    assert tuple(got["scales"].shape) == (L, NE, 1, 2 * F)
    jl = jq["layers"]
    _assert_leaf_equal(got, np.concatenate([jl["w_gate"]["q"], jl["w_up"]["q"]], -1),
                       np.concatenate([jl["w_gate"]["scales"], jl["w_up"]["scales"]], -1),
                       "w_gateup")
    # packing JAX's unpacked int8 leaves gives the same leaf
    repacked = tweights.pack_matmul_params(_tree(jq))["layers"]["w_gateup"]
    assert all(torch.equal(repacked[k], got[k]) for k in QKEYS)


# -------------------------------------------------------- (b) blocked FFN

def _sorted_rows(rng, T, E, NE, k, skew=None):
    """x_sorted [T·k, E] bf16 and the group sizes of a routing of T tokens
    over NE experts (``skew``: an expert every token picks)."""
    logits = _np(rng, T, NE, scale=2.0)
    if skew is not None:
        logits[:, skew] += 30.0
    top_e = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    flat = top_e.reshape(-1)
    order = np.argsort(flat, kind="stable")
    x = _np(rng, T, E, dtype=BF16)
    sizes = np.bincount(flat, minlength=NE).astype(np.int32)
    return x[order // k], sizes


@pytest.mark.parametrize("skew", [None, 3], ids=["balanced", "skewed"])
@pytest.mark.parametrize("packed", [False, True])
def test_expert_ffn_blocked_matches_jax(packed, skew):
    """tests/test_ring_quant.py:93-118's shapes (T=24, E=32, F=48, NE=8,
    k=2). Skewed: expert 3 takes all 24 tokens, past cap = 16, so its last
    8 rows drop: 0 in both packages, at the same rows. JAX runs the
    unpacked leaves (its packed path crashes, test below)."""
    rng = np.random.default_rng(1)
    T, E, NE, k = 24, 32, 8, 2
    jq = _quantized_experts(rng)
    xs, sizes = _sorted_rows(rng, T, E, NE, k, skew)
    cap = tmoe_ops.expert_capacity(T * k, NE)
    assert cap == 16
    want = jmoe_ops._expert_ffn_blocked(jnp.asarray(xs), jq["w_gate"], jq["w_up"],
                                        jq["w_down"], jnp.asarray(sizes))
    tq = _tree(jq)
    wg, wu = (_packed(tq), None) if packed else (tq["w_gate"], tq["w_up"])
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    got = tmoe_ops._expert_ffn_blocked(_t(xs), wg, wu, tq["w_down"], offsets)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T * k, E)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)
    # the dropped rows: an expert's rows from the cap-th on
    pos = np.arange(T * k) - np.repeat(np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes)
    dropped = pos >= cap
    assert dropped.sum() == (8 if skew is not None else 0)
    assert np.array_equal(np.all(_f32(want) == 0, axis=-1), dropped)
    assert np.array_equal(np.all(_f32(got) == 0, axis=-1), dropped)
    # the plain versions take the rows the wrappers take
    ref = tmoe_ops._expert_ffn_blocked(_t(xs), wg, wu, tq["w_down"], offsets, plain=True)
    assert torch.equal(ref, got)


@pytest.mark.parametrize("packed", [False, True])
def test_expert_ffn_blocked_matches_jax_at_prefill_rows(packed):
    """At the row count from which the card takes the prefill form
    (``PREFILL_ROWS_PER_EXPERT`` rows an expert on average: T=64, k=2,
    NE=8, S=128), with expert 3 taking all 64 tokens, past cap = 32: the
    wrappers' CPU path (the plain versions) against JAX's
    ``_expert_ffn_blocked``, the dropped rows 0 in both at the same rows."""
    rng = np.random.default_rng(5)
    T, E, NE, k = 64, 32, 8, 2
    jq = _quantized_experts(rng)
    xs, sizes = _sorted_rows(rng, T, E, NE, k, skew=3)
    S = T * k
    assert S == tmoe_ops.PREFILL_ROWS_PER_EXPERT * NE
    cap = tmoe_ops.expert_capacity(S, NE)
    assert cap == 32 and sizes[3] == T
    want = jmoe_ops._expert_ffn_blocked(jnp.asarray(xs), jq["w_gate"], jq["w_up"],
                                        jq["w_down"], jnp.asarray(sizes))
    tq = _tree(jq)
    wg, wu = (_packed(tq), None) if packed else (tq["w_gate"], tq["w_up"])
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    got = tmoe_ops._expert_ffn_blocked(_t(xs), wg, wu, tq["w_down"], offsets)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)
    pos = np.arange(S) - np.repeat(np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes)
    dropped = pos >= cap
    assert dropped.sum() == T - cap
    assert np.array_equal(np.all(_f32(want) == 0, axis=-1), dropped)
    assert np.array_equal(np.all(_f32(got) == 0, axis=-1), dropped)


def test_reference_crashes_on_the_packed_int8_expert_leaf():
    """A reference behaviour: JAX's blocked path reads ``w_up=None`` (the
    packed gate|up layout of ``pack_matmul_params``) as an operand."""
    rng = np.random.default_rng(2)
    jq = _quantized_experts(rng, NE=4)
    packed = {k: jnp.concatenate([jq["w_gate"][k], jq["w_up"][k]], -1) for k in QKEYS}
    xs, sizes = _sorted_rows(rng, 8, 32, 4, 2)
    with pytest.raises(TypeError, match="not a valid JAX type"):
        jmoe_ops._expert_ffn_blocked(jnp.asarray(xs), packed, None, jq["w_down"],
                                     jnp.asarray(sizes))


def test_expert_capacity_is_jax_rule():
    """max(8, ceil(int(2·S) / NE) rounded up to 8), at the shapes of the
    smoke's routings (qwen3-30b-a3b: 128 experts, top-8)."""
    for S, n, want in ((48, 8, 16), (8, 8, 8), (128, 128, 8), (512, 128, 8),
                       (24576, 128, 384), (40, 8, 16), (1000, 3, 672)):
        assert tmoe_ops.expert_capacity(S, n) == want, (S, n)
        cap = -(-int(2.0 * S) // n)
        assert want == max(8, -(-cap // 8) * 8)


def test_int8_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain versions: any other device goes to
    the kernel's checks and launch, which raise here (a tensor off the card
    is refused before any library is loaded)."""
    rng = np.random.default_rng(3)
    tq = _tree(_quantized_experts(rng, NE=4, E=128, F=64))
    xs = torch.zeros((8, 128), dtype=torch.bfloat16, device="meta")
    offsets = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        tmoe_ops.grouped_gateup_i8(xs, tq["w_gate"], tq["w_up"], offsets, 8)
    with pytest.raises((ValueError, RuntimeError)):
        tmoe_ops.grouped_down_i8(xs[:, :64], tq["w_down"], offsets, 8)


# ------------------------------------------------------------ (c) dispatch

@pytest.mark.parametrize("packed", [False, True])
def test_moe_ragged_int8_matches_jax(packed):
    """The ragged dispatch over int8 experts (the blocked FFN), with expert 5
    never routed to and expert 2 over its capacity."""
    rng = np.random.default_rng(4)
    jq = _quantized_experts(rng)
    x = _np(rng, 16, 32, dtype=BF16)
    logits = _np(rng, 16, 8, scale=2.0)
    logits[:, 5] = -30.0
    logits[:12, 2] += 30.0            # 12 of 16 tokens: past cap = 8
    want = jmoe_ops.moe_ragged(jnp.asarray(x), None, jq["w_gate"], jq["w_up"], jq["w_down"],
                               top_k=2, router_logits=jnp.asarray(logits))
    tq = _tree(jq)
    wg, wu = (_packed(tq), None) if packed else (tq["w_gate"], tq["w_up"])
    got = tmoe_ops.moe_ragged(_t(x), None, wg, wu, tq["w_down"], top_k=2,
                              router_logits=_t(logits))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (16, 32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_capacity_int8_matches_jax(capacity_factor):
    """The capacity dispatch over int8 leaves (``_expert_dot`` with ``{q,
    scales}``): unbounded, and a capacity where assignments drop."""
    rng = np.random.default_rng(5)
    jq = _quantized_experts(rng, NE=4)
    x = _np(rng, 16, 32, dtype=BF16)
    router = _np(rng, 32, 4, scale=32 ** -0.5, dtype=BF16)
    want = jmoe_ops.moe_capacity(jnp.asarray(x), jnp.asarray(router), jq["w_gate"],
                                 jq["w_up"], jq["w_down"], top_k=2,
                                 capacity_factor=capacity_factor)
    tq = _tree(jq)
    got = tmoe_ops.moe_capacity(_t(x), _t(router), tq["w_gate"], tq["w_up"], tq["w_down"],
                                top_k=2, capacity_factor=capacity_factor)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------- (d) MLA experts

def test_mla_routed_int8_experts_match_jax():
    """DeepSeek's sigmoid routing shares the dispatch: ``_moe_v3_routed``
    with JAX-quantized expert stacks, layer 1 of ``deepseek-v3-test``."""
    jcfg = jds.DEEPSEEK_V3_CONFIGS["deepseek-v3-test"]
    tcfg = tds.DEEPSEEK_V3_CONFIGS["deepseek-v3-test"]
    jp = jweights.fast_random_params(jcfg, seed=0)["moe_layers"]
    keys = ("w_gate", "w_up", "w_down")
    jm = dict(jp, **jquant.quantize_params({k: jp[k] for k in keys}))
    assert jm["w_gate"]["q"].dtype == jnp.int8
    x = _np(np.random.default_rng(6), 10, jcfg.hidden, dtype=BF16)
    layer = jax.tree.map(lambda a: a[1], jm)
    want = jds._moe_v3_routed(jcfg, layer, jnp.asarray(x))
    # the port's MLA tree never holds int8 leaves (it refuses them), so the
    # layer's leaves go in as a one-layer sequence that ``[l]`` indexes
    tp = {k: [v] for k, v in _tree({k: layer[k] for k in ("router", "router_bias") + keys}
                                   ).items()}
    got = tds._moe_v3_routed(tcfg, tp, 0, _t(x))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(tds._moe_v3_routed(tcfg, tp, 0, _t(x), plain=True), got)


# ------------------------------------------------------------- (e) model

def _cfgs(dtype="bfloat16", **kw):
    j = dataclasses.replace(jmoe.QWEN3_MOE_CONFIGS[CFG], dtype=dtype, **kw)
    t = dataclasses.replace(tmoe.QWEN3_MOE_CONFIGS[CFG], dtype=dtype, **kw)
    return j, t


def _int8_params(jcfg):
    """JAX's init quantized (unpacked, as its int8 MoE engine serves them)
    and the port's packed copy of the same tree."""
    jq = jquant.quantize_params(jmoe.init_params(jcfg, jax.random.PRNGKey(0)))
    return jq, tweights.pack_matmul_params(_tree(jq))


@pytest.mark.parametrize("moe_impl", ["ragged", "capacity"])
def test_int8_no_cache_forward_matches_jax(moe_impl):
    jcfg, tcfg = _cfgs(moe_impl=moe_impl, capacity_factor=8.0)
    jq, tp = _int8_params(jcfg)
    assert tp["layers"]["w_gateup"]["q"].dtype == torch.int8
    assert tp["lm_head"]["q"].dtype == torch.int8 and tp["layers"]["router"].dtype == torch.bfloat16
    rng = np.random.default_rng(7)
    ids = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want, _ = jmoe.forward(jq, jcfg, jnp.asarray(ids), jnp.asarray(pos))
    got, cache = tmoe.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=FWD_TOL, atol=FWD_TOL)
    # plain_int8 takes every int8 product and the expert FFN off the wrappers
    tmoe_ops.grouped_gateup_i8.launches = tmoe_ops.grouped_down_i8.launches = 0
    ref, _ = tmoe.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos),
                          plain_int8=True)
    assert tmoe_ops.grouped_gateup_i8.launches == tmoe_ops.grouped_down_i8.launches == 0
    assert torch.equal(ref, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_serving_forwards_match_jax(dtype):
    """Fresh prefill → re-prefill over the cached prefix → three T=1 paged
    decode steps (one row inactive on the last); ``fused_decode`` is asked
    for and, as in JAX, not taken on int8 leaves; logits and pools agree."""
    jcfg, tcfg = _cfgs(dtype)
    jq, tp = _int8_params(jcfg)
    L, Kh, D = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jk, jv = jkv.init_kv_pages(L, 16, 4, Kh, D, jcfg.jnp_dtype)
    tk, tv = tkv.init_kv_pages(L, 16, 4, Kh, D, tcfg.torch_dtype)
    table = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)

    def step(tokens, positions, seq_lens, logits_idx=None, **kw):
        nonlocal jk, jv
        jl, (jk, jv) = jmoe.forward(
            jq, jcfg, jnp.asarray(tokens), jnp.asarray(positions), k_pages=jk, v_pages=jv,
            page_table=jnp.asarray(table), seq_lens=jnp.asarray(seq_lens),
            logits_indices=None if logits_idx is None else jnp.asarray(logits_idx), **kw)
        tl, _ = tmoe.forward(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions), k_pages=tk,
            v_pages=tv, page_table=torch.from_numpy(table), seq_lens=torch.from_numpy(seq_lens),
            logits_indices=None if logits_idx is None else torch.from_numpy(logits_idx), **kw)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(_f32(tk), _f32(jk), rtol=FWD_TOL, atol=FWD_TOL)

    lens0 = [8, 6]
    tokens = np.zeros((2, 8), np.int32)
    positions = np.full((2, 8), -1, np.int32)
    for b, n in enumerate(lens0):
        tokens[b, :n], positions[b, :n] = toks[b, :n], np.arange(n)
    step(tokens, positions, np.array(lens0, np.int32), np.array([7, 5], np.int32),
         fresh_prefill=True)
    tokens = np.stack([toks[b, n:n + 5] for b, n in enumerate(lens0)]).astype(np.int32)
    positions = np.stack([np.arange(n, n + 5) for n in lens0]).astype(np.int32)
    lens = np.array([n + 5 for n in lens0], np.int32)
    step(tokens, positions, lens, np.array([4, 4], np.int32))
    for i in range(3):
        active = np.array([True, i < 2])
        pos = np.where(active, lens, -1).astype(np.int32)[:, None]
        step(toks[:, 13 + i:14 + i].astype(np.int32), pos, (lens + active).astype(np.int32),
             fused_decode=True)
        lens = lens + active


# ----------------------------------------------------------- (f, g) weights

def test_golden_int8_converter_matches_jax_quantized_tree():
    """``convert_qwen3_moe(quantize="int8")`` on the in-repo checkpoint:
    every int8 leaf equals JAX's converted-then-quantized tree (gate|up
    packed), the rest bit for bit; its logits stay within the JAX suite's
    golden bound of HuggingFace's float32 logits."""
    cfg = tmoe.QWEN3_MOE_CONFIGS[CFG]
    raw = tweights._load_safetensors_dir(GOLDEN)
    got = tweights.convert_qwen3_moe(raw, cfg, quantize="int8")
    want = jax.tree.map(np.asarray, jquant.quantize_params(
        jweights.convert_qwen3_moe(jweights._load_safetensors_dir(GOLDEN),
                                   jmoe.QWEN3_MOE_CONFIGS[CFG])))
    wl, gl = want["layers"], got["layers"]

    def cat(*keys):
        return tuple(np.concatenate([wl[k][p] for k in keys], -1) for p in QKEYS)

    _assert_leaf_equal(gl["wqkv"], *cat("wq", "wk", "wv"), "wqkv")
    _assert_leaf_equal(gl["w_gateup"], *cat("w_gate", "w_up"), "w_gateup")
    for key in ("wo", "w_down"):
        _assert_leaf_equal(gl[key], wl[key]["q"], wl[key]["scales"], key)
    _assert_leaf_equal(got["lm_head"], want["lm_head"]["q"], want["lm_head"]["scales"],
                       "lm_head")
    for key in ("ln1", "ln2", "q_norm", "k_norm", "router"):
        assert torch.equal(gl[key], _t(wl[key])), key
    assert torch.equal(got["embed"], _t(want["embed"]))
    with open(os.path.join(GOLDEN, "meta.json")) as f:
        ids = torch.tensor([json.load(f)["input_ids"]])
    logits, _ = tmoe.forward(got, cfg, ids, torch.arange(ids.shape[1])[None])
    expected = np.load(os.path.join(GOLDEN, "expected_logits.npy"))
    err = np.abs(logits[0].numpy() - expected)
    assert err.max() < GOLDEN_MAX_ERR, err.max()
    # and the engine's loader takes the quantized path
    loaded, _ = tweights.load_or_init_params(CFG, GOLDEN, quantize="int8")
    assert torch.equal(loaded["layers"]["w_gateup"]["q"], gl["w_gateup"]["q"])


def test_random_params_int8_equals_quantized_random_params():
    """For the MoE family, drawn and quantized one expert matrix at a time."""
    cfg = tmoe.QWEN3_MOE_CONFIGS[CFG]
    want = tquant.quantize_params(tweights.random_params(cfg, seed=3))
    got = tweights.random_params(cfg, seed=3, quantize="int8")
    for key in ("wqkv", "wo", "w_gateup", "w_down"):
        for part in QKEYS:
            assert torch.equal(got["layers"][key][part], want["layers"][key][part]), key
    assert got["layers"]["w_gateup"]["q"].shape == (2, 8, 64, 192)
    assert torch.equal(got["lm_head"]["q"], want["lm_head"]["q"])
    assert torch.equal(got["layers"]["router"], want["layers"]["router"])
    assert got["layers"]["router"].dtype == torch.bfloat16


# ----------------------------------------------------------- (h) engines

def _greedy(ids, n):
    return dict(prompt_ids=[int(i) for i in ids], max_tokens=n, temperature=0.0,
                top_k=0, top_p=1.0, min_p=0.0, repetition_penalty=1.0)


def _register(name, **kw):
    """``name`` in both registries: float32 ``qwen3-moe-test`` (tie-free
    greedy streams) with ``kw``; JAX's and the port's params of one seed."""
    jcfg, tcfg = _cfgs("float32", **kw)
    jregistry.register(name, jcfg, jmoe.init_params, jmoe.forward,
                       lambda: jmoe.logical_axes(jcfg))
    tregistry.register(name, tcfg, tmoe.forward)
    jp = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, _tree(jp)


def _engines(name, jp, tp, **kw):
    tok = ByteTokenizer()
    common = dict(max_slots=4, max_seq_len=128, decode_chunk_len=4, seed=0, quantize="int8",
                  **kw)
    return (jengine.Engine(name, tok, params=jp, pack_weights=False, **common),
            tengine.Engine(name, tok, params=tp, device="cpu", **common))


def _run(eng, mod, reqs):
    futs = eng.submit_many([mod.GenerationRequest(**r) for r in reqs])
    return [f.result(timeout=300) for f in futs]


ENGINES = {"paged": ("qwen3-moe-i8-parity", {}, dict(page_size=4, n_pages=128)),
           "slot": ("qwen3-moe-i8-parity", {}, dict(cache_mode="slot", attn_impl="pallas")),
           "capacity": ("moe-int8-capacity-parity", dict(moe_impl="capacity",
                                                         capacity_factor=8.0),
                        dict(page_size=4, n_pages=128))}


@pytest.mark.parametrize("case", list(ENGINES))
def test_int8_engine_greedy_streams_match_jax(case):
    """Three concurrent requests, then a follow-up that extends the first
    conversation: a prefix-cache hit (paged) or a parked-row re-entry
    (slot). The JAX engine serves the unpacked int8 tree
    (``pack_weights=False``), the port its packed one; both run unfused."""
    name, cfg_kw, kw = ENGINES[case]
    je, te = _engines(name, *_register(name, **cfg_kw), **kw)
    try:
        assert not te.layer_fusion and not je.layer_fusion
        assert te.params["layers"]["w_gateup"]["q"].dtype == torch.int8
        assert je.params["layers"]["w_gate"]["q"].dtype == jnp.int8
        rng = np.random.default_rng(8)
        first = rng.integers(0, 256, 21)
        reqs = [_greedy(first, 8)] + [_greedy(rng.integers(0, 256, n), 12) for n in (9, 30)]
        out = []
        for mod, eng in ((jengine, je), (tengine, te)):
            res = _run(eng, mod, reqs)
            follow = list(first) + res[0].token_ids + list(range(60, 66))
            res += _run(eng, mod, [_greedy(follow, 8)])
            out.append(res)
        for j, t in zip(*out):
            assert len(t.token_ids) >= 8
            assert t.token_ids == j.token_ids
            assert (t.finish_reason, t.prompt_tokens, t.cached_prompt_tokens) == (
                j.finish_reason, j.prompt_tokens, j.cached_prompt_tokens)
        assert out[1][-1].cached_prompt_tokens > 0
    finally:
        je.shutdown()
        te.shutdown()


def test_int8_speculative_engine_streams_match_jax():
    """JAX gates speculative decoding on neither ``quantize`` nor the family
    (engine.py:201-235): its slot verify windows run unfused over the int8
    experts in both packages, with the same greedy streams."""
    name = "qwen3-moe-i8-parity"
    je, te = _engines(name, *_register(name), cache_mode="slot", speculative="ngram",
                      spec_k=3, spec_ngram=2)
    try:
        rng = np.random.default_rng(9)
        loop = list(rng.integers(0, 256, 6)) * 3      # n-gram drafts hit
        reqs = [_greedy(loop, 12), _greedy(rng.integers(0, 256, 11), 10)]
        jres, tres = _run(je, jengine, reqs), _run(te, tengine, reqs)
        for j, t in zip(jres, tres):
            assert len(t.token_ids) >= 8 and t.token_ids == j.token_ids
        assert te.speculative == je.speculative == "ngram"
    finally:
        je.shutdown()
        te.shutdown()


def test_int8_prefill_lane_streams_match_jax():
    """Nor does JAX gate the prefill lane on them (engine.py:1643): short
    prompts arriving while a row decodes ride the lane (the port's
    scheduler driven by hand), with JAX's lane engine's greedy streams."""
    from concurrent.futures import Future

    name = "qwen3-moe-i8-parity"
    jp, tp = _register(name)
    kw = dict(page_size=4, n_pages=128, enable_prefix_cache=False, prefill_lane=16)
    je, te = _engines(name, jp, tp, **kw)
    je.shutdown()
    te.shutdown()
    first, later = list(range(1, 4)), [list(range(10, 10 + n)) for n in (3, 11)]
    tok = ByteTokenizer()
    te = tengine.Engine(name, tok, params=tp, device="cpu", max_slots=4, max_seq_len=128,
                        decode_chunk_len=4, seed=0, quantize="int8", **kw)

    def queue(prompts, n):
        futs = []
        for p in prompts:
            fut = Future()
            te._queue.put((tengine.GenerationRequest(**_greedy(p, n)), fut))
            futs.append(fut)
        return futs

    futs, chunks = queue([first], 16), 0
    while not all(f.done() for f in futs):
        if chunks == 1:
            futs += queue(later, 5)
        te._admit()
        if any(s.active for s in te.slots) or te._lane:
            te._decode_chunk()
        chunks += 1
        assert chunks < 200
    got = [f.result(timeout=0).token_ids for f in futs]
    assert te.stats["lane_tokens"] == 3 + 11
    je = jengine.Engine(name, tok, params=jp, pack_weights=False, max_slots=4,
                        max_seq_len=128, decode_chunk_len=4, seed=0, quantize="int8", **kw)
    try:
        want = [f.result(timeout=600).token_ids for f in
                [je.submit(jengine.GenerationRequest(**_greedy(first, 16)))]
                + [je.submit(jengine.GenerationRequest(**_greedy(p, 5))) for p in later]]
    finally:
        je.shutdown()
    assert got == want


# --------------------------------------------------------- (i, j) refusals

def _raised_at(excinfo, filename: str, lineno: int) -> bool:
    return any(f.filename.endswith(filename) and f.lineno == lineno
               for f in traceback.extract_tb(excinfo.value.__traceback__))


def test_mla_int8_refused_as_the_reference_fails():
    """The port refuses int8 MLA with the reference's reason; the reference
    fails at deepseek_v3.py:283 on its first prefill (a recorded reference
    behaviour)."""
    tok = ByteTokenizer()
    jcfg = jds.DEEPSEEK_V3_CONFIGS["deepseek-v3-test"]
    for refuse in (
            lambda: tengine.Engine("deepseek-v3-test", tok, device="cpu", max_slots=1,
                                   quantize="int8"),
            lambda: tweights.random_params(tds.DEEPSEEK_V3_CONFIGS["deepseek-v3-test"],
                                           quantize="int8"),
            lambda: tweights.convert_deepseek_v3({}, tds.DEEPSEEK_V3_CONFIGS["deepseek-v3-test"],
                                                 quantize="int8")):
        with pytest.raises(NotImplementedError, match="deepseek_v3.py:283") as err:
            refuse()
        assert str(err.value) == tweights.INT8_MLA_REFUSED
    je = jengine.Engine("deepseek-v3-test", tok, params=jweights.fast_random_params(jcfg),
                        max_slots=1, n_pages=16, page_size=4, max_seq_len=32, quantize="int8")
    try:
        with pytest.raises(AttributeError, match="reshape") as err:
            je.generate(jengine.GenerationRequest(**_greedy(range(5), 2)))
        assert _raised_at(err, "deepsearch_tts_tpu/models/deepseek_v3.py", 283)
    finally:
        je.shutdown()


def test_reference_int8_moe_engine_crashes_with_packed_weights():
    """JAX's default ``pack_weights`` (on off the TPU) packs the experts
    before quantizing them, and its blocked path then fails at
    ops/moe.py:74 (a recorded reference behaviour); the port serves the
    packed layout."""
    name = "qwen3-moe-i8-parity"
    jp, tp = _register(name)
    je = jengine.Engine(name, ByteTokenizer(), params=jp, max_slots=1, n_pages=32,
                        page_size=4, max_seq_len=32, quantize="int8")
    try:
        with pytest.raises(TypeError, match="not a valid JAX type") as err:
            je.generate(jengine.GenerationRequest(**_greedy(range(5), 2)))
        assert _raised_at(err, "deepsearch_tts_tpu/ops/moe.py", 74)
    finally:
        je.shutdown()


def test_kv_quantize_still_refused_on_the_moe_family():
    tok = ByteTokenizer()
    for q in (None, "int8"):
        with pytest.raises(ValueError, match="does not support int8 KV") as terr:
            tengine.Engine(CFG, tok, device="cpu", max_slots=1, kv_quantize="int8", quantize=q)
        with pytest.raises(ValueError, match="does not support int8 KV") as jerr:
            jengine.Engine(CFG, tok, max_slots=1, kv_quantize="int8", quantize=q)
        assert str(terr.value) == str(jerr.value)


def test_int8_engine_runs_unfused_and_quantizes_every_key():
    """The auto gate follows JAX's ``quantize is None or (quantize == "int8"
    and is_dense)``: no fusion for int8 MoE (fusion stays on in bf16); the
    router, norms and embedding stay bf16."""
    tok = ByteTokenizer()
    bf = tengine.Engine(CFG, tok, device="cpu", max_slots=1)
    eng = tengine.Engine(CFG, tok, device="cpu", max_slots=1, quantize="int8")
    try:
        assert bf.layer_fusion and not eng.layer_fusion
        lp = eng.params["layers"]
        assert {k for k, v in lp.items() if isinstance(v, dict)} == {
            "wqkv", "wo", "w_gateup", "w_down"}
        assert eng.params["lm_head"]["q"].dtype == torch.int8
        assert lp["router"].dtype == eng.params["embed"].dtype == torch.bfloat16
        r = eng.generate(tengine.GenerationRequest(**_greedy(range(40, 52), 6)))
        assert len(r.token_ids) == 6
    finally:
        bf.shutdown()
        eng.shutdown()
