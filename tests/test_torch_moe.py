"""Parity of the torch port's Qwen3-MoE slice with the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its counterpart in ``deepsearch_tts_tpu_torch``: routing, the ragged and
capacity dispatches, the grouped expert FFN's plain version against
``_expert_ffn_ragged`` (``lax.ragged_dot``), B7's plain version against the
JAX kernel in interpret mode, the ``qwen3-moe-test`` forwards, the fused
decode layer, the golden checkpoint, the random-init tree, and greedy token
streams of the paged and slot engines. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.engine.weights import fast_random_params
from deepsearch_tts_tpu.engine.weights import pack_matmul_params as jpack
from deepsearch_tts_tpu.models import qwen3_moe as jmoe
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.ops import fused_layer as jfused
from deepsearch_tts_tpu.ops import moe as jmoe_ops
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.engine import weights as tweights
from deepsearch_tts_tpu_torch.models import qwen3_moe as tmoe
from deepsearch_tts_tpu_torch.models import registry as tregistry
from deepsearch_tts_tpu_torch.ops import fused_layer as tfused
from deepsearch_tts_tpu_torch.ops import moe as tmoe_ops

torch.set_num_threads(1)

BF16 = np.dtype(ml_dtypes.bfloat16)
CFG = "qwen3-moe-test"
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden", CFG)
# bf16 outputs that round at the same points in both packages: a float32
# summation-order difference can flip one bf16 rounding (2^-8 relative) —
# the JAX suite's own bound for the stacked fused kernels
# (tests/test_fused_layer.py:181,190)
RTOL, ATOL = 2e-2, 1e-2
# whole forwards: ROADMAP.md's forward bound (tests/test_torch_model.py TOL)
FWD_TOL = 5e-2
# the 128-aligned MoE config of tests/test_moe.py:123-125, which the JAX
# fused kernels (B3, B7) can tile
ALIGNED = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=2, n_kv_heads=2,
               head_dim=128, n_experts=4, top_k=2, moe_intermediate=128,
               tie_embeddings=True)


def _np(rng, *shape, scale=1.0, dtype=np.float32):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(dtype)


def _t(a):
    a = np.array(a)   # a writable copy (JAX hands out read-only buffers)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _experts(rng, E=32, NE=8, F=48, dtype=BF16):
    """router [E,NE], gate/up [NE,E,F], down [NE,F,E]."""
    return (_np(rng, E, NE, scale=E ** -0.5, dtype=dtype),
            _np(rng, NE, E, F, scale=E ** -0.5, dtype=dtype),
            _np(rng, NE, E, F, scale=E ** -0.5, dtype=dtype),
            _np(rng, NE, F, E, scale=F ** -0.5, dtype=dtype))


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("norm", [True, False])
def test_route_topk_matches_jax(norm):
    logits = _np(np.random.default_rng(0), 12, 8, scale=3.0)   # tie-free
    jp, je = jmoe_ops.route_topk(jnp.asarray(logits), 3, norm)
    tp, te = tmoe_ops.route_topk(_t(logits), 3, norm)
    assert te.tolist() == np.asarray(je).tolist()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    if norm:
        np.testing.assert_allclose(tp.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_group_offsets_count_without_bincount():
    flat_e = torch.tensor([3, 0, 3, 5, 0, 3], dtype=torch.int64)
    off = tmoe_ops.group_offsets(flat_e, 7)
    assert off.dtype == torch.int32
    assert off.tolist() == [0, 2, 2, 2, 5, 5, 6, 6]


# ----------------------------------------------------------------- dispatch

@pytest.mark.parametrize("packed", [False, True])
def test_moe_ragged_matches_jax(packed):
    """Both gate|up layouts, with expert 5 never routed to (an empty group)."""
    rng = np.random.default_rng(1)
    router, wg, wu, wd = _experts(rng)
    x = _np(rng, 16, 32, dtype=BF16)
    logits = _np(rng, 16, 8, scale=2.0)
    logits[:, 5] = -30.0
    args_j = [jnp.asarray(x), None, jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd)]
    args_t = [_t(x), None, _t(wg), _t(wu), _t(wd)]
    if packed:
        args_j[2:4] = [jnp.concatenate([args_j[2], args_j[3]], -1), None]
        args_t[2:4] = [torch.cat([args_t[2], args_t[3]], -1), None]
    want = jmoe_ops.moe_ragged(*args_j, top_k=2, router_logits=jnp.asarray(logits))
    got = tmoe_ops.moe_ragged(*args_t, top_k=2, router_logits=_t(logits))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (16, 32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)
    # through the router weights as well
    want = jmoe_ops.moe_ragged(args_j[0], jnp.asarray(router), *args_j[2:], top_k=2)
    got = tmoe_ops.moe_ragged(args_t[0], _t(router), *args_t[2:], top_k=2)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.1])
def test_moe_capacity_matches_jax(capacity_factor):
    """Unbounded capacity, and capacity 1 per expert, where most
    assignments drop: the same rows come out zero in both packages."""
    rng = np.random.default_rng(2)
    router, wg, wu, wd = _experts(rng, NE=4)
    x = _np(rng, 16, 32, dtype=BF16)
    want = jmoe_ops.moe_capacity(*(jnp.asarray(a) for a in (x, router, wg, wu, wd)),
                                 top_k=2, capacity_factor=capacity_factor)
    got = tmoe_ops.moe_capacity(*(_t(a) for a in (x, router, wg, wu, wd)),
                                top_k=2, capacity_factor=capacity_factor)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)
    dropped = np.all(_f32(want) == 0, axis=-1)
    assert np.array_equal(np.all(_f32(got) == 0, axis=-1), dropped)
    assert dropped.any() == (capacity_factor < 1)


@pytest.mark.parametrize("packed", [False, True])
def test_grouped_expert_plain_matches_ragged_dot(packed):
    """The grouped expert kernel's plain version (entries 1 and 2) against
    JAX ``_expert_ffn_ragged`` over expert-sorted rows with an empty group."""
    rng = np.random.default_rng(3)
    _, wg, wu, wd = _experts(rng, NE=4)
    sizes = np.array([5, 0, 9, 2], np.int32)
    xs = _np(rng, int(sizes.sum()), 32, dtype=BF16)
    jwg, jwu = jnp.asarray(wg), jnp.asarray(wu)
    twg, twu = _t(wg), _t(wu)
    if packed:
        jwg, jwu = jnp.concatenate([jwg, jwu], -1), None
        twg, twu = torch.cat([twg, twu], -1), None
    want = jmoe_ops._expert_ffn_ragged(jnp.asarray(xs), jwg, jwu, jnp.asarray(wd),
                                       jnp.asarray(sizes))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    got = tmoe_ops._expert_ffn_ragged(_t(xs), twg, twu, _t(wd), offsets)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (16, 32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)


def test_grouped_prefill_choice_reads_sizes_only():
    """The grouped wrappers take the decode or the prefill kernel from
    static sizes alone: the group offsets stay on the card (no host sync,
    CUDA-graph safe)."""
    import inspect

    params = list(inspect.signature(tmoe_ops.grouped_prefill).parameters)
    assert params == ["S", "n_exp", "hidden", "moe_intermediate"]


def _moe_widths(name):
    from deepsearch_tts_tpu_torch.models.deepseek_v3 import DEEPSEEK_V3_CONFIGS

    cfg = {**tmoe.QWEN3_MOE_CONFIGS, **DEEPSEEK_V3_CONFIGS}[name]
    n_exp = getattr(cfg, "n_experts", None) or cfg.n_routed_experts
    return n_exp, cfg.hidden, cfg.moe_intermediate, cfg.top_k


@pytest.mark.parametrize("name", ["qwen3-30b-a3b", "qwen3-235b-a22b", "deepseek-v3", "kimi-k2",
                                  "qwen3-moe-test", "deepseek-v3-test"])
def test_grouped_prefill_choice_per_config(name):
    """Every MoE config: a 16-slot decode step takes the decode kernel; a
    3072-token prefill takes the prefill kernel wherever its widths suit
    it (the test configs' narrow widths never do); the switch lies at
    ``PREFILL_ROWS_PER_EXPERT`` rows an expert on average."""
    n_exp, E, F, k = _moe_widths(name)
    fits = tmoe_ops.prefill_shapes_ok(E, F, n_exp)
    assert fits == (E % 128 == 0 and F % 64 == 0)
    assert not tmoe_ops.grouped_prefill(16 * k, n_exp, E, F)
    assert tmoe_ops.grouped_prefill(3072 * k, n_exp, E, F) == fits
    cross = tmoe_ops.PREFILL_ROWS_PER_EXPERT * n_exp
    assert not tmoe_ops.grouped_prefill(cross - 1, n_exp, E, F)
    assert tmoe_ops.grouped_prefill(cross, n_exp, E, F) == fits


def test_grouped_prefill_choice_refuses_what_the_kernel_cannot_take():
    """Widths the prefill kernel's tiles do not divide, and more experts
    than its tile table holds, stay on the decode kernel at any size."""
    S = 1 << 20
    assert tmoe_ops.grouped_prefill(S, 128, 2048, 768)
    assert not tmoe_ops.grouped_prefill(S, 128, 2048 + 64, 768)      # E % 128
    assert not tmoe_ops.grouped_prefill(S, 128, 2048, 768 + 32)      # F % 64
    assert tmoe_ops.grouped_prefill(S, 1024, 2048, 768)
    assert not tmoe_ops.grouped_prefill(S, 1025, 2048, 768)          # the tile table


# ------------------------------------------------------------------- B7

@pytest.mark.parametrize("layer", [0, 1])
def test_fused_out_router_plain_matches_jax_kernel(layer):
    """B7 at a 128-aligned shape (E=128, H·D=256, NE=8, L=2)."""
    rng = np.random.default_rng(4)
    B, E, HD, NE, L = 3, 128, 256, 8, 2
    a, x = _np(rng, B, HD, dtype=BF16), _np(rng, B, E, dtype=BF16)
    wo = _np(rng, L, HD, E, scale=HD ** -0.5, dtype=BF16)
    ln = (1 + _np(rng, L, E, scale=0.1)).astype(BF16)
    router = _np(rng, L, E, NE, scale=E ** -0.5, dtype=BF16)
    want = jfused.fused_out_router_stacked(
        *(jnp.asarray(v) for v in (a, x, wo, ln, router)), jnp.int32(layer),
        eps=1e-6, interpret=True)
    args = (_t(a), _t(x), _t(wo), _t(ln), _t(router), layer)
    got = tfused.fused_out_router_stacked(*args, eps=1e-6)    # CPU → plain version
    plain = tfused.fused_out_router_stacked_plain(*args, eps=1e-6)
    for g, p, w, dt in zip(got, plain, want, (torch.bfloat16, torch.bfloat16,
                                              torch.float32)):
        assert g.dtype == dt and tuple(g.shape) == w.shape
        assert torch.equal(g, p)
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ model

def _moe_params(jcfg, packed=False):
    jp = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    if packed:
        jp = jpack(jp)
    return jp, tweights.params_from_jax(jax.tree.map(np.asarray, jp))


def _cfgs(dtype="bfloat16", **kw):
    j = dataclasses.replace(jmoe.QWEN3_MOE_CONFIGS[CFG], dtype=dtype, **kw)
    t = dataclasses.replace(tmoe.QWEN3_MOE_CONFIGS[CFG], dtype=dtype, **kw)
    return j, t


def test_moe_configs_equal_jax_fields():
    assert set(tmoe.QWEN3_MOE_CONFIGS) == set(jmoe.QWEN3_MOE_CONFIGS)
    for name, jcfg in jmoe.QWEN3_MOE_CONFIGS.items():
        assert dataclasses.asdict(tmoe.QWEN3_MOE_CONFIGS[name]) == dataclasses.asdict(jcfg)
    assert ([f.name for f in dataclasses.fields(tmoe.Qwen3MoeConfig)]
            == [f.name for f in dataclasses.fields(jmoe.Qwen3MoeConfig)])
    assert tregistry.get_model("qwen3-30b-a3b").forward is tmoe.forward


@pytest.mark.parametrize("moe_impl", ["ragged", "capacity"])
def test_no_cache_forward_matches_jax(moe_impl):
    jcfg, tcfg = _cfgs(moe_impl=moe_impl, capacity_factor=8.0)
    jp, tp = _moe_params(jcfg)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want, _ = jmoe.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos))
    got, cache = tmoe.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=FWD_TOL, atol=FWD_TOL)


def _serving_step(jfwd, tfwd, jk, jv, tk, tv, table, tokens, positions, seq_lens,
                  logits_idx=None, **kw):
    """One serving forward in both packages; logits and pools must agree.
    Returns JAX's pools and the port's logits."""
    jl, (jk, jv) = jfwd(
        jnp.asarray(tokens), jnp.asarray(positions), k_pages=jk, v_pages=jv,
        page_table=jnp.asarray(table), seq_lens=jnp.asarray(seq_lens),
        logits_indices=None if logits_idx is None else jnp.asarray(logits_idx), **kw)
    tl, _ = tfwd(
        torch.from_numpy(tokens), torch.from_numpy(positions), k_pages=tk, v_pages=tv,
        page_table=torch.from_numpy(table), seq_lens=torch.from_numpy(seq_lens),
        logits_indices=None if logits_idx is None else torch.from_numpy(logits_idx), **kw)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(_f32(tk), _f32(jk), rtol=FWD_TOL, atol=FWD_TOL)
    return jk, jv, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_forwards_match_jax(dtype):
    """``qwen3-moe-test`` through ``params_from_jax``: fresh prefill →
    re-prefill over the cached prefix → three T=1 paged decode steps (one
    row inactive on the last), on packed weights; logits and pools agree."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _moe_params(jcfg, packed=True)
    L, Kh, D = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jk, jv = jkv.init_kv_pages(L, 16, 4, Kh, D, jcfg.jnp_dtype)
    tk, tv = tkv.init_kv_pages(L, 16, 4, Kh, D, tcfg.torch_dtype)
    table = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)

    def jfwd(*a, **kw):
        return jmoe.forward(jp, jcfg, *a, **kw)

    def tfwd(*a, **kw):
        return tmoe.forward(tp, tcfg, *a, **kw)

    def step(*a, **kw):
        nonlocal jk, jv
        jk, jv, _ = _serving_step(jfwd, tfwd, jk, jv, tk, tv, table, *a, **kw)

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
        step(toks[:, 13 + i:14 + i].astype(np.int32), pos,
             (lens + active).astype(np.int32))
        lens = lens + active


def test_fused_decode_matches_jax():
    """The fused T=1 layer (B3 → attention → B7 → experts on hn with B7's
    router logits) on the 128-aligned config, against JAX's fused decode
    (its Pallas kernels in interpret mode) and against the port's own
    unfused decode."""
    jcfg = jmoe.Qwen3MoeConfig(**ALIGNED)
    tcfg = tmoe.Qwen3MoeConfig(**ALIGNED)
    jp, tp = _moe_params(jcfg, packed=True)
    B, ctx = 4, 5
    L, Kh, D = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jk, jv = jkv.init_kv_pages(L, 16, 8, Kh, D)
    tk, tv = tkv.init_kv_pages(L, 16, 8, Kh, D, torch.bfloat16)
    table = np.array([[1 + 2 * b, 2 + 2 * b] for b in range(B)], np.int32)
    rng = np.random.default_rng(7)

    def jfwd(*a, **kw):
        return jmoe.forward(jp, jcfg, *a, **kw)

    def tfwd(*a, **kw):
        return tmoe.forward(tp, tcfg, *a, **kw)

    ptoks = rng.integers(0, jcfg.vocab_size, (B, ctx)).astype(np.int32)
    ppos = np.tile(np.arange(ctx, dtype=np.int32), (B, 1))
    jk, jv, _ = _serving_step(jfwd, tfwd, jk, jv, tk, tv, table, ptoks, ppos,
                              np.full((B,), ctx, np.int32))
    tok = np.array([[7], [9], [11], [13]], np.int32)
    pos = np.full((B, 1), ctx, np.int32)
    lens = np.full((B,), ctx + 1, np.int32)
    # a copy of the prefilled pools (with the spare row of init_kv_pages)
    ck, cv = tkv.init_kv_pages(L, 16, 8, Kh, D, torch.bfloat16)
    ck.copy_(tk)
    cv.copy_(tv)
    _, _, fused = _serving_step(jfwd, tfwd, jk, jv, tk, tv, table, tok, pos, lens,
                                fused_decode=True)
    plain, _ = tfwd(torch.from_numpy(tok), torch.from_numpy(pos), k_pages=ck, v_pages=cv,
                    page_table=torch.from_numpy(table), seq_lens=torch.from_numpy(lens))
    # tests/test_moe.py:157-159's bound for fused against unfused
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=0.08, atol=0.08)


def test_golden_logits_through_port_converter():
    """The in-repo HF checkpoint through the port's reader and
    ``convert_qwen3_moe``, against HuggingFace's float32 logits — the JAX
    suite's bounds (tests/test_weights.py:410-414)."""
    cfg = tmoe.QWEN3_MOE_CONFIGS[CFG]
    params = tweights.convert_qwen3_moe(tweights._load_safetensors_dir(GOLDEN), cfg)
    # experts arrive packed, gate first, as the engine serves them
    assert tuple(params["layers"]["w_gateup"].shape) == (
        cfg.n_layers, cfg.n_experts, cfg.hidden, 2 * cfg.moe_intermediate)
    assert "w_gate" not in params["layers"] and "w_up" not in params["layers"]
    with open(os.path.join(GOLDEN, "meta.json")) as f:
        ids = torch.tensor([json.load(f)["input_ids"]])
    pos = torch.arange(ids.shape[1])[None]
    logits, _ = tmoe.forward(params, cfg, ids, pos)
    ours = logits[0].numpy()
    expected = np.load(os.path.join(GOLDEN, "expected_logits.npy"))
    err = np.abs(ours - expected)
    assert err.max() < 0.2, err.max()
    assert err.mean() < 0.01, err.mean()
    assert (ours.argmax(-1) == expected.argmax(-1)).mean() >= 0.9
    # the loader dispatches on the family
    loaded, name = tweights.load_or_init_params(CFG, GOLDEN)
    assert name == CFG and torch.equal(loaded["layers"]["router"],
                                       params["layers"]["router"])


def test_random_init_tree_matches_jax_packed_tree():
    """The port's random init is drawn in the packed layout: the keys,
    shapes and dtypes of JAX's packed ``fast_random_params`` tree, and the
    same scale (normal·fan_in^-½); packing it again hands every tensor back
    untouched."""
    want = jax.tree.map(np.asarray, jpack(fast_random_params(CFG, seed=0)))
    cfg = tmoe.QWEN3_MOE_CONFIGS[CFG]
    got = tweights.random_params(cfg, seed=0)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = {path: leaf for path, leaf in jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda v: isinstance(v, torch.Tensor))}
    assert set(map(str, flat_g)) == set(map(str, flat_w))
    for path, leaf in flat_w.items():
        g = flat_g[path]
        assert tuple(g.shape) == leaf.shape and g.dtype == torch.bfloat16, path
        if leaf.ndim >= 2:
            np.testing.assert_allclose(float(g.float().std()),
                                       float(leaf.astype(np.float32).std()), rtol=0.1)
    packed = tweights.pack_matmul_params(got)
    assert all(packed["layers"][k] is t for k, t in got["layers"].items())


def test_plain_experts_reference_bypasses_the_kernel_wrappers():
    """``plain_experts=True`` (the reference ``chip_smoke.py`` holds the
    serving logits to) runs the expert FFN without the grouped wrappers and
    gives the wrappers' own result."""
    jcfg, tcfg = _cfgs()
    _, tp = _moe_params(jcfg, packed=True)
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 7)))
    pos = torch.arange(7).repeat(2, 1)
    tmoe_ops.grouped_gateup.launches = tmoe_ops.grouped_down.launches = 0
    ref, _ = tmoe.forward(tp, tcfg, ids, pos, plain_experts=True)
    assert tmoe_ops.grouped_gateup.launches == tmoe_ops.grouped_down.launches == 0
    got, _ = tmoe.forward(tp, tcfg, ids, pos)
    assert torch.equal(ref, got)


# ----------------------------------------------------------------- engines

NAME = "qwen3-moe-torch-parity"


def _greedy(ids, n):
    return dict(prompt_ids=[int(i) for i in ids], max_tokens=n, temperature=0.0,
                top_k=0, top_p=1.0, min_p=0.0, repetition_penalty=1.0)


def _engine_pair(**kw):
    """JAX and torch engines on the same float32 ``qwen3-moe-test`` params,
    ``layer_fusion=False`` on both sides (JAX's B7 cannot tile E=64)."""
    jcfg, tcfg = _cfgs("float32")
    jregistry.register(NAME, jcfg, jmoe.init_params, jmoe.forward,
                       lambda: jmoe.logical_axes(jcfg))
    tregistry.register(NAME, tcfg, tmoe.forward)
    jp, tp = _moe_params(jcfg)
    tok = ByteTokenizer()
    common = dict(max_slots=4, max_seq_len=128, decode_chunk_len=4, seed=0,
                  layer_fusion=False, **kw)
    return (jengine.Engine(NAME, tok, params=jp, **common),
            tengine.Engine(NAME, tok, params=tp, device="cpu", **common))


@pytest.mark.parametrize("kw", [dict(page_size=4, n_pages=128),
                                dict(cache_mode="slot", attn_impl="pallas")],
                         ids=["paged", "slot"])
def test_engine_greedy_streams_match_jax(kw):
    """Three concurrent requests, then a follow-up that extends the first
    conversation: a prefix-cache hit (paged) or a parked-row re-entry (slot)."""
    je, te = _engine_pair(**kw)
    try:
        rng = np.random.default_rng(8)
        first = rng.integers(0, 256, 21)
        reqs = [_greedy(first, 8)] + [_greedy(rng.integers(0, 256, n), 12) for n in (9, 30)]
        out = []
        for mod, eng in ((jengine, je), (tengine, te)):
            futs = eng.submit_many([mod.GenerationRequest(**r) for r in reqs])
            res = [f.result(timeout=300) for f in futs]
            follow = list(first) + res[0].token_ids + list(range(60, 66))
            res.append(eng.generate(mod.GenerationRequest(**_greedy(follow, 8))))
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
