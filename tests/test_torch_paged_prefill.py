"""K2's paged mode (``ops/flash_attention.flash_attention_paged``) against
the JAX package's re-prefill, on the CPU.

(a) ``flash_attention_paged_plain`` against JAX's ``prefix_chunk_attention``
    (``ops/attention.py:167``): seeded numpy inputs; JAX reads the gathered
    prefix before the chunk's write and the chunk's keys from registers,
    the port the pages after the write. A chunk starting at 0, mid-page
    and at a page boundary; B = 3 rows: a full chunk, one with tail
    padding, and a whole padding row; G in {1, 2, 4, 5} (5: qwen3-14b's
    40 / 8 heads); ps in {4, 8}; and the slot layout (one page of
    ``max_seq_len`` keys a row). Valid query
    rows compare at 1e-5 in float32 and rtol 5e-2 / atol 2e-2 in bf16.
    The padding row is 0 (JAX averages stale values there), a tail-padding
    query sees the cached prefix (0 where there is none).
(b) Engines with ``attn_impl="pallas"`` (the JAX Pallas kernels in
    interpret mode, the port's wrappers on their plain versions) on the
    golden ``qwen3-test`` / ``qwen3-moe-test`` checkpoints: greedy streams
    equal JAX's after a paged multi-turn prefix hit, a slot park hit, on
    Qwen3-MoE in bf16, and for the int8 Qwen3-MoE burst of three whose
    expert capacity counts the group's padding rows.
(c) The wrapper's refusals (meta tensors: no kernel is reached).
"""
import dataclasses
import os
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine import weights as jweights
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.models import qwen3_moe as jmoe
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.ops import attention as jattn
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine.weights import params_from_jax
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.models import qwen3_moe as tmoe
from deepsearch_tts_tpu_torch.models import registry as tregistry
from deepsearch_tts_tpu_torch.ops import attention as tattn
from deepsearch_tts_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=2e-2)
K, D, T = 2, 16, 7


# ------------------------------------------------- (a) the plain version

def _case(G, ps, cs, dtype, slot=False, seed=0):
    """Pools of stale values, each row's pages, a chunk of T queries from
    ``cs``: row 0 full, row 1 with two tail-padding queries, row 2 padding.
    Returns the JAX output (prefix read before the write) and the port's
    (the pages after the write), both float32 numpy, and the positions."""
    rng = np.random.default_rng(seed)
    B, H = 3, K * G
    if slot:   # a slot row is one page of max_seq_len keys, the identity table
        P, N, ps = 1, B, 32
        table = np.arange(B)[:, None]
    else:
        P = -(-(cs + T) // ps) + 1
        N = 1 + B * P
        table = 1 + rng.permutation(N - 1)[: B * P].reshape(B, P)
    kp, vp = (rng.standard_normal((N, ps, K, D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, T, K, D)).astype(np.float32) for _ in range(2))
    valid = [T, T - 2, 0]
    pos = np.full((B, T), -1, np.int64)
    for b, n in enumerate(valid):
        pos[b, :n] = cs + np.arange(n)
    seq = np.array([cs + n if n else 0 for n in valid], np.int64)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rnd = (lambda x: x) if dtype == torch.float32 else (
        lambda x: np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)))
    kp, vp, q, kn, vn = map(rnd, (kp, vp, q, kn, vn))

    S = P * ps
    k_old = kp[table].reshape(B, S, K, D)
    v_old = vp[table].reshape(B, S, K, D)
    want = jattn.prefix_chunk_attention(
        *(jnp.asarray(x, jd) for x in (q, k_old, v_old, kn, vn)),
        jnp.asarray(pos[:, 0], jnp.int32), jnp.asarray(pos, jnp.int32))
    # the chunk's write: valid positions only (padding writes are dropped)
    kw, vw = kp.copy(), vp.copy()
    for b in range(B):
        for t in range(T):
            p = pos[b, t]
            if p >= 0:
                kw[table[b, p // ps], p % ps] = kn[b, t]
                vw[table[b, p // ps], p % ps] = vn[b, t]
    got = tfa.flash_attention_paged(
        *(torch.from_numpy(x).to(dtype) for x in (q, kw, vw)), torch.from_numpy(table),
        torch.from_numpy(seq), torch.from_numpy(pos))
    return np.asarray(jnp.asarray(want, jnp.float32)), got.float().numpy(), pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("where", ["start", "mid_page", "page_boundary"])
@pytest.mark.parametrize("G", [1, 2, 4, 5])
def test_plain_matches_prefix_chunk_attention(G, where, ps, dtype):
    cs = {"start": 0, "mid_page": 2 * ps + ps // 2 + 1, "page_boundary": 2 * ps}[where]
    want, got, pos = _case(G, ps, cs, dtype, seed=G * 100 + ps + cs)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    valid = pos >= 0
    np.testing.assert_allclose(got[valid], want[valid], **tol)
    assert not got[2].any()                          # the whole padding row
    if cs == 0:
        assert not got[1, T - 2:].any()              # tail padding, no prefix


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 4, 5])
def test_plain_matches_prefix_chunk_attention_slot_layout(G, dtype):
    want, got, pos = _case(G, 0, 9, dtype, slot=True, seed=G)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got[pos >= 0], want[pos >= 0], **tol)
    assert not got[2].any()


def test_tail_padding_sees_the_cached_prefix():
    """A tail-padding query of a row with a cached prefix attends exactly
    the prefix, as JAX's old-key mask has it (JAX's value there is the
    same softmax: its chunk part is all masked)."""
    want, got, pos = _case(2, 4, 10, torch.float32, seed=3)
    np.testing.assert_allclose(got[1, T - 2:], want[1, T - 2:], **F32_TOL)


def test_key_limits():
    pos = torch.tensor([[5, 6, 7, -1], [0, 1, -1, -1], [-1, -1, -1, -1], [3, 4, 5, 6]])
    seq = torch.tensor([8, 2, 0, 6])
    lim = tfa.paged_key_limits(seq, pos, S=16)
    assert lim.tolist() == [[6, 7, 8, 5], [1, 2, 0, 0], [0, 0, 0, 0], [4, 5, 6, 6]]
    assert tfa.paged_key_limits(seq, pos, S=5)[0].tolist() == [5, 5, 5, 5]


def test_plain_gathers_and_counts_no_launch(monkeypatch):
    """On the CPU the wrapper is its plain version: the gather runs (once
    for the keys, once for the values), the kernel's launch counter does
    not move."""
    tables = []

    def gather(pool, table):
        tables.append(table)
        return tattn.gather_kv_rows(pool, table)

    monkeypatch.setattr(tfa, "gather_kv_rows", gather)
    n0 = tfa.flash_attention_paged.launches
    _case(1, 4, 0, torch.float32)
    assert tfa.flash_attention_paged.launches == n0
    assert len(tables) == 2


# ------------------------------------------------------------ (c) refusals

def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("ps,D_,G,match", [(12, 128, 4, "ps"), (100, 128, 4, "ps"),
                                           (64, 64, 4, "head_dim"), (64, 128, 129, "head_dim")])
def test_wrapper_refuses_what_the_kernel_cannot_take(ps, D_, G, match):
    B, P = 2, 3
    q = _meta(B, 5, 2 * G, D_)
    pool = _meta(1 + B * P, ps, 2, D_)
    idx = _meta(B, P, dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_paged(q, pool, pool, idx, _meta(B, dtype=torch.int64),
                                  _meta(B, 5, dtype=torch.int64))


@pytest.mark.parametrize("ps,pages,want", [
    (64, 3, True), (48, 3, True), (24, 3, True), (16, 3, True), (8, 3, True),
    (12, 3, False), (4, 3, False), (100, 3, False),
    (100, 1, True), (3000, 1, True), (4, 1, True)])
def test_page_sizes_the_kernel_takes(ps, pages, want):
    """Boxes of 64, 32, 16 or 8 keys each lie in one page where ps is a
    multiple of 8; a row of one page (a slot row) takes any length."""
    assert tfa.paged_pages_ok(ps, pages) is want


# ------------------------------------------------------------- (b) engines

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
MODELS = {"dense": ("qwen3-test", jqwen3, tqwen3, jqwen3.QWEN3_CONFIGS, tqwen3.QWEN3_CONFIGS,
                    jweights.convert_qwen3_dense),
          "moe": ("qwen3-moe-test", jmoe, tmoe, jmoe.QWEN3_MOE_CONFIGS,
                  tmoe.QWEN3_MOE_CONFIGS, jweights.convert_qwen3_moe)}
KW = dict(max_slots=4, page_size=4, n_pages=96, max_seq_len=64, decode_chunk_len=4, seed=0,
          attn_impl="pallas")


def _golden(kind: str, dtype: str):
    """The golden checkpoint of ``kind`` registered under a name of its own
    at ``dtype`` in both packages: (name, JAX params, port params)."""
    base, jm, tm, jcfgs, tcfgs, convert = MODELS[kind]
    name = f"{base}-paged-prefill-{dtype}"
    jcfg = dataclasses.replace(jcfgs[base], dtype=dtype)
    tcfg = dataclasses.replace(tcfgs[base], dtype=dtype)
    jregistry.register(name, jcfg, jm.init_params, jm.forward,
                       lambda: jm.logical_axes(jcfg))
    tregistry.register(name, tcfg, tm.forward)
    raw = jweights._load_safetensors_dir(os.path.join(GOLDEN, base))
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.dtype(dtype)), convert(raw, jcfg))
    return name, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _greedy(mod, ids, n):
    return mod.GenerationRequest(prompt_ids=[int(i) for i in ids], max_tokens=n,
                                 temperature=0.0, top_k=0, top_p=1.0, min_p=0.0,
                                 repetition_penalty=1.0)


def _serve(engines, prompts, n):
    """Each engine's results for ``prompts`` submitted together."""
    out = []
    for mod, eng in zip((jengine, tengine), engines):
        futs = eng.submit_many([_greedy(mod, p, n) for p in prompts])
        out.append([f.result(timeout=600) for f in futs])
    return out


def _same(jres, tres):
    for j, t in zip(jres, tres):
        assert t.token_ids == j.token_ids
        assert (t.prompt_tokens, t.cached_prompt_tokens) == (j.prompt_tokens,
                                                             j.cached_prompt_tokens)


@pytest.fixture
def routed(monkeypatch):
    """Counts the port's calls of K2's paged mode (its plain version on the
    CPU); ``prefix_chunk_attention`` must not run."""
    calls = []
    plain = tfa.flash_attention_paged_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    def refused(*a, **k):
        raise AssertionError("re-prefill took prefix_chunk_attention")

    monkeypatch.setattr(tfa, "flash_attention_paged_plain", counted)
    monkeypatch.setattr(tattn, "prefix_chunk_attention", refused)
    return calls


def _pair(name, jp, tp, **kw):
    tok = ByteTokenizer()
    je = jengine.Engine(name, tok, params=jp, **kw)
    te = tengine.Engine(name, tok, params=tp, device="cpu", **kw)
    assert je.attn_impl == te.attn_impl == "pallas"
    return je, te


def _two_turns(engines, rng):
    """A first turn, then a follow-up that extends it: the second prefill
    runs over the cached (paged) or parked (slot) prefix."""
    first = list(rng.integers(0, 250, 21))
    jres, tres = _serve(engines, [first], 8)
    _same(jres, tres)
    follow = first + tres[0].token_ids + list(rng.integers(0, 250, 6))
    jres, tres = _serve(engines, [follow], 8)
    _same(jres, tres)
    assert len(tres[0].token_ids) == 8
    return tres[0]


@pytest.mark.parametrize("mode", ["paged", "slot"])
def test_prefix_hit_streams_match_jax(mode, routed):
    name, jp, tp = _golden("dense", "float32")
    engines = _pair(name, jp, tp, **dict(KW, **({"cache_mode": "slot"} if mode == "slot"
                                               else {})))
    try:
        res = _two_turns(engines, np.random.default_rng(0))
        assert res.cached_prompt_tokens > 0
        n_layers = engines[1].cfg.n_layers
        assert len(routed) == 2 * n_layers, len(routed)   # both turns' prefills
        if mode == "slot":
            assert [e.stats["slot_park_hits"] for e in engines] == [1, 1]
    finally:
        for e in engines:
            e.shutdown()


def test_moe_bf16_streams_match_jax(routed):
    name, jp, tp = _golden("moe", "bfloat16")
    engines = _pair(name, jp, tp, **KW)
    try:
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 250, n) for n in (9, 14)]
        _same(*_serve(engines, prompts, 6))
        res = _two_turns(engines, rng)
        assert res.cached_prompt_tokens > 0 and routed
    finally:
        for e in engines:
            e.shutdown()


def test_int8_moe_burst_of_three_matches_jax(routed):
    """Expert capacity counts the group's padding rows (3 prompts padded to
    4 rows, one with a tail-padding query): their attention output reaches
    the router. K2's paged mode gives a padding row 0 where JAX averages
    stale values; the streams still equal JAX's."""
    name, jp, tp = _golden("moe", "float32")
    kw = dict(KW, max_slots=8, quantize="int8")
    prompts = [[5] * 16, [9] * 15, [5] * 16]
    je = jengine.Engine(name, ByteTokenizer(), params=jp, pack_weights=False, **kw)
    try:
        futs = je.submit_many([_greedy(jengine, p, 6) for p in prompts])
        want = [f.result(timeout=600).token_ids for f in futs]
    finally:
        je.shutdown()
    te = tengine.Engine(name, ByteTokenizer(), params=tp, device="cpu", **kw)
    assert te.attn_impl == "pallas"
    # one admission group: queued as one batch, the scheduler driven by hand
    futs = [Future() for _ in prompts]
    te._queue.put(list(zip([_greedy(tengine, p, 6) for p in prompts], futs)))
    for _ in range(200):
        if all(f.done() for f in futs):
            break
        te._admit()
        te._decode_chunk()
    assert [f.result(timeout=0).token_ids for f in futs] == want
    assert te.stats["prefill_group_hist"] == {"16x3": 1}
    assert len(routed) == te.cfg.n_layers
