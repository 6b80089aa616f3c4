"""The port's slot cache and Pallas-attention engines against the JAX
engines, on the CPU.

Both packages run the same float32 ``qwen3-test`` params (converted with
``params_from_jax``), fused decode layers on and ``max_seq_len=128`` (as
``tests/test_engine_sharded.py:78-80`` runs the JAX slot engine). The JAX
Pallas kernels run in interpret mode, the port's wrappers their plain
versions (CPU tensors). Greedy token streams must be exactly equal: the
slot engine with parking and ``attn_impl="pallas"`` (B1 decode), without
parking (fresh prefill through B2), and the paged engine with each B6 entry
point. Also the slot forward itself against JAX's, logits at the model
tolerance of ``tests/test_torch_model.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.engine.weights import pack_matmul_params as jpack
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.engine.weights import params_from_jax
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.models import registry as tregistry

torch.set_num_threads(1)

NAME = "qwen3-torch-slot-parity"
SLOT_KW = dict(max_slots=4, max_seq_len=128, decode_chunk_len=4, seed=0,
               layer_fusion=True, cache_mode="slot", attn_impl="pallas")
PAGED_KW = dict(max_slots=4, page_size=4, n_pages=128, max_seq_len=128,
                decode_chunk_len=4, seed=0, layer_fusion=True)
# the float32 forward: both packages round each layer matmul to bf16 at the
# same points (tests/test_torch_model.py TOL)
LOGITS_TOL = 5e-2


def _register():
    jcfg = dataclasses.replace(jqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    tcfg = dataclasses.replace(tqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    jregistry.register(NAME, jcfg, jqwen3.init_params, jqwen3.forward,
                       lambda: jqwen3.logical_axes(jcfg))
    tregistry.register(NAME, tcfg, tqwen3.forward)
    jp = jqwen3.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _engine_pair(**kw):
    _, _, jp, tp = _register()
    tok = ByteTokenizer()
    je = jengine.Engine(NAME, tok, params=jp, **kw)
    te = tengine.Engine(NAME, tok, params=tp, device="cpu", **kw)
    assert je.layer_fusion and te.layer_fusion
    assert je.attn_impl == te.attn_impl == kw.get("attn_impl", "xla")
    return je, te


def _greedy(ids, n, **kw):
    return dict(prompt_ids=[int(i) for i in ids], max_tokens=n, temperature=0.0,
                top_k=0, top_p=1.0, min_p=0.0, repetition_penalty=1.0, **kw)


def _both(engines, reqs):
    out = []
    for mod, eng in zip((jengine, tengine), engines):
        futs = eng.submit_many([mod.GenerationRequest(**r) for r in reqs])
        out.append([f.result(timeout=300) for f in futs])
    return out


def _same(jres, tres, min_len=8):
    for j, t in zip(jres, tres):
        assert len(t.token_ids) >= min_len        # long enough to diverge
        assert t.token_ids == j.token_ids
        assert (t.finish_reason, t.prompt_tokens, t.completion_tokens,
                t.cached_prompt_tokens) == (j.finish_reason, j.prompt_tokens,
                                            j.completion_tokens, j.cached_prompt_tokens)


@pytest.fixture(scope="module")
def slot_engines():
    je, te = _engine_pair(**SLOT_KW)
    assert te.cache_mode == "slot" and te.prefix_cache is None and te._slot_park
    yield je, te
    je.shutdown()
    te.shutdown()


def test_slot_concurrent_greedy_streams_match_jax(slot_engines):
    rng = np.random.default_rng(0)
    reqs = [_greedy(rng.integers(0, 256, n), 16) for n in (9, 17, 30)]
    _same(*_both(slot_engines, reqs))


def test_slot_park_hit_matches_jax(slot_engines):
    """A follow-up that extends a finished conversation re-enters its
    parked row and prefills only the rest."""
    rng = np.random.default_rng(1)
    first = list(rng.integers(0, 256, 21))
    jres, tres = _both(slot_engines, [_greedy(first, 8)])
    _same(jres, tres)
    hits = [e.stats["slot_park_hits"] for e in slot_engines]
    follow = first + tres[0].token_ids + list(rng.integers(0, 256, 6))
    jres, tres = _both(slot_engines, [_greedy(follow, 8)])
    _same(jres, tres)
    # the parked row's KV is usable up to its last fed token
    assert tres[0].cached_prompt_tokens == len(first) + 8 - 1
    assert [e.stats["slot_park_hits"] - h for e, h in zip(slot_engines, hits)] == [1, 1]


def test_slot_min_tokens_matches_jax(slot_engines):
    """EOS is made the greedy first token of this prompt, so an unforced
    request stops at once and a forced one must run past min_tokens."""
    je, te = slot_engines
    prompt = list(range(70, 90))
    eos = te.generate(tengine.GenerationRequest(**_greedy(prompt, 1))).token_ids[0]
    tok = ByteTokenizer()
    tok.eos_id = eos
    saved = je.tokenizer
    je.tokenizer = te.tokenizer = tok
    je._decode_fn_cache.clear()   # the JAX programs bake eos_id in
    je._jit_cache.clear()
    try:
        jres, tres = _both(slot_engines, [_greedy(prompt, 12),
                                          _greedy(prompt, 12, min_tokens=6)])
    finally:
        je.tokenizer = te.tokenizer = saved
        je._decode_fn_cache.clear()
        je._jit_cache.clear()
    free, forced = tres
    assert free.finish_reason == "stop" and free.completion_tokens == 1
    assert forced.completion_tokens >= 6 and eos not in forced.token_ids[:5]
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]


def test_slot_stream_crosses_context_bucket(slot_engines):
    """A 60-token prompt decoding 40 tokens reads the 64-wide bucket, then
    the 96-wide one (``context_buckets="fine"``, JAX's default, puts 96
    between 64 and 128)."""
    prompt = [(7 * i) % 256 for i in range(60)]
    jres, tres = _both(slot_engines, [_greedy(prompt, 40)])
    _same(jres, tres, min_len=30)
    assert slot_engines[1]._slot_bucket(60 + 4 + 1) == 96
    assert slot_engines[1]._slot_bucket(17) == 64


def test_slot_fresh_prefill_engine_matches_jax():
    """Without parking every group takes fresh causal prefill, which
    ``attn_impl="pallas"`` sends through flash attention (B2)."""
    je, te = _engine_pair(**SLOT_KW, enable_prefix_cache=False)
    try:
        assert not te._slot_park and te.fresh_prefill
        rng = np.random.default_rng(2)
        reqs = [_greedy(rng.integers(0, 256, n), 12) for n in (5, 23)]
        _same(*_both((je, te), reqs))
    finally:
        je.shutdown()
        te.shutdown()


@pytest.mark.parametrize("impl", ["pallas", "pallas2", "clamp"])
def test_paged_pallas_engines_match_jax(impl):
    """The paged engine's T=1 decode through each B6 entry point."""
    je, te = _engine_pair(**PAGED_KW, attn_impl=impl)
    try:
        rng = np.random.default_rng(3)
        reqs = [_greedy(rng.integers(0, 256, n), 12) for n in (7, 26)]
        _same(*_both((je, te), reqs))
    finally:
        je.shutdown()
        te.shutdown()


def test_slot_forwards_match_jax():
    """The slot path of ``forward`` in both packages on the same packed
    params and slot pools: a padded prefill of rows 0 and 2 (fresh, flash),
    then three fused slot-decode steps through ``slot_attention`` with one
    row inactive; logits and the written pools agree."""
    jcfg, tcfg, jp, _ = _register()
    jp = jpack(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    L, Kh, D = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    N, S = 3, 64
    jk, jv = jkv.init_kv_pages(L, N, S, Kh, D, jnp.float32)
    tk, tv = tkv.init_kv_pages(L, N, S, Kh, D, torch.float32)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (N, 24)).astype(np.int32)

    def step(tokens, positions, seq_lens, table=None, logits_idx=None, **kw):
        nonlocal jk, jv
        common = dict(impl="pallas", **kw)
        jl, (jk, jv) = jqwen3.forward(
            jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), k_pages=jk,
            v_pages=jv, page_table=None if table is None else jnp.asarray(table),
            seq_lens=jnp.asarray(seq_lens),
            logits_indices=None if logits_idx is None else jnp.asarray(logits_idx),
            **common)
        tl, _ = tqwen3.forward(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
            k_pages=tk, v_pages=tv,
            page_table=None if table is None else torch.from_numpy(table),
            seq_lens=torch.from_numpy(seq_lens),
            logits_indices=None if logits_idx is None else torch.from_numpy(logits_idx),
            **common)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)

    lens = np.array([10, 7], np.int32)
    tokens = np.zeros((2, 16), np.int32)
    positions = np.full((2, 16), -1, np.int32)
    for g, n in enumerate(lens):
        tokens[g, :n] = toks[2 * g, :n]
        positions[g, :n] = np.arange(n)
    step(tokens, positions, lens, table=np.array([[0], [2]], np.int32),
         logits_idx=lens - 1, fresh_prefill=True)
    lens = np.array([10, 0, 7], np.int32)
    active = np.array([True, False, True])
    for i in range(3):
        act = active & (i < 2 or np.arange(N) != 2)
        pos = np.where(act, lens, -1).astype(np.int32)[:, None]
        step(toks[:, 10 + i: 11 + i], pos, (lens + act).astype(np.int32),
             slot_decode=True, slot_ctx=S, fused_decode=True)
        lens = lens + act
