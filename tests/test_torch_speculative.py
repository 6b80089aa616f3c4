"""The port's speculative decoding (n-gram drafts, K+1-token verify windows on
the slot cache, B9) against the JAX package, on the CPU.

* ``ngram_draft`` / ``accept_drafts`` equal JAX's exactly on seeded numpy
  histories;
* ``slot_window_attention_plain`` within rtol 5e-2 / atol 2e-2 of JAX's
  ``slot_window_attention`` in interpret mode (the shapes of
  ``tests/test_kernels.py:179`` and :214, plus inactive rows);
* the slot serving forward over a K+1 window, fused and unfused, ``impl``
  "pallas" and "xla", against JAX's forward (float32 ``qwen3-test``);
* greedy streams of the port's speculative engine exactly equal to JAX's
  (dense fused "pallas" and "xla", Qwen3-MoE, int8 weights);
* the scenarios of ``tests/test_speculative.py`` run on the port, against
  its plain slot engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.engine import speculative as jspec
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from deepsearch_tts_tpu.engine.weights import pack_matmul_params as jpack
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.models import qwen3_moe as jmoe
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.ops import slot_attention as jsa
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.engine import speculative as tspec
from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu_torch.engine.weights import params_from_jax
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.models import qwen3_moe as tmoe
from deepsearch_tts_tpu_torch.models import registry as tregistry
from deepsearch_tts_tpu_torch.ops import slot_attention as tsa

torch.set_num_threads(1)

# bf16 attention against the interpret-mode kernel (tests/test_kernels.py:203)
ATTN_RTOL, ATTN_ATOL = 5e-2, 2e-2
# the float32 forward: both packages round each layer matmul to bf16 at the
# same points (tests/test_torch_slot_engine.py LOGITS_TOL)
LOGITS_TOL = 5e-2
SPEC = dict(speculative="ngram", spec_k=3)
SLOT_KW = dict(max_slots=4, max_seq_len=128, decode_chunk_len=4, seed=0, cache_mode="slot")


# ------------------------------------------------------- drafts and acceptance

def _histories(seed: int, B: int = 12, S: int = 40):
    """Histories over a 4-token alphabet (many matches), one row of distinct
    tokens (no match), lengths from 0 to S - 1."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 4, (B, S)).astype(np.int32)
    hist[1] = np.arange(100, 100 + S)
    lens = rng.integers(0, S, B).astype(np.int32)
    lens[:4] = [0, S - 1, 1, S - 2]
    return hist, lens


@pytest.mark.parametrize("n,k", [(1, 3), (2, 3), (3, 4), (2, 1), (2, 6)])
def test_ngram_draft_matches_jax(n, k):
    for seed in range(3):
        hist, lens = _histories(seed)
        want = np.asarray(jspec.ngram_draft(jnp.asarray(hist), jnp.asarray(lens), k, n=n))
        got = tspec.ngram_draft(torch.from_numpy(hist).long(), torch.from_numpy(lens), k, n=n)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hist,lens,k,want", [
    # the most recent earlier (7 8) is at 6-7: continuation 5, 6, 4
    ([3, 7, 8, 9, 1, 2, 7, 8, 5, 6, 4, 7, 8], 12, 3, [5, 6, 4]),
    # no match: the last token repeats
    ([1, 2, 3, 4, 5], 4, 2, [5, 5]),
    # continuation positions 2-5 all <= lens: 9, 1, 7, 8
    ([7, 8, 9, 1, 7, 8], 5, 4, [9, 1, 7, 8]),
    # positions past lens fall back to the last token
    ([7, 8, 9, 7, 8], 4, 4, [9, 7, 8, 8]),
], ids=["recent", "no-match", "to-lens", "clipped"])
def test_ngram_draft_cases_match_jax(hist, lens, k, want):
    h = np.zeros((1, 16), np.int32)
    h[0, :len(hist)] = hist
    l = np.array([lens], np.int32)
    j = np.asarray(jspec.ngram_draft(jnp.asarray(h), jnp.asarray(l), k, n=2))
    t = tspec.ngram_draft(torch.from_numpy(h).long(), torch.from_numpy(l), k, n=2)
    assert j[0].tolist() == t[0].tolist() == want


@pytest.mark.parametrize("K", [1, 3, 7])
def test_accept_drafts_matches_jax(K):
    rng = np.random.default_rng(K)
    B = 32
    sampled = rng.integers(0, 2, (B, K + 1)).astype(np.int32)
    draft = rng.integers(0, 2, (B, K)).astype(np.int32)
    draft[:4] = sampled[:4, :K]          # every draft accepted
    active = rng.random(B) < 0.75
    active[:2] = [True, False]
    j = jspec.accept_drafts(jnp.asarray(sampled), jnp.asarray(draft), jnp.asarray(active))
    t = tspec.accept_drafts(torch.from_numpy(sampled).long(), torch.from_numpy(draft).long(),
                            torch.from_numpy(active))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(t[0][0]) == K + 1 and int(t[0][1]) == 0 and bool(t[2][:, 0].all())


# ------------------------------------------------------------------------ B9

# (L, B, ps, K, G, D, W, slot_ctx, base, shared, scale)
WINDOW_CASES = {
    "gqa": (2, 8, 64, 2, 2, 32, 3, 48, [0, 4, 16, 43, 32, -1, 15, 45], False, None),
    "shared": (2, 4, 32, 1, 6, 48, 4, 32, [0, 7, -1, 28], True, 0.21),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_slot_window_attention_plain_matches_jax(case):
    """Window limits ``min(max(seq, 1), max(base, 0) + 1 + t)``: rows whose
    window crosses a 16-key context block, one ending at ``slot_ctx``, and
    an inactive row (base -1, seq_len 0) that attends one key."""
    L, B, ps, K, G, D, W, slot_ctx, base, shared, scale = WINDOW_CASES[case]
    H = K * G
    rng = np.random.default_rng(13)
    kpf = (rng.standard_normal((L * B, ps, K, D)) * 0.3).astype(np.float32)
    vpf = (rng.standard_normal((L * B, ps, K, D)) * 0.3).astype(np.float32)
    q = (rng.standard_normal((B, W, H, D)) * 0.3).astype(np.float32)
    base = np.asarray(base, np.int32)
    seq_lens = np.where(base >= 0, base + W, 0).astype(np.int32)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)               # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)     # noqa: E731
    for layer in range(L):
        want = jsa.slot_window_attention(
            jb(q), jb(kpf), None if shared else jb(vpf), jnp.asarray(seq_lens),
            jnp.asarray(base), jnp.int32(layer), n_rows=B, slot_ctx=slot_ctx, scale=scale,
            interpret=True)
        got = tsa.slot_window_attention(
            tb(q), tb(kpf), None if shared else tb(vpf), torch.from_numpy(seq_lens),
            torch.from_numpy(base), layer, n_rows=B, slot_ctx=slot_ctx, scale=scale)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=ATTN_RTOL, atol=ATTN_ATOL)
    with pytest.raises(ValueError, match="n_rows"):
        tsa.slot_window_attention(tb(q), tb(kpf), None, torch.from_numpy(seq_lens),
                                  torch.from_numpy(base), 0, n_rows=B + 1, slot_ctx=slot_ctx)


def test_slot_window_attention_plain_at_one_token_is_b1():
    """A one-token window is B1's query: the same limit and result."""
    rng = np.random.default_rng(5)
    B, ps, K, H, D = 4, 32, 2, 4, 16
    kp = torch.from_numpy(rng.standard_normal((2 * B, ps, K, D))).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D))).to(torch.bfloat16)
    seq = torch.tensor([5, 0, 32, 9])
    base = torch.tensor([4, -1, 31, 3])
    got = tsa.slot_window_attention(q, kp, None, seq, base, 1, n_rows=B, slot_ctx=ps)
    want = tsa.slot_attention(q[:, 0], kp, None, torch.minimum(seq, base.clamp(min=0) + 1),
                              1, n_rows=B, slot_ctx=ps)
    assert torch.equal(got[:, 0], want)


# ------------------------------------------------------- the serving forward

def _dense_cfgs():
    return (dataclasses.replace(jqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32"),
            dataclasses.replace(tqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32"))


def _dense_register(name: str):
    """Float32 ``qwen3-test`` under ``name`` in both registries; its JAX
    params."""
    jcfg, tcfg = _dense_cfgs()
    jregistry.register(name, jcfg, jqwen3.init_params, jqwen3.forward,
                       lambda: jqwen3.logical_axes(jcfg))
    tregistry.register(name, tcfg, tqwen3.forward)
    return jqwen3.init_params(jcfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_slot_window_forward_matches_jax(impl, fused):
    """A padded prefill of rows 0 and 2 into 3 slot rows, then two K+1 = 4
    token verify windows with row 1 inactive (positions -1): the logits of
    every window position and the written pools agree with JAX's."""
    jcfg, tcfg = _dense_cfgs()
    jp = jpack(jqwen3.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    L, Kh, D = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    N, S, W = 3, 64, 4
    jk, jv = jkv.init_kv_pages(L, N, S, Kh, D, jnp.float32)
    tk, tv = tkv.init_kv_pages(L, N, S, Kh, D, torch.float32)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (N, 32)).astype(np.int32)

    def step(tokens, positions, seq_lens, **kw):
        nonlocal jk, jv
        jl, (jk, jv) = jqwen3.forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                      k_pages=jk, v_pages=jv, seq_lens=jnp.asarray(seq_lens),
                                      impl=impl, **kw)
        kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        tl, _ = tqwen3.forward(tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
                               k_pages=tk, v_pages=tv, seq_lens=torch.from_numpy(seq_lens),
                               impl=impl, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_TOL, rtol=LOGITS_TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=LOGITS_TOL, rtol=LOGITS_TOL)
        return tl

    lens = np.array([10, 7], np.int32)
    tokens = np.zeros((2, 16), np.int32)
    positions = np.full((2, 16), -1, np.int32)
    for g, n in enumerate(lens):
        tokens[g, :n] = toks[2 * g, :n]
        positions[g, :n] = np.arange(n)
    step(tokens, positions, lens, page_table=np.array([[0], [2]], np.int32),
         logits_indices=lens - 1, fresh_prefill=True)
    lens = np.array([10, 0, 7], np.int32)
    active = np.array([True, False, True])
    for i in range(2):
        pos = np.where(active[:, None], lens[:, None] + np.arange(W), -1).astype(np.int32)
        logits = step(toks[:, 10 + i * W: 10 + (i + 1) * W], pos,
                      (lens + W * active).astype(np.int32), slot_decode=True, slot_ctx=S,
                      fused_decode=fused)
        assert logits.shape == (N, W, jcfg.vocab_size)
        lens = lens + (W - 1) * active       # the last window token was rejected


# -------------------------------------------------------- engines against JAX

def _greedy(ids, n, **kw):
    return dict(prompt_ids=[int(i) for i in ids], max_tokens=n, temperature=0.0,
                top_k=0, top_p=1.0, min_p=0.0, repetition_penalty=1.0, **kw)


def _same_streams(je, te, reqs):
    out = []
    for mod, eng in ((jengine, je), (tengine, te)):
        futs = eng.submit_many([mod.GenerationRequest(**r) for r in reqs])
        out.append([f.result(timeout=300) for f in futs])
    for j, t in zip(*out):
        assert len(t.token_ids) >= 8
        assert t.token_ids == j.token_ids
        assert (t.finish_reason, t.completion_tokens) == (j.finish_reason, j.completion_tokens)
    assert te.telemetry()["spec_tokens_per_step"] > 1.0
    return out


def _int8_register(name: str):
    # head_dim 128: JAX's int8 fused kernels tile it (tests/test_torch_quant.py)
    kw = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=2, n_kv_heads=2,
              head_dim=128, intermediate=256, tie_embeddings=True, dtype="float32")
    jcfg, tcfg = jqwen3.Qwen3Config(**kw), tqwen3.Qwen3Config(**kw)
    jregistry.register(name, jcfg, jqwen3.init_params, jqwen3.forward,
                       lambda: jqwen3.logical_axes(jcfg))
    tregistry.register(name, tcfg, tqwen3.forward)
    return jqwen3.init_params(jcfg, jax.random.PRNGKey(0))


def _moe_register(name: str):
    jcfg = dataclasses.replace(jmoe.QWEN3_MOE_CONFIGS["qwen3-moe-test"], dtype="float32")
    tcfg = dataclasses.replace(tmoe.QWEN3_MOE_CONFIGS["qwen3-moe-test"], dtype="float32")
    jregistry.register(name, jcfg, jmoe.init_params, jmoe.forward,
                       lambda: jmoe.logical_axes(jcfg))
    tregistry.register(name, tcfg, tmoe.forward)
    return jmoe.init_params(jcfg, jax.random.PRNGKey(0))


# name: (register, engine arguments beside SLOT_KW and SPEC)
ENGINE_CASES = {
    "fused-pallas": (_dense_register, dict(layer_fusion=True, attn_impl="pallas")),
    "fused-xla": (_dense_register, dict(layer_fusion=True, attn_impl="xla")),
    # JAX's B7 cannot tile E=64, so both MoE engines run unfused
    # (tests/test_torch_moe.py); the port's window attends through B9
    "moe": (_moe_register, dict(layer_fusion=False, attn_impl="pallas")),
    "int8": (_int8_register, dict(layer_fusion=True, attn_impl="pallas", quantize="int8")),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_spec_engine_greedy_streams_match_jax(case):
    """Three concurrent requests (a cycling prompt, a random one, one long
    enough to cross the 64-wide context bucket): the port's speculative
    engine emits exactly JAX's tokens."""
    register, kw = ENGINE_CASES[case]
    name = f"spec-parity-{case}"
    jp = register(name)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    je = jengine.Engine(name, JByteTokenizer(), params=jp, **SLOT_KW, **SPEC, **kw)
    te = tengine.Engine(name, ByteTokenizer(), params=tp, device="cpu", **SLOT_KW, **SPEC,
                        **kw)
    try:
        assert te.layer_fusion == je.layer_fusion == kw["layer_fusion"]
        rng = np.random.default_rng(6)
        reqs = [_greedy([1, 2, 3, 1, 2, 3, 1, 2], 24), _greedy(rng.integers(0, 250, 9), 16),
                _greedy(rng.integers(0, 250, 40), 32)]
        _same_streams(je, te, reqs)
    finally:
        je.shutdown()
        te.shutdown()


def test_spec_engine_length_finish_matches_jax():
    """A 64-token slot row: each chunk may advance a row by
    ``decode_chunk_len·(spec_k+1)`` = 16 positions, so a row stops being
    stepped, and finishes with "length", 16 positions before the row's end
    (a window position past it would index past the slot row)."""
    name = "spec-parity-length"
    jp = _dense_register(name)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    kw = dict(SLOT_KW, max_seq_len=64, layer_fusion=True, attn_impl="pallas", **SPEC)
    je = jengine.Engine(name, JByteTokenizer(), params=jp, **kw)
    te = tengine.Engine(name, ByteTokenizer(), params=tp, device="cpu", **kw)
    try:
        assert te._max_adv == 16
        reqs = [_greedy(np.random.default_rng(7).integers(0, 250, 20), 60),
                _greedy([4, 5, 6, 4, 5, 6], 60)]
        for j, t in zip(*(
                [f.result(timeout=300) for f in eng.submit_many(
                    [mod.GenerationRequest(**r) for r in reqs])]
                for mod, eng in ((jengine, je), (tengine, te)))):
            assert t.finish_reason == j.finish_reason == "length"
            assert t.token_ids == j.token_ids
            assert t.prompt_tokens + t.completion_tokens + 16 >= 64
    finally:
        je.shutdown()
        te.shutdown()


# ---------------------------------------------- scenarios on the port alone

@pytest.fixture(scope="module")
def engines():
    """A speculative and a plain slot engine on the same bf16 ``qwen3-test``
    weights (seed 0), as ``tests/test_speculative.py`` builds the JAX ones."""
    tk = ByteTokenizer()
    spec = tengine.Engine("qwen3-test", tk, device="cpu", **SLOT_KW, **SPEC)
    ref = tengine.Engine("qwen3-test", tk, device="cpu", **SLOT_KW)
    yield spec, ref
    spec.shutdown()
    ref.shutdown()


def _req(p, n=16, **kw):
    return tengine.GenerationRequest(prompt_ids=list(p), max_tokens=n, temperature=0.0,
                                     repetition_penalty=1.0, **kw)


@pytest.mark.parametrize("prompt", [[10, 20, 30, 40, 50], [1, 2, 3, 1, 2, 3, 1, 2],
                                    [9, 9, 9, 9], list(range(64, 96))],
                         ids=["rising", "cycle", "repeat", "long"])
def test_greedy_equals_plain_slot_engine(engines, prompt):
    spec, ref = engines
    r1, r2 = spec.generate(_req(prompt, 24)), ref.generate(_req(prompt, 24))
    assert r1.token_ids == r2.token_ids
    assert (r1.finish_reason, r1.completion_tokens) == (r2.finish_reason, r2.completion_tokens)


def test_acceptance_beats_one_token_per_step(engines):
    spec, _ = engines
    t0 = dict(spec.stats)
    spec.generate(_req([10, 20, 30, 40, 50], 32))
    dt = spec.stats["decode_tokens"] - t0["decode_tokens"]
    ds = spec.stats["slot_steps"] - t0["slot_steps"]
    assert dt / max(ds, 1) > 1.0
    tel = spec.telemetry()
    assert tel["spec_tokens_per_step"] == tel["decode_tokens"] / tel["slot_steps"]


def test_sampled_decode_deterministic_per_seed():
    req = lambda: tengine.GenerationRequest(                      # noqa: E731
        prompt_ids=[5, 6, 7, 8], max_tokens=12, temperature=0.8, top_k=20, top_p=0.9,
        repetition_penalty=1.05)
    outs = []
    for _ in range(2):
        eng = tengine.Engine("qwen3-test", ByteTokenizer(), device="cpu", **SLOT_KW, **SPEC)
        try:
            outs.append((eng.generate(req()).token_ids, eng.generate(req()).token_ids))
        finally:
            eng.shutdown()
    assert len(outs[0][0]) == 12
    assert outs[0] == outs[1]


def test_concurrent_requests_match_sequential(engines):
    spec, ref = engines
    prompts = [[i, i + 1, i + 2, i + 3] for i in range(5, 37, 8)]
    got = [f.result(timeout=300) for f in spec.submit_many([_req(p, 10) for p in prompts])]
    for p, r in zip(prompts, got):
        assert r.token_ids == ref.generate(_req(p, 10)).token_ids


def test_max_tokens_exact(engines):
    spec, _ = engines
    r = spec.generate(_req([7, 8, 9], 5))
    assert (r.completion_tokens, len(r.token_ids), r.finish_reason) == (5, 5, "length")


@pytest.fixture
def eos_at(engines):
    """Make ``eos_at(prompt, i)`` the EOS id: token ``i`` of the plain
    engine's greedy stream for ``prompt``; restores the tokenizer after."""
    spec, ref = engines
    saved = spec.tokenizer

    def set_eos(prompt, i):
        tok = ByteTokenizer()
        tok.eos_id = ref.generate(_req(prompt, i + 1)).token_ids[i]
        spec.tokenizer = ref.tokenizer = tok
        return tok.eos_id

    yield set_eos
    spec.tokenizer = ref.tokenizer = saved


def test_eos_mid_window(engines, eos_at):
    """EOS inside an accepted window cuts the stream where the plain engine
    stops; the row's length is trimmed back to the consumed tokens."""
    spec, ref = engines
    prompt = [10, 20, 30, 40, 50]
    eos = eos_at(prompt, 9)
    r1, r2 = spec.generate(_req(prompt, 40)), ref.generate(_req(prompt, 40))
    assert r1.token_ids == r2.token_ids and eos not in r1.token_ids
    assert r1.finish_reason == r2.finish_reason == "stop"
    assert r1.completion_tokens == r2.completion_tokens <= 10


def test_min_tokens_suppresses_eos(engines, eos_at):
    """EOS is the first greedy token: an unforced request stops at once, a
    forced one runs past ``min_tokens`` as the plain engine does."""
    spec, ref = engines
    prompt = [40, 41, 42]
    eos = eos_at(prompt, 0)
    assert spec.generate(_req(prompt, 30)).completion_tokens == 1
    r = spec.generate(_req(prompt, 30, min_tokens=25))
    assert r.token_ids == ref.generate(_req(prompt, 30, min_tokens=25)).token_ids
    assert r.completion_tokens >= 25 and eos not in r.token_ids[:24]


def test_stop_sequence_respected(engines):
    spec, ref = engines
    prompt = ByteTokenizer().encode("q")
    base = ref.generate(_req(prompt, 8))
    stop_txt = spec.tokenizer.decode(base.token_ids[3:4])
    r = spec.generate(_req(prompt, 20, stop=(stop_txt,)))
    assert r.finish_reason in ("stop", "length")
    assert stop_txt not in r.text


def test_parked_row_reentry(engines):
    spec, ref = engines
    turn1 = [3, 1, 4, 1, 5, 9, 2, 6]
    a1, b1 = spec.generate(_req(turn1, 8)), ref.generate(_req(turn1, 8))
    assert a1.token_ids == b1.token_ids
    hits0 = spec.stats["slot_park_hits"]
    turn2 = turn1 + a1.token_ids + [7, 7]
    a2, b2 = spec.generate(_req(turn2, 8)), ref.generate(_req(turn2, 8))
    assert spec.stats["slot_park_hits"] > hits0
    assert a2.cached_prompt_tokens == len(turn1) + 8 - 1
    assert a2.token_ids == b2.token_ids


@pytest.mark.parametrize("kw,match", [
    (dict(cache_mode="paged", speculative="ngram"), "slot"),
    (dict(speculative="ngram"), "slot"),
    (dict(cache_mode="slot", speculative="medusa"), "unknown speculative"),
    (dict(cache_mode="slot", speculative="ngram", prefill_lane=16), "lane"),
    (dict(cache_mode="slot", speculative="ngram", kv_quantize="int8"), "int8 KV"),
    (dict(cache_mode="slot", speculative="ngram", spec_k=0), "spec_k"),
    (dict(cache_mode="slot", speculative="ngram", spec_ngram=0), "spec_ngram"),
    (dict(cache_mode="slot", speculative="ngram", chunk_trim=True), "chunk_trim"),
])
def test_constructor_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        tengine.Engine("qwen3-test", ByteTokenizer(), device="cpu", max_slots=1, **kw)


def test_spec_engine_builds_and_warns_past_the_ridge():
    """A slot engine builds with speculation; 16 slots x 4 window tokens
    stay under the H100's bf16 ridge, 128 x 4 pass it (and 40 x 4 pass the
    int8 ridge, half as many rows)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = tengine.Engine("qwen3-test", ByteTokenizer(), device="cpu", max_slots=16,
                             max_seq_len=64, cache_mode="slot", speculative="ngram")
    assert eng._max_adv == eng.decode_chunk_len * 4 and eng.hist.shape == (16, 65)
    for slots, quantize in ((128, None), (40, "int8")):
        with pytest.warns(UserWarning, match="ridge"):
            tengine.Engine("qwen3-test", ByteTokenizer(), device="cpu", max_slots=slots,
                           max_seq_len=16, cache_mode="slot", speculative="ngram",
                           quantize=quantize)
