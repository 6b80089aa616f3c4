"""The port's prefill programs against the JAX engine's, on the CPU.

Engines run the golden ``qwen3-test`` / ``qwen3-moe-test`` checkpoints
(``tests/fixtures/golden``) read by JAX's loader and widened to float32 on
float32 configs, so that greedy streams have no near-ties; streams compare
exactly.

(a) ``warmup``'s prefill keys ``(bucket, Gp, fresh, ring, P)`` project onto
    the ``(bucket, Gp, fresh, ring)`` programs JAX's warmup builds (JAX's
    ``jax.jit`` replaced by a recorder, so nothing compiles), on paged
    engines with and without the prefix cache and on slot engines; ``P`` is
    every page bucket a prompt of the bucket can read (from its narrowest
    prompt, through a cached prefix up to the page budget), bounded by
    ``max_ctx`` as the decode programs are, and None on the fresh branch;
    they are built widest first (rows × prompt width × context).
(b) Off-ladder bursts of 3 and 5 requests (padded to 4 and 16 rows): greedy
    streams and ``prefill_group_hist`` equal JAX's; after the admission the
    group's seen rows are the presence of each prompt plus its first token,
    and no pool row outside the group's pages (slot: its rows' prompt
    positions) changed.
(c) int8 ``qwen3-moe-test``, a burst of 3 prompts of repeated tokens that
    fill their bucket: the streams of JAX's ``Engine(quantize="int8",
    pack_weights=False)``. Expert capacity counts the padding rows, so the
    group must run at Gp: at G rows the second stream differs.
(d) A prompt in a warmed bucket builds nothing; one in a bucket warmup did
    not reach counts 1 in ``post_warmup_builds``.
(e) A speculative engine's history rows after a prefill: each prompt, then
    zeros, and the other rows untouched.
(f) ``load_lora_adapter``: the next prefill builds every program again on
    the merged weights.
Also: a program run again after new inputs are written into the static
buffers equals a fresh eager run of its body on them.
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
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine.prefill_program import prefill_body
from deepsearch_tts_tpu_torch.engine.program import Program
from deepsearch_tts_tpu_torch.engine.weights import params_from_jax
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.models import qwen3_moe as tmoe
from deepsearch_tts_tpu_torch.models import registry as tregistry

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
DENSE, MOE = "qwen3-prefill-golden", "qwen3-moe-prefill-golden"
MODELS = {DENSE: ("qwen3-test", jqwen3, tqwen3, jqwen3.QWEN3_CONFIGS, tqwen3.QWEN3_CONFIGS,
                  jweights.convert_qwen3_dense),
          MOE: ("qwen3-moe-test", jmoe, tmoe, jmoe.QWEN3_MOE_CONFIGS, tmoe.QWEN3_MOE_CONFIGS,
                jweights.convert_qwen3_moe)}
KW = dict(max_slots=8, page_size=4, n_pages=96, max_seq_len=64, decode_chunk_len=4, seed=0)
MODES = {"paged": {}, "paged-fresh": dict(enable_prefix_cache=False),
         "slot": dict(cache_mode="slot")}


@pytest.fixture(scope="module")
def golden():
    """name -> (JAX params, port params) of each golden checkpoint, float32."""
    out = {}
    for name, (base, jm, tm, jcfgs, tcfgs, convert) in MODELS.items():
        jcfg = dataclasses.replace(jcfgs[base], dtype="float32")
        tcfg = dataclasses.replace(tcfgs[base], dtype="float32")
        jregistry.register(name, jcfg, jm.init_params, jm.forward,
                           lambda jm=jm, jcfg=jcfg: jm.logical_axes(jcfg))
        tregistry.register(name, tcfg, tm.forward)
        raw = jweights._load_safetensors_dir(os.path.join(GOLDEN, base))
        jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), convert(raw, jcfg))
        out[name] = jp, params_from_jax(jax.tree.map(np.asarray, jp))
    return out


def _greedy(mod, ids, n):
    return mod.GenerationRequest(prompt_ids=[int(i) for i in ids], max_tokens=n,
                                 temperature=0.0, top_k=0, top_p=1.0, min_p=0.0,
                                 repetition_penalty=1.0)


def _queue(eng, reqs) -> list:
    """``reqs`` queued as one ``submit_many`` batch, the scheduler not started."""
    futs = [Future() for _ in reqs]
    eng._queue.put(list(zip(reqs, futs)))
    return futs


def _drive(eng, futs) -> list:
    """The port's scheduler by hand until ``futs`` are done; their streams."""
    for _ in range(200):
        if all(f.done() for f in futs):
            return [f.result(timeout=0).token_ids for f in futs]
        eng._admit()
        eng._decode_chunk()
    raise AssertionError("requests did not finish")


def _jax_streams(name, jp, prompts, n, **kw):
    je = jengine.Engine(name, ByteTokenizer(), params=jp, **kw)
    try:
        futs = je.submit_many([_greedy(jengine, p, n) for p in prompts])
        return [f.result(timeout=600).token_ids for f in futs], dict(je.stats)
    finally:
        je.shutdown()


# ----------------------------------------------------------- (a) the keys

class _FakeJit:
    """``jax.jit`` for one prefill-only warmup: nothing compiles; a call
    hands the donated buffers back."""

    def __call__(self, fn, **_):
        def call(*a):
            return a[0], a[1], a[2], a[10], None
        return call


WARM = {
    "paged-prefix": (dict(), dict(prompt_lens=(8, 40), group_sizes=(1, 3, 16), max_ctx=30)),
    "paged-prefix-budget": (dict(), dict(prompt_lens=(16, 64))),
    "paged-fresh": (dict(enable_prefix_cache=False), dict(prompt_lens=(8, 33))),
    "paged-both": (dict(context_buckets=True), dict(prompt_lens=(20,), group_sizes=(2,),
                                                    fresh_variants=(True, False))),
    "paged-whole": (dict(context_buckets=False, max_seq_len=100),
                    dict(prompt_lens=(100,), max_ctx=50)),
    "slot-park": (dict(cache_mode="slot"), dict(prompt_lens=(8, 60), max_ctx=20)),
    "slot-fresh": (dict(cache_mode="slot", enable_prefix_cache=False),
                   dict(prompt_lens=(8,), group_sizes=(5,))),
}


def _widths(eng, bucket, max_ctx):
    """Every page bucket a prompt of ``bucket`` reads (its suffix in the
    bucket, a cached prefix before it), narrowest first, bounded by
    ``max_ctx`` as the decode programs are."""
    lo = min(n for n in range(1, eng.max_seq_len + 1) if eng._bucket(n) == bucket)
    every = sorted({eng._page_bucket(n) for n in range(lo, eng.max_seq_len + 1)})
    if max_ctx is None or not eng.context_buckets:
        return every
    ps = eng.page_size
    return [P for P in every if P * ps < max_ctx] + [P for P in every if P * ps >= max_ctx][:1]


@pytest.mark.parametrize("case", list(WARM))
def test_warmup_prefill_keys_equal_jax_plus_page_width(monkeypatch, golden, case):
    kw, warm = WARM[case]
    kw = dict(KW, **kw)
    jp, tp = golden[DENSE]
    monkeypatch.setattr(jax, "jit", _FakeJit())
    je = jengine.Engine(DENSE, ByteTokenizer(), params=jp, **kw)
    je.warmup(decode=False, **warm)
    monkeypatch.undo()
    eng = tengine.Engine(DENSE, ByteTokenizer(), params=tp, device="cpu", **kw)
    eng.warmup(decode=False, **warm)
    keys = set(eng._prefill_programs)
    assert {k[:4] for k in keys} == set(je._jit_cache) == eng._prefill_keys
    for bucket, Gp, fresh, ring in eng._prefill_keys:
        got = sorted((k[4] for k in keys if k[:4] == (bucket, Gp, fresh, ring)),
                     key=lambda P: -1 if P is None else P)
        want = [None] if fresh else _widths(eng, bucket, warm.get("max_ctx"))
        assert got == want, (bucket, Gp, fresh, got, want)
    # built widest first (rows x prompt width x context): the narrower keys'
    # captures reuse the pool blocks the widest left free
    sizes = [Gp * b * (b if fresh else P * eng.page_size)
             for b, Gp, fresh, _, P in eng._prefill_programs]
    assert sizes == sorted(sizes, reverse=True), sizes
    assert eng.stats["post_warmup_builds"] == 0 and not eng.seen.any()
    assert eng.telemetry()["prefill_program"] == "cpu"


# ----------------------------------------------------- (b) off-ladder bursts

def _pool_rows_outside(eng, grp_rows, k0, v0) -> bool:
    """Whether every pool row outside the group's prompt KV is unchanged."""
    keep = torch.ones(eng.k_pages.shape[:3], dtype=torch.bool)   # [L, N, ps]
    for b in grp_rows:
        s, n = eng.slots[b], int(eng.prompt_lens[b])
        if eng.cache_mode == "slot":
            keep[:, b, :n] = False
        else:
            pages = (s.shared_pages + s.pages)[: -(-n // eng.page_size)]
            keep[:, pages] = False
    return bool(torch.equal(eng.k_pages[keep], k0[keep])
                and torch.equal(eng.v_pages[keep], v0[keep]))


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("mode", list(MODES))
def test_off_ladder_burst_matches_jax(golden, mode, n):
    jp, tp = golden[DENSE]
    kw = dict(KW, **MODES[mode])
    rng = np.random.default_rng(n)
    prompts = [rng.integers(0, 250, L) for L in (9, 13, 16, 11, 14)[:n]]
    want, jstats = _jax_streams(DENSE, jp, prompts, 6, **kw)
    eng = tengine.Engine(DENSE, ByteTokenizer(), params=tp, device="cpu", **kw)
    eng.k_pages.normal_(generator=torch.Generator().manual_seed(1))
    eng.v_pages.normal_(generator=torch.Generator().manual_seed(2))
    k0, v0 = eng.k_pages.clone(), eng.v_pages.clone()
    futs = _queue(eng, [_greedy(tengine, p, 6) for p in prompts])
    eng._admit()
    rows = [s.idx for s in eng.slots if s.req is not None]
    assert len(rows) == n and eng.stats["prefill_dispatches"] == 1
    V = eng.cfg.vocab_size
    for b in rows:
        s = eng.slots[b]
        want_seen = torch.zeros(V, dtype=torch.bool)
        want_seen[torch.tensor(s.prompt_tokens)] = True
        want_seen[s.generated[0]] = True
        assert torch.equal(eng.seen[b], want_seen), b
    assert not eng.seen[[b for b in range(eng.max_slots) if b not in rows]].any()
    assert _pool_rows_outside(eng, rows, k0, v0)
    assert _drive(eng, futs) == want
    assert eng.stats["prefill_group_hist"] == jstats["prefill_group_hist"] == {f"16x{n}": 1}
    assert {k[1] for k in eng._prefill_programs} == {4 if n == 3 else 16}


# ------------------------------------------------------ (c) int8 MoE at Gp

def test_int8_moe_burst_of_three_matches_jax(golden):
    jp, tp = golden[MOE]
    kw = dict(KW, quantize="int8")
    # repeated tokens crowd the same experts: at 3 rows (S = 96, cap 15) the
    # second prompt's first token differs from JAX's 4 rows (S = 128, cap 20)
    prompts = [[5] * 16, [9] * 15, [5] * 16]
    want, _ = _jax_streams(MOE, jp, prompts, 6, pack_weights=False, **kw)
    eng = tengine.Engine(MOE, ByteTokenizer(), params=tp, device="cpu", **kw)
    got = _drive(eng, _queue(eng, [_greedy(tengine, p, 6) for p in prompts]))
    assert got == want
    assert eng.stats["prefill_group_hist"] == {"16x3": 1}


# -------------------------------------------------- (d) post-warmup builds

def test_warmed_bucket_builds_nothing_and_an_unwarmed_one_counts(golden, capsys):
    _, tp = golden[DENSE]
    eng = tengine.Engine(DENSE, ByteTokenizer(), params=tp, device="cpu", **KW)
    eng.warmup(prompt_lens=(16,), max_ctx=40)
    built = set(eng._prefill_programs)
    rng = np.random.default_rng(4)
    _drive(eng, _queue(eng, [_greedy(tengine, rng.integers(0, 250, L), 4) for L in (10, 12)]))
    assert eng.stats["post_warmup_builds"] == 0 and set(eng._prefill_programs) == built
    # a 40-token prompt: bucket 64, which warmup did not reach (one token:
    # no decode chunk)
    _drive(eng, _queue(eng, [_greedy(tengine, rng.integers(0, 250, 40), 1)]))
    assert eng.stats["post_warmup_builds"] == 1
    (new,) = set(eng._prefill_programs) - built
    assert new == (64, 1, False, False, eng._page_bucket(40))
    assert "post-warmup prefill program build" in capsys.readouterr().err


# ---------------------------------------------------- (e) history rows

def test_speculative_history_rows_after_prefill(golden):
    _, tp = golden[DENSE]
    eng = tengine.Engine(DENSE, ByteTokenizer(), params=tp, device="cpu",
                         **dict(KW, cache_mode="slot", speculative="ngram", spec_k=2))
    eng._hist_ext.fill_(7)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 250, L) for L in (9, 14, 5)]
    _queue(eng, [_greedy(tengine, p, 6) for p in prompts])
    eng._admit()
    rows = []
    for s in eng.slots:
        if s.req is None:
            continue
        rows.append(s.idx)
        want = torch.zeros(eng.hist.shape[1], dtype=torch.int64)
        want[: len(s.prompt_tokens)] = torch.tensor(s.prompt_tokens)
        assert torch.equal(eng.hist[s.idx], want), s.idx
    assert len(rows) == 3
    others = [b for b in range(eng.max_slots) if b not in rows]
    assert (eng.hist[others] == 7).all()


# ------------------------------------------------------------- (f) LoRA

def test_lora_rebind_builds_the_prefill_programs_again(golden, tmp_path):
    from deepsearch_tts_tpu_torch.train import checkpoint as tck
    from deepsearch_tts_tpu_torch.train import lora as tlora

    _, tp = golden[DENSE]
    eng = tengine.Engine(DENSE, ByteTokenizer(), params=tp, device="cpu", **KW)
    eng.warmup(prompt_lens=(16,), group_sizes=(1,), max_ctx=24)
    old = dict(eng._prefill_programs)
    path = tck.save_params(str(tmp_path / "adapter"), tlora.init_lora(tp, rank=2, alpha=4.0))
    eng.load_lora_adapter(path)
    prompt = list(range(30, 41))
    got = _drive(eng, _queue(eng, [_greedy(tengine, prompt, 4)]))
    assert eng._programs_params is eng.params
    assert eng._prefill_programs and not set(map(id, eng._prefill_programs.values())) & set(
        map(id, old.values()))
    assert eng.stats["post_warmup_builds"] >= 1
    ref = tengine.Engine(DENSE, ByteTokenizer(), params=eng.params, device="cpu", **KW)
    assert _drive(ref, _queue(ref, [_greedy(tengine, prompt, 4)])) == got


# ------------------------------------------------------ replay semantics

@pytest.mark.parametrize("mode", ["paged", "slot"])
def test_program_rerun_on_new_inputs_equals_fresh_eager_run(golden, mode):
    _, tp = golden[DENSE]
    eng = tengine.Engine(DENSE, ByteTokenizer(), params=tp, device="cpu",
                         **dict(KW, **MODES[mode]))
    rng = np.random.default_rng(6)
    key = (16, 4, False, False, eng._page_bucket(16))
    prog = eng._prefill_program(key)

    def group(lens):
        grp = []
        for i, L in enumerate(lens):
            s = eng.slots[i + 1]
            if eng.cache_mode != "slot":
                s.pages = list(range(1 + 8 * i, 9 + 8 * i))
                eng.page_tables[s.idx, :8] = s.pages
            ids = [int(t) for t in rng.integers(0, 250, L)]
            grp.append({"slot": s, "suffix": ids, "cached_len": 0, "prompt": ids})
        return grp

    eng._upload_prefill(key, group((5, 16, 9)))
    first = prog()["first"].clone()
    eng._upload_prefill(key, group((12, 3)))
    st = [t.clone() for t in (eng._seen_ext, eng.k_pages, eng.v_pages)] + [
        eng.generator.get_state()]
    got = prog()["first"].clone()
    after = [t.clone() for t in (eng._seen_ext, eng.k_pages, eng.v_pages)]
    for t, v in zip((eng._seen_ext, eng.k_pages, eng.v_pages), st):
        t.copy_(v)
    eng.generator.set_state(st[3])
    want = Program(key, prefill_body(eng, key), capture=False).body()["first"]
    assert torch.equal(got, want) and not torch.equal(got, first)
    assert (got[4:] == 0).all() and got.shape == (eng.MAX_PREFILL_GROUP,)
    for t, v in zip((eng._seen_ext, eng.k_pages, eng.v_pages), after):
        assert torch.equal(t, v)
