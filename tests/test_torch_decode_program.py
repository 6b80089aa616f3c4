"""The port's decode-program layer against the JAX engine's, on the CPU.

* ``_decode_buckets`` / ``_slot_buckets`` equal JAX's ladders for every
  ``context_buckets`` setting over several ``(max_seq_len, page_size)``.
* After ``warmup(prompt_lens, group_sizes, fresh_variants, max_ctx)`` the
  port's program keys ``(P, slot_ctx, lane, spec, chunk_len)`` equal the
  decode programs JAX's warmup builds (its ``_decode_fn_cache`` keys with
  the page-table width each is called at) and its prefill variants. JAX's
  ``jax.jit`` is replaced by a recorder for that run, so its enumeration
  runs without compiling.
* ``_can_speculate`` and ``_churn_imminent`` decide as JAX's on the same
  slot states (``churn_rtt_s = 0`` included), JAX's methods run on a stub
  holding those states.
* A program run again after new inputs are written into the static
  buffers equals a fresh eager run on the new inputs: nothing the body
  reads is fixed when the program is built.
"""
import types

import jax
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine.decode_program import chunk_body
from deepsearch_tts_tpu_torch.engine.program import Program

torch.set_num_threads(1)


def _tengine(**kw):
    kw = dict(dict(max_slots=4, page_size=4, n_pages=64, max_seq_len=64, decode_chunk_len=2,
                   seed=0), **kw)
    return tengine.Engine("qwen3-test", ByteTokenizer(), device="cpu", **kw)


# ------------------------------------------------------------ the ladders

SHAPES = [(64, 4), (128, 16), (96, 12), (1024, 16), (4096, 64), (48, 16), (100, 7)]


@pytest.mark.parametrize("context_buckets", [False, True, "fine"])
@pytest.mark.parametrize("max_seq_len,page_size", SHAPES)
def test_bucket_ladders_equal_jax(context_buckets, max_seq_len, page_size):
    eng = _tengine(max_seq_len=max_seq_len, page_size=page_size, n_pages=8,
                   context_buckets=context_buckets)
    stub = types.SimpleNamespace(max_seq_len=max_seq_len, context_buckets=context_buckets,
                                 max_pages_per_seq=eng.max_pages_per_seq)
    assert eng._decode_buckets() == jengine.Engine._decode_buckets(stub)
    assert eng._slot_buckets() == jengine.Engine._slot_buckets(stub)


def test_context_buckets_default_and_refusal():
    eng = _tengine()
    assert eng.context_buckets == "fine" and eng.pipeline_decode
    assert eng.churn_rtt_s == 0.035
    assert eng.telemetry()["decode_program"] == "cpu"
    with pytest.raises(ValueError, match="context_buckets"):
        _tengine(context_buckets="pow3")


# ------------------------------------------------------ warmup's programs

class _FakeJit:
    """``jax.jit`` for one warmup: the function is not compiled; a call
    hands the donated buffers back (and records a decode program's
    page-table width)."""

    def __init__(self, widths):
        self.widths = widths

    def __call__(self, fn, **_):
        def call(*a):
            if fn.__name__ == "prefill":
                return a[0], a[1], a[2], a[10], None
            self.widths.append(int(a[4].shape[1]))
            return a[0], a[1], a[2], a[5], a[6]
        return call


def _jax_warm_keys(monkeypatch, kw, warm):
    """The decode programs JAX's warmup builds, as the port keys them
    ``(P, slot_ctx, lane, spec, chunk_len)``, and its prefill variants."""
    widths, keys = [], []
    monkeypatch.setattr(jax, "jit", _FakeJit(widths))
    je = jengine.Engine("qwen3-test", ByteTokenizer(), **kw)
    program = je._decode_program

    def record(slot_ctx=None, lane=False, spec=False, chunk_len=None):
        keys.append((None if je.cache_mode != "slot" else slot_ctx, bool(lane), bool(spec),
                     chunk_len))
        return program(slot_ctx, lane=lane, spec=spec, chunk_len=chunk_len)

    je._decode_program = record
    je.warmup(**warm)
    monkeypatch.undo()
    assert set(keys) == set(je._decode_fn_cache)
    return {(p,) + k for p, k in zip(widths, keys)}, set(je._jit_cache)


WARM_CASES = {
    "paged-lane": (dict(prefill_lane=8), dict(prompt_lens=(8, 40), group_sizes=(1, 4),
                                              max_ctx=30)),
    "paged-pow2": (dict(context_buckets=True), dict(prompt_lens=(8,), max_ctx=None)),
    "paged-whole": (dict(context_buckets=False), dict(prompt_lens=(8,), group_sizes=(2,),
                                                      fresh_variants=(True, False))),
    "slot-trim": (dict(cache_mode="slot", max_seq_len=256, chunk_trim=True),
                  dict(prompt_lens=(20,), group_sizes=(1, 16), max_ctx=150)),
    "slot-spec": (dict(cache_mode="slot", max_seq_len=256, speculative="ngram", spec_k=2),
                  dict(prompt_lens=(8,), max_ctx=97)),
    "slot-lane-fresh": (dict(cache_mode="slot", prefill_lane=8, enable_prefix_cache=False),
                        dict(prompt_lens=(8,), group_sizes=(3,))),
}


@pytest.mark.parametrize("case", list(WARM_CASES))
def test_warmup_programs_equal_jax(monkeypatch, case):
    kw, warm = WARM_CASES[case]
    kw = dict(dict(max_slots=4, page_size=4, n_pages=64, max_seq_len=64, decode_chunk_len=2,
                   seed=0), **kw)
    jdec, jpre = _jax_warm_keys(monkeypatch, kw, warm)
    eng = tengine.Engine("qwen3-test", ByteTokenizer(), device="cpu", **kw)
    eng.warmup(**warm)
    assert set(eng._programs) == jdec and eng._prefill_keys == jpre
    assert eng.stats["post_warmup_builds"] == 0 and not eng.seen.any()
    if eng.chunk_trim:
        assert eng._trim_warm == {k[:2] for k in jdec if k[4] is not None}
    # a program built after warmup counts (no chunk reads 999 pages)
    eng._program(999, 7)
    assert eng.stats["post_warmup_builds"] == 1


# --------------------------------------------- the pipelining decisions

def _states(rng, eng, n_cases=60):
    """Random slot states: active / stepped-in-the-carry / reset rows,
    tokens left, lengths near the cap, lane work, measured walls."""
    B = eng.max_slots
    for _ in range(n_cases):
        near = rng.random() < 0.4   # every row within a few tokens of its end
        slots = []
        for i in range(B):
            s = types.SimpleNamespace(idx=i, active=bool(rng.random() < 0.8),
                                      epoch=int(rng.integers(1, 3)))
            mx = int(rng.integers(1, 40))
            left = int(rng.integers(0, 3) if near else rng.integers(0, mx + 1))
            s.stop = types.SimpleNamespace(max_tokens=mx, n_tokens=max(mx - left, 0))
            slots.append(s)
        h = {"active": rng.random(B) < 0.9,
             "epochs": [s.epoch if rng.random() < 0.9 else s.epoch - 1 for s in slots]}
        seq_lens = rng.integers(0, eng.max_seq_len, B).astype(np.int32)
        lane = bool(rng.random() < 0.2)
        walls = [(0.0, 0.0), (0.08, 0.0), (0.08, 0.004), (0.02, 0.05)][int(rng.integers(4))]
        rtt = [0.035, 0.0, 0.01][int(rng.integers(3))]
        yield slots, h, seq_lens, lane, walls, rtt


@pytest.mark.parametrize("kw", [dict(), dict(cache_mode="slot", speculative="ngram"),
                                dict(max_slots=32, decode_chunk_len=4)])
def test_can_speculate_and_churn_imminent_equal_jax(kw):
    eng = _tengine(**kw)
    rng = np.random.default_rng(0)
    seen = set()
    for slots, h, seq_lens, lane, (chunk_ema, gap_ema), rtt in _states(rng, eng):
        eng.slots, eng.seq_lens = slots, seq_lens
        eng._chunk_ema, eng._gap_ema, eng.churn_rtt_s = chunk_ema, gap_ema, rtt
        eng._lane = [{"suffix": [1, 2]}] if lane else []
        stub = types.SimpleNamespace(
            slots=slots, seq_lens=seq_lens, decode_chunk_len=eng.decode_chunk_len,
            _max_adv=eng._max_adv, max_seq_len=eng.max_seq_len, max_slots=eng.max_slots,
            _chunk_ema=chunk_ema, _gap_ema=gap_ema, churn_rtt_s=rtt,
            _lane=[{"p": {"suffix": [1, 2]}, "off": 0}] if lane else [])
        want = (jengine.Engine._can_speculate(stub, h), jengine.Engine._churn_imminent(stub, h))
        assert (eng._can_speculate(h), eng._churn_imminent(h)) == want
        seen.add(want)
    assert len({w[0] for w in seen}) == len({w[1] for w in seen}) == 2   # both answers


# ----------------------------------------------------- replay semantics

def _inputs(eng, rng):
    """Random inputs in the static buffers: some rows active at random
    lengths over their own pages, random last tokens and sampler fields."""
    bf, B = eng._bufs, eng.max_slots
    act = torch.from_numpy(rng.random(B) < 0.75)
    lens = torch.from_numpy(rng.integers(1, 20, B))
    bf.act.copy_(act)
    bf.lens.copy_(lens)
    bf.last.copy_(torch.from_numpy(rng.integers(1, 250, B)))
    bf.prompt_lens.copy_(lens - torch.from_numpy(rng.integers(0, 3, B)))
    bf.temperature.copy_(torch.from_numpy(rng.choice([0.0, 0.7], B).astype(np.float32)))
    bf.min_tokens.copy_(torch.from_numpy(rng.integers(0, 3, B)))
    if eng.cache_mode != "slot":
        bf.tables.copy_(torch.from_numpy(
            1 + np.arange(B * eng.max_pages_per_seq).reshape(B, -1) % (eng.n_pages - 1)))


def _state(eng):
    return [t.clone() for t in (eng._seen_ext, eng.k_pages, eng.v_pages,
                                eng._bufs.last_ext, eng._bufs.lens)] + [
        eng.generator.get_state()] + ([eng.hist.clone()] if eng.hist is not None else [])


def _restore(eng, st):
    for t, v in zip((eng._seen_ext, eng.k_pages, eng.v_pages, eng._bufs.last_ext,
                     eng._bufs.lens), st):
        t.copy_(v)
    eng.generator.set_state(st[5])
    if eng.hist is not None:
        eng.hist.copy_(st[6])


@pytest.mark.parametrize("kw", [dict(), dict(cache_mode="slot"),
                                dict(cache_mode="slot", speculative="ngram", spec_k=2)])
def test_program_rerun_on_new_inputs_equals_fresh_eager_run(kw):
    eng = _tengine(max_seq_len=128, **kw)
    rng = np.random.default_rng(1)
    key = (eng._page_bucket(40), eng._slot_bucket(40), False, eng.speculative is not None,
           None)
    prog = eng._program(*key)
    _inputs(eng, rng)
    first = prog()
    _inputs(eng, rng)
    st = _state(eng)
    got = {k: v.clone() for k, v in prog().items()}
    carry = (eng._bufs.last.clone(), eng._bufs.lens.clone(), eng.seen.clone())
    _restore(eng, st)
    want = Program(key, chunk_body(eng, key), capture=False).body()
    assert set(got) == set(want) == set(first)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(carry[0], eng._bufs.last) and torch.equal(carry[1], eng._bufs.lens)
    assert torch.equal(carry[2], eng.seen)
    assert not all(torch.equal(first[k], got[k]) for k in got)
