"""Pipelined dispatch and admission injection on the port, on the CPU.

``tests/test_engine.py:227 test_pipelined_decode_matches_serial`` for the
port, on three engines: paged with the prefix cache and a prefill lane of
16 rows, slot with parking (a follow-up re-enters its parked row), and
speculative slot. Greedy requests with ``max_tokens`` across chunk
boundaries, one request aborted mid-stream and two admitted from a stream
callback (so while a pipelined chunk is in flight) give the same streams
with ``pipeline_decode=True`` and ``False``, and the same as JAX's engine
on the same float32 params; the pipelined engine pipelines chunks and
injects prefill groups.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine.weights import params_from_jax
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.models import registry as tregistry

torch.set_num_threads(1)

NAME = "qwen3-pipeline-parity"
KW = dict(max_slots=4, page_size=4, n_pages=128, max_seq_len=128, decode_chunk_len=4, seed=0)
ENGINES = {
    "paged-prefix-lane": dict(prefill_lane=16),
    # 8 rows for the 7 requests: no row is reused before the follow-up
    "slot-park": dict(cache_mode="slot", max_slots=8),
    "slot-spec": dict(cache_mode="slot", speculative="ngram", spec_k=2),
}
PROMPTS = [[7, 8, 9, 10, 11], [30, 31], [50, 51, 52, 53, 54, 55, 56], [90, 91, 92]]
# straddle several chunk boundaries; one row within a verify chunk's
# advance of its end, so that the first chunk pipelines on every engine
# (before any chunk is timed, ``_churn_imminent`` allows one such row)
LENS = [17, 3, 19, 25]
LATE = [([120, 121, 122, 123], 6), ([140, 141], 11)]


@pytest.fixture(scope="module")
def params():
    jcfg = dataclasses.replace(jqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    tcfg = dataclasses.replace(tqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    jregistry.register(NAME, jcfg, jqwen3.init_params, jqwen3.forward,
                       lambda: jqwen3.logical_axes(jcfg))
    tregistry.register(NAME, tcfg, tqwen3.forward)
    jp = jqwen3.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _req(mod, prompt, n, **kw):
    return mod.GenerationRequest(prompt_ids=list(prompt), max_tokens=n, temperature=0.0,
                                 top_k=0, top_p=1.0, min_p=0.0, repetition_penalty=1.0, **kw)


def _scenario(eng, mod):
    """The requests; returns (streams of the finished ones in order, the
    aborted request's result)."""
    late: list = []
    pieces: list = []

    def admit_late(_piece):
        # from the engine's thread, while it folds a chunk in: these are
        # admitted with the next chunk already dispatched
        if not late:
            late.extend(eng.submit(_req(mod, p, n)) for p, n in LATE)

    def abort(piece):
        pieces.append(piece)   # after a few tokens: the first chunks run unaborted
        if len(pieces) == 6:
            eng.abort("abort-me")

    futs = [eng.submit(_req(mod, p, n, **({"on_delta": admit_late} if i == 0 else {})))
            for i, (p, n) in enumerate(zip(PROMPTS, LENS))]
    aborted = eng.submit(_req(mod, [200, 201, 202], 100, request_id="abort-me",
                              on_delta=abort))
    res = [f.result(timeout=600) for f in futs]
    res += [f.result(timeout=600) for f in late]
    # a follow-up turn of the first conversation: a slot engine re-enters
    # its parked row, a paged one hits the prefix cache
    follow = PROMPTS[0] + res[0].token_ids + [60, 61]
    res.append(eng.submit(_req(mod, follow, 7)).result(timeout=600))
    return [(r.token_ids, r.finish_reason, r.completion_tokens) for r in res], \
        aborted.result(timeout=600)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_pipelined_streams_equal_serial_and_jax(params, engine):
    jp, tp = params
    kw = dict(KW, **ENGINES[engine])
    out, stats = {}, {}
    for flag in (True, False):
        eng = tengine.Engine(NAME, ByteTokenizer(), params=tp, device="cpu",
                             pipeline_decode=flag, **kw)
        try:
            out[flag], aborted = _scenario(eng, tengine)
            stats[flag] = eng.telemetry()
        finally:
            eng.shutdown()
        assert aborted.finish_reason == "aborted" and aborted.completion_tokens < 100
        assert all(not s.active and s.req is None for s in eng.slots)
        assert eng._pending is None and not eng._inject_handles
    je = jengine.Engine(NAME, ByteTokenizer(), params=jp, **kw)
    try:
        want, _ = _scenario(je, jengine)
    finally:
        je.shutdown()
    assert out[True] == out[False] == want
    for n, (toks, _, count) in zip(LENS + [n for _, n in LATE], out[True]):
        assert len(toks) == count <= n
    assert stats[True]["pipelined_chunks"] > 0 and stats[False]["pipelined_chunks"] == 0
    assert stats[True]["injected_groups"] > 0
    assert stats[True]["decode_program"] == "cpu"
    if engine == "slot-park":
        assert stats[True]["slot_park_hits"] >= 1 and stats[False]["slot_park_hits"] >= 1
    if engine == "paged-prefix-lane":
        assert stats[True]["prefix_cache"]["hits"] >= 1


@pytest.mark.parametrize("engine", list(ENGINES))
def test_rows_ending_at_their_first_token_queue_no_chunk(params, engine):
    """A row that ends at its first token (``max_tokens=1``, or a prompt
    one short of ``max_seq_len``) is injected inactive: no decode chunk is
    queued for it, so the next request's prefill waits behind none. The
    tokens and finish reasons equal JAX's."""
    jp, tp = params
    kw = dict(KW, **ENGINES[engine])
    reqs = [(p, 1) for p in PROMPTS] + [(list(range(3, 2 + kw["max_seq_len"])), 5)]
    eng = tengine.Engine(NAME, ByteTokenizer(), params=tp, device="cpu", **kw)
    try:
        got = [eng.submit(_req(tengine, p, n)).result(timeout=600) for p, n in reqs]
        stats = eng.telemetry()
    finally:
        eng.shutdown()
    je = jengine.Engine(NAME, ByteTokenizer(), params=jp, **kw)
    try:
        want = [je.submit(_req(jengine, p, n)).result(timeout=600) for p, n in reqs]
    finally:
        je.shutdown()
    assert [(r.token_ids, r.finish_reason) for r in got] == \
        [(r.token_ids, r.finish_reason) for r in want]
    assert all(r.completion_tokens == 1 for r in got)
    assert stats["decode_steps"] == 0 and stats["injected_groups"] == len(reqs)
