"""The port's engine under the failures of ``tests/test_engine_robustness.py``,
on the CPU: abort mid-flight, abort while queued, KV exhaustion under
sustained load, a preempted sequence that resumes token-identical, an
impossible prompt, and a burst of concurrent SSE streams. Each engine
scenario runs with and without the prefill lane (``prefill_lane=16``, the
CLIs' default).
"""
import asyncio
import concurrent.futures
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from deepsearch_tts_tpu_torch.engine.engine import Engine, GenerationRequest
from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer

torch.set_num_threads(1)

LANES = [0, 16]


def _greedy(prompt_ids, max_tokens=8, **kw):
    return GenerationRequest(prompt_ids=prompt_ids, max_tokens=max_tokens,
                             temperature=0.0, repetition_penalty=1.0, **kw)


def _engine(lane, **kw):
    return Engine("qwen3-test", ByteTokenizer(), device="cpu", page_size=4,
                  decode_chunk_len=4, seed=0, prefill_lane=lane, **kw)


def _clean(eng):
    """Every slot idle and every page free or held by the prefix cache
    (page 0 is never handed out)."""
    assert all(not s.active and s.req is None for s in eng.slots) and not eng._lane
    assert eng.allocator.num_free + len(eng.allocator._refs) == eng.n_pages - 1


@pytest.mark.parametrize("lane", LANES)
def test_abort_mid_generation_frees_slot_and_keeps_engine_sane(lane):
    eng = _engine(lane, max_slots=4, n_pages=128, max_seq_len=128)
    try:
        baseline = eng.generate(_greedy([9, 8, 7, 6], max_tokens=6)).token_ids
        got_delta = threading.Event()
        rid = "abort-me"

        def on_delta(_piece):
            if not got_delta.is_set():
                got_delta.set()
                eng.abort(rid)

        res = eng.submit(_greedy([1, 2, 3, 4], max_tokens=100, request_id=rid,
                                 on_delta=on_delta)).result(timeout=300)
        assert got_delta.is_set()
        assert res.finish_reason == "aborted" and res.completion_tokens < 100
        _clean(eng)
        # the abort did not poison KV or prefix state for later requests
        assert eng.generate(_greedy([9, 8, 7, 6], max_tokens=6)).token_ids == baseline
    finally:
        eng.shutdown()


@pytest.mark.parametrize("lane", LANES)
def test_abort_queued_request_cancels_future(lane):
    eng = _engine(lane, max_slots=1, n_pages=64, max_seq_len=128)
    try:
        running = eng.submit(_greedy([5, 6, 7], max_tokens=40, request_id="running"))
        queued = eng.submit(_greedy([8, 9, 10], max_tokens=4, request_id="queued"))
        eng.abort("queued")
        assert running.result(timeout=300).completion_tokens == 40
        with pytest.raises(concurrent.futures.CancelledError):
            queued.result(timeout=300)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("lane", LANES)
def test_kv_exhaustion_defers_admissions_under_sustained_load(lane):
    """More in-flight demand than the page pool holds: admissions defer
    until pages free, every request completes in full, the pool ends clean."""
    eng = _engine(lane, max_slots=4, n_pages=32, max_seq_len=128)
    try:
        # each request needs ~11 of the 32 pages: at most 2 run at once; the
        # 12-token ones fit the lane once decode runs
        rng = np.random.default_rng(0)
        prompts = [[int(x) for x in rng.integers(1, 200, size=24 if i % 2 else 12)]
                   for i in range(12)]
        futs = eng.submit_many([_greedy(p, max_tokens=16) for p in prompts])
        for r in (f.result(timeout=600) for f in futs):
            # memory pressure never truncates: full budget or a genuine EOS
            assert (r.completion_tokens == 16 and r.finish_reason == "length"
                    ) or r.finish_reason == "stop", (r.completion_tokens, r.finish_reason)
        _clean(eng)
        assert eng.generate(_greedy([3, 1, 4, 1, 5], max_tokens=4)).completion_tokens == 4
    finally:
        eng.shutdown()


@pytest.mark.parametrize("lane", LANES)
def test_preempted_sequence_resumes_token_identical(lane):
    """A mid-decode preemption resumes token-identical to the same request
    run without memory pressure."""
    prompt_a, prompt_b = list(range(40, 60)), list(range(140, 160))
    ref = _engine(lane, max_slots=2, n_pages=128, max_seq_len=128)
    try:
        want_a = ref.generate(_greedy(prompt_a, max_tokens=24)).token_ids
        want_b = ref.generate(_greedy(prompt_b, max_tokens=24)).token_ids
    finally:
        ref.shutdown()
    # 19 usable pages: both admit, decode growth exhausts the pool
    eng = _engine(lane, max_slots=2, n_pages=20, max_seq_len=128)
    try:
        futs = eng.submit_many([_greedy(prompt_a, max_tokens=24),
                                _greedy(prompt_b, max_tokens=24)])
        got_a, got_b = [f.result(timeout=600) for f in futs]
        assert eng.stats["preemptions"] >= 1
        assert got_a.token_ids == want_a and got_b.token_ids == want_b
        assert got_a.completion_tokens == got_b.completion_tokens == 24
    finally:
        eng.shutdown()


@pytest.mark.parametrize("lane", LANES)
def test_impossible_prompt_fails_loudly_not_silently(lane):
    eng = _engine(lane, max_slots=2, n_pages=16, max_seq_len=256)
    try:
        with pytest.raises(MemoryError):   # ~51 pages of a 16-page pool
            eng.submit(_greedy(list(range(1, 201)), max_tokens=4)).result(timeout=300)
        assert eng.generate(_greedy([1, 2, 3], max_tokens=4)).completion_tokens == 4
    finally:
        eng.shutdown()


def test_server_concurrent_sse_streams():
    """A burst of concurrent streaming chat requests against a lane engine:
    every stream ends with [DONE] and carries a finish reason."""
    from deepsearch_tts_tpu_torch.engine.server import OpenAIServer

    eng = _engine(16, max_slots=4, n_pages=128, max_seq_len=128)
    n_streams = 6

    async def go():
        server = OpenAIServer(eng, "127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        loop = asyncio.get_running_loop()

        def post(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/chat/completions",
                data=json.dumps({"messages": [{"role": "user", "content": f"q{i}"}],
                                 "max_tokens": 6, "temperature": 0.0,
                                 "stream": True}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.read().decode()

        try:
            return await asyncio.gather(*(loop.run_in_executor(None, post, i)
                                          for i in range(n_streams)))
        finally:
            await server.stop()

    try:
        raws = asyncio.run(go())
        assert len(raws) == n_streams
        for raw in raws:
            events = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
            assert events[-1] == "[DONE]"
            chunks = [json.loads(e) for e in events[:-1]]
            finish = [c for c in chunks if c["choices"][0]["finish_reason"]]
            assert finish and finish[-1]["choices"][0]["finish_reason"] in ("stop", "length")
        # the engine loop survived the burst
        assert eng.generate(_greedy([2, 4, 6], max_tokens=3)).completion_tokens == 3
    finally:
        eng.shutdown()
