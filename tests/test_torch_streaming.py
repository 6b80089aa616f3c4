"""Token streaming on the port's engine, the counterpart of
``tests/test_streaming.py``: ``on_delta`` pieces add up to the result's
text, with and without the prefill lane, and an SSE stream over the OpenAI
server carries the role, the content and a finish reason.
"""
import asyncio
import json
import threading
import urllib.request

import pytest
import torch

from deepsearch_tts_tpu_torch.engine.engine import Engine, GenerationRequest
from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[0, 16], ids=["no-lane", "lane"])
def engine(request):
    eng = Engine("qwen3-test", ByteTokenizer(), device="cpu", max_slots=2, page_size=4,
                 n_pages=64, max_seq_len=128, decode_chunk_len=4,
                 prefill_lane=request.param)
    yield eng
    eng.shutdown()


def _req(ids, n, **kw):
    return GenerationRequest(prompt_ids=ids, max_tokens=n, temperature=0.0,
                             repetition_penalty=1.0, **kw)


def test_on_delta_callback(engine):
    pieces = []
    res = engine.generate(_req([1, 2, 3], 5, on_delta=pieces.append))
    assert "".join(pieces) == res.text
    assert len(pieces) >= 1


def test_on_delta_of_a_prompt_that_rides_the_lane(engine):
    """A short prompt arriving while another row decodes (it rides the lane
    on the lane engine) streams the same pieces as its text."""
    first = threading.Event()
    long = engine.submit(_req([7, 8, 9], 100, on_delta=lambda _p: first.set()))
    assert first.wait(timeout=300)
    lanes0 = engine.stats["lane_tokens"]
    pieces = []
    res = engine.generate(_req([4, 5, 6, 7], 6, on_delta=pieces.append))
    assert "".join(pieces) == res.text and res.completion_tokens == 6
    assert long.result(timeout=300).completion_tokens == 100
    if engine.prefill_lane:
        assert engine.stats["lane_tokens"] == lanes0 + 4


def test_sse_streaming(engine):
    from deepsearch_tts_tpu_torch.engine.server import OpenAIServer

    async def go():
        server = OpenAIServer(engine, "127.0.0.1", 0)
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        loop = asyncio.get_running_loop()

        def post():
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/chat/completions",
                data=json.dumps({"messages": [{"role": "user", "content": "hi"}],
                                 "max_tokens": 8, "min_tokens": 6, "temperature": 0.0,
                                 "stream": True}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.read().decode()

        try:
            return await loop.run_in_executor(None, post)
        finally:
            await server.stop()

    raw = asyncio.run(go())
    events = [line[6:] for line in raw.splitlines() if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    finish = [c for c in chunks if c["choices"][0]["finish_reason"]]
    assert finish and finish[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert len(text) >= 1
