"""OpenAI-compatible HTTP server over the in-process engine (port of
``engine/server.py``; the same file, importing this package's ``Engine``).

Preserves the wire contract the reference speaks to its providers
(reference: scripts/deep_search.py:1424-1531 posts OpenAI chat-completions
JSON with tools and reads ``choices[0].message``): ``/v1/chat/completions``
and ``/v1/completions`` endpoints, so the reference's own orchestration —
or any OpenAI SDK — can point at a GPU running this server and work
unchanged.

Implementation: asyncio HTTP/1.1 server on stdlib only (no fastapi/uvicorn
in the image). Requests run concurrently; the engine batches them on the
device.
"""
from __future__ import annotations

import asyncio
import json
import time
import uuid

from .engine import Engine, GenerationRequest
from .tokenizer import parse_tool_calls


def _chat_payload_to_request(engine: Engine, payload: dict) -> GenerationRequest:
    tok = engine.tokenizer
    prompt = tok.apply_chat_template(
        payload.get("messages", []), tools=payload.get("tools"),
        add_generation_prompt=True,
    )
    stop = payload.get("stop") or ()
    if isinstance(stop, str):
        stop = (stop,)
    return GenerationRequest(
        prompt_ids=tok.encode(prompt),
        max_tokens=int(payload.get("max_tokens", 1024)),
        temperature=float(payload.get("temperature", 0.7)),
        top_k=int(payload.get("top_k", 20)),
        top_p=float(payload.get("top_p", 0.8)),
        min_p=float(payload.get("min_p", 0.05)),
        repetition_penalty=float(payload.get("repetition_penalty", 1.05)),
        min_tokens=int(payload.get("min_tokens", 0)),
        stop=tuple(stop),
        include_stop_str=bool(payload.get("include_stop_str_in_output", False)),
    )


async def _handle_chat(engine: Engine, payload: dict) -> dict:
    req = _chat_payload_to_request(engine, payload)
    res = await asyncio.wrap_future(engine.submit(req))
    content, tool_calls = parse_tool_calls(res.text)
    message: dict = {"role": "assistant", "content": content}
    if tool_calls:
        message["tool_calls"] = tool_calls
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:20]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": payload.get("model", "deepsearch-tts-tpu"),
        "choices": [{
            "index": 0,
            "message": message,
            "finish_reason": "tool_calls" if tool_calls else res.finish_reason,
        }],
        "usage": {
            "prompt_tokens": res.prompt_tokens,
            "completion_tokens": res.completion_tokens,
            "total_tokens": res.prompt_tokens + res.completion_tokens,
            "prompt_tokens_details": {"cached_tokens": res.cached_prompt_tokens},
        },
    }


async def _handle_completions(engine: Engine, payload: dict) -> dict:
    tok = engine.tokenizer
    stop = payload.get("stop") or ()
    if isinstance(stop, str):
        stop = (stop,)
    req = GenerationRequest(
        prompt_ids=tok.encode(payload.get("prompt", "")),
        max_tokens=int(payload.get("max_tokens", 1024)),
        temperature=float(payload.get("temperature", 0.7)),
        top_k=int(payload.get("top_k", 20)),
        top_p=float(payload.get("top_p", 0.8)),
        min_p=float(payload.get("min_p", 0.05)),
        repetition_penalty=float(payload.get("repetition_penalty", 1.05)),
        stop=tuple(stop),
        include_stop_str=bool(payload.get("include_stop_str_in_output", False)),
    )
    res = await asyncio.wrap_future(engine.submit(req))
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:20]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": payload.get("model", "deepsearch-tts-tpu"),
        "choices": [{"index": 0, "text": res.text, "finish_reason": res.finish_reason}],
        "usage": {
            "prompt_tokens": res.prompt_tokens,
            "completion_tokens": res.completion_tokens,
            "total_tokens": res.prompt_tokens + res.completion_tokens,
        },
    }


class OpenAIServer:
    def __init__(self, engine: Engine, host: str = "127.0.0.1", port: int = 8000):
        self.engine = engine
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None

    async def _read_request(self, reader: asyncio.StreamReader):
        line = await reader.readline()
        if not line:
            return None, None, None
        method, path, _ = line.decode().split(" ", 2)
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        n = int(headers.get("content-length", 0))
        if n:
            body = await reader.readexactly(n)
        return method, path, body

    async def _respond(self, writer: asyncio.StreamWriter, status: int, obj: dict):
        data = json.dumps(obj).encode()
        writer.write(
            f"HTTP/1.1 {status} {'OK' if status == 200 else 'Error'}\r\n"
            f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n"
            "Connection: close\r\n\r\n".encode() + data
        )
        await writer.drain()
        writer.close()

    async def _handle(self, reader, writer):
        try:
            method, path, body = await self._read_request(reader)
            if method is None:
                writer.close()
                return
            if method == "GET" and path in ("/health", "/v1/models"):
                await self._respond(writer, 200, {
                    "object": "list",
                    "data": [{"id": "deepsearch-tts-tpu", "object": "model"}],
                    "engine": self.engine.telemetry(),
                })
                return
            payload = json.loads(body or b"{}")
            if path.endswith("/load_lora_adapter"):
                # vLLM-compatible LoRA hot-load (reference demo settings.py:99)
                self.engine.load_lora_adapter(
                    payload["lora_path"], payload.get("scale"))
                await self._respond(writer, 200, {
                    "status": "ok", "lora_name": payload.get("lora_name", "")})
                return
            if payload.get("stream") and path.endswith("/chat/completions"):
                await self._stream_chat(writer, payload)
                return
            if path.endswith("/chat/completions"):
                out = await _handle_chat(self.engine, payload)
            elif path.endswith("/completions"):
                out = await _handle_completions(self.engine, payload)
            else:
                await self._respond(writer, 404, {"error": f"unknown path {path}"})
                return
            await self._respond(writer, 200, out)
        except Exception as e:
            try:
                await self._respond(writer, 500, {"error": str(e)})
            except Exception:
                pass

    async def _stream_chat(self, writer: asyncio.StreamWriter, payload: dict):
        """Server-sent-events streaming (OpenAI `stream: true` semantics)."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        req = _chat_payload_to_request(self.engine, payload)
        req.on_delta = lambda piece: loop.call_soon_threadsafe(q.put_nowait, piece)
        cmpl_id = f"chatcmpl-{uuid.uuid4().hex[:20]}"
        model = payload.get("model", "deepsearch-tts-tpu")

        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n")
        await writer.drain()

        def chunk(delta: dict, finish=None):
            obj = {"id": cmpl_id, "object": "chat.completion.chunk",
                   "created": int(time.time()), "model": model,
                   "choices": [{"index": 0, "delta": delta,
                                "finish_reason": finish}]}
            return f"data: {json.dumps(obj)}\n\n".encode()

        writer.write(chunk({"role": "assistant", "content": ""}))
        fut = self.engine.submit(req)
        wrapped = asyncio.wrap_future(fut)
        try:
            while True:
                getter = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    {getter, wrapped}, return_when=asyncio.FIRST_COMPLETED)
                if getter in done:
                    writer.write(chunk({"content": getter.result()}))
                    await writer.drain()
                    continue
                getter.cancel()
                res = wrapped.result()
                # let pending call_soon_threadsafe enqueues land before draining
                for _ in range(3):
                    await asyncio.sleep(0)
                while not q.empty():
                    writer.write(chunk({"content": q.get_nowait()}))
                writer.write(chunk({}, finish=res.finish_reason))
                writer.write(b"data: [DONE]\n\n")
                await writer.drain()
                break
        finally:
            writer.close()

    async def start(self):
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        return self

    async def serve_forever(self):
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
