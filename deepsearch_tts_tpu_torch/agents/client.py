"""Model client layer: one async interface, three backends (port of
``agents/client.py``).

The reference talks to chat-completions HTTP APIs with retry/key-rotation
logic spread over four functions (reference: scripts/deep_search.py:214-665
completions, :1274-1721 tool-calling). Here the same contract is a single
protocol:

    await client.chat(messages, tools=...) -> ChatResponse
    await client.complete(prompt, ...)     -> CompletionResponse

Backends:

* :class:`EngineClient` — the port's in-process engine (a CUDA card, or
  the CPU when the engine was built there): renders the chat template, runs paged-cache generation,
  parses ``<tool_call>`` blocks back into OpenAI-style tool_calls.
* :class:`HTTPClient`  — OpenAI-compatible HTTP endpoint, with the
  reference's resilience semantics: retry w/ exponential backoff, rotation
  across comma-separated API keys, Retry-After on 429, key eviction on 401,
  max_tokens halving on context-length errors.
* :class:`FakeClient`  — scripted responses for hermetic agent tests.

All responses carry token usage, aggregated by agents/tracing.py into the
reference-compatible statistics files.
"""
from __future__ import annotations

import asyncio
import json
import random
from dataclasses import dataclass, field
from typing import Any, Protocol, Sequence


@dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens


@dataclass
class ChatResponse:
    type: str                      # 'tool' | 'normal' | 'error'
    content: str = ""
    tool_calls: list[dict] = field(default_factory=list)
    finish_reason: str = "stop"
    usage: Usage = field(default_factory=Usage)
    error: str | None = None

    @property
    def message(self) -> dict:
        """OpenAI-style assistant message for appending to history."""
        msg: dict[str, Any] = {"role": "assistant", "content": self.content}
        if self.tool_calls:
            msg["tool_calls"] = self.tool_calls
        return msg


@dataclass
class CompletionResponse:
    text: str
    finish_reason: str = "stop"
    usage: Usage = field(default_factory=Usage)


class ModelClient(Protocol):
    async def chat(self, messages: Sequence[dict], tools: Sequence[dict] | None = None,
                   **opts) -> ChatResponse: ...
    async def complete(self, prompt: str, **opts) -> CompletionResponse: ...


# --------------------------------------------------------------------- engine

class EngineClient:
    """Serve chat/completions from an in-process Engine."""

    def __init__(self, engine, tokenizer=None, default_opts: dict | None = None):
        self.engine = engine
        self.tokenizer = tokenizer or engine.tokenizer
        self.defaults = {
            "temperature": 0.7, "top_p": 0.8, "top_k_sampling": 20,
            "min_p": 0.05, "repetition_penalty": 1.05, "max_tokens": 1024,
        }
        self.defaults.update(default_opts or {})

    def _request(self, prompt_ids, opts, stop=()):
        from ..engine.engine import GenerationRequest

        o = {**self.defaults, **opts}
        return GenerationRequest(
            prompt_ids=prompt_ids,
            max_tokens=int(o["max_tokens"]),
            temperature=float(o["temperature"]),
            top_k=int(o.get("top_k_sampling", o.get("top_k", 20))),
            top_p=float(o["top_p"]),
            min_p=float(o["min_p"]),
            repetition_penalty=float(o["repetition_penalty"]),
            # logit-level budget forcing: the engine suppresses EOS in-program
            # until min_tokens are generated (engine/sampling.py:80)
            min_tokens=int(o.get("min_tokens", 0)),
            stop=tuple(stop) + tuple(o.get("stop", ())),
            include_stop_str=bool(o.get("include_stop_str_in_output", False)),
        )

    async def chat(self, messages, tools=None, **opts) -> ChatResponse:
        from ..engine.tokenizer import parse_tool_calls

        prompt = self.tokenizer.apply_chat_template(
            messages, tools=tools, add_generation_prompt=True
        )
        ids = self.tokenizer.encode(prompt)
        fut = self.engine.submit(self._request(ids, opts))
        res = await asyncio.wrap_future(fut)
        content, calls = parse_tool_calls(res.text)
        return ChatResponse(
            type="tool" if calls else "normal",
            content=content,
            tool_calls=calls,
            finish_reason=res.finish_reason,
            usage=Usage(res.prompt_tokens, res.completion_tokens),
        )

    async def complete(self, prompt: str, **opts) -> CompletionResponse:
        ids = self.tokenizer.encode(prompt)
        fut = self.engine.submit(self._request(ids, opts, stop=opts.pop("stop", ())))
        res = await asyncio.wrap_future(fut)
        return CompletionResponse(res.text, res.finish_reason,
                                  Usage(res.prompt_tokens, res.completion_tokens))


# ----------------------------------------------------------------------- http

class HTTPClient:
    """OpenAI-compatible chat completions over HTTP (urllib in a thread)."""

    def __init__(self, base_url: str, api_keys: str = "empty", model: str = "",
                 max_retries: int = 8, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.keys = [k.strip() for k in api_keys.split(",") if k.strip()] or ["empty"]
        self.model = model
        self.max_retries = max_retries
        self.timeout = timeout

    def _post(self, payload: dict, key: str) -> dict:
        import urllib.request

        url = self.base_url if self.base_url.endswith("completions") else (
            self.base_url + "/chat/completions")
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Authorization": f"Bearer {key}",
                     "Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read().decode())

    async def _request_with_retries(self, payload: dict) -> dict:
        import urllib.error

        loop = asyncio.get_running_loop()
        max_tokens_halvings = 0
        for attempt in range(self.max_retries):
            key = random.choice(self.keys)
            try:
                return await loop.run_in_executor(None, self._post, payload, key)
            except urllib.error.HTTPError as e:
                if e.code == 429:
                    retry_after = float(e.headers.get("Retry-After", 1) or 1)
                    await asyncio.sleep(min(retry_after, 60))
                elif e.code == 401 and len(self.keys) > 1:
                    self.keys = [k for k in self.keys if k != key] or self.keys
                elif e.code == 400:
                    body = ""
                    try:
                        body = e.read().decode()
                    except Exception:
                        pass
                    if "context" in body.lower() and max_tokens_halvings < 5:
                        payload["max_tokens"] = max(256, payload.get("max_tokens", 4096) // 2)
                        max_tokens_halvings += 1
                    else:
                        raise
                else:
                    await asyncio.sleep(min(2 ** attempt + random.random(), 30))
            except Exception:
                await asyncio.sleep(min(2 ** attempt + random.random(), 30))
        raise RuntimeError("HTTP request failed after retries")

    async def chat(self, messages, tools=None, **opts) -> ChatResponse:
        payload = {
            "model": opts.get("model", self.model),
            "messages": list(messages),
            "temperature": opts.get("temperature", 0.7),
            "top_p": opts.get("top_p", 0.8),
            "max_tokens": opts.get("max_tokens", 4096),
        }
        # forward stop semantics + extra sampler knobs so the explorer's
        # in-band stop contract holds server-side too (reference forwards
        # these carefully: scripts/deep_search.py:295-316)
        if opts.get("stop"):
            payload["stop"] = list(opts["stop"])
            payload["include_stop_str_in_output"] = bool(
                opts.get("include_stop_str_in_output", False))
        for k in ("top_k", "min_p", "repetition_penalty", "min_tokens"):
            if k in opts:
                payload[k] = opts[k]
        if tools:
            payload["tools"] = list(tools)
            payload["tool_choice"] = opts.get("tool_choice", "auto")
        try:
            data = await self._request_with_retries(payload)
        except Exception as e:
            return ChatResponse(type="error", error=str(e),
                                content=f"Error: {e}")
        choice = (data.get("choices") or [{}])[0]
        msg = choice.get("message", {})
        usage = data.get("usage", {})
        calls = msg.get("tool_calls") or []
        return ChatResponse(
            type="tool" if calls else "normal",
            content=msg.get("content") or "",
            tool_calls=calls,
            finish_reason=choice.get("finish_reason", "stop"),
            usage=Usage(usage.get("prompt_tokens", 0), usage.get("completion_tokens", 0)),
        )

    async def complete(self, prompt: str, **opts) -> CompletionResponse:
        resp = await self.chat([{"role": "user", "content": prompt}], **opts)
        return CompletionResponse(resp.content, resp.finish_reason, resp.usage)


# ----------------------------------------------------------------------- fake

class FakeClient:
    """Scripted client for hermetic agent tests.

    ``script`` is a list of ChatResponse-like dicts consumed in order, or a
    callable (messages, tools) -> ChatResponse for programmable behavior.
    """

    def __init__(self, script=None, handler=None):
        self.script = list(script or [])
        self.handler = handler
        self.calls: list[dict] = []

    async def chat(self, messages, tools=None, **opts) -> ChatResponse:
        self.calls.append({"messages": list(messages), "tools": tools, "opts": opts})
        if self.handler is not None:
            out = self.handler(messages, tools)
            if asyncio.iscoroutine(out):
                out = await out
            return out
        if not self.script:
            return ChatResponse(type="normal", content=r"\boxed{no script}")
        item = self.script.pop(0)
        if isinstance(item, ChatResponse):
            return item
        return ChatResponse(**item)

    async def complete(self, prompt: str, **opts) -> CompletionResponse:
        resp = await self.chat([{"role": "user", "content": prompt}], **opts)
        return CompletionResponse(resp.content, resp.finish_reason, resp.usage)


class FaultInjectionClient:
    """Chaos wrapper: fail a fraction of calls to exercise resilience paths.

    The reference has no fault injection at all (SURVEY.md §5); this wrapper
    lets tests verify that retry/error-row/degradation behavior holds under
    injected model-backend failures.
    """

    def __init__(self, inner, error_rate: float = 0.3, seed: int = 0,
                 exception: bool = False):
        import random as _random

        self.inner = inner
        self.error_rate = error_rate
        self.exception = exception
        self._rng = _random.Random(seed)
        self.injected = 0

    def _fail(self) -> bool:
        if self._rng.random() < self.error_rate:
            self.injected += 1
            return True
        return False

    async def chat(self, messages, tools=None, **opts) -> ChatResponse:
        if self._fail():
            if self.exception:
                raise ConnectionError("injected fault")
            return ChatResponse(type="error", error="injected fault",
                                content="Error: injected fault")
        return await self.inner.chat(messages, tools=tools, **opts)

    async def complete(self, prompt: str, **opts) -> CompletionResponse:
        if self._fail():
            if self.exception:
                raise ConnectionError("injected fault")
            return CompletionResponse("Error: injected fault", "error")
        return await self.inner.complete(prompt, **opts)


def make_tool_call(name: str, arguments: dict) -> dict:
    import uuid

    return {
        "id": f"call_{uuid.uuid4().hex[:12]}",
        "type": "function",
        "function": {"name": name, "arguments": json.dumps(arguments)},
    }
