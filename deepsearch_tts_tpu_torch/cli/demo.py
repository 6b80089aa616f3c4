"""Interactive demo: token-in-band search agent in the terminal (and via
Streamlit when available; port of ``cli/demo.py``).

Terminal equivalent of the reference's Streamlit demo (reference:
demo/run_demo.py): streams the agent's reasoning, search actions, and
results for one query.

Usage:
    python -m deepsearch_tts_tpu_torch.cli.demo --question "..." --backend fake
    python -m deepsearch_tts_tpu_torch.cli.demo --question "..." --backend engine \
        --engine_pages 1024 --engine_max_slots 16

JAX's flags, plus the engine flags of ``cli/deep_search.py`` (every
``--engine_*`` flag, ``--device`` and ``--seed``, with its defaults), passed
on to ``build_demo_session`` as ``extra_args``. The terminal demo shuts its
engines down when the agent is done.
"""
from __future__ import annotations

import argparse
import asyncio


def build_demo_session(backend: str, model_name: str = "qwen3-8b",
                       aux_model_name: str = "qwen3-4b",
                       search_backend: str = "replay",
                       max_search_calls: int = 10,
                       question: str | None = None,
                       extra_args: list[str] | None = None):
    """Shared demo wiring for the terminal and Streamlit UIs: honor the
    backend selector (fake | engine | http) and return
    ``(env, client, aux, tool)`` ready for ``run_inband_agent``.

    The reference demo builds its vLLM/search session inside the Streamlit
    page (reference: demo/run_demo.py); here the same construction is
    importable so both front ends and tests drive identical wiring.
    """
    from ..agents.client import ChatResponse, FakeClient
    from ..agents.websearch import WebSearchTool
    from ..demo.environment import Environment
    from ..prompts import qa as P

    env = Environment(model_name=model_name, aux_model_name=aux_model_name,
                      max_search_limit=max_search_calls)

    if backend == "fake":
        calls = {"n": 0}

        async def fake_complete(prompt, **opts):
            from ..agents.client import CompletionResponse
            # the task instruction itself mentions the in-band tokens, so key
            # on the call sequence: search once, then answer from the result
            calls["n"] += 1
            if calls["n"] > 1:
                return CompletionResponse(r"Based on the results, \boxed{demo answer}")
            q = question or "demo query"
            return CompletionResponse(
                f"I should search. {P.BEGIN_SEARCH_QUERY}{q}{P.END_SEARCH_QUERY}")
        client = type("C", (), {"complete": staticmethod(fake_complete)})()
        aux = FakeClient(handler=lambda m, t: ChatResponse(
            type="normal", content="**Final Information**: demo info"))
        from ..web.fetch import PageFetcher
        from ..web.replay import ReplaySearchBackend, replay_fetcher, synthetic_store
        store = synthetic_store({question or "demo query": "The demo fact."})
        tool = WebSearchTool(ReplaySearchBackend(store),
                             PageFetcher(raw_fetch=replay_fetcher(store)),
                             aux, use_explorer=False)
        return env, client, aux, tool

    from .deep_search import build_parser, make_clients, make_search
    ds_args = build_parser().parse_args([
        "--backend", backend, "--model_name", model_name,
        "--aux_model_name", aux_model_name,
        "--search_backend", search_backend,
    ] + (extra_args or []))
    client, aux, _ = make_clients(ds_args)
    sbackend, fetcher = make_search(ds_args)
    tool = WebSearchTool(sbackend, fetcher, aux)
    return env, client, aux, tool


async def run(args):
    from ..demo.inband import run_inband_agent
    from .deep_search import engine_argv, shutdown_engines

    env, client, aux, tool = build_demo_session(
        args.backend, args.model_name, args.aux_model_name,
        args.search_backend, args.max_search_calls, question=args.question,
        extra_args=engine_argv(args))

    async for ev in run_inband_agent(args.question, env, client, aux, tool):
        if ev.kind == "text":
            print(ev.payload, end="", flush=True)
        elif ev.kind == "search":
            print(f"\n\033[36m[searching: {ev.payload}]\033[0m")
        elif ev.kind == "result":
            print(f"\033[33m[result: {ev.payload[:200]}]\033[0m")
        else:
            print(f"\n\n\033[32mFINAL ANSWER: {ev.payload}\033[0m")
    shutdown_engines(client, aux)


def main(argv=None):
    from .deep_search import add_engine_flags

    p = argparse.ArgumentParser()
    p.add_argument("--question", required=True)
    p.add_argument("--backend", default="fake", choices=["fake", "engine", "http"])
    p.add_argument("--search_backend", default="replay")
    p.add_argument("--model_name", default="qwen3-8b")
    p.add_argument("--aux_model_name", default="qwen3-4b")
    p.add_argument("--max_search_calls", type=int, default=10)
    add_engine_flags(p)
    args = p.parse_args(argv)
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
