"""Reference-compatible CLI: the ``deep_search.py`` entry point (port of
``cli/deep_search.py``).

Preserves the public flag surface and mode set of the reference's
orchestrator (reference: scripts/deep_search.py:3943-3980 — 30 flags, modes
search/solve/verify/solve_budget_forcing/verify_budget_forcing) and its
output trace schema, with the JAX CLI's backend flags (``--backend engine``
serves the policy/aux models from the port's in-process engine;
``--backend http`` matches the reference's hosted-API behavior;
``--backend fake`` runs hermetically for tests). Defaults never embed real
API keys (the reference shipped live keys in its defaults; deliberately not
reproduced).

The flags and defaults are the JAX CLI's (the policy engine takes
``--engine_prefill_lane``, the aux engine no lane, as in JAX), except:

* ``--device`` (default ``cuda``) and ``--seed`` (of the random weights
  drawn when a weights path is empty) are added, as in ``cli/serve.py``;
* ``--engine_tp N`` runs under ``torchrun`` (one process a rank, as
  ``cli/serve.py --tp``): every rank builds the sharded policy engine,
  rank 0 runs the agents (and its aux engine, single-device as in JAX) and
  writes the results, and the other ranks follow the policy engine's
  scheduler until rank 0 shuts it down.

JAX's persistent compile cache has no counterpart here. With ``--backend
engine`` both engines are shut down before ``main`` returns.

Usage:
    python -m deepsearch_tts_tpu_torch.cli.deep_search --mode solve \
        --input_path data/BrowseCompEN-Sample100/all_data_random100_sample1.json \
        --backend engine --model_name qwen3-8b --aux_model_name qwen3-4b
    python -m deepsearch_tts_tpu_torch.cli.deep_search --mode solve \
        --backend engine --search_backend replay --device cpu \
        --model_name qwen3-test --aux_model_name qwen3-test --input_path x.json
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Deep-search test-time scaling on the port's engine")
    # reference-compatible flags (scripts/deep_search.py:3943-3980)
    p.add_argument("--query", type=str, help="single search query (mode=search)")
    p.add_argument("--pred_answer", type=str, help="predicted answer to verify")
    p.add_argument("--context", type=str, default="")
    p.add_argument("--api_base_url", type=str, default="http://localhost:8000/v1")
    p.add_argument("--aux_api_base_url", type=str, default="http://localhost:8000/v1")
    p.add_argument("--bing_subscription_key", type=str, default="")
    p.add_argument("--use_bing_pro", action="store_true")
    p.add_argument("--bing_pro_token", type=str, default="")
    p.add_argument("--use_google_pro", action="store_true")
    p.add_argument("--google_pro_api_key", type=str, default="")
    p.add_argument("--api_key", type=str, default="empty")
    p.add_argument("--aux_api_key", type=str, default="empty")
    p.add_argument("--use_custom_api", action="store_true")
    p.add_argument("--custom_api_url", type=str, default=None)
    p.add_argument("--use_aihubmix", action="store_true")
    p.add_argument("--aihubmix_api_url", type=str, default="")
    p.add_argument("--aihubmix_api_keys", type=str, default="")
    p.add_argument("--model_name", type=str, default="qwen3-8b")
    p.add_argument("--aux_model_name", type=str, default="qwen3-4b")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top_p", type=float, default=0.8)
    p.add_argument("--min_p", type=float, default=0.05)
    p.add_argument("--top_k", type=int, default=10, help="search documents to keep")
    p.add_argument("--top_k_sampling", type=int, default=20)
    p.add_argument("--repetition_penalty", type=float, default=1.05)
    p.add_argument("--max_tokens", type=int, default=81920)
    p.add_argument("--input_path", type=str, default="")
    p.add_argument("--output_dir", type=str, default="./outputs")
    p.add_argument("--max_search_calls", type=int, default=15)
    p.add_argument("--concurrent_limit", type=int, default=32)
    p.add_argument("--mode", type=str, default="search",
                   choices=["search", "solve", "verify", "verify_budget_forcing",
                            "solve_budget_forcing", "solve_bestofn"])
    p.add_argument("--price_config_path", type=str,
                   default="./model_config/aihubmix_price.json")
    # backend flags
    p.add_argument("--backend", type=str, default="http",
                   choices=["engine", "http", "fake"],
                   help="model backend: in-process engine, hosted HTTP, or fake")
    p.add_argument("--search_backend", type=str, default="serper",
                   choices=["serper", "bing", "replay"])
    p.add_argument("--serper_api_key", type=str,
                   default=os.environ.get("SERPER_API_KEY", ""))
    p.add_argument("--replay_path", type=str, default="",
                   help="replay fixture for --search_backend replay")
    p.add_argument("--weights_path", type=str, default="",
                   help="safetensors dir for --backend engine (random init if empty)")
    p.add_argument("--aux_weights_path", type=str, default="",
                   help="safetensors dir for the aux model engine")
    p.add_argument("--tokenizer_path", type=str, default="")
    add_engine_flags(p)
    p.add_argument("--limit", type=int, default=0, help="max problems (0 = all)")
    p.add_argument("--verifier_version", type=int, default=0)
    p.add_argument("--budget_forcing", type=str, default="text",
                   choices=["text", "logit"],
                   help="*_budget_forcing re-entry mechanism: 'text' = the "
                        "reference's user nudge only; 'logit' = nudge + "
                        "on-device EOS suppression (engine refuses EOS until "
                        "--min_thinking_tokens are generated)")
    p.add_argument("--min_thinking_tokens", type=int, default=512,
                   help="forced continuation length for --budget_forcing logit")
    p.add_argument("--n_samples", type=int, default=4,
                   help="samples for --mode solve_bestofn (parallel scaling)")
    return p


def add_engine_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags of the engines :func:`make_clients` builds: every
    ``--engine_*`` flag, ``--device`` and ``--seed``. ``cli/report.py``,
    ``cli/lcb_run.py`` and ``cli/demo.py`` take them too, with these
    defaults, and pass them on through :func:`engine_argv`."""
    p.add_argument("--engine_max_slots", type=int, default=64)
    p.add_argument("--engine_page_size", type=int, default=64)
    p.add_argument("--engine_pages", type=int, default=4096)
    p.add_argument("--engine_max_seq_len", type=int, default=8192)
    p.add_argument("--engine_prefill_lane", type=int, default=16,
                   help="in-flight prefill width of the policy engine: a "
                        "prompt of at most this many tokens rides a decode "
                        "step (0 = off)")
    p.add_argument("--engine_warmup", type=int, default=0,
                   help="pre-compile engine programs for this prompt length")
    p.add_argument("--engine_tp", type=int, default=0,
                   help="tensor-parallel ways for the engine (0 = single device; "
                        ">1 under torchrun, one process a rank)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the engines for --backend engine (cuda or cpu)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used when a weights path is empty")
    return p


def engine_argv(args) -> list[str]:
    """``args``' engine flags (:func:`add_engine_flags`) as arguments of
    :func:`build_parser`, values unchanged."""
    argv = []
    for a in add_engine_flags(argparse.ArgumentParser())._actions:
        if a.dest != "help":
            argv += [a.option_strings[0], str(getattr(args, a.dest))]
    return argv


def shutdown_engines(*clients) -> None:
    """Shut down the engine behind each client (the aux engine too: a
    co-served engine left running keeps its weights and KV pool on the
    card)."""
    for client in clients:
        if getattr(client, "engine", None) is not None:
            client.engine.shutdown()


def make_clients(args):
    """Build (main client, aux client, engine handles) per --backend."""
    from ..agents.client import FakeClient, HTTPClient

    if args.backend == "http":
        main = HTTPClient(args.custom_api_url or args.aihubmix_api_url or
                          args.api_base_url,
                          api_keys=args.aihubmix_api_keys or args.api_key,
                          model=args.model_name)
        aux = HTTPClient(args.aux_api_base_url,
                         api_keys=args.aux_api_key, model=args.aux_model_name)
        return main, aux, None
    if args.backend == "fake":
        from ..agents.client import ChatResponse

        def handler(messages, tools):
            return ChatResponse(type="normal", content=r"\boxed{fake answer}")

        return FakeClient(handler=handler), FakeClient(handler=handler), None

    # in-process engine backend
    from ..device import resolve_device
    from ..engine.engine import Engine
    from ..engine.tokenizer import ByteTokenizer, HFTokenizer
    from ..agents.client import EngineClient

    from .serve import _tp_mesh

    mesh = _tp_mesh(args.engine_tp, args.device)
    device = resolve_device(args.device)
    tok = (HFTokenizer(args.tokenizer_path) if args.tokenizer_path
           else ByteTokenizer())

    def build(name, weights_path, **kw):
        # with weights: converted onto the device (under a mesh onto the
        # host, each rank moving its slices to the card one matrix at a
        # time); without: params=None, so the Engine draws random weights
        # from --seed on the device itself
        params = None
        if weights_path:
            from ..engine.weights import load_or_init_params

            params, name = load_or_init_params(name, weights_path,
                                               device=device if mesh is None else "cpu")
        return Engine(name, tok, params=params, device=device, seed=args.seed,
                      page_size=args.engine_page_size,
                      max_seq_len=args.engine_max_seq_len, **kw)

    sharded = {} if mesh is None else {"mesh": mesh}
    engine = build(args.model_name, args.weights_path, **sharded,
                   max_slots=args.engine_max_slots, n_pages=args.engine_pages,
                   prefill_lane=args.engine_prefill_lane)
    if args.engine_warmup:
        engine.warmup(prompt_lens=(args.engine_warmup,))
    if mesh is not None and engine.multi and engine.par.rank != 0:
        return None, None, engine   # a follower rank: no agents, no aux engine
    main = EngineClient(engine)
    if args.aux_model_name and args.aux_model_name != args.model_name:
        # co-serve a distinct aux verifier/explorer model on the same card:
        # separate engine + KV pool, half the slot budget
        aux_engine = build(args.aux_model_name, args.aux_weights_path,
                           max_slots=max(args.engine_max_slots // 2, 4),
                           n_pages=max(args.engine_pages // 2, 64))
        aux = EngineClient(aux_engine)
    else:
        aux = EngineClient(engine)
    return main, aux, engine


def make_search(args):
    from ..web.fetch import PageFetcher
    from ..web.replay import ReplaySearchBackend, ReplayStore, replay_fetcher
    from ..web.search import BingBackend, SerperBackend

    if args.search_backend == "replay":
        store = ReplayStore.load(args.replay_path) if args.replay_path else ReplayStore()
        return ReplaySearchBackend(store), PageFetcher(raw_fetch=replay_fetcher(store))
    if args.use_bing_pro:
        from ..web.search import BingProBackend

        return BingProBackend(args.bing_pro_token), PageFetcher()
    if args.search_backend == "bing":
        return BingBackend(args.bing_subscription_key), PageFetcher()
    return SerperBackend(args.serper_api_key), PageFetcher()


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    from ..agents.policy import PolicyAgent
    from ..agents.runner import BatchRunner
    from ..agents.tracing import RunStatistics
    from ..agents.websearch import WebSearchTool
    from ..datasets.loaders import load_dataset

    stats = RunStatistics(args.model_name, args.aux_model_name,
                          args.price_config_path)
    main_client, aux_client, engine = make_clients(args)
    if engine is not None and engine.multi and engine.par.rank != 0:
        engine.follow()   # rank 0 runs the agents and writes the results
        return
    search_backend, fetcher = make_search(args)

    gen_opts = {
        "temperature": args.temperature, "top_p": args.top_p,
        "min_p": args.min_p, "top_k_sampling": args.top_k_sampling,
        "repetition_penalty": args.repetition_penalty,
        "max_tokens": min(args.max_tokens, 16384),
    }
    tool = WebSearchTool(search_backend, fetcher, aux_client,
                         top_k=args.top_k, stats=stats, gen_opts=gen_opts)
    agent = PolicyAgent(main_client, search_tool=tool,
                        max_search_calls=args.max_search_calls,
                        gen_opts=gen_opts, stats=stats,
                        verifier_version=args.verifier_version,
                        budget_forcing=args.budget_forcing,
                        min_thinking_tokens=args.min_thinking_tokens)

    try:
        if args.mode == "search":
            if not args.query:
                raise SystemExit("--query required for mode=search")
            result = asyncio.run(tool.search_with_intent(args.query,
                                                         args.context or args.query))
            print(json.dumps(result, ensure_ascii=False, indent=2))
            return

        problems = load_dataset(args.input_path, limit=args.limit or None)
        runner = BatchRunner(agent, output_dir=args.output_dir,
                             concurrent_limit=args.concurrent_limit,
                             mode=args.mode, n_samples=args.n_samples, stats=stats)
        results = runner.run_sync(problems)

        ts = time.strftime("%Y%m%d_%H%M%S")
        if engine is not None:
            stats.engine_stats = engine.telemetry()
    finally:
        shutdown_engines(main_client, aux_client)
    stats_path = stats.save(args.output_dir, ts)
    print(f"Processed {len(results)} problems -> "
          f"{getattr(runner, 'last_result_file', runner.result_path(ts))}")
    print(f"Statistics -> {stats_path}")
    summary = stats.summary()
    print(json.dumps({"api_counters": summary["api_counters"],
                      "token_usage": summary["token_usage"],
                      "cost": summary["cost"]}, indent=2))


if __name__ == "__main__":
    main()
