"""Report-generation batch CLI (WebThinker report mode over e.g. Glaive;
port of ``cli/report.py``).

Usage:
    python -m deepsearch_tts_tpu_torch.cli.report --input_path data/Glaive/test.json \
        --backend engine --output_dir ./outputs [--limit N]

Writes ``report_results_<ts>.json`` rows: input fields + ``title`` /
``report`` / ``plan`` / ``sections``. Judge them with
evaluate/report_judge.py.

JAX's flags, plus the engine flags of ``cli/deep_search.py`` (every
``--engine_*`` flag, ``--device`` and ``--seed``, with its defaults), which
are passed on unchanged: with ``--backend engine`` JAX's version builds its
engines at ``deep_search``'s default pools, which do not fit beside
qwen3-8b and qwen3-4b on one 80 GB card. Both engines are shut down before
``main`` returns.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import time


def main(argv=None):
    from .deep_search import add_engine_flags

    p = argparse.ArgumentParser()
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_dir", default="./outputs")
    p.add_argument("--backend", default="fake", choices=["engine", "http", "fake"])
    p.add_argument("--search_backend", default="replay")
    p.add_argument("--model_name", default="qwen3-8b")
    p.add_argument("--aux_model_name", default="qwen3-4b")
    p.add_argument("--concurrent_limit", type=int, default=4)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--max_sections", type=int, default=8)
    add_engine_flags(p)
    args = p.parse_args(argv)

    from ..agents.report import generate_report
    from ..agents.websearch import WebSearchTool
    from ..datasets.loaders import extract_question, load_dataset
    from .deep_search import (build_parser, engine_argv, make_clients, make_search,
                              shutdown_engines)

    ds_args = build_parser().parse_args([
        "--backend", args.backend, "--model_name", args.model_name,
        "--aux_model_name", args.aux_model_name,
        "--search_backend", args.search_backend,
    ] + engine_argv(args))
    client, aux, _ = make_clients(ds_args)
    backend, fetcher = make_search(ds_args)
    tool = WebSearchTool(backend, fetcher, aux, use_explorer=False)

    problems = load_dataset(args.input_path, limit=args.limit or None)
    os.makedirs(args.output_dir, exist_ok=True)

    async def run_all():
        sem = asyncio.Semaphore(args.concurrent_limit)

        async def one(rec):
            q = extract_question(rec)
            async with sem:
                try:
                    res = await generate_report(q, client, tool,
                                                max_sections=args.max_sections)
                    return {**rec, "title": res.title, "report": res.report,
                            "plan": res.plan,
                            "sections": [s["name"] for s in res.sections]}
                except Exception as e:
                    return {**rec, "report": f"Error: {e}", "error": str(e)}

        return await asyncio.gather(*(one(r) for r in problems))

    rows = asyncio.run(run_all())
    ts = time.strftime("%Y%m%d_%H%M%S")
    out = os.path.join(args.output_dir, f"report_results_{ts}.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(list(rows), f, ensure_ascii=False, indent=2)
    shutdown_engines(client, aux)
    print(f"Wrote {len(rows)} reports -> {out}")


if __name__ == "__main__":
    main()
