"""LiveCodeBench runner: all three scenarios end-to-end (port of
``cli/lcb_run.py``).

Generates N solutions per problem through any backend, scores them, and
reports pass@k — the same generate→extract→score pipeline as the
reference's scripts/lcb_runner (runner/main.py + evaluation/), with
``--continue_existing``-style resume. Scenarios
(reference: scripts/lcb_runner/utils/scenarios.py):

* ``codegen`` — write a program, execute it against the test suite in the
  sandbox (evaluate/code_eval.codegen_metrics).
* ``codeexecution`` — predict a program's output; scored by executing
  ``assert expected == predicted`` (code_eval.code_execution_metrics).
* ``testoutput`` — complete an ``assert fn(input) == ...`` test case;
  scored by literal comparison (code_eval.test_output_metrics).

Usage:
    python -m deepsearch_tts_tpu_torch.cli.lcb_run --input_path problems.json \
        --scenario codegen --backend engine --n 4 --k 1,2 --output_dir ./out

Codegen problem rows: {"Question"|"question_content", "starter_code"?,
"test_cases": [{"input", "expected_output"} | {"fn_name", "args",
"expected"}]}. The other scenarios always read raw LCB dataset exports.

JAX's flags, plus the engine flags of ``cli/deep_search.py`` (every
``--engine_*`` flag, ``--device`` and ``--seed``, with its defaults), passed
on unchanged. As in JAX, ``--backend engine`` also builds ``deep_search``'s
default aux engine (qwen3-4b), which no scenario uses. The generations are
scored while the engines still run; both are shut down before ``main``
returns.
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
    p.add_argument("--scenario", default="codegen",
                   choices=["codegen", "codeexecution", "testoutput"])
    p.add_argument("--backend", default="fake", choices=["engine", "http", "fake"])
    p.add_argument("--model_name", default="qwen3-8b")
    p.add_argument("--n", type=int, default=1, help="samples per problem")
    p.add_argument("--k", default="1", help="comma-separated pass@k values")
    p.add_argument("--timeout", type=float, default=6.0)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--concurrent_limit", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=1,
                   help="parallel eval processes (lcb multiprocess pool)")
    p.add_argument("--lcb_format", action="store_true",
                   help="codegen input is a raw LiveCodeBench dataset export "
                        "(compressed private tests are decoded)")
    p.add_argument("--cot_code_execution", action="store_true",
                   help="chain-of-thought prompt for the codeexecution "
                        "scenario")
    p.add_argument("--continue_existing", default="",
                   help="prior generations JSON to resume from")
    add_engine_flags(p)
    args = p.parse_args(argv)

    from ..datasets.loaders import load_dataset
    from ..evaluate import code_eval
    from ..evaluate.extract import extract_answer_fn
    from ..evaluate import lcb_prompts
    from .deep_search import build_parser, engine_argv, make_clients, shutdown_engines

    ds_args = build_parser().parse_args(
        ["--backend", args.backend, "--model_name", args.model_name] + engine_argv(args))
    client, aux, _ = make_clients(ds_args)

    limit = args.limit or None
    if args.scenario == "codegen":
        if args.lcb_format:
            from ..evaluate.lcb_benchmarks import load_code_generation_rows

            problems = load_code_generation_rows(args.input_path, limit=limit)
        else:
            problems = load_dataset(args.input_path, limit=limit)

        def messages(rec):
            return lcb_prompts.codegen_messages(rec, args.model_name)

        def extract(text):
            return extract_answer_fn(text, mode="codegen", extract_answer=True)
    else:
        from ..evaluate.lcb_benchmarks import Scenario, load_scenario_rows

        scen = (Scenario.codeexecution if args.scenario == "codeexecution"
                else Scenario.testoutputprediction)
        problems = load_scenario_rows(args.input_path, scen, limit=limit)
        if args.scenario == "codeexecution":
            def messages(rec):
                return lcb_prompts.code_execution_messages(
                    rec, args.model_name, cot=args.cot_code_execution)

            def extract(text):
                return code_eval.extract_execution_answer(
                    text, cot=args.cot_code_execution)
        else:
            def messages(rec):
                return lcb_prompts.test_output_prediction_messages(
                    rec, args.model_name)

            extract = code_eval.extract_test_output_answer

    prior: dict[str, list[str]] = {}
    if args.continue_existing and os.path.exists(args.continue_existing):
        with open(args.continue_existing, encoding="utf-8") as f:
            prior = {r["key"]: r["codes"] for r in json.load(f)}

    async def gen_all():
        sem = asyncio.Semaphore(args.concurrent_limit)

        async def one(i, rec):
            key = str(rec.get("id", i))
            if key in prior and len(prior[key]) >= args.n:
                return key, prior[key][: args.n]
            async with sem:
                outs = []
                for _ in range(args.n):
                    resp = await client.chat(messages(rec), max_tokens=4096)
                    outs.append(extract(resp.content))
                return key, outs

        return await asyncio.gather(*(one(i, r) for i, r in enumerate(problems)))

    gen = asyncio.run(gen_all())
    samples = [codes for _, codes in gen]

    ts = time.strftime("%Y%m%d_%H%M%S")
    os.makedirs(args.output_dir, exist_ok=True)
    gen_path = os.path.join(args.output_dir, f"{args.scenario}_{ts}.json")
    with open(gen_path, "w", encoding="utf-8") as f:
        json.dump([{"key": k, "codes": c} for k, c in gen], f, indent=1)

    k_list = tuple(int(x) for x in args.k.split(","))
    if args.scenario == "codegen":
        metrics = code_eval.codegen_metrics(problems, samples, k_list=k_list,
                                            timeout=args.timeout,
                                            num_workers=args.num_workers)
    elif args.scenario == "codeexecution":
        metrics = code_eval.code_execution_metrics(problems, samples,
                                                   timeout=args.timeout)
    else:
        metrics = code_eval.test_output_metrics(problems, samples,
                                                k_list=k_list,
                                                timeout=args.timeout)
    metrics.pop("per_problem", None)
    shutdown_engines(client, aux)
    print(json.dumps(metrics, indent=2))
    print(f"generations -> {gen_path}")


if __name__ == "__main__":
    main()
