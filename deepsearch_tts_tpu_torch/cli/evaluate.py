"""Offline evaluation CLI (port of ``cli/evaluate.py``).

Mirrors the reference's evaluation entry point (reference:
scripts/evaluate/evaluate.py:813-891): load a run's output JSON (prefers
``pred_answer`` over raw ``Output``, :852-867), score with the metrics
engine, optionally LLM-judge, bucket by domain, and write
``<output>.metrics.json`` + ``<output>.metrics.overall.json``.

Usage:
    python -m deepsearch_tts_tpu_torch.cli.evaluate \
        --output_path outputs/policy_results_x.json --task qa [--use_llm ...]
"""
from __future__ import annotations

import argparse
import asyncio
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_path", required=True, help="run output JSON")
    p.add_argument("--task", default="qa", choices=["qa", "math", "choose", "code"])
    p.add_argument("--use_llm", action="store_true", help="LLM-judge equivalence")
    p.add_argument("--extract_answer", action="store_true", default=True)
    p.add_argument("--api_base_url", default="")
    p.add_argument("--model_name", default="")
    p.add_argument("--api_key", default="empty")
    p.add_argument("--domain_fields", default="High-level domain,Level,category,domain,type")
    p.add_argument("--use_math_grader", action="store_true",
                   help="sympy symbolic grading for math tasks")
    args = p.parse_args(argv)

    from ..evaluate.metrics import run_evaluation

    with open(args.output_path, encoding="utf-8") as f:
        items = json.load(f)

    judge_fn = None
    if args.use_llm and args.api_base_url:
        from ..agents.client import HTTPClient
        from ..evaluate.judge import JUDGE_PROMPT, judge_verdict

        client = HTTPClient(args.api_base_url, api_keys=args.api_key,
                            model=args.model_name)

        def judge_fn(question, pred, gold):  # noqa: F811
            async def go():
                resp = await client.complete(JUDGE_PROMPT.format(
                    question=question, gold=gold, pred=pred), max_tokens=8)
                return resp.text
            text = asyncio.run(go())
            return judge_verdict(pred, str(gold), text.strip()), text

    if args.task == "code":
        from ..evaluate.code_eval import codegen_metrics
        from ..evaluate.extract import extract_answer_fn

        problems, samples = [], []
        for it in items:
            problems.append(it)
            code = it.get("pred_answer") or extract_answer_fn(
                it.get("Output", ""), mode="codegen", extract_answer=True)
            samples.append([code])
        overall = codegen_metrics(problems, samples)
        overall.pop("per_problem", None)
    else:
        if args.use_math_grader and args.task == "math":
            from ..evaluate.math_grader import math_equal

            base_judge = judge_fn

            def judge_fn(question, pred, gold):  # noqa: F811
                if math_equal(pred, str(gold)):
                    return True, "math_grader"
                return base_judge(question, pred, gold) if base_judge else (False, "")

        overall = run_evaluation(
            items, task_type=args.task,
            output_metrics_path=args.output_path + ".metrics.json",
            output_metrics_overall_path=args.output_path + ".metrics.overall.json",
            extract_answer=args.extract_answer,
            domain_fields=[d.strip() for d in args.domain_fields.split(",")],
            judge_fn=judge_fn,
        )
    print(json.dumps(overall, ensure_ascii=False, indent=2, default=str))


if __name__ == "__main__":
    main()
