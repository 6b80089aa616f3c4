"""Pairwise multi-system report judging.

The port's own copy of ``evaluate/report_judge.py`` (same behaviour; imports resolve in this package).

Capability match for the reference's report evaluator (reference:
scripts/evaluate/evaluate_report.py:57-193): give an LLM several systems'
reports for one question, get 0-10 scores on comprehensiveness /
thoroughness / factuality / coherence per system, parse them robustly, and
aggregate across questions.
"""
from __future__ import annotations

import asyncio
import json
import re
from typing import Sequence

from ..prompts.reports import REPORT_JUDGE_DIMENSIONS, get_report_evaluation_instruction


def extract_scores(text: str, system_names: Sequence[str]) -> dict[str, dict[str, float]]:
    """Parse judge output into {system: {dimension: score}}.

    Tries strict JSON first (possibly inside a code fence), then regex
    per-system/per-dimension recovery (the reference needs the same
    robustness, evaluate_report.py:193).
    """
    text = text.strip()
    fence = re.search(r"```(?:json)?\s*(.*?)```", text, re.DOTALL)
    if fence:
        text = fence.group(1).strip()
    try:
        data = json.loads(text)
        out = {}
        for name in system_names:
            entry = data.get(name) or {}
            out[name] = {d: float(entry.get(d, 0.0)) for d in REPORT_JUDGE_DIMENSIONS}
        return out
    except (json.JSONDecodeError, TypeError, ValueError):
        pass
    out = {}
    for name in system_names:
        scores = {}
        seg = text
        m = re.search(re.escape(name) + r"(.{0,400})", text, re.DOTALL | re.IGNORECASE)
        if m:
            seg = m.group(1)
        for d in REPORT_JUDGE_DIMENSIONS:
            dm = re.search(d + r"\D{0,10}(\d+(?:\.\d+)?)", seg, re.IGNORECASE)
            scores[d] = float(dm.group(1)) if dm else 0.0
        out[name] = scores
    return out


async def judge_reports(
    rows: Sequence[dict],          # each: {question, reports: {system: text}}
    complete,                       # async prompt -> text
    concurrency: int = 8,
) -> dict:
    """Score every row; return per-system dimension means."""
    sem = asyncio.Semaphore(concurrency)

    async def one(row):
        prompt = get_report_evaluation_instruction(row["question"], row["reports"])
        async with sem:
            try:
                text = await complete(prompt)
            except Exception as e:
                return {name: {d: 0.0 for d in REPORT_JUDGE_DIMENSIONS}
                        for name in row["reports"]}, f"judge-error: {e}"
        return extract_scores(text, list(row["reports"])), text

    results = await asyncio.gather(*(one(r) for r in rows))
    agg: dict[str, dict[str, list[float]]] = {}
    for scores, _ in results:
        for sys_name, dims in scores.items():
            bucket = agg.setdefault(sys_name, {d: [] for d in REPORT_JUDGE_DIMENSIONS})
            for d, v in dims.items():
                bucket[d].append(v)
    return {
        sys_name: {d: (sum(v) / len(v) if v else 0.0) for d, v in dims.items()}
        for sys_name, dims in agg.items()
    }
