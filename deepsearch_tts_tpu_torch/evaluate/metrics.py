"""Metrics engine: per-item EM / Acc / F1 / math-equal, domain bucketing,

The port's own copy of ``evaluate/metrics.py`` (same behaviour; imports resolve in this package).
overall aggregation, and metrics-JSON emission.

Semantics match the reference's ``evaluate_predictions`` / ``run_evaluation``
(reference: scripts/evaluate/evaluate.py:445-810): QA answers are normalized
by lowercasing, punctuation removal, article removal, and whitespace
collapse; ``acc`` is substring containment of the normalized gold in the
normalized prediction; QA takes the max metric over the list of gold
answers; math/choose additionally score LaTeX equivalence. When no answer is
extracted, the prediction falls back to the output's last 5 lines.
"""
from __future__ import annotations

import json
import os
import re
import string
from collections import Counter, defaultdict
from typing import Any, Iterable, Sequence

from .extract import extract_answer_fn
from .math_equivalence import is_equiv

_PUNCT = set(string.punctuation)


def normalize_answer_qa(s: str) -> str:
    s = (s or "").lower()
    s = "".join(ch for ch in s if ch not in _PUNCT)
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.strip().split())


def _normalize_loose(s: str) -> str:
    return " ".join((s or "").lower().strip().split())


def _token_f1(pred: str, gold: str) -> float:
    pt, gt = pred.split(), gold.split()
    if not pt or not gt:
        return 0.0
    overlap = sum((Counter(pt) & Counter(gt)).values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(pt)
    recall = overlap / len(gt)
    return 2 * precision * recall / (precision + recall)


def evaluate_predictions(
    output: str,
    labeled_answer: Any,
    mode: str = "math",
    use_llm: bool = False,
    question: str | None = None,
    extract_answer: bool = False,
) -> tuple[dict, str]:
    metric = {"is_valid_answer": False, "acc": 0, "em": 0, "f1": 0,
              "math_equal": 0, "llm_equal": 0}
    pred = extract_answer_fn(output, mode=mode, extract_answer=extract_answer)
    pred_eval = pred
    if pred != "":
        metric["is_valid_answer"] = True
    else:
        pred_eval = "\n".join(
            (output or "").replace("\n\n", "\n").strip().split("\n")[-5:]
        )

    if mode == "qa":
        golds = labeled_answer if isinstance(labeled_answer, (list, tuple)) else [labeled_answer]
        npred = normalize_answer_qa(pred_eval)
        for gold in golds:
            ngold = normalize_answer_qa(str(gold))
            metric["em"] = max(metric["em"], int(npred == ngold))
            metric["acc"] = max(metric["acc"], int(bool(ngold) and ngold in npred))
            metric["f1"] = max(metric["f1"], _token_f1(npred, ngold))
    elif mode in ("math", "choose"):
        gold = labeled_answer[0] if isinstance(labeled_answer, (list, tuple)) else labeled_answer
        npred, ngold = _normalize_loose(pred_eval), _normalize_loose(str(gold))
        metric["em"] = int(npred == ngold)
        metric["acc"] = int(bool(ngold) and ngold in npred)
        metric["f1"] = _token_f1(npred, ngold)
        metric["math_equal"] = int(is_equiv(npred, ngold))

    return metric, pred


DEFAULT_DOMAIN_FIELDS = ("High-level domain", "Level", "category", "domain", "type")


def run_evaluation(
    items: Sequence[dict],
    task_type: str = "qa",
    output_metrics_path: str | None = None,
    output_metrics_overall_path: str | None = None,
    use_llm: bool = False,
    extract_answer: bool = True,
    domain_fields: Iterable[str] = DEFAULT_DOMAIN_FIELDS,
    judge_fn=None,
) -> dict:
    """Score a list of result rows and write per-item + overall metrics JSONs.

    Each row should carry a question (any alias), a gold answer (any alias),
    and either ``pred_answer`` (preferred) or raw ``Output`` text
    (reference: evaluate.py:852-867 prefers pred_answer).

    ``judge_fn(question, pred, gold) -> (bool, rationale)`` optionally adds an
    LLM-equivalence metric (see judge.py for the reference-parity judge).
    """
    from ..datasets.loaders import extract_answer as gold_of, extract_question

    domain_fields = list(domain_fields)
    per_item = []
    buckets: dict[str, list[dict]] = defaultdict(list)

    for item in items:
        output = item.get("pred_answer") if item.get("pred_answer") not in (None, "") else item.get("Output", "")
        gold = item.get("answer", item.get("Correct Choice", gold_of(item)))
        mode = task_type if task_type != "auto" else "qa"
        metric, pred = evaluate_predictions(
            str(output), gold, mode=mode, extract_answer=extract_answer
        )
        if judge_fn is not None:
            ok, rationale = judge_fn(extract_question(item), pred, gold)
            metric["llm_equal"] = int(bool(ok))
            item = {**item, "llm_rationale": rationale}
        domain = next(
            (item[f] for f in domain_fields if item.get(f) is not None), "Unknown"
        )
        row = {**item, "Pred_Answer": pred, "Metrics": metric}
        per_item.append(row)
        buckets[str(domain)].append(metric)

    keys = ["em", "acc", "f1", "math_equal", "llm_equal"]
    overall: dict[str, Any] = {"total": len(per_item)}
    for k in keys:
        vals = [r["Metrics"][k] for r in per_item]
        overall[k] = sum(vals) / len(vals) if vals else 0.0
    overall["is_valid_answer"] = sum(
        int(r["Metrics"]["is_valid_answer"]) for r in per_item
    )
    overall["domains"] = {
        dom: {
            "total": len(ms),
            **{k: (sum(m[k] for m in ms) / len(ms) if ms else 0.0) for k in keys},
        }
        for dom, ms in sorted(buckets.items())
    }

    if output_metrics_path:
        os.makedirs(os.path.dirname(output_metrics_path) or ".", exist_ok=True)
        with open(output_metrics_path, "w", encoding="utf-8") as f:
            json.dump(per_item, f, ensure_ascii=False, indent=2)
    if output_metrics_overall_path:
        with open(output_metrics_overall_path, "w", encoding="utf-8") as f:
            json.dump(overall, f, ensure_ascii=False, indent=2)
    return overall
