"""LLM-as-judge answer equivalence with the reference's non-answer blacklist.

The port's own copy of ``evaluate/judge.py`` (same behaviour; imports resolve in this package).

The reference's judge (scripts/evaluate/evaluate.py:193-442) asks a model for
a bare "Correct"/"Incorrect" verdict and then forces *Incorrect* whenever the
prediction contains any of ~35 "non-answer" phrases ("unknown", "not found",
"cannot be determined", ...). That blacklist is load-bearing for reported
accuracy (SURVEY.md §7(c)), so it is reproduced here verbatim as data.
"""
from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Sequence

JUDGE_PROMPT = """You will be given a question, a gold (labeled) answer, and a predicted answer.
Decide whether the predicted answer is equivalent to the gold answer for the
purposes of grading the question. Small differences in formatting, casing,
units, or phrasing do not matter; the factual content must match.

Question: {question}
Labeled Answer: {gold}
Predicted Answer: {pred}

Respond with exactly one word: Correct or Incorrect."""

# Phrases that mark a prediction as a refusal / non-answer; any hit forces an
# Incorrect verdict regardless of the judge model's verdict.
NON_ANSWER_PHRASES: tuple[str, ...] = (
    "not mention", "no definitive answer", "insufficient", "no such article",
    "no match", "unknown", "cannot be determined", "no article match",
    "not enough information", "not stated", "not specified", "not available",
    "meets all", "no publicky documented artist", "no publicly known artist",
    "no publicly", "no such", "no known", "no specific", "not enough",
    "available information", "matches all", "no verifiable",
    "unable to determine", "no conclusive", "no definitive", "no exact",
    "no answer", "not publicly", "no available", "not found", "not found in",
    "not correct",
)


def is_non_answer(pred: str) -> bool:
    p = (pred or "").lower()
    return any(phrase in p for phrase in NON_ANSWER_PHRASES)


def judge_verdict(pred: str, gold: str, response_text: str) -> bool:
    """Combine string equivalence, the model verdict, and the blacklist.

    Mirrors reference evaluate.py:259-296: correct iff the prediction is
    non-empty AND (math-equivalent OR the judge said "correct" without also
    saying "incorrect"/"wrong") AND it is not a blacklisted non-answer.
    """
    from .math_equivalence import is_equiv

    if not pred:
        return False
    rt = (response_text or "").lower()
    model_says_correct = rt == "correct" and "incorrect" not in rt and "wrong" not in rt
    if is_equiv(pred, gold):
        return True
    return model_says_correct and not is_non_answer(pred)


async def llm_judge_batch(
    rows: Sequence[dict],
    complete: Callable[[str], Awaitable[str]],
    concurrency: int = 32,
) -> list[tuple[bool, str]]:
    """Judge rows of {question, pred, gold} with a bounded async fan-out.

    ``complete(prompt) -> text`` is any async completion callable (the HTTP
    client or the in-process engine client both satisfy it).
    """
    sem = asyncio.Semaphore(concurrency)

    async def one(row: dict) -> tuple[bool, str]:
        prompt = JUDGE_PROMPT.format(
            question=row.get("question", ""),
            gold=row.get("gold", ""),
            pred=row.get("pred", ""),
        )
        async with sem:
            try:
                text = (await complete(prompt)).strip()
            except Exception as e:  # judge failures degrade to string match
                text = f"judge-error: {e}"
        return judge_verdict(row.get("pred", ""), str(row.get("gold", "")), text), text

    return list(await asyncio.gather(*(one(r) for r in rows)))
