"""Sandboxed code-generation evaluation (LiveCodeBench-runner capability).

The port's own copy of ``evaluate/code_eval.py`` (same behaviour; imports resolve in this package).

The reference vendors ~4.5k LoC of LCB harness (scripts/lcb_runner/): test
execution in a child process with alarm timeouts and stdout capture
(evaluation/testing_util.py), pass@k (evaluation/pass_k_utils.py), and
parallel evaluation (utils/multiprocess.py). This module supplies the same
capabilities:

* :func:`run_test_cases` — executes a candidate program against stdin/stdout
  test cases in a separate process with a hard timeout, or calls a named
  function for functional tests.
* :func:`pass_at_k` — the unbiased estimator from the Codex paper.
* :func:`codegen_metrics` — per-problem aggregation over n samples.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import sys
from dataclasses import dataclass


@dataclass
class TestCase:
    input: str = ""
    expected_output: str = ""
    fn_name: str | None = None     # functional test: call fn(*args)
    args: tuple = ()
    expected: object = None


def _worker(code: str, case: dict, q) -> None:
    """Run one test in a child process. stdin/stdout are redirected."""
    import io

    try:
        if case.get("fn_name"):
            ns: dict = {}
            exec(code, ns)  # noqa: S102 — sandboxed evaluation of benchmark code
            fn = ns.get(case["fn_name"])
            if fn is None:
                q.put(("error", f"function {case['fn_name']} not defined"))
                return
            out = fn(*case.get("args", ()))
            ok = out == case.get("expected")
            q.put(("pass" if ok else "fail", repr(out)))
        else:
            sys.stdin = io.StringIO(case.get("input", ""))
            buf = io.StringIO()
            sys.stdout = buf
            ns = {"__name__": "__main__"}
            exec(code, ns)  # noqa: S102
            sys.stdout = sys.__stdout__
            got = buf.getvalue()
            ok = _normalize_io(got) == _normalize_io(case.get("expected_output", ""))
            q.put(("pass" if ok else "fail", got[:2000]))
    except SystemExit:
        sys.stdout = sys.__stdout__
        got = ""
        try:
            got = buf.getvalue()  # type: ignore[name-defined]
        except Exception:
            pass
        ok = _normalize_io(got) == _normalize_io(case.get("expected_output", ""))
        q.put(("pass" if ok else "fail", got[:2000]))
    except Exception as e:
        q.put(("error", f"{type(e).__name__}: {e}"))


def _normalize_io(s: str) -> list[str]:
    return [line.rstrip() for line in s.strip().splitlines()]


def run_test_cases(code: str, cases: list[dict], timeout: float = 6.0) -> list[dict]:
    """Execute code against each test case in an isolated process."""
    results = []
    ctx = mp.get_context("fork")
    for case in cases:
        q = ctx.Queue()
        p = ctx.Process(target=_worker, args=(code, case, q))
        p.start()
        p.join(timeout)
        if p.is_alive():
            p.terminate()
            p.join()
            results.append({"status": "timeout", "detail": ""})
            continue
        try:
            status, detail = q.get_nowait()
        except Exception:
            status, detail = "error", "no result (crashed)"
        results.append({"status": status, "detail": detail})
    return results


def pass_at_k(n: int, c: int, k: int) -> float:
    """Unbiased pass@k (Chen et al. 2021): 1 - C(n-c, k)/C(n, k)."""
    if n - c < k:
        return 1.0
    return 1.0 - math.prod(1.0 - k / i for i in range(n - c + 1, n + 1))


def _eval_one_problem(job: tuple) -> dict:
    """Worker body for the parallel pool (module-level: must pickle)."""
    cases, samples, timeout = job
    n_correct = 0
    details = []
    for code in samples:
        if not code:
            details.append([])
            continue
        res = run_test_cases(code, cases, timeout=timeout)
        details.append(res)
        if res and all(r["status"] == "pass" for r in res):
            n_correct += 1
    return {"n": len(samples), "correct": n_correct, "details": details}


def codegen_metrics(problems: list[dict], samples_per_problem: list[list[str]],
                    k_list: tuple[int, ...] = (1,), timeout: float = 6.0,
                    num_workers: int = 1) -> dict:
    """Evaluate n generations per problem; report pass@k averages.

    problems[i]["test_cases"] is a list of TestCase-style dicts.
    ``num_workers > 1`` evaluates problems in a process pool (the
    reference's parallel evaluation, lcb_runner/utils/multiprocess.py:33-80
    — here stdlib ProcessPoolExecutor; each test still runs in its own
    sandboxed child with a hard timeout either way).
    """
    jobs = [(prob.get("test_cases", []), samples, timeout)
            for prob, samples in zip(problems, samples_per_problem)]
    if num_workers > 1 and len(jobs) > 1:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=mp.get_context("fork")) as pool:
            per_problem = list(pool.map(_eval_one_problem, jobs))
    else:
        per_problem = [_eval_one_problem(j) for j in jobs]
    out = {}
    for k in k_list:
        vals = [pass_at_k(p["n"], p["correct"], k) for p in per_problem
                if p["n"] >= k]
        out[f"pass@{k}"] = sum(vals) / len(vals) if vals else 0.0
    out["per_problem"] = per_problem
    return out


# --------------------------------------------------------------------------
# Code-execution scenario: predict a program's output
# (reference: scripts/lcb_runner/evaluation/compute_code_execution_metrics.py,
# utils/extraction_utils.py:49-59)
# --------------------------------------------------------------------------

# Common competitive-programming imports made available to the checked
# assertion, mirroring the reference's BASE_IMPORTS preamble
# (evaluation/utils_execute.py:28-57) — the predicted/expected literals may
# spell values like ``inf`` or ``Counter({...})``.
_EXEC_PREAMBLE = """import collections, itertools, functools, math, string, re
import heapq, bisect, copy, random, operator
from collections import defaultdict, deque, Counter, OrderedDict
from itertools import accumulate, chain, combinations, permutations, product, groupby, islice, repeat, zip_longest, cycle
from functools import reduce, cache, lru_cache, partial
from math import floor, ceil, sqrt, isqrt, gcd, comb, inf, log, log2, log10, prod
from bisect import bisect, bisect_left, bisect_right, insort
from heapq import heappush, heappop, heapify, merge
from string import ascii_lowercase
from typing import List, Tuple, Dict, Set, Optional, Union, Any, Callable, Iterable, Iterator, Generator
try:
    import numpy as np
except ImportError:
    pass
"""


def extract_execution_answer(text: str, cot: bool = False) -> str:
    """Pull the predicted output literal out of a code-execution response.

    Same ladder as the reference (extraction_utils.py:49-59): take what
    follows ``[ANSWER]`` (cot mode), then what follows ``==``, then cut at
    ``[/ANSWER]`` — or, absent the closing tag, the first line.
    """
    if cot and "[ANSWER]" in text:
        text = text.split("[ANSWER]")[1].strip()
    if "==" in text:
        text = text.split("==")[1].strip()
    if "[/ANSWER]" in text:
        text = text.split("[/ANSWER]")[0].strip()
    else:
        text = text.split("\n")[0].strip()
    return text.strip()


def _assert_worker(snippet: str, q) -> None:
    try:
        exec(snippet, {"__name__": "__main__"})  # noqa: S102 — sandboxed
        q.put(True)
    except BaseException:
        q.put(False)


def _run_assertion(snippet: str, timeout: float) -> bool:
    """Execute a self-checking snippet in a child process; True iff it exits
    cleanly within the timeout."""
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=_assert_worker, args=(snippet, q))
    p.start()
    p.join(timeout)
    if p.is_alive():
        p.terminate()
        p.join()
        return False
    try:
        return bool(q.get_nowait())
    except Exception:
        return False


def code_execution_metrics(problems: list[dict],
                           samples_per_problem: list[list[str]],
                           timeout: float = 3.0) -> dict:
    """pass@1 for output prediction: each sample is an extracted literal;
    correct iff ``assert {expected} == {sample}`` holds when executed with
    the problem's code in scope.

    Reference semantics (compute_code_execution_metrics.py:7-22): a sample
    that still contains the raw input expression is discarded (the model
    echoed the question instead of answering); a problem whose samples are
    all discarded scores 0. pass@1 is reported as a fraction (the reference
    multiplies by 100).
    """
    per_problem = []
    for prob, samples in zip(problems, samples_per_problem):
        graded = []
        for pred in samples:
            if not pred or prob["input"] in pred:
                continue
            snippet = (f"{_EXEC_PREAMBLE}\n{prob['code']}\n"
                       f"assert {prob['answer']} == {pred}")
            graded.append(_run_assertion(snippet, timeout))
        if not graded:
            graded = [False] * max(len(samples), 1)
        per_problem.append({"n": len(graded), "correct": graded.count(True),
                            "graded": graded})
    vals = [pass_at_k(p["n"], p["correct"], 1) for p in per_problem]
    return {"pass@1": sum(vals) / len(vals) if vals else 0.0,
            "per_problem": per_problem}


# --------------------------------------------------------------------------
# Test-output-prediction scenario
# (reference: evaluation/compute_test_output_prediction_metrics.py,
# extraction_utils.py:19-46)
# --------------------------------------------------------------------------


def extract_test_output_answer(text: str) -> str:
    """Last ``assert`` line of the response; else the first fenced code
    block (preferring a ```python fence as its start)."""
    lines = text.split("\n")
    asserts = [i for i, ln in enumerate(lines) if ln.startswith("assert")]
    if asserts:
        return lines[asserts[-1]]
    py_fences = [i for i, ln in enumerate(lines)
                 if "```python" in ln or "```Python" in ln]
    fences = [i for i, ln in enumerate(lines) if "```" in ln]
    if py_fences:
        start = py_fences[0]
        fences = [start] + [i for i in fences if i > start]
    if len(fences) < 2:
        return ""
    return "\n".join(lines[fences[0] + 1:fences[1]])


def _assert_rhs(statement: str) -> str | None:
    """The right side of ``assert lhs == rhs`` as source text, via ast."""
    import ast

    try:
        parsed = ast.parse(statement, mode="exec")
    except SyntaxError:
        return None
    if not parsed.body or not isinstance(parsed.body[0], ast.Assert):
        return None
    cmp = parsed.body[0].test
    if not isinstance(cmp, ast.Compare) or not isinstance(cmp.ops[0], ast.Eq):
        return None
    return ast.get_source_segment(statement, cmp.comparators[0])


def check_testcase_output(pred: str, expected_json: str,
                          timeout: float = 3.0) -> bool:
    """Does the predicted assert's RHS equal the expected JSON value?

    Mirrors the reference decision ladder
    (compute_test_output_prediction_metrics.py:39-74): multi-line
    predictions are reduced to their first non-comment ``assert`` line; the
    RHS is parsed out with ast; the literal is evaluated and compared
    against ``json.loads(expected)``. Unlike the reference's bare in-process
    ``eval``, non-literal predictions are evaluated in a sandboxed child
    process (model output is untrusted).
    """
    import ast
    import json

    if len(pred.splitlines()) > 1:
        for line in pred.splitlines():
            if line.startswith("#"):
                continue
            if "assert" in line:
                pred = line
                break
    pred = pred.strip()
    if "assert" in pred:
        value_src = _assert_rhs(pred)
        if value_src is None:
            return False
    else:
        value_src = pred
    try:
        expected = json.loads(expected_json)
    except (json.JSONDecodeError, ValueError):
        return False
    try:
        value = ast.literal_eval(value_src)
        return value == expected
    except (ValueError, SyntaxError, MemoryError, TypeError):
        pass
    # non-literal RHS (e.g. tuple arithmetic): sandboxed equality check
    snippet = (f"import json\nexpected = json.loads({expected_json!r})\n"
               f"assert ({value_src}) == expected")
    return _run_assertion(snippet, timeout)


def test_output_metrics(problems: list[dict],
                        samples_per_problem: list[list[str]],
                        k_list: tuple[int, ...] = (1,),
                        timeout: float = 3.0) -> dict:
    """pass@k over predicted test outputs; ``problems[i]['answer']`` is the
    expected output as JSON text."""
    per_problem = []
    for prob, samples in zip(problems, samples_per_problem):
        graded = [check_testcase_output(pred, prob["answer"], timeout=timeout)
                  for pred in samples]
        per_problem.append({"n": len(graded), "correct": graded.count(True),
                            "graded": graded})
    out = {}
    for k in k_list:
        vals = [pass_at_k(p["n"], p["correct"], k) for p in per_problem
                if p["n"] >= k]
        out[f"pass@{k}"] = sum(vals) / len(vals) if vals else 0.0
    out["per_problem"] = per_problem
    return out
