"""The port's evaluation modules against the JAX originals, on the CPU.

``evaluate/math_grader.py``, ``code_eval.py``, ``lcb_benchmarks.py``,
``lcb_prompts.py``, ``judge.py`` and ``report_judge.py`` are the port's own
copies of JAX-free host code. Each test gives the same inputs to JAX's
function and the port's and asserts equal results: the grader's verdicts on
the whole bank of ``tests/test_math_grader.py`` (each case a test), its
LaTeX conversion, answer extraction and timeout path; the sandboxed test
runs (stdin/stdout, functional, error, timeout), pass@k and the three LCB
scenarios' metrics, with two workers equal to one; the LCB export loaders
(compressed private tests included) and the restricted unpickler's
refusals; the prompt builders per scenario and model name; the judge's
verdicts and the report judge's scores and aggregates. Sandbox timeouts are
short.
"""
from __future__ import annotations

import asyncio
import base64
import importlib.util
import json
import os
import pickle
import time
import zlib

import pytest

from deepsearch_tts_tpu.evaluate import code_eval as jce
from deepsearch_tts_tpu.evaluate import judge as jjudge
from deepsearch_tts_tpu.evaluate import lcb_benchmarks as jlcb
from deepsearch_tts_tpu.evaluate import lcb_prompts as jlp
from deepsearch_tts_tpu.evaluate import math_grader as jmg
from deepsearch_tts_tpu.evaluate import report_judge as jrj
from deepsearch_tts_tpu_torch.evaluate import code_eval as tce
from deepsearch_tts_tpu_torch.evaluate import judge as tjudge
from deepsearch_tts_tpu_torch.evaluate import lcb_benchmarks as tlcb
from deepsearch_tts_tpu_torch.evaluate import lcb_prompts as tlp
from deepsearch_tts_tpu_torch.evaluate import math_grader as tmg
from deepsearch_tts_tpu_torch.evaluate import report_judge as trj

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 1.0


def _bank():
    """JAX's grader bank (``CASES``, with the verdicts) and its
    differential cases (no verdict), read from ``tests/test_math_grader.py``."""
    spec = importlib.util.spec_from_file_location(
        "_jax_math_grader_bank", os.path.join(HERE, "test_math_grader.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES, mod.DIFFERENTIAL_CASES


CASES, DIFFERENTIAL = _bank()


# ------------------------------------------------------------- math_grader

@pytest.mark.parametrize("pred,ref,expected", CASES,
                         ids=[f"{i}:{c[0][:18]}~{c[1][:18]}" for i, c in enumerate(CASES)])
def test_math_equal_bank_equal(pred, ref, expected):
    got = tmg.math_equal(pred, ref)
    assert got == jmg.math_equal(pred, ref) == expected


@pytest.mark.parametrize("pred,ref", DIFFERENTIAL,
                         ids=[str(i) for i in range(len(DIFFERENTIAL))])
def test_math_equal_differential_cases_equal(pred, ref):
    assert tmg.math_equal(pred, ref) == jmg.math_equal(pred, ref)


LATEX = [r"\frac{1}{2}", r"\dfrac{3}{4}", r"\sqrt{3}", r"\sqrt[3]{8}", r"2\pi",
         r"\frac{x+2}{7}", r"\sec^2(y)", r"x^{2}+2x\cdot y", r"\left(1,\frac{9}{2}\right]",
         r"\frac{\sqrt{\sqrt{11}+\sqrt{194}}}{2\sqrt{33}+15}", r"\tfrac12", r"\sqrt2",
         r"\begin{pmatrix}1&2\\3&4\end{pmatrix}", "x = 5", "", "no idea"]


@pytest.mark.parametrize("s", LATEX)
def test_latex_to_expr_equal(s):
    assert tmg.latex_to_expr_string(s) == jmg.latex_to_expr_string(s)
    assert str(tmg.parse_math(s)) == str(jmg.parse_math(s))
    assert tmg.strip_answer_string(s) == jmg.strip_answer_string(s)


OUTPUTS = [r"so \boxed{42}", "blah ANSWER: 7", "the result is 3.5 meters",
           r"we get \boxed{\frac{1}{2}} finally", "ANSWER: **5 dollars**",
           "1,234 and then 5/6", "nothing numeric here", r"\boxed{90^\circ}",
           "The answer is (C).", r"\boxed{\text{seven}}"]


@pytest.mark.parametrize("out", OUTPUTS)
def test_extract_math_answer_equal(out):
    assert tmg.extract_math_answer(out) == jmg.extract_math_answer(out)
    assert tmg.choice_answer_clean(out) == jmg.choice_answer_clean(out)
    assert tmg.parse_digits(out) == jmg.parse_digits(out)


def test_timeout_path_equal():
    """``math_equal(timeout=True)`` grades in a forked child; a function
    that outlives the limit is killed and counts False in both."""
    for pred, ref in (("2", "2.0"), ("x+1", "x+2"), ("x**2 - 1", "(x-1)*(x+1)")):
        assert tmg.math_equal(pred, ref, timeout=True) == jmg.math_equal(pred, ref, timeout=True)
    t0 = time.time()
    assert tmg.call_with_timeout(time.sleep, 30, timeout=0.5) is False
    assert jmg.call_with_timeout(time.sleep, 30, timeout=0.5) is False
    assert time.time() - t0 < 10
    assert tmg.call_with_timeout(tmg.symbolic_equal, "2*x + x", "3*x") is True
    assert tmg.call_with_timeout(divmod, 1, 0) is False   # raises in the child


# --------------------------------------------------------------- code_eval

CASE_PROGRAMS = [
    # stdin / stdout
    ("n = int(input())\nprint(n * 2)", [{"input": "3\n", "expected_output": "6\n"},
                                        {"input": "5\n", "expected_output": "11\n"}]),
    ("import sys\nprint(sys.stdin.read().upper())\nsys.exit(0)",
     [{"input": "ab\n", "expected_output": "AB"}]),
    # functional
    ("def add(a, b):\n    return a + b", [{"fn_name": "add", "args": (1, 2), "expected": 3},
                                          {"fn_name": "add", "args": (1, 2), "expected": 4},
                                          {"fn_name": "sub", "args": (1, 2), "expected": -1}]),
    # error and timeout
    ("raise ValueError('boom')", [{"input": "", "expected_output": ""}]),
    ("while True:\n    pass", [{"input": "", "expected_output": "x"}]),
]


@pytest.mark.parametrize("code,cases", CASE_PROGRAMS, ids=["stdio", "exit", "functional",
                                                           "error", "timeout"])
def test_run_test_cases_equal(code, cases):
    got = tce.run_test_cases(code, cases, timeout=TIMEOUT)
    assert got == jce.run_test_cases(code, cases, timeout=TIMEOUT)
    assert len(got) == len(cases)
    if code.startswith("while"):
        assert got == [{"status": "timeout", "detail": ""}]


def test_pass_at_k_equal():
    for n in range(1, 11):
        for c in range(n + 1):
            for k in range(1, n + 1):
                assert tce.pass_at_k(n, c, k) == jce.pass_at_k(n, c, k), (n, c, k)


CODEGEN_PROBLEMS = [
    {"test_cases": [{"input": "2\n", "expected_output": "4\n"},
                    {"input": "7\n", "expected_output": "14\n"}]},
    {"test_cases": [{"fn_name": "inc", "args": (1,), "expected": 2}]},
    {"test_cases": [{"input": "x\n", "expected_output": "x\n"}]},
]
CODEGEN_SAMPLES = [
    ["print(int(input()) * 2)", "print(int(input()) + 2)", ""],
    ["def inc(x):\n    return x + 1", "def inc(x):\n    return x"],
    ["print(input())", "import time\ntime.sleep(30)"],
]


def test_codegen_metrics_equal_and_workers_equal_serial():
    kw = dict(k_list=(1, 2), timeout=TIMEOUT)
    serial = tce.codegen_metrics(CODEGEN_PROBLEMS, CODEGEN_SAMPLES, **kw)
    assert serial == jce.codegen_metrics(CODEGEN_PROBLEMS, CODEGEN_SAMPLES, **kw)
    assert tce.codegen_metrics(CODEGEN_PROBLEMS, CODEGEN_SAMPLES, num_workers=2, **kw) == serial
    assert [p["correct"] for p in serial["per_problem"]] == [1, 1, 1]
    assert serial["per_problem"][2]["details"][1] == [{"status": "timeout", "detail": ""}]


EXEC_PROBLEMS = [
    {"code": "def f(x):\n    return x * 2", "input": "f(x = 3)", "answer": "6"},
    {"code": "def g(s):\n    return s + 'a'", "input": "g(s = 'hi')", "answer": "'hia'"},
    {"code": "def h():\n    return float('inf')", "input": "h()", "answer": "inf"},
    {"code": "def w():\n    while True:\n        pass", "input": "w()", "answer": "w()"},
]
EXEC_SAMPLES = [["6", "7"], ["'nope'", "'hia'"], ["inf"], ["0"]]


def test_code_execution_metrics_equal():
    got = tce.code_execution_metrics(EXEC_PROBLEMS, EXEC_SAMPLES, timeout=TIMEOUT)
    assert got == jce.code_execution_metrics(EXEC_PROBLEMS, EXEC_SAMPLES, timeout=TIMEOUT)
    assert [p["graded"] for p in got["per_problem"]] == [[True, False], [False, True],
                                                         [True], [False]]


OUT_PROBLEMS = [{"answer": "[1, 2]"}, {"answer": '"x"'}, {"answer": "[1, 2]"},
                {"answer": "not json"}]
OUT_SAMPLES = [["assert f() == [1, 2]", "assert f() == [9]"],
               ["assert g() == 'y'", "# c\nassert g() == 'x'"],
               ["assert f(3) == [1] + [2]", "assert f(1) != 2"],
               ["assert f() == 1"]]


def test_test_output_metrics_equal():
    kw = dict(k_list=(1, 2), timeout=TIMEOUT)
    got = tce.test_output_metrics(OUT_PROBLEMS, OUT_SAMPLES, **kw)
    assert got == jce.test_output_metrics(OUT_PROBLEMS, OUT_SAMPLES, **kw)
    assert [p["graded"] for p in got["per_problem"]] == [[True, False], [False, True],
                                                         [True, False], [False]]
    assert got["pass@2"] == 1.0   # over the problems with 2 samples


RESPONSES = ["assert doubleValue(number = 21) == 42\n[/ANSWER]",
             "[THOUGHT]\nsteps\n[/THOUGHT]\n[ANSWER]\nassert f(x = \"hi\") == \"bhihia\"\n[/ANSWER]",
             "assert f(1) == [1, 2]\nextra prose", "no assert here",
             "prose\nassert f(1) == 2\nmore\nassert f(3) == 6\n",
             "prose\n```python\nassert g(1) == 9\n```\n", "```\nx = 1\n```", ""]


@pytest.mark.parametrize("text", RESPONSES)
def test_extractors_equal(text):
    for cot in (False, True):
        assert tce.extract_execution_answer(text, cot=cot) == \
            jce.extract_execution_answer(text, cot=cot)
    assert tce.extract_test_output_answer(text) == jce.extract_test_output_answer(text)
    assert tce.check_testcase_output(text, "6", timeout=TIMEOUT) == \
        jce.check_testcase_output(text, "6", timeout=TIMEOUT)


def test_sandbox_prelude_equal():
    assert tce._EXEC_PREAMBLE == jce._EXEC_PREAMBLE


# ---------------------------------------------------------- lcb_benchmarks

def _compress(obj) -> str:
    return base64.b64encode(zlib.compress(pickle.dumps(json.dumps(obj)))).decode()


PRIVATE = [{"input": "3\n", "output": "9\n", "testtype": "stdin"},
           {"input": "4\n", "output": "16\n", "testtype": "stdin"}]


def _codegen_record(**over):
    rec = {"question_title": "Square", "question_content": "Print n squared.",
           "platform": "atcoder", "question_id": "abc001_a", "contest_id": "abc001",
           "contest_date": "2024-01-01T00:00:00", "starter_code": "",
           "difficulty": "easy",
           "public_test_cases": json.dumps([{"input": "2\n", "output": "4\n",
                                             "testtype": "stdin"}]),
           "private_test_cases": _compress(PRIVATE), "metadata": "{}",
           "release_version": "v5"}
    rec.update(over)
    return rec


def _functional_record():
    return _codegen_record(
        platform="leetcode", question_id="lc1", starter_code="class Solution:\n    ...",
        public_test_cases=json.dumps([{"input": "[1, 2]", "output": "3",
                                       "testtype": "functional"},
                                      {"input": "not json", "output": "x",
                                       "testtype": "functional"}]),
        private_test_cases=json.dumps([]), metadata=json.dumps({"func_name": "add"}))


def _exec_record():
    return {"question_id": "q1", "contest_id": "c1", "contest_date": "2024-01-01",
            "difficulty": "easy", "function_name": "f",
            "code": "def f(x):\n    return x + 1", "input": "f(x = 1)", "output": "2",
            "id": "e1", "problem_id": "p1", "numsteps": 3}


def _top_record():
    return {"question_title": "Add", "question_content": "Add one.", "question_id": "q9",
            "contest_id": "c1", "contest_date": "2024-01-01", "difficulty": "easy",
            "starter_code": "def addOne(x):\n    ...", "function_name": "addOne",
            "test_id": 2, "test": json.dumps([{"input": "5", "output": "6",
                                               "testtype": "functional"}])}


@pytest.mark.parametrize("jsonl", [False, True], ids=["json", "jsonl"])
def test_lcb_exports_decode_equal(tmp_path, jsonl):
    def write(name, recs):
        p = tmp_path / name
        p.write_text("\n".join(json.dumps(r) for r in recs) if jsonl else json.dumps(recs))
        return str(p)

    cg = write("cg", [_codegen_record(), _functional_record()])
    got = tlcb.load_code_generation_rows(cg)
    assert got == jlcb.load_code_generation_rows(cg)
    assert [c["expected_output"] for c in got[0]["test_cases"]] == ["4\n", "9\n", "16\n"]
    assert got[1]["test_cases"][0] == {"fn_name": "add", "args": (1, 2), "expected": 3}
    assert tlcb.load_code_generation_rows(cg, limit=1) == jlcb.load_code_generation_rows(
        cg, limit=1)
    for name, recs, scen in (("ex", [_exec_record()], "codeexecution"),
                             ("top", [_top_record()], "testoutputprediction")):
        path = write(name, recs)
        assert tlcb.load_scenario_rows(path, scen) == jlcb.load_scenario_rows(path, scen)
        assert tlcb.load_scenario_rows(path, tlcb.Scenario(scen)) == \
            jlcb.load_scenario_rows(path, jlcb.Scenario(scen))
    problems = tlcb.load_problems(cg)
    assert [t.testtype.value for t in problems[0].tests] == ["stdin"] * 3


def test_lcb_bad_record_errors_equal(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps([_codegen_record(platform="nowhere")]))
    errs = []
    for mod in (jlcb, tlcb):
        with pytest.raises(ValueError) as e:
            mod.load_code_generation_rows(str(p))
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "#0" in errs[0]


class _Evil:
    pass


REFUSED = [os.system, eval, _Evil(), __import__("collections").OrderedDict(a=1),
           complex(1, 2), range(3)]


@pytest.mark.parametrize("obj", REFUSED, ids=["os.system", "eval", "class", "OrderedDict",
                                              "complex", "range"])
def test_restricted_unpickler_refuses_equal(obj):
    """A blob that names any global beyond the primitive builtins is
    refused with the same error, and nothing is called."""
    blob = base64.b64encode(zlib.compress(pickle.dumps(obj))).decode()
    errs = []
    for mod in (jlcb, tlcb):
        with pytest.raises(pickle.UnpicklingError) as e:
            mod._decompress_tests(blob)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and errs[0].startswith("benchmark file tried to unpickle")


def test_restricted_unpickler_admits_primitives_equal():
    obj = {"a": [1, 2.5, "s", None, True, (1, 2)], "b": {3, 4}, "c": b"x"}
    raw = pickle.dumps(obj)
    assert tlcb._RestrictedUnpickler(__import__("io").BytesIO(raw)).load() == \
        jlcb._RestrictedUnpickler(__import__("io").BytesIO(raw)).load() == obj
    assert tlcb._decompress_tests(_compress(PRIVATE)) == jlcb._decompress_tests(
        _compress(PRIVATE)) == PRIVATE


# ------------------------------------------------------------- lcb_prompts

MODELS = ["qwen3-8b", "QWEN3-4B", "deepseek-v3", "some-new-model", ""]


@pytest.mark.parametrize("model", MODELS)
def test_lcb_prompts_equal(model):
    q = {"question_content": "Print the sum.", "starter_code": ""}
    qs = {"Question": "Add two numbers.", "starter_code": "def add(a, b):\n    ..."}
    for row in (q, qs, {}):
        assert tlp.codegen_messages(row, model) == jlp.codegen_messages(row, model)
        assert tlp.self_repair_messages(row, "print(1)", "wrong answer", model) == \
            jlp.self_repair_messages(row, "print(1)", "wrong answer", model)
    ex = {"code": "def f(x):\n    return x + 1", "input": "f(x = 1)"}
    for cot in (False, True):
        assert tlp.code_execution_messages(ex, model, cot=cot) == \
            jlp.code_execution_messages(ex, model, cot=cot)
    top = {"question_content": "Add one.", "starter_code": "def addOne(x):\n    ...",
           "function_name": "addOne", "input": "5\n6"}
    assert tlp.test_output_prediction_messages(top, model) == \
        jlp.test_output_prediction_messages(top, model)
    assert tlp.test_output_prediction_messages({}, model) == \
        jlp.test_output_prediction_messages({}, model)
    assert tlp.get_model_style(model).__dict__ == jlp.get_model_style(model).__dict__


# ------------------------------------------------------- judge, report judge

VERDICTS = [("Paris", "Paris", "Incorrect"), ("paris", "Paris", "nonsense"),
            ("Lyon", "Paris", "Correct"), ("Lyon", "Paris", "correct"),
            ("Lyon", "Paris", "Correct, not wrong"), ("unknown city", "Paris", "Correct"),
            ("It is not found", "Paris", "Correct"), ("", "Paris", "Correct"),
            ("1/2", "0.5", "Incorrect"), (r"\frac{1}{2}", "0.5", ""),
            ("No specific answer", "x", "correct")]


@pytest.mark.parametrize("pred,gold,text", VERDICTS)
def test_judge_verdict_equal(pred, gold, text):
    assert tjudge.judge_verdict(pred, gold, text) == jjudge.judge_verdict(pred, gold, text)
    assert tjudge.is_non_answer(pred) == jjudge.is_non_answer(pred)


def test_llm_judge_batch_equal():
    assert tjudge.JUDGE_PROMPT == jjudge.JUDGE_PROMPT
    assert tjudge.NON_ANSWER_PHRASES == jjudge.NON_ANSWER_PHRASES
    rows = [{"question": "q1", "pred": "Lyon", "gold": "Paris"},
            {"question": "q2", "pred": "Paris", "gold": "Paris"},
            {"question": "q3", "pred": "not found", "gold": "Paris"},
            {"question": "boom", "pred": "Rome", "gold": "Rome"},
            {"question": "q5", "pred": "Rome", "gold": "Milan"}]

    async def complete(prompt):
        if "Question: boom" in prompt:
            raise ConnectionError("down")
        return " Correct " if "Lyon" in prompt or "not found" in prompt else "Incorrect"

    got = asyncio.run(tjudge.llm_judge_batch(rows, complete, concurrency=2))
    assert got == asyncio.run(jjudge.llm_judge_batch(rows, complete, concurrency=2))
    assert [ok for ok, _ in got] == [True, True, False, True, False]


SYSTEMS = ["sysA", "sysB"]
JUDGE_TEXTS = [
    json.dumps({"sysA": {"comprehensiveness": 8, "thoroughness": 7, "factuality": 9,
                         "coherence": 6},
                "sysB": {"comprehensiveness": 5}}),
    "```json\n" + json.dumps({"sysA": {"factuality": 4.5}}) + "\n```",
    "sysA: comprehensiveness 7, thoroughness: 6, factuality - 8, coherence 9.\n"
    "sysB: comprehensiveness 3 thoroughness 2",
    "no scores at all",
    json.dumps({"sysA": {"coherence": "high"}}),
]


@pytest.mark.parametrize("text", JUDGE_TEXTS)
def test_extract_scores_equal(text):
    assert trj.extract_scores(text, SYSTEMS) == jrj.extract_scores(text, SYSTEMS)


def test_judge_reports_equal():
    rows = [{"question": "Q1", "reports": {"sysA": "report a", "sysB": "report b"}},
            {"question": "Q2", "reports": {"sysA": "report c", "sysB": "report d"}},
            {"question": "boom", "reports": {"sysA": "x", "sysB": "y"}}]

    async def complete(prompt):
        if "boom" in prompt:
            raise RuntimeError("judge down")
        return JUDGE_TEXTS[0] if "Q1" in prompt else JUDGE_TEXTS[2]

    got = asyncio.run(trj.judge_reports(rows, complete, concurrency=2))
    assert got == asyncio.run(jrj.judge_reports(rows, complete, concurrency=2))
    assert got["sysA"]["factuality"] == pytest.approx((9 + 8 + 0) / 3)
