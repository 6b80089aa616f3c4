"""The port's ``evaluate/`` and ``datasets/`` copies against the JAX originals.

Every public function of ``evaluate/extract.py``, ``math_equivalence.py`` and
``metrics.py`` and of ``datasets/loaders.py`` gets the same inputs in both
packages — the JAX tests' own cases (``tests/test_extract.py``,
``test_metrics.py``, ``test_datasets.py``) and a ``hypothesis`` text
strategy over the markers the extractors look for — and must give exactly
equal outputs. The modules' constants must be equal too.
"""
import base64
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deepsearch_tts_tpu import datasets as jds
from deepsearch_tts_tpu import evaluate as je
from deepsearch_tts_tpu.datasets import loaders as jload
from deepsearch_tts_tpu.evaluate import extract as jex
from deepsearch_tts_tpu.evaluate import math_equivalence as jmeq
from deepsearch_tts_tpu.evaluate import math_examples as jmex
from deepsearch_tts_tpu.evaluate import metrics as jmet
from deepsearch_tts_tpu_torch import datasets as tds
from deepsearch_tts_tpu_torch import evaluate as te
from deepsearch_tts_tpu_torch.datasets import loaders as tload
from deepsearch_tts_tpu_torch.evaluate import extract as tex
from deepsearch_tts_tpu_torch.evaluate import math_equivalence as tmeq
from deepsearch_tts_tpu_torch.evaluate import math_examples as tmex
from deepsearch_tts_tpu_torch.evaluate import metrics as tmet

MODES = ("qa", "math", "choose", "codegen", "infogen", "summary", "research", "other")

# the JAX tests' inputs (tests/test_extract.py, tests/test_metrics.py) and
# the forms around them: nested braces, several boxes, text wrappers,
# ANSWER markers, code blocks, explorer outputs, confidence scores
TEXTS = [
    r"first \boxed{1} then \boxed{2}",
    r"\boxed{\frac{1}{2}}",
    r"thinking... \boxed{Paris}",
    "blah\nANSWER: 42",
    "**ANSWER: 42**",
    r"\boxed{\text{(B)}}",
    "```python\nx=1\n```\nmore\n```python\ny=2\n```",
    "reasoning</think>\n**Final Information**: The fact is X.",
    "**Final Information stuff<|begin_click_link|>http://x",
    "a\nb\nc\nd\ne\nf\ng",
    "**Final Information" + "x" * 10000,
    "y" * 7000,
    r"\boxed{0.75}",
    r"\boxed{\text{3/4}}",
    r"\boxed{\text{75%}}",
    "no box here",
    r"\boxed{2}",
    r"\boxed{3/0}",
    r"\boxed{100}",
    r"\boxed{\text{150}}",
    r"\boxed{-0.2}",
    r"\boxed{}",
    r"\boxed{abc",
    r"\[\boxed{\text{0.5}}\]",
    r"2 of 4 conditions verified. \[\boxed{\text{0.5}}\]",
    r"\fbox{7} and \boxed 8",
    "",
    "  \n\n  ",
    "line1\n\nline2\n\nline3\n\nline4",
    "</think>\n**Final Information**\n\n```\nA\n\nB\nC\nD\nE\nF\n```",
]

MATH_PAIRS = [
    (r"\frac12", r"\frac{1}{2}"), ("1/2", "0.5"), (r"\sqrt3", r"\sqrt{3}"), ("3", "4"),
    ("50%", "50"), (r"5\text{ meters}", "5"), (r"\dfrac{3}{4}", "0.75"),
    ("0.5", r"\frac{1}{2}"), (r"x^{2}", "x^2"), (r"\left(1,2\right)", "(1,2)"),
    ("1,000", "1000"), (r"\$5", "5"), ("5.", "5"), (".5", "0.5"), (r"\tfrac{1}{3}", "1/3"),
    (r"x = 3", "3"), (None, "3"), (None, None), ("", ""), (r"\frac{a}{b}", "a/b"),
    (r"10^\circ", "10"), (r"\text{(A)}", "A"), ("2\\%", "2"), (r"{7}", "7"),
]

QA_PAIRS = [
    (r"reasoning \boxed{George Washington}", ["George Washington"], "qa"),
    (r"\boxed{President George Washington of the USA}", ["George Washington"], "qa"),
    (r"\boxed{NYC}", ["New York City", "NYC"], "qa"),
    (r"\boxed{\frac{1}{2}}", ["0.5"], "math"),
    (r"\boxed{\text{(C)}}", "C", "choose"),
    ("The answer is Paris", "Paris", "qa"),
    ("", ["x"], "qa"),
    (r"\boxed{The  Answer, IS: Paris!}", ["answer is paris"], "qa"),
    ("a\nb\nc\nd\ne\nf", ["f"], "math"),
]

# a text strategy over the characters and markers the extractors parse
_PIECES = st.sampled_from([
    r"\boxed{", "}", "{", r"\text{", "ANSWER:", "</think>\n", "**Final Information",
    "<|begin_click_link|>", "```python\n", "```", "\n", "\n\n", "0.", "1/2", "%",
    "(", ")", " ", "x", "Paris", "42", r"\frac", r"\sqrt", "**", ":", "-", "7.5",
])
TEXT = st.lists(st.one_of(_PIECES, st.text(max_size=6)), max_size=24).map("".join)


def _both(fn_name, mod_j, mod_t, *args, **kw):
    return getattr(mod_j, fn_name)(*args, **kw), getattr(mod_t, fn_name)(*args, **kw)


def test_constants_equal():
    assert (jex.FINAL_INFO_MARK, jex.CLICK_TOKEN) == (tex.FINAL_INFO_MARK, tex.CLICK_TOKEN)
    assert jmet.DEFAULT_DOMAIN_FIELDS == tmet.DEFAULT_DOMAIN_FIELDS
    assert jmeq._REMOVALS == tmeq._REMOVALS
    assert jmex.MATH_EXAMPLES == tmex.MATH_EXAMPLES
    assert jload.QUESTION_KEYS == tload.QUESTION_KEYS
    assert jload.ANSWER_KEYS == tload.ANSWER_KEYS
    assert sorted(jload.DATASET_REGISTRY) == sorted(tload.DATASET_REGISTRY)
    for name, spec in jload.DATASET_REGISTRY.items():
        other = tload.DATASET_REGISTRY[name]
        assert (spec.name, spec.default_file, spec.domain_field, spec.mode,
                spec.encrypted_fields, spec.postprocess is None) == (
            other.name, other.default_file, other.domain_field, other.mode,
            other.encrypted_fields, other.postprocess is None)
    assert je.__all__ == te.__all__
    for name in te.__all__:
        assert getattr(te, name).__module__.startswith("deepsearch_tts_tpu_torch.")


@pytest.mark.parametrize("text", TEXTS)
def test_extract_equal(text):
    for last in (True, False):
        j, t = _both("extract_boxed", jex, tex, text, last=last)
        assert j == t, last
    assert jex.extract_confidence(text) == tex.extract_confidence(text)
    for mode in MODES:
        for ea in (True, False):
            j, t = _both("extract_answer_fn", jex, tex, text, mode=mode, extract_answer=ea)
            assert j == t, (mode, ea)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(TEXT)
def test_extract_equal_on_generated_text(text):
    assert jex.extract_boxed(text) == tex.extract_boxed(text)
    assert jex.extract_boxed(text, last=False) == tex.extract_boxed(text, last=False)
    assert jex.extract_confidence(text) == tex.extract_confidence(text)
    for mode in MODES:
        assert jex.extract_answer_fn(text, mode=mode, extract_answer=True) == \
            tex.extract_answer_fn(text, mode=mode, extract_answer=True)


@pytest.mark.parametrize("a,b", MATH_PAIRS)
def test_math_equivalence_equal(a, b):
    assert jmeq.is_equiv(a, b) == tmeq.is_equiv(a, b)
    for s in (a, b):
        if s is not None:
            assert jmeq.normalize_math(s) == tmeq.normalize_math(s)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(TEXT, TEXT)
def test_math_equivalence_equal_on_generated_text(a, b):
    assert jmeq.normalize_math(a) == tmeq.normalize_math(a)
    assert jmeq.is_equiv(a, b) == tmeq.is_equiv(a, b)
    assert jmeq.is_equiv(a, a) == tmeq.is_equiv(a, a)


@pytest.mark.parametrize("pred,gold,mode", QA_PAIRS)
def test_evaluate_predictions_equal(pred, gold, mode):
    for ea in (True, False):
        assert jmet.evaluate_predictions(pred, gold, mode=mode, extract_answer=ea) == \
            tmet.evaluate_predictions(pred, gold, mode=mode, extract_answer=ea)
    for s in (pred, *([gold] if isinstance(gold, str) else gold)):
        assert jmet.normalize_answer_qa(s) == tmet.normalize_answer_qa(s)


@settings(max_examples=100, deadline=None, derandomize=True, database=None)
@given(TEXT, TEXT)
def test_metrics_equal_on_generated_text(pred, gold):
    assert jmet.normalize_answer_qa(pred) == tmet.normalize_answer_qa(pred)
    for mode in ("qa", "math", "choose"):
        assert jmet.evaluate_predictions(pred, [gold], mode=mode, extract_answer=True) == \
            tmet.evaluate_predictions(pred, [gold], mode=mode, extract_answer=True)


def test_run_evaluation_equal(tmp_path):
    """tests/test_metrics.py's rows and more: every alias of question and
    gold, raw ``Output`` text, domains, a judge function; the returned
    overall metrics and both JSON files equal."""
    items = [
        {"Question": "q1", "answer": "a", "pred_answer": "a", "category": "Math"},
        {"Question": "q2", "answer": "b", "pred_answer": "x", "category": "Physics"},
        {"problem": "q3", "Answer": "Paris", "Output": r"so \boxed{Paris}", "Level": 2},
        {"prompt": "q4", "Correct Choice": "B", "pred_answer": r"\boxed{\text{(B)}}"},
        {"question": "q5", "labeled_answer": "1/2", "pred_answer": "0.5"},
        {"query": "q6", "answer": ["NYC", "New York"], "pred_answer": "", "Output": ""},
    ]

    def judge(q, pred, gold):
        return pred == "Paris", f"{q}: {pred} vs {gold}"

    for task in ("qa", "math", "choose", "auto"):
        for judge_fn in (None, judge):
            outs = []
            for mod, tag in ((jmet, "j"), (tmet, "t")):
                m = tmp_path / f"{tag}_{task}_m.json"
                o = tmp_path / f"{tag}_{task}_o.json"
                overall = mod.run_evaluation([dict(i) for i in items], task_type=task,
                                             output_metrics_path=str(m),
                                             output_metrics_overall_path=str(o),
                                             judge_fn=judge_fn)
                outs.append((overall, m.read_text(), o.read_text()))
            assert outs[0] == outs[1], (task, judge_fn)


def test_dataset_helpers_equal():
    msg, key = "secret question?", "canary-key"
    enc = jds.xor_decrypt(msg.encode(), key)
    assert tds.xor_decrypt(msg.encode(), key) == enc
    b64 = base64.b64encode(enc).decode()
    assert jload.decrypt_canary_field(b64, key) == tload.decrypt_canary_field(b64, key) == msg
    for rec in ({"Question": "q"}, {"problem": "p"}, {"prompt": "pr"}, {"question": "lc"},
                {}, {"task": "t", "answer": "a"}, {"query": "x", "Answer": "y"},
                {"labeled_answer": "z"}, {"Correct Answer": "w"}, {"question": ""}):
        assert jds.extract_question(rec) == tds.extract_question(rec)
        assert jload.extract_answer(rec) == tload.extract_answer(rec)
    gpqa = {"id": 7, "Question": "Which?", "Correct Answer": "c",
            "Incorrect Answer 1": "i1", "Incorrect Answer 2": "i2", "Incorrect Answer 3": "i3"}
    assert jload._gpqa_choices(gpqa) == tload._gpqa_choices(gpqa)


def _load_both(path, **kw):
    return jds.load_dataset(str(path), **kw), tds.load_dataset(str(path), **kw)


def test_load_dataset_equal(tmp_path, monkeypatch):
    """tests/test_datasets.py's files (a JSON list, a canary CSV, a limit),
    a ``{"data": [...]}`` file and a registry name under a data root."""
    p = tmp_path / "d.json"
    p.write_text(json.dumps([{"problem": "what?", "answer": "that"},
                             {"Question": "q", "x": 1}] + [{"Question": str(i)}
                                                             for i in range(10)]))
    j, t = _load_both(p)
    assert j == t and j[0]["Question"] == "what?"
    for limit in (None, 1, 3, 100):
        assert _load_both(p, limit=limit)[0] == _load_both(p, limit=limit)[1]
    key = "k123"
    q = base64.b64encode(jds.xor_decrypt("Q?".encode(), key)).decode()
    a = base64.b64encode(jds.xor_decrypt("A!".encode(), key)).decode()
    c = tmp_path / "d.csv"
    c.write_text(f"canary,prompt,answer\n{key},{q},{a}\n,plain,ans\n")
    assert jload.load_records(str(c)) == tload.load_records(str(c))
    assert _load_both(c)[0] == _load_both(c)[1]
    d = tmp_path / "wrapped.json"
    d.write_text(json.dumps({"data": [{"prompt": "p1"}]}))
    assert _load_both(d)[0] == _load_both(d)[1]
    one = tmp_path / "one.json"
    one.write_text(json.dumps({"task": "only"}))
    assert _load_both(one)[0] == _load_both(one)[1]
    (tmp_path / "GPQA").mkdir()
    (tmp_path / "GPQA" / "diamond.json").write_text(json.dumps([
        {"id": i, "Question": f"Q{i}", "Correct Answer": "c", "Incorrect Answer 1": "x",
         "Incorrect Answer 2": "y", "Incorrect Answer 3": "z"} for i in range(5)]))
    for kw in ({"data_root": str(tmp_path)}, {}):
        if not kw:
            monkeypatch.setenv("DSTTS_DATA_ROOT", str(tmp_path))
        j = jds.load_dataset("gpqa", limit=4, **kw)
        assert j == tds.load_dataset("GPQA", limit=4, **kw) and len(j) == 4
