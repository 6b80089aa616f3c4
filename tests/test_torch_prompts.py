"""The port's ``prompts/`` copies against the JAX originals.

Every function of ``prompts/qa.py`` and ``prompts/reports.py`` (public and
the private helpers they share) is called in both packages over a grid of
its arguments, chosen by parameter name and annotation; the strings (or the
raised exceptions) must be equal. The module-level constants — the in-band
markers, the tool schema, the report phrases — must be equal too.
"""
import inspect
import itertools

import pytest

from deepsearch_tts_tpu import prompts as jprompts
from deepsearch_tts_tpu.prompts import qa as jqa
from deepsearch_tts_tpu.prompts import reports as jrep
from deepsearch_tts_tpu_torch import prompts as tprompts
from deepsearch_tts_tpu_torch.prompts import qa as tqa
from deepsearch_tts_tpu_torch.prompts import reports as trep

TEXT = ["", "What is the capital of France?",
        "Q with {braces}, \\boxed{x} and a % sign\nsecond line <|begin_search_query|>"]
VALUES = {
    "model_name": [None, "qwen3-8b", "QwQ-32B", "deepseek-r1", "llama-3-70b", "gpt-4o"],
    "mode": ["solve", "verify", "other"],
    "version": list(range(7)),
    "few_shot": [0, 1, 3, 8],
    "reports": [{}, {"system_a": "Report A.", "system_b": "Report B\nwith lines."}],
    "spaced_tokens": [True, False],
    "opening": [None, "Custom opening."],
}
INT_VALUES = [0, 1, 10, 15]
MAX_CALLS = 96   # argument combinations a function, at most


def _functions(mod):
    return sorted(n for n, f in vars(mod).items()
                  if inspect.isfunction(f) and f.__module__ == mod.__name__)


def _grid(fn):
    axes = []
    for name, p in inspect.signature(fn).parameters.items():
        if name in VALUES:
            axes.append(VALUES[name])
        elif "int" in str(p.annotation):
            axes.append(INT_VALUES)
        else:
            axes.append(TEXT)
    return list(itertools.islice(itertools.product(*axes), MAX_CALLS))


def _call(fn, args):
    try:
        return "ok", fn(*args)
    except Exception as e:   # a raise must be the same raise
        return type(e).__name__, str(e)


CASES = [(jqa, tqa, n) for n in _functions(jqa)] + [(jrep, trep, n) for n in _functions(jrep)]


def test_same_functions_and_constants():
    for jm, tm in ((jqa, tqa), (jrep, trep), (jprompts, tprompts)):
        assert _functions(jm) == _functions(tm)
        jc = {n: v for n, v in vars(jm).items() if n.isupper()}
        tc = {n: v for n, v in vars(tm).items() if n.isupper()}
        assert jc == tc and jc or jm is jprompts
        public = sorted(n for n in dir(jm) if not n.startswith("_"))
        assert public == sorted(n for n in dir(tm) if not n.startswith("_"))
        for n in public:
            if callable(getattr(jm, n)) and not isinstance(getattr(jm, n), type):
                assert getattr(tm, n).__module__.startswith("deepsearch_tts_tpu_torch."), n
    assert len(CASES) > 50


@pytest.mark.parametrize("jmod,tmod,name", CASES,
                         ids=[f"{j.__name__.rsplit('.', 1)[1]}.{n}" for j, _, n in CASES])
def test_prompt_strings_equal(jmod, tmod, name):
    jf, tf = getattr(jmod, name), getattr(tmod, name)
    assert inspect.signature(jf) == inspect.signature(tf)
    ok = 0
    for args in _grid(jf):
        j, t = _call(jf, args), _call(tf, args)
        assert j == t, (name, args)
        ok += j[0] == "ok"
    assert ok > 0, f"{name}: every argument combination raised"


def test_math_examples_through_prompt():
    """``get_task_instruction_math(few_shot=...)`` reads the port's own
    example bank (its lazy import resolves in the port)."""
    import sys

    tqa.get_task_instruction_math("q", few_shot=2)
    assert "deepsearch_tts_tpu_torch.evaluate.math_examples" in sys.modules
    assert jqa.get_task_instruction_math("q", few_shot=2) == \
        tqa.get_task_instruction_math("q", few_shot=2)
