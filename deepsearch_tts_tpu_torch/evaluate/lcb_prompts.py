"""Code-generation prompt builders + model-style registry.

The port's own copy of ``evaluate/lcb_prompts.py`` (same behaviour; imports resolve in this package).

Capability match for the reference's vendored LCB prompt layer
(scripts/lcb_runner/prompts/ and lm_styles.py:716 LoC): per-style chat
formatting for code generation, self-repair, and test-output prediction,
with a small registry mapping model names to prompt styles. The sandboxed
execution + pass@k lives in evaluate/code_eval.py.
"""
from __future__ import annotations

from dataclasses import dataclass

SYSTEM_CODEGEN = (
    "You are an expert Python programmer. You will be given a question "
    "(problem specification) and will generate a correct Python program that "
    "matches the specification and passes all tests."
)


@dataclass(frozen=True)
class ModelStyle:
    name: str
    style: str = "chatml"          # chatml | plain
    system_prompt: str = SYSTEM_CODEGEN


MODEL_STYLES = {
    name: ModelStyle(name) for name in (
        "qwen3-0.6b", "qwen3-1.7b", "qwen3-4b", "qwen3-8b", "qwen3-14b",
        "qwen3-32b", "qwen3-235b-a22b", "qwen3-30b-a3b", "deepseek-v3",
        "kimi-k2",
    )
}


def get_model_style(name: str) -> ModelStyle:
    return MODEL_STYLES.get(name.lower(), ModelStyle(name.lower()))


def format_question_codegen(question: dict) -> str:
    """Stdin/stdout or functional problem → user prompt."""
    text = question.get("question_content") or question.get("Question") or ""
    starter = question.get("starter_code") or ""
    if starter:
        return (f"### Question:\n{text}\n\n### Starter code (complete the "
                f"function; read nothing from stdin):\n```python\n{starter}\n```"
                "\n\n### Answer: (return the full solution in a python code block)\n")
    return (f"### Question:\n{text}\n\nRead input from stdin and write the "
            "answer to stdout. Return the full program in a python code "
            "block.\n\n### Answer:\n")


def codegen_messages(question: dict, model: str = "") -> list[dict]:
    style = get_model_style(model)
    return [
        {"role": "system", "content": style.system_prompt},
        {"role": "user", "content": format_question_codegen(question)},
    ]


def self_repair_messages(question: dict, prior_code: str, error: str,
                         model: str = "") -> list[dict]:
    style = get_model_style(model)
    return [
        {"role": "system", "content": style.system_prompt},
        {"role": "user", "content": format_question_codegen(question)},
        {"role": "assistant", "content": f"```python\n{prior_code}\n```"},
        {"role": "user", "content":
            f"Your program is incorrect. Error/failed test:\n{error}\n\n"
            "Fix the program and return the full corrected solution in a "
            "python code block."},
    ]


SYSTEM_EXECUTION = (
    "You are an expert at Python programming, code execution, test case "
    "generation, and fuzzing."
)

SYSTEM_TEST_OUTPUT = (
    "You are a helpful programming assistant and an expert Python "
    "programmer. You are helping a user write a test case to check the "
    "correctness of a function. The user has written the input for the "
    "testcase; you will compute the output and write the whole assertion "
    "statement in a markdown code block with the correct output."
)

_EXECUTION_CONTRACT = (
    "You are given a Python function and an assertion containing an input "
    "to the function. Complete the assertion with a literal (no "
    "unsimplified expressions, no function calls) containing the output "
    "when executing the provided code on the given input, even if the "
    "function is incorrect or incomplete. Do NOT output any extra "
    "information."
)


def format_question_execution(code: str, test_input: str, cot: bool = False) -> str:
    """Code-execution prompt (predict a program's output).

    Structural contract matches the reference so its extraction ladder
    applies unchanged: the program inside ``[PYTHON]``/``[/PYTHON]`` tags
    with ``assert {input} == ??``, the answer as a full assert inside
    ``[ANSWER]``/``[/ANSWER]`` tags, optional chain-of-thought inside
    ``[THOUGHT]`` (reference: scripts/lcb_runner/prompts/code_execution.py:7-64).
    Few-shot examples are our own.
    """
    if cot:
        shot = """[PYTHON]
def shiftJoin(items):
    items = items[1:] + items[:1]
    return "-".join(items)
assert shiftJoin(items = ["a", "b", "c"]) == ??
[/PYTHON]
[THOUGHT]
Let's execute the code step by step:

1. shiftJoin is called with items = ["a", "b", "c"].
2. items[1:] is ["b", "c"] and items[:1] is ["a"], so items becomes ["b", "c", "a"].
3. "-".join(["b", "c", "a"]) produces "b-c-a".
4. The function therefore returns "b-c-a".
[/THOUGHT]
[ANSWER]
assert shiftJoin(items = ["a", "b", "c"]) == "b-c-a"
[/ANSWER]"""
        tail = "[THOUGHT]\n"
        guidance = ("Execute the program step by step before arriving at an "
                    "answer, and provide the full assertion with the correct "
                    "output in [ANSWER] and [/ANSWER] tags, following the "
                    "example.")
    else:
        shot = """[PYTHON]
def doubleValue(number : int) -> int:
    return number * 2
assert doubleValue(number = 21) == ??
[/PYTHON]
[ANSWER]
assert doubleValue(number = 21) == 42
[/ANSWER]

[PYTHON]
def tagText(text : str) -> str:
    return "<" + text + ">"
assert tagText(text = "q7w") == ??
[/PYTHON]
[ANSWER]
assert tagText(text = "q7w") == "<q7w>"
[/ANSWER]"""
        tail = "[ANSWER]\n"
        guidance = ("Provide the full assertion with the correct output in "
                    "[ANSWER] and [/ANSWER] tags, following the examples.")
    return (f"{_EXECUTION_CONTRACT} {guidance}\n\n{shot}\n\n"
            f"[PYTHON]\n{code}\nassert {test_input} == ??\n[/PYTHON]\n{tail}")


def code_execution_messages(question: dict, model: str = "",
                            cot: bool = False) -> list[dict]:
    """question: a CodeExecutionProblem row ({"code", "input", ...})."""
    return [
        {"role": "system", "content": SYSTEM_EXECUTION},
        {"role": "user", "content": format_question_execution(
            question["code"], question["input"], cot=cot)},
    ]


def format_testcase_call(function_name: str, test_input: str) -> str:
    """``assert fn(a, b) == # TODO`` with newline-separated inputs joined as
    arguments (reference: test_output_prediction.py:47-53)."""
    args = ", ".join(test_input.split("\n"))
    return f"assert {function_name}({args}) == # TODO"


def test_output_prediction_messages(question: dict, model: str = "") -> list[dict]:
    """question: a TestOutputPredictionProblem row ({"question_content",
    "starter_code", "function_name", "input", ...}). The scored contract is
    an ``assert`` line completing the given call (reference:
    scripts/lcb_runner/prompts/test_output_prediction.py:70-84)."""
    fn = question.get("function_name") or "f"
    body = (f"Problem:\n{question.get('question_content', '')}"
            f"Function:\n```\n{question.get('starter_code', '')}\n```\n"
            "Please complete the following test case:\n\n"
            f"```\n{format_testcase_call(fn, question.get('input', ''))}\n```\n")
    return [
        {"role": "system", "content": SYSTEM_TEST_OUTPUT},
        {"role": "user", "content": body},
    ]
