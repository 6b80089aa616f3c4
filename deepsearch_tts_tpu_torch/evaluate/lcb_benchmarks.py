"""LiveCodeBench benchmark ingestion — the lcb_runner/benchmarks capability.

The port's own copy of ``evaluate/lcb_benchmarks.py`` (same behaviour; imports resolve in this package).

Fresh implementation of the reference's LCB record model
(reference: scripts/lcb_runner/benchmarks/code_generation.py:29-121,
code_execution.py:10-44, test_output_prediction.py:17-56): typed problem
records for the three scenarios, including the code-generation dataset's
compressed ``private_test_cases`` decode ladder (plain JSON first, then
base64 → zlib → pickle). Unlike the reference, the pickle stage goes
through a restricted unpickler that admits only primitive containers —
benchmark files are untrusted input.

Loaders read local JSON/JSONL exports of the HF datasets (this environment
has no egress); ``load_dataset``-style fetching can be layered on by
callers that have network access.
"""
from __future__ import annotations

import base64
import io
import json
import pickle
import zlib
from dataclasses import dataclass
from enum import Enum
from typing import Any, Iterable


class Platform(Enum):
    LEETCODE = "leetcode"
    CODEFORCES = "codeforces"
    ATCODER = "atcoder"


class Difficulty(Enum):
    EASY = "easy"
    MEDIUM = "medium"
    HARD = "hard"


class TestType(Enum):
    STDIN = "stdin"
    FUNCTIONAL = "functional"


class Scenario(Enum):
    """reference: scripts/lcb_runner/utils/scenarios.py"""

    codegeneration = "codegeneration"
    codeexecution = "codeexecution"
    testoutputprediction = "testoutputprediction"


class _RestrictedUnpickler(pickle.Unpickler):
    """Only primitive builtins may be reconstructed from benchmark files."""

    _SAFE = {("builtins", n) for n in
             ("list", "dict", "tuple", "set", "str", "int", "float", "bool",
              "bytes", "NoneType")}

    def find_class(self, module, name):
        if (module, name) in self._SAFE:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"benchmark file tried to unpickle {module}.{name}")


def _decompress_tests(blob: str) -> list[dict]:
    """The code-generation dataset stores large private test lists as
    base64(zlib(pickle(json_str))) (reference: code_generation.py:63-74)."""
    raw = zlib.decompress(base64.b64decode(blob.encode("utf-8")))
    inner = _RestrictedUnpickler(io.BytesIO(raw)).load()
    return json.loads(inner)


@dataclass
class Test:
    input: str
    output: str
    testtype: TestType

    def __post_init__(self):
        self.testtype = TestType(self.testtype)


@dataclass
class CodeGenerationProblem:
    """One LCB code-generation record (code_generation.py:42-121)."""

    question_title: str
    question_content: str
    platform: Platform
    question_id: str
    contest_id: str
    contest_date: str
    starter_code: str
    difficulty: Difficulty
    public_test_cases: list[Test]
    private_test_cases: list[Test]
    metadata: dict

    def __post_init__(self):
        self.platform = Platform(self.platform)
        self.difficulty = Difficulty(self.difficulty)
        if isinstance(self.public_test_cases, str):
            self.public_test_cases = json.loads(self.public_test_cases)
        self.public_test_cases = [t if isinstance(t, Test) else Test(**t)
                                  for t in self.public_test_cases]
        if isinstance(self.private_test_cases, str):
            try:
                self.private_test_cases = json.loads(self.private_test_cases)
            except (json.JSONDecodeError, ValueError):
                self.private_test_cases = _decompress_tests(self.private_test_cases)
        self.private_test_cases = [t if isinstance(t, Test) else Test(**t)
                                   for t in self.private_test_cases]
        if isinstance(self.metadata, str):
            self.metadata = json.loads(self.metadata)

    @property
    def tests(self) -> list[Test]:
        return self.public_test_cases + self.private_test_cases

    def to_row(self) -> dict:
        """Convert to the harness row format consumed by
        evaluate.code_eval.codegen_metrics / cli.lcb_run."""
        fn_name = (self.metadata or {}).get("func_name")
        cases = []
        for t in self.tests:
            if t.testtype == TestType.FUNCTIONAL and fn_name:
                try:
                    args = json.loads(t.input)
                except (json.JSONDecodeError, ValueError):
                    args = [t.input]
                if not isinstance(args, (list, tuple)):
                    args = [args]
                try:
                    expected = json.loads(t.output)
                except (json.JSONDecodeError, ValueError):
                    expected = t.output
                cases.append({"fn_name": fn_name, "args": tuple(args),
                              "expected": expected})
            else:
                cases.append({"input": t.input, "expected_output": t.output})
        return {
            "id": self.question_id,
            "question_content": self.question_content,
            "question_title": self.question_title,
            "platform": self.platform.value,
            "difficulty": self.difficulty.value,
            "starter_code": self.starter_code,
            "test_cases": cases,
        }


@dataclass
class CodeExecutionProblem:
    """reference: code_execution.py:10-44 — predict a program's output."""

    question_id: str
    contest_id: str
    contest_date: str
    difficulty: str
    function_name: str
    code: str
    input: str
    output: str
    id: str
    problem_id: str
    numsteps: int

    def to_row(self) -> dict:
        return {
            "id": self.id, "question_id": self.question_id,
            "code": self.code, "input": self.input, "answer": self.output,
            "function_name": self.function_name,
            "difficulty": self.difficulty,
        }


@dataclass
class TestOutputPredictionProblem:
    """reference: test_output_prediction.py:17-56."""

    question_title: str
    question_content: str
    question_id: str
    contest_id: str
    contest_date: str
    difficulty: str
    test: list[Test]
    starter_code: str
    function_name: str
    test_id: int

    def __post_init__(self):
        if isinstance(self.test, str):
            self.test = json.loads(self.test)
        self.test = [t if isinstance(t, Test) else Test(**t) for t in self.test]

    def to_row(self) -> dict:
        # the dataset emits one record per (question, test_id) with that
        # test first in `test`; the reference prompts and scores test[0]
        # (prompts/test_output_prediction.py:162, benchmarks/
        # test_output_prediction.py:55-58), not test[test_id]
        t = self.test[0]
        return {
            "id": f"{self.question_id}_{self.test_id}",
            "question_content": self.question_content,
            "function_name": self.function_name,
            "starter_code": self.starter_code,
            "input": t.input, "answer": t.output,
            "difficulty": self.difficulty,
        }


_SCENARIO_TYPES = {
    Scenario.codegeneration: CodeGenerationProblem,
    Scenario.codeexecution: CodeExecutionProblem,
    Scenario.testoutputprediction: TestOutputPredictionProblem,
}


def _iter_records(path: str) -> Iterable[dict]:
    with open(path, encoding="utf-8") as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            yield from json.load(f)
        else:  # jsonl
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)


def _known_fields(cls) -> set:
    import dataclasses

    return {f.name for f in dataclasses.fields(cls)}


def load_problems(path: str, scenario: Scenario | str = Scenario.codegeneration,
                  limit: int | None = None) -> list[Any]:
    """Load LCB problems from a local JSON/JSONL export of the HF dataset.

    Unknown extra fields are dropped (dataset releases add columns over
    time); records that fail to decode raise with their index for
    debuggability."""
    if isinstance(scenario, str):
        scenario = Scenario(scenario)
    cls = _SCENARIO_TYPES[scenario]
    keep = _known_fields(cls)
    out = []
    for i, rec in enumerate(_iter_records(path)):
        if limit is not None and len(out) >= limit:
            break
        try:
            out.append(cls(**{k: v for k, v in rec.items() if k in keep}))
        except Exception as e:
            raise ValueError(f"bad {scenario.value} record #{i}: {e}") from e
    return out


def load_code_generation_rows(path: str, limit: int | None = None) -> list[dict]:
    """Problems → harness rows (the shape cli/lcb_run.py consumes)."""
    return [p.to_row() for p in load_problems(path, Scenario.codegeneration, limit)]


def load_scenario_rows(path: str, scenario: Scenario | str,
                       limit: int | None = None) -> list[dict]:
    """Any scenario's problems → harness rows."""
    return [p.to_row() for p in load_problems(path, scenario, limit)]
