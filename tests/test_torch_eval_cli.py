"""The port's ``cli/evaluate.py``, ``cli/lcb_run.py``, ``cli/report.py`` and
``cli/demo.py`` against the JAX originals, on the CPU.

Each CLI runs in both packages on the same inputs, with the same stubs:
``evaluate`` writes equal metrics files (``qa``, ``math
--use_math_grader``, ``code``, and ``--use_llm`` with ``HTTPClient``'s
``complete`` stubbed alike); ``lcb_run`` (``make_clients`` monkeypatched,
as in ``tests/test_lcb_scenarios.py``) prints equal metrics and writes equal
generations in all three scenarios; ``report`` writes equal rows; the demo
gives equal events with the fake backend, and with ``"engine"``: scripted
families registered in both registries emit the in-band search tokens and
text past ``<|end_search_query|>``, and both engines cut the reply at the
stop string alike, with a prefix hit on the second call. The three CLIs
that build engines take JAX's flags plus ``deep_search``'s engine flags,
which reach the port's ``Engine``; and the four CLIs run with ``jax`` and the
JAX package blocked from import.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu_torch.cli import deep_search as tds
from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu_torch.models import registry as tregistry
from deepsearch_tts_tpu_torch.prompts import qa as P

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("deepsearch_tts_tpu", "deepsearch_tts_tpu_torch")
TOK = ByteTokenizer()
ENGINE_FLAGS = {"engine_max_slots", "engine_page_size", "engine_pages", "engine_max_seq_len",
                "engine_prefill_lane", "engine_warmup", "engine_tp", "device", "seed"}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _last_json(out: str) -> dict:
    """The JSON object a CLI printed (lines up to the ``generations`` line)."""
    return json.loads("".join(ln for ln in out.splitlines() if not ln.startswith("generations")))


# ------------------------------------------------------------------- flags

class _Parsed(Exception):
    pass


def _parser(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser ``main`` builds, caught at its first ``parse_args``."""
    seen = []

    def parse_args(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Parsed):
            main([])
    return seen[0]


@pytest.mark.parametrize("cli", ["evaluate", "report", "lcb_run", "demo"])
def test_flags_are_jaxs_plus_the_engine_flags(cli, monkeypatch):
    j = {a.dest: a for a in _parser(_mod(PKGS[0], f"cli.{cli}").main, monkeypatch)._actions}
    t = {a.dest: a for a in _parser(_mod(PKGS[1], f"cli.{cli}").main, monkeypatch)._actions}
    added = set() if cli == "evaluate" else ENGINE_FLAGS
    assert set(t) == set(j) | added and not set(j) & added
    for dest, a in j.items():
        b = t[dest]
        assert (a.option_strings, a.type, a.choices, a.default, a.required) == (
            b.option_strings, b.type, b.choices, b.default, b.required), dest
    ds = {a.dest: a for a in tds.build_parser()._actions}
    for dest in added:
        assert (t[dest].option_strings, t[dest].type, t[dest].default) == (
            ds[dest].option_strings, ds[dest].type, ds[dest].default), dest


def test_engine_argv_round_trips():
    args = tds.build_parser().parse_args(["--device", "cpu", "--engine_pages", "64",
                                          "--seed", "3", "--engine_prefill_lane", "0"])
    again = tds.build_parser().parse_args(tds.engine_argv(args))
    assert {k: getattr(again, k) for k in ENGINE_FLAGS} == {k: getattr(args, k)
                                                           for k in ENGINE_FLAGS}
    assert again.engine_pages == 64 and again.device == "cpu" and again.seed == 3


class _Stop(Exception):
    pass


class _RecordingEngine:
    """Stands in for the port's ``Engine``: records how it was built; a
    request raises ``_Stop``."""

    built: list = []

    def __init__(self, name, tokenizer, **kw):
        self.tokenizer = tokenizer
        self.shut = False
        _RecordingEngine.built.append((name, kw, self))

    def submit(self, req):
        raise _Stop

    def shutdown(self):
        self.shut = True


@pytest.mark.parametrize("cli", ["report", "lcb_run", "demo"])
def test_engine_flags_reach_the_engine(cli, tmp_path, monkeypatch):
    from deepsearch_tts_tpu_torch.engine import engine as tengine

    monkeypatch.setattr(tengine, "Engine", _RecordingEngine)
    _RecordingEngine.built = []
    flags = ["--backend", "engine", "--model_name", "qwen3-test", "--device", "cpu",
             "--engine_pages", "64", "--engine_max_slots", "2", "--engine_page_size", "8",
             "--engine_max_seq_len", "256", "--engine_prefill_lane", "0", "--seed", "3"]
    inp = tmp_path / "in.json"
    inp.write_text(json.dumps([{"Question": "q", "id": "p1", "test_cases": []}]))
    main = _mod(PKGS[1], f"cli.{cli}").main
    if cli == "report":
        main(flags + ["--aux_model_name", "qwen3-moe-test", "--input_path", str(inp),
                      "--output_dir", str(tmp_path)])
    else:
        extra = (["--input_path", str(inp), "--output_dir", str(tmp_path)] if cli == "lcb_run"
                 else ["--question", "q", "--aux_model_name", "qwen3-moe-test"])
        with pytest.raises(_Stop):
            main(flags + extra)
    # the policy engine, then the aux (deep_search's default qwen3-4b for
    # lcb_run) at half the slots and pages, no lane
    (main_name, main_kw, main_eng), (aux_name, aux_kw, aux_eng) = _RecordingEngine.built
    assert main_name == "qwen3-test"
    assert aux_name == ("qwen3-4b" if cli == "lcb_run" else "qwen3-moe-test")
    assert main_kw == dict(params=None, device=torch.device("cpu"), seed=3, page_size=8,
                           max_seq_len=256, max_slots=2, n_pages=64, prefill_lane=0)
    assert aux_kw == dict(params=None, device=torch.device("cpu"), seed=3, page_size=8,
                          max_seq_len=256, max_slots=4, n_pages=64)
    if cli == "report":   # each report row records its error; both engines shut down
        assert main_eng.shut and aux_eng.shut
        (out,) = tmp_path.glob("report_results_*.json")
        assert json.loads(out.read_text())[0]["report"].startswith("Error")


# ---------------------------------------------------------------- evaluate

ROWS = [
    {"Question": "Capital of France?", "answer": "Paris", "pred_answer": "\\boxed{Paris}",
     "domain": "geo"},
    {"Question": "Largest planet?", "answer": ["Jupiter", "jupiter"],
     "Output": "I think it is \\boxed{Jupiter}.", "domain": "space"},
    {"Question": "Author of Hamlet?", "answer": "Shakespeare",
     "pred_answer": "\\boxed{Christopher Marlowe}", "Level": "hard"},
    {"Question": "Speed of light?", "answer": "299792458 m/s", "pred_answer": "\\boxed{not found}"},
]
MATH_ROWS = [
    {"Question": "Half of one?", "answer": "0.5", "pred_answer": "\\boxed{\\frac{1}{2}}",
     "type": "math"},
    {"Question": "Percent?", "answer": "50%", "Output": "so \\boxed{0.5}"},
    {"Question": "Root?", "answer": "2", "pred_answer": "\\boxed{\\sqrt{4}}"},
    {"Question": "Factor?", "answer": "(x-1)(x+1)", "pred_answer": "\\boxed{x^2-1}"},
    {"Question": "Wrong?", "answer": "3", "pred_answer": "\\boxed{4}", "Level": "easy"},
    {"Question": "Planet?", "answer": "5", "pred_answer": "\\boxed{Jupiter}"},
    {"Question": "Gave up?", "answer": "7", "pred_answer": "I give up"},
]
CODE_ROWS = [
    {"Question": "double", "pred_answer": "print(int(input()) * 2)",
     "test_cases": [{"input": "2\n", "expected_output": "4\n"}]},
    {"Question": "double", "Output": "```python\nprint(int(input()) + 2)\n```",
     "test_cases": [{"input": "3\n", "expected_output": "6\n"}]},
    {"Question": "inc", "pred_answer": "def inc(x):\n    return x + 1",
     "test_cases": [{"fn_name": "inc", "args": [1], "expected": 2}]},
]


def _stub_http(monkeypatch):
    """``HTTPClient.complete`` of both packages answers the judge prompt:
    "Correct" when the prediction names a planet or a playwright, else
    "Incorrect"; the requests are recorded."""
    seen = []
    for pkg in PKGS:
        client = _mod(pkg, "agents.client")

        async def complete(self, prompt, _client=client, **opts):
            seen.append((self.base_url, self.model, opts))
            pred = prompt.split("Predicted Answer:")[1]
            ok = "Jupiter" in pred or "Marlowe" in pred
            return _client.CompletionResponse("Correct" if ok else "Incorrect")

        monkeypatch.setattr(client.HTTPClient, "complete", complete)
    return seen


@pytest.mark.parametrize("task,extra", [
    ("qa", []), ("math", ["--use_math_grader"]), ("choose", []),
    ("qa", ["--use_llm", "--api_base_url", "http://127.0.0.1:9/v1", "--model_name", "judge"]),
    ("math", ["--use_math_grader", "--use_llm", "--api_base_url", "http://127.0.0.1:9/v1"]),
    ("code", []),
], ids=["qa", "math-grader", "choose", "qa-llm", "math-grader-llm", "code"])
def test_evaluate_metrics_equal(task, extra, tmp_path, monkeypatch, capsys):
    seen = _stub_http(monkeypatch)
    rows = {"code": CODE_ROWS, "math": MATH_ROWS}.get(task, ROWS)
    outs = []
    for pkg in PKGS:
        path = tmp_path / pkg / "policy_results.json"
        path.parent.mkdir()
        path.write_text(json.dumps(rows))
        _mod(pkg, "cli.evaluate").main(["--output_path", str(path), "--task", task] + extra)
        printed = json.loads(capsys.readouterr().out)
        files = [] if task == "code" else [
            json.loads((tmp_path / pkg / f"policy_results.json{s}").read_text())
            for s in (".metrics.json", ".metrics.overall.json")]
        outs.append((printed, files))
    assert outs[0] == outs[1]
    printed, files = outs[1]
    if task == "code":
        assert printed == {"pass@1": pytest.approx(2 / 3)}
        return
    assert files[1] == printed and printed["total"] == len(rows)
    if "--use_llm" in extra:
        # one judge request a row, 8 tokens each; under the math grader only
        # the rows it does not grade equal reach the judge
        judged = len(rows) if task == "qa" else 3
        assert len(seen) == 2 * judged
        assert all(o == {"max_tokens": 8} for _, _, o in seen)
        assert {m for _, m, _ in seen} == {"judge" if task == "qa" else ""}
    if task == "math":
        # the grader takes four; the judge only the planet
        want = 5 / 7 if "--use_llm" in extra else 4 / 7
        assert printed["llm_equal"] == pytest.approx(want)
        assert [r["llm_rationale"] for r in files[0]][:4] == ["math_grader"] * 4
    if task == "qa" and "--use_llm" in extra:
        assert printed["llm_equal"] == pytest.approx(3 / 4)
        assert [r["llm_rationale"] for r in files[0]] == ["Incorrect", "Correct", "Correct",
                                                           "Incorrect"]


# ----------------------------------------------------------------- lcb_run

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


CODEGEN = [{"id": "echo", "question_content": "echo stdin",
            "test_cases": [{"input": "hi\n", "expected_output": "hi\n"}]},
           {"id": "twice", "question_content": "print twice the number",
            "test_cases": [{"input": "4\n", "expected_output": "8\n"}]},
           {"id": "inc", "question_content": "increment", "starter_code": "def inc(x):",
            "test_cases": [{"fn_name": "inc", "args": [1], "expected": 2}]}]


def _lcb_handler(client_mod):
    def handler(messages, tools):
        user = messages[-1]["content"]
        if "assert f(x = 1) == ??" in user:
            return client_mod.ChatResponse(type="normal",
                                           content="assert f(x = 1) == 2\n[/ANSWER]")
        if "assert addOne(5) == # TODO" in user:
            return client_mod.ChatResponse(type="normal",
                                           content="```\nassert addOne(5) == 6\n```")
        if "twice" in user:   # a wrong program
            return client_mod.ChatResponse(type="normal",
                                           content="```python\nprint(input())\n```")
        if "increment" in user:
            return client_mod.ChatResponse(
                type="normal", content="```python\ndef inc(x):\n    return x + 1\n```")
        return client_mod.ChatResponse(type="normal", content="```python\nprint(input())\n```")
    return handler


@pytest.mark.parametrize("scenario", ["codegen", "codeexecution", "testoutput"])
def test_lcb_run_equal(scenario, tmp_path, monkeypatch, capsys):
    records = {"codegen": CODEGEN, "codeexecution": [_exec_record()],
               "testoutput": [_top_record()]}[scenario]
    inp = tmp_path / "in.json"
    inp.write_text(json.dumps(records))
    outs = []
    for pkg in PKGS:
        client = _mod(pkg, "agents.client")

        def make_clients(args, _c=client):
            h = _lcb_handler(_c)
            return _c.FakeClient(handler=h), _c.FakeClient(handler=h), None

        monkeypatch.setattr(_mod(pkg, "cli.deep_search"), "make_clients", make_clients)
        out = tmp_path / pkg
        extra = (["--num_workers", "2", "--n", "2", "--k", "1,2", "--timeout", "2"]
                 if scenario == "codegen" else [])
        _mod(pkg, "cli.lcb_run").main(["--input_path", str(inp), "--scenario", scenario,
                                       "--output_dir", str(out)] + extra)
        metrics = _last_json(capsys.readouterr().out)
        (gen,) = out.glob(f"{scenario}_*.json")
        outs.append((metrics, json.loads(gen.read_text())))
    assert outs[0] == outs[1]
    metrics, gen = outs[1]
    if scenario == "codegen":
        assert metrics == {"pass@1": pytest.approx(2 / 3), "pass@2": pytest.approx(2 / 3)}
        assert [g["key"] for g in gen] == ["echo", "twice", "inc"]
    else:
        assert metrics == {"pass@1": 1.0}


def test_lcb_run_continue_existing_equal(tmp_path, monkeypatch, capsys):
    """A prior generations file serves the problems it covers."""
    inp = tmp_path / "in.json"
    inp.write_text(json.dumps(CODEGEN))
    prior = tmp_path / "prior.json"
    prior.write_text(json.dumps([{"key": "twice", "codes": ["print(int(input()) * 2)"]}]))
    outs = []
    for pkg in PKGS:
        client = _mod(pkg, "agents.client")
        monkeypatch.setattr(_mod(pkg, "cli.deep_search"), "make_clients",
                            lambda args, _c=client: (_c.FakeClient(handler=_lcb_handler(_c)),
                                                     None, None))
        _mod(pkg, "cli.lcb_run").main(["--input_path", str(inp), "--output_dir",
                                       str(tmp_path / pkg), "--continue_existing",
                                       str(prior)])
        outs.append(_last_json(capsys.readouterr().out))
    assert outs[0] == outs[1] == {"pass@1": 1.0}


# ------------------------------------------------------------------ report

PLAN = {"title": "T", "sections": [{"name": "Background", "goal": "context"},
                                   {"name": "Conclusion", "goal": "answer"}]}


def _report_handler(client_mod):
    def handler(messages, tools):
        prompt = messages[-1]["content"]
        if "Return a JSON object" in prompt:
            text = json.dumps(PLAN)
        elif "Write the complete markdown" in prompt:
            text = "## Background\ndraft" if "Background" in prompt else "## Conclusion\nok"
        elif "List any factual claims" in prompt:
            text = "claim X unsupported" if "draft" in prompt else "OK"
        elif "address the reviewer feedback" in prompt:
            text = "## Background\nfixed"
        elif "concise, informative title" in prompt:
            text = "Final Title\nsecond line"
        else:
            text = "# Report\npolished"
        return client_mod.ChatResponse(type="normal", content=text)
    return handler


@pytest.mark.parametrize("scripted", [False, True], ids=["fake-backend", "scripted"])
def test_report_rows_equal(scripted, tmp_path, monkeypatch, capsys):
    inp = tmp_path / "in.json"
    inp.write_text(json.dumps([{"Question": "Why is the sky blue?", "id": 1},
                               {"Question": "How do tides work?", "id": 2}]))
    outs = []
    for pkg in PKGS:
        if scripted:
            client = _mod(pkg, "agents.client")
            monkeypatch.setattr(
                _mod(pkg, "cli.deep_search"), "make_clients",
                lambda args, _c=client: (_c.FakeClient(handler=_report_handler(_c)),
                                         _c.FakeClient(handler=_report_handler(_c)), None))
        _mod(pkg, "cli.report").main(["--input_path", str(inp), "--output_dir",
                                      str(tmp_path / pkg), "--max_sections", "3"])
        assert "Wrote 2 reports" in capsys.readouterr().out
        (out,) = (tmp_path / pkg).glob("report_results_*.json")
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1]
    rows = outs[1]
    assert [r["id"] for r in rows] == [1, 2]
    if scripted:
        assert rows[0]["title"] == "Final Title" and rows[0]["report"] == "# Report\npolished"
        assert rows[0]["sections"] == ["Background", "Conclusion"]
    else:   # the fake backend's boxed reply is no plan: the default sections
        assert rows[0]["sections"] == ["Background", "Analysis", "Conclusion"]


# -------------------------------------------------------------------- demo

async def _events(pkg, question, env, client, aux, tool):
    inband = _mod(pkg, "demo.inband")
    return [(e.kind, e.payload)
            async for e in inband.run_inband_agent(question, env, client, aux, tool)]


def test_demo_fake_events_equal(capsys):
    q = "what is the demo fact?"
    outs = []
    for pkg in PKGS:
        session = _mod(pkg, "cli.demo").build_demo_session("fake", question=q)
        outs.append(asyncio.run(_events(pkg, q, *session)))
        _mod(pkg, "cli.demo").main(["--question", q])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert [k for k, _ in outs[2]] == ["text", "search", "result", "text", "final"]
    assert outs[2][-1] == ("final", "demo answer")


SCRIPT_LEN = 2048
DEMO_MAIN, DEMO_AUX = "script-demo-main", "script-demo-aux"
QUESTION = "What is the capital of France?"
REPLAY = {"searches": {"capital of France": [
    {"id": 1, "title": "France", "url": "https://example.org/france",
     "site_name": "example.org", "date": "2024-01-01",
     "snippet": "Paris is the capital and largest city of France."}]},
    "pages": {"https://example.org/france":
              "France is a country in Western Europe. Paris is the capital and largest "
              "city of France."}}
SEARCH = f"I should look this up. {P.BEGIN_SEARCH_QUERY}capital of France{P.END_SEARCH_QUERY}"
PAST_STOP = " and more"     # the scripted reply goes on past the stop string
ANSWER = "The results say Paris. \\boxed{Paris}"
AUX_REPLIES = ["find the capital city of France",
               "**Final Information**\nParis is the capital of France."]


class _Recorder:
    def __init__(self, client_mod, replies):
        self.mod, self.replies, self.calls = client_mod, list(replies), []

    async def complete(self, prompt, **opts):
        out = self.replies.pop(0)
        self.calls.append((prompt, out))
        return self.mod.CompletionResponse(out, "stop")


def _script(segments) -> np.ndarray:
    script = np.full((SCRIPT_LEN,), ord("x"), np.int32)
    written: dict[int, int] = {}
    for prompt_text, reply_text in segments:
        p = len(TOK.encode(prompt_text))
        for off, t in enumerate(TOK.encode(reply_text) + [TOK.eos_id]):
            assert written.get(p + off, t) == t, f"script conflict at {p + off}"
            written[p + off] = script[p + off] = t
    return script


class _JaxScriptCfg:
    vocab_size = TOK.vocab_size
    n_layers = 1
    n_kv_heads = 1
    head_dim = 8
    jnp_dtype = jnp.float32
    custom_init = True


class _TorchScriptCfg:
    vocab_size = TOK.vocab_size
    n_layers = 1
    n_kv_heads = 1
    head_dim = 8
    torch_dtype = torch.float32
    custom_init = True


def _jax_forward(params, cfg, tokens, positions, *, k_pages=None, v_pages=None,
                 logits_indices=None, **kw):
    import jax

    script = params["script"]
    pos = positions
    if logits_indices is not None:
        pos = jnp.take_along_axis(positions, logits_indices[:, None], axis=1)
    nxt = script[jnp.clip(pos + 1, 0, script.shape[0] - 1)]
    return 30.0 * jax.nn.one_hot(nxt, cfg.vocab_size, dtype=jnp.float32), (k_pages, v_pages)


def _torch_forward(params, cfg, tokens, positions, *, k_pages=None, v_pages=None,
                   logits_indices=None, **kw):
    script = params["script"]
    pos = positions
    if logits_indices is not None:
        pos = torch.gather(positions, 1, logits_indices[:, None])
    nxt = script[torch.clamp(pos + 1, 0, script.shape[0] - 1)]
    logits = 30.0 * torch.nn.functional.one_hot(nxt, cfg.vocab_size).to(torch.float32)
    return logits, (k_pages, v_pages)


def _demo_args(tmp, pkg):
    argv = ["--search_backend", "replay", "--replay_path", str(tmp / "replay.json"),
            "--engine_max_slots", "2", "--engine_page_size", "16", "--engine_pages", "257",
            "--engine_max_seq_len", "2048", "--engine_prefill_lane", "0"]
    return argv + (["--device", "cpu"] if pkg == PKGS[1] else [])


@pytest.fixture(scope="module")
def demo_scripts(tmp_path_factory):
    """The scripted families, from a dry run of the in-band loop through each
    package's own search stack with recording clients (the recorded prompts
    must be equal): the policy's first reply runs past the stop string."""
    tmp = tmp_path_factory.mktemp("demo")
    (tmp / "replay.json").write_text(json.dumps(REPLAY))
    recs = []
    for pkg in PKGS:
        ds = _mod(pkg, "cli.deep_search")
        args = ds.build_parser().parse_args(_demo_args(tmp, pkg))
        backend, fetcher = ds.make_search(args)
        client = _mod(pkg, "agents.client")
        main, aux = _Recorder(client, [SEARCH, ANSWER]), _Recorder(client, AUX_REPLIES)
        tool = _mod(pkg, "agents.websearch").WebSearchTool(backend, fetcher, aux)
        env = _mod(pkg, "demo.environment").Environment(
            model_name=DEMO_MAIN, aux_model_name=DEMO_AUX, max_search_limit=10)
        events = asyncio.run(_events(pkg, QUESTION, env, main, aux, tool))
        assert not main.replies and not aux.replies
        recs.append((events, main.calls, aux.calls))
    assert recs[0] == recs[1]
    events, main_calls, aux_calls = recs[1]
    (p1, _), (p2, _) = main_calls
    main = _script([(p1, SEARCH + PAST_STOP), (p2, ANSWER)])
    aux = _script(aux_calls)
    for name, s in ((DEMO_MAIN, main), (DEMO_AUX, aux)):
        jregistry.register(name, _JaxScriptCfg(), lambda cfg, key, s=s: {"script": jnp.asarray(s)},
                           _jax_forward, lambda: {})
        tregistry.register(name, _TorchScriptCfg(), _torch_forward,
                           init_params=lambda cfg, *, seed, device, s=s: {
                               "script": torch.from_numpy(s).long().to(device)})
    return tmp, events


def _engine_demo(tmp, pkg):
    demo = _mod(pkg, "cli.demo")
    env, client, aux, tool = demo.build_demo_session(
        "engine", DEMO_MAIN, DEMO_AUX, max_search_calls=10,
        extra_args=_demo_args(tmp, pkg))
    try:
        events = asyncio.run(_events(pkg, QUESTION, env, client, aux, tool))
        return events, client.engine.telemetry(), aux.engine.telemetry()
    finally:
        client.engine.shutdown()
        aux.engine.shutdown()


def test_demo_engine_events_equal(demo_scripts):
    tmp, dry = demo_scripts
    (jev, jmain, jaux), (tev, tmain, taux) = (_engine_demo(tmp, pkg) for pkg in PKGS)
    assert tev == jev == dry
    assert [k for k, _ in tev] == ["text", "search", "result", "text", "final"]
    # the reply is cut at the stop string, which it keeps
    assert tev[0] == ("text", SEARCH) and PAST_STOP not in tev[0][1]
    assert tev[1] == ("search", "capital of France") and tev[-1] == ("final", "Paris")
    assert tmain["requests"] == jmain["requests"] == 2
    assert taux["requests"] == jaux["requests"] == 2
    # the second call's prompt extends the first byte for byte
    assert tmain["prefix_cache"]["hits"] == jmain["prefix_cache"]["hits"] >= 1
    assert tmain["prefix_cache"]["tokens_reused"] == jmain["prefix_cache"]["tokens_reused"] > 0


def test_demo_engine_on_qwen3_test_streams():
    """``backend="engine"`` builds the port's in-process ``Engine`` on the CPU
    and streams decoded tokens through the in-band loop (the port's
    counterpart of ``tests/test_demo.py``'s engine test)."""
    from deepsearch_tts_tpu_torch.agents.client import EngineClient
    from deepsearch_tts_tpu_torch.cli.demo import build_demo_session

    env, client, aux, tool = build_demo_session(
        "engine", model_name="qwen3-test", aux_model_name="qwen3-test",
        extra_args=["--device", "cpu", "--engine_max_slots", "2", "--engine_page_size", "4",
                    "--engine_pages", "256", "--engine_max_seq_len", "512"])
    assert isinstance(client, EngineClient) and client.engine.device.type == "cpu"
    try:
        env.max_tokens = 16
        events = asyncio.run(_events(PKGS[1], "hello", env, client, aux, tool))
        assert events and events[0][0] == "text" and events[0][1]
        assert events[-1][0] == "final"
    finally:
        client.engine.shutdown()


class _FakeStreamlit:
    """The calls ``demo/app.py`` makes, answered as a user who picks the
    engine backend and presses Run."""

    def __init__(self):
        self.titles, self.session_state, self.markdown_calls = [], {}, []
        self.sidebar = self

    def set_page_config(self, **kw):
        self.page = kw

    def title(self, text):
        self.titles.append(text)

    def selectbox(self, label, options):
        return "engine" if label == "backend" else options[0]

    def text_input(self, label, default=""):
        return "What is the demo fact?" if label == "Question" else default

    def slider(self, label, lo, hi, default):
        return default

    def button(self, label):
        return True

    @contextlib.contextmanager
    def spinner(self, text):
        yield


def test_streamlit_app_passes_the_engine_flags(monkeypatch):
    """``demo/app.py`` builds its session through ``build_demo_session`` with
    the engine flags given after ``--``; its title names the port."""
    fake = _FakeStreamlit()
    monkeypatch.setitem(sys.modules, "streamlit", fake)
    monkeypatch.setattr(sys, "argv", ["app.py", "--engine_pages", "64", "--device", "cpu",
                                      "--not_an_engine_flag", "x"])
    demo = _mod(PKGS[1], "cli.demo")
    seen = []

    def build(*args, **kw):
        seen.append((args, kw))
        raise _Stop

    monkeypatch.setattr(demo, "build_demo_session", build)
    with pytest.raises(_Stop):
        _mod(PKGS[1], "demo.app").main()
    (args, kw), = seen
    assert args == ("engine", "qwen3-8b", "qwen3-4b", "replay", 10)
    extra = tds.build_parser().parse_args(kw["extra_args"])
    assert (extra.engine_pages, extra.device, extra.seed) == (64, "cpu", 0)
    assert "TPU" not in fake.titles[0] + fake.page["page_title"]


# ---------------------------------------------------------------- JAX-free

JAX_FREE = r"""
import json, os, sys
sys.modules["jax"] = None      # any import of jax now raises ImportError
sys.modules["deepsearch_tts_tpu"] = None      # and of the JAX package
from deepsearch_tts_tpu_torch.cli import demo, evaluate, lcb_run, report
out = sys.argv[1]
inp = os.path.join(out, "in.json")
json.dump([{"Question": "q1", "answer": "a", "pred_answer": "a", "id": "p1",
            "test_cases": [{"input": "x\n", "expected_output": "x\n"}]}], open(inp, "w"))
evaluate.main(["--output_path", inp, "--task", "math", "--use_math_grader"])
evaluate.main(["--output_path", inp, "--task", "code"])
report.main(["--input_path", inp, "--output_dir", out])
lcb_run.main(["--input_path", inp, "--output_dir", out])
demo.main(["--question", "q"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "ml_dtypes", "transformers", "deepsearch_tts_tpu")
    and sys.modules[m] is not None)
assert not loaded, loaded
print("OK")
"""


def test_clis_run_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", JAX_FREE, str(tmp_path)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("OK"), proc.stdout[-2000:]
