"""The port's ``agents/`` copies against the JAX originals.

Each scenario runs once with the JAX package's agent stack and once with
the port's, driven by the same scripted clients as ``tests/test_agents.py``,
``test_bestofn.py``, ``test_budget_forcing.py`` and ``test_explorer.py``
(tool calls carry fixed ids, so nothing random enters). The message lists,
answers, confidences, selections, the options each model call got
(``min_tokens`` on the budget-forcing re-entry only), explorer transcripts,
statistics and the result rows ``BatchRunner`` writes must be equal.
``HTTPClient``'s payloads and retries and ``EngineClient``'s requests and
tool-call parsing are compared too.
"""
import asyncio
import concurrent.futures
import dataclasses
import importlib
import io
import json
import types
import urllib.error

import pytest

PKGS = ("deepsearch_tts_tpu", "deepsearch_tts_tpu_torch")


def _ns(pkg: str):
    mods = ("agents.client", "agents.policy", "agents.runner", "agents.tracing",
            "agents.websearch", "agents.explorer", "web.replay", "web.fetch",
            "prompts.qa", "engine.engine")
    return types.SimpleNamespace(pkg=pkg, **{
        m.split(".")[1]: importlib.import_module(f"{pkg}.{m}") for m in mods})


JAX, PORT = _ns(PKGS[0]), _ns(PKGS[1])


def _call(cid: str, query: str, intent: str = "i", name: str = "deep_websearch") -> dict:
    return {"id": cid, "type": "function",
            "function": {"name": name, "arguments": json.dumps(
                {"search_query": query, "search_intent": intent})}}


def _tr(res) -> dict:
    return dataclasses.asdict(res)


def _web(ns, facts=None):
    store = ns.replay.synthetic_store(facts or {
        "capital of france": "Paris is the capital of France."})
    return (ns.replay.ReplaySearchBackend(store),
            ns.fetch.PageFetcher(raw_fetch=ns.replay.replay_fetcher(store)), store)


def _tool(ns, use_explorer=False, aux=None, stats=None):
    backend, fetcher, _ = _web(ns)
    aux = aux or ns.client.FakeClient(handler=lambda m, t: ns.client.ChatResponse(
        type="normal",
        content="</think>\n**Final Information**: Paris is the capital of France."))
    return ns.websearch.WebSearchTool(backend, fetcher, aux, top_k=5, stats=stats,
                                      use_explorer=use_explorer)


def _resp(ns, **kw):
    return ns.client.ChatResponse(**kw)


# ------------------------------------------------------------- scenarios


def sc_solve_direct(ns):
    c = ns.client.FakeClient(script=[_resp(ns, type="normal", content=r"Thinking... \boxed{42}",
                                           finish_reason="stop")])
    return _tr(asyncio.run(ns.policy.PolicyAgent(c).solve("What is 6x7?"))), c.calls


def sc_solve_with_tool_call(ns):
    c = ns.client.FakeClient(script=[
        _resp(ns, type="tool", content="", tool_calls=[
            _call("call_1", "capital of france", "find the capital")]),
        _resp(ns, type="normal", content=r"\boxed{Paris}", finish_reason="stop")])
    stats = ns.tracing.RunStatistics("m", "aux")
    agent = ns.policy.PolicyAgent(c, search_tool=_tool(ns, stats=stats), max_search_calls=3,
                                  stats=stats, gen_opts={"temperature": 0.0, "max_tokens": 64})
    res = asyncio.run(agent.solve("What is the capital of France?"))
    assert res.answer == "Paris"
    summary = stats.summary()
    summary.pop("wall_time_s")
    return _tr(res), c.calls, summary


def sc_search_budget_enforced(ns):
    def always_search(messages, tools):
        return _resp(ns, type="tool", tool_calls=[_call(f"c{len(messages)}",
                                                        f"q{len(messages)}")])
    c = ns.client.FakeClient(handler=always_search)
    res = asyncio.run(ns.policy.PolicyAgent(c, search_tool=_tool(ns), max_search_calls=2)
                      .solve("loop forever"))
    assert res.error == "max_iterations" and res.n_search_calls == 2
    return _tr(res), c.calls


def sc_empty_query_and_other_tool(ns):
    c = ns.client.FakeClient(script=[
        _resp(ns, type="tool", tool_calls=[_call("a", ""), _call("b", "x", name="other"),
                                           {"id": "c", "function": {
                                               "name": "deep_websearch",
                                               "arguments": "{not json"}}]),
        _resp(ns, type="normal", content="no box", finish_reason="length"),
        _resp(ns, type="normal", content=r"\boxed{x}", finish_reason="stop")])
    res = asyncio.run(ns.policy.PolicyAgent(c, search_tool=_tool(ns)).solve("q"))
    return _tr(res), c.calls


def sc_verify_confidence(ns):
    outs = []
    for content in (r"2 of 4 conditions verified. \[\boxed{\text{0.5}}\]", r"\boxed{75%}",
                    r"\boxed{\text{3/4}}", r"\boxed{high}", "no box"):
        c = ns.client.FakeClient(script=[_resp(ns, type="normal", content=content,
                                               finish_reason="stop")])
        agent = ns.policy.PolicyAgent(c, max_search_calls=1, verifier_version=2)
        outs.append((_tr(asyncio.run(agent.verify("Q?", "some answer"))), c.calls))
    return outs


def _prior():
    return [{"role": "system", "content": "solver"}, {"role": "user", "content": "Q?"},
            {"role": "assistant", "content": "I think it's 41. \\boxed{41}"}]


def sc_budget_forcing(ns):
    outs = []
    for forcing in ("text", "logit"):
        for mode in ("solve_budget_forcing", "verify_budget_forcing"):
            c = ns.client.FakeClient(script=[
                _resp(ns, type="normal", content="hmm, not sure yet", finish_reason="stop"),
                _resp(ns, type="tool", tool_calls=[_call("s1", "capital of france")]),
                _resp(ns, type="normal", content=r"\boxed{0.5}")])
            agent = ns.policy.PolicyAgent(c, search_tool=_tool(ns), max_search_calls=3,
                                          budget_forcing=forcing, min_thinking_tokens=256,
                                          gen_opts={"temperature": 0.7})
            res = asyncio.run(getattr(agent, mode)(_prior()))
            opts = [call["opts"] for call in c.calls]
            # min_tokens on the re-entry turn only, and only in logit mode
            assert [o.get("min_tokens") for o in opts] == (
                [256, None, None] if forcing == "logit" else [None] * 3)
            outs.append((_tr(res), c.calls))
    return outs


def sc_error_response(ns):
    c = ns.client.FakeClient(script=[_resp(ns, type="error", content="Error: boom",
                                           error="boom")])
    return _tr(asyncio.run(ns.policy.PolicyAgent(c).solve("q")))


def _bestofn_handler(ns, answers, scores):
    it = iter(answers)

    def handler(messages, tools):
        if "fact-check" in messages[0]["content"]:
            pred = messages[1]["content"].split("[Predicted Answer Start]")[-1]
            score = next((s for a, s in scores.items() if a in pred), "0.1")
            return _resp(ns, type="normal", content=rf"\[\boxed{{\text{{{score}}}}}\]",
                         finish_reason="stop")
        return _resp(ns, type="normal", content=next(it), finish_reason="stop")
    return handler


def sc_best_of_n(ns):
    outs = []
    for answers, scores, n in (
            ([r"\boxed{A}", r"\boxed{A}", r"\boxed{B}"], {"B": "0.9", "A": "0.3"}, 3),
            ([r"\boxed{A}", r"\boxed{A}", r"\boxed{B}"], {"A": "0.5", "B": "0.5"}, 3),
            ([r"\boxed{C}", "no answer", r"\boxed{D}", r"\boxed{C}"], {"D": "0.6"}, 4)):
        c = ns.client.FakeClient(handler=_bestofn_handler(ns, answers, scores))
        res = asyncio.run(ns.policy.PolicyAgent(c, max_search_calls=2)
                          .solve_best_of_n("q?", n=n))
        # the calls' order across concurrent trajectories is the loop's, the
        # same in both packages; compare them as a sorted multiset too
        outs.append((_tr(res), sorted(json.dumps(x, sort_keys=True) for x in c.calls)))
    fail = ns.client.FakeClient(handler=lambda m, t: _resp(ns, type="error",
                                                           content="Error: down", error="down"))
    outs.append(_tr(asyncio.run(ns.policy.PolicyAgent(fail).solve_best_of_n("q?", n=2))))
    return outs


class _Completer:
    def __init__(self, ns, responses):
        self.ns, self.responses, self.calls = ns, list(responses), []

    async def complete(self, prompt, **opts):
        self.calls.append((prompt, opts))
        text = self.responses.pop(0) if self.responses else \
            "**Final Information**: nothing more."
        return self.ns.client.CompletionResponse(text)


def sc_explorer(ns):
    P = ns.qa
    store = ns.replay.synthetic_store({"eiffel tower height": "The Eiffel Tower is 330m tall.",
                                       "q": "Fact sentence."})
    url = sorted(store.pages)[0]
    scripts = [
        ([f"Let me check. {P.BEGIN_SEARCH_QUERY}eiffel tower height{P.END_SEARCH_QUERY}",
          "**Final Information**: The Eiffel Tower is 330m tall."], {}),
        ([f"{P.BEGIN_SEARCH_QUERY}same query{P.END_SEARCH_QUERY}",
          f"{P.BEGIN_SEARCH_QUERY}same query", "**Final Information**: done."], {}),
        ([f"{P.BEGIN_CLICK_LINK}{url}{P.END_CLICK_LINK}",
          "</think>\n**Final Information**: page says Fact sentence.",
          f"{P.BEGIN_CLICK_LINK}{url}{P.END_CLICK_LINK}",
          "**Final Information**: overall, Fact sentence."], {}),
        ([f"{P.BEGIN_SEARCH_QUERY}q{i}{P.END_SEARCH_QUERY}" for i in range(12)]
         + ["forced summary text"], {"max_interactions": 3}),
        (["just talking, no action"], {"gen_opts": {"temperature": 0.0}}),
    ]
    outs = []
    for responses, kw in scripts:
        aux = _Completer(ns, responses)
        stats = ns.tracing.RunStatistics("m", "aux")
        res = asyncio.run(ns.explorer.run_explorer(
            "tower height", "find the height", "initial results...", aux_client=aux,
            search_backend=ns.replay.ReplaySearchBackend(store),
            fetcher=ns.fetch.PageFetcher(raw_fetch=ns.replay.replay_fetcher(store)),
            stats=stats, top_k=3, **kw))
        outs.append((_tr(res), aux.calls, stats.api_counters.as_dict(),
                     dataclasses.astuple(stats.aux_usage)))
    for s in (f"I will search {P.BEGIN_SEARCH_QUERY}eiffel height",
              f"{P.BEGIN_CLICK_LINK}http://x", "plain text"):
        outs.append(ns.explorer._repair_dropped_stop(s))
    return outs


def sc_websearch_tool(ns):
    outs = []
    for use_explorer in (True, False):
        stats = ns.tracing.RunStatistics("m", "aux")
        tool = _tool(ns, use_explorer=use_explorer, stats=stats)
        outs.append(asyncio.run(tool.search_with_intent("capital of france", "find capital")))
        outs.append(asyncio.run(tool.search_with_intent("capital of france", "again")))
        outs.append(stats.api_counters.as_dict())

    class Broken:
        async def search(self, q, k):
            raise RuntimeError("backend down")
    _, fetcher, _ = _web(ns)
    tool = ns.websearch.WebSearchTool(Broken(), fetcher, None)
    outs.append(asyncio.run(tool.search_with_intent("x", "y")))
    return outs


def _runner_rows(ns, tmp, mode, handler, problems, **kw):
    agent = ns.policy.PolicyAgent(ns.client.FakeClient(handler=handler),
                                  search_tool=_tool(ns), max_search_calls=2,
                                  budget_forcing="logit", min_thinking_tokens=32)
    runner = ns.runner.BatchRunner(agent, output_dir=str(tmp), mode=mode,
                                   concurrent_limit=2, save_interval=1, **kw)
    out = tmp / f"{ns.pkg}_{mode}.json"
    rows = runner.run_sync([dict(p) for p in problems], str(out))
    assert runner.last_result_file == str(out)
    prefix = runner.result_path("TS").rsplit("/", 1)[1]
    # the file holds rows in completion order (both packages), which the
    # trajectories' thread timing decides: compare it in id order
    return rows, sorted(json.loads(out.read_text()), key=lambda r: r["id"]), prefix


def sc_batch_runner(ns, tmp):
    def handler(messages, tools):
        if "fact-check" in messages[0]["content"]:
            return _resp(ns, type="normal", content=r"\[\boxed{0.8}\]", finish_reason="stop")
        if len(messages) == 2 and "q1" in messages[1]["content"]:
            return _resp(ns, type="tool", tool_calls=[_call("t", "capital of france")])
        if messages[-1]["role"] == "user" and "boom" in messages[-1]["content"]:
            raise RuntimeError("model exploded")
        return _resp(ns, type="normal", content=r"\boxed{A}", finish_reason="stop")

    problems = [{"Question": "q1", "answer": "A", "id": 1}, {"problem": "q2", "id": 2},
                {"Question": "boom", "id": 3},
                {"Question": "q4", "id": 4, "pred_answer": "A",
                 "messages": [{"role": "system", "content": "s"},
                              {"role": "user", "content": "q4"},
                              {"role": "assistant", "content": "stuck"}]}]
    return [_runner_rows(ns, tmp, mode, handler, problems, n_samples=2)
            for mode in ("solve", "verify", "solve_budget_forcing", "verify_budget_forcing",
                         "solve_bestofn")]


def sc_fault_injection(ns):
    inner = ns.client.FakeClient(handler=lambda m, t: _resp(
        ns, type="normal", content=r"\boxed{ok}", finish_reason="stop"))
    chaotic = ns.client.FaultInjectionClient(inner, error_rate=0.5, seed=1)
    answers = [_tr(asyncio.run(ns.policy.PolicyAgent(chaotic).solve(f"q{i}")))
               for i in range(10)]
    raising = ns.client.FaultInjectionClient(inner, error_rate=0.5, seed=3, exception=True)
    outcomes = []
    for i in range(10):
        try:
            outcomes.append(asyncio.run(raising.complete(f"p{i}")).text)
        except ConnectionError as e:
            outcomes.append(str(e))
    return answers, chaotic.injected, outcomes, raising.injected


def sc_tracing(ns, tmp):
    T = ns.tracing
    prices = {"m": {"input": 0.001, "output": 0.002}, "n": {"prompt_tokens": 0.5}}
    u = T.TokenUsage(1000, 500)
    out = [T.calculate_cost(u, name, prices) for name in ("m", "n", "unknown")]
    out.append(T.load_price_config(None))
    out.append(T.load_price_config(str(tmp / "missing.json")))
    assert T.DEFAULT_PRICE_CONFIG.endswith("model_config/aihubmix_price.json")
    stats = T.RunStatistics("Kimi-K2", "qwen3-8b", None)
    stats.record_main(types.SimpleNamespace(prompt_tokens=1000, completion_tokens=1000))
    stats.record_aux(types.SimpleNamespace(prompt_tokens=10, completion_tokens=5))
    stats.record_search()
    stats.record_search("page_fetch")
    stats.engine_stats = {"requests": 3, "prefix_cache": {"hits": 1}}
    path = stats.save(str(tmp / ns.pkg), "TS")
    saved = json.loads(open(path).read())
    saved.pop("wall_time_s")
    return out, saved, path.rsplit("/", 1)[1]


# --------------------------------------------------------------- the tests


SCENARIOS = [sc_solve_direct, sc_solve_with_tool_call, sc_search_budget_enforced,
             sc_empty_query_and_other_tool, sc_verify_confidence, sc_budget_forcing,
             sc_error_response, sc_best_of_n, sc_explorer, sc_websearch_tool,
             sc_fault_injection]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[3:] for s in SCENARIOS])
def test_agent_scenario_equal(scenario):
    assert scenario(JAX) == scenario(PORT)


@pytest.mark.parametrize("scenario", [sc_batch_runner, sc_tracing],
                         ids=["batch_runner_every_mode", "tracing"])
def test_files_equal(scenario, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j, t = scenario(JAX, tmp_path / "j"), scenario(PORT, tmp_path / "t")
    assert j == t


def test_batch_runner_rows_hold_the_modes():
    """What the rows of each mode carry (the JAX CLI tests' fields), on the
    port's runner: confidence and verification searches for the verify
    modes, the nudge for budget forcing, the selection for best-of-n, an
    error row for a raising model."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        import pathlib

        runs = dict(zip(("solve", "verify", "sbf", "vbf", "bon"),
                        sc_batch_runner(PORT, pathlib.Path(d))))
    rows = {k: {r["id"]: r for r in v[1]} for k, v in runs.items()}
    assert rows["solve"][1]["pred_answer"] == "A" and rows["solve"][1]["web_search"]
    assert rows["solve"][3]["pred_answer"].startswith("Error:") and "error" in rows["solve"][3]
    assert rows["verify"][1]["confidence_score"] == 0.8
    assert "verification_searches" in rows["verify"][1]
    assert runs["verify"][2].startswith("verifier_results_")
    assert runs["solve"][2].startswith("policy_results_")
    nudged = rows["sbf"][4]["messages"]
    assert any("additional search" in m.get("content", "") for m in nudged
               if m["role"] == "user")
    assert rows["bon"][1]["best_of_n"]["n_samples"] == 2
    assert rows["bon"][1]["confidence_score"] == 0.8


# ------------------------------------------------------------ model clients


def _http_scenario(ns, monkeypatch):
    async def no_sleep(_s):
        return None

    monkeypatch.setattr(ns.client.asyncio, "sleep", no_sleep)
    client = ns.client.HTTPClient(base_url="http://fake/v1/", api_keys="k1, k2,", model="m",
                                  max_retries=6)
    payloads = []
    failures = iter([
        urllib.error.HTTPError("u", 429, "slow", {"Retry-After": "0"}, None),
        urllib.error.HTTPError("u", 400, "bad", {}, io.BytesIO(b"context length exceeded")),
        OSError("reset"),
    ])

    def fake_post(payload, key):
        payloads.append(json.loads(json.dumps(payload)))
        err = next(failures, None)
        if err is not None:
            raise err
        return {"choices": [{"message": {"content": "ok", "tool_calls": [
            _call("h1", "q")]}, "finish_reason": "tool_calls"}],
            "usage": {"prompt_tokens": 3, "completion_tokens": 2}}

    client._post = fake_post
    outs = [dataclasses.asdict(asyncio.run(client.chat(
        [{"role": "user", "content": "hi"}], tools=[ns.qa.DEEP_WEBSEARCH_TOOL],
        temperature=0.1, top_p=0.9, max_tokens=4096, min_tokens=8, top_k=20)))]
    outs.append(dataclasses.asdict(asyncio.run(client.complete(
        "q", stop=["<|end_search_query|>"], include_stop_str_in_output=True, top_k=20,
        min_p=0.05, repetition_penalty=1.05))))

    def always_400(payload, key):
        payloads.append(dict(payload))
        raise urllib.error.HTTPError("u", 400, "bad", {}, io.BytesIO(b"invalid"))

    client._post = always_400
    outs.append(dataclasses.asdict(asyncio.run(client.chat([{"role": "user", "content": "x"}]))))
    return outs, payloads, client.keys, client.base_url


def test_http_client_payloads_equal(monkeypatch):
    j = _http_scenario(JAX, monkeypatch)
    t = _http_scenario(PORT, monkeypatch)
    assert j == t
    payloads = t[1]
    # 429, then a context-length 400 (the next try halves max_tokens), a
    # reset, then the answer; complete() posts once
    assert [p["max_tokens"] for p in payloads[:4]] == [4096, 4096, 2048, 2048]
    assert payloads[4]["stop"] == ["<|end_search_query|>"]
    assert payloads[4]["include_stop_str_in_output"] is True


class _FakeEngine:
    """Records the requests an ``EngineClient`` submits; answers each with
    a planned text."""

    def __init__(self, ns, texts):
        self.ns, self.texts, self.requests = ns, list(texts), []
        from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer

        self.tokenizer = ByteTokenizer() if ns is PORT else importlib.import_module(
            "deepsearch_tts_tpu.engine.tokenizer").ByteTokenizer()

    def submit(self, req):
        self.requests.append(req)
        fut = concurrent.futures.Future()
        fut.set_result(types.SimpleNamespace(
            text=self.texts.pop(0), finish_reason="stop",
            prompt_tokens=len(req.prompt_ids), completion_tokens=7))
        return fut


def _engine_client_scenario(ns):
    tool_text = ("I will search.\n<tool_call>\n" + json.dumps(
        {"name": "deep_websearch", "arguments": {"search_query": "q", "search_intent": "i"}})
        + "\n</tool_call>")
    eng = _FakeEngine(ns, [tool_text, r"\boxed{x}", "explored"])
    client = ns.client.EngineClient(eng, default_opts={"max_tokens": 99})
    msgs = [{"role": "system", "content": "s"}, {"role": "user", "content": "Q"}]
    chat = asyncio.run(client.chat(msgs, tools=[ns.qa.DEEP_WEBSEARCH_TOOL], temperature=0.0,
                                   min_tokens=16, top_k_sampling=5))
    calls = [{k: v for k, v in c.items() if k != "id"} for c in chat.tool_calls]
    chat2 = asyncio.run(client.chat(msgs + [chat.message]))
    comp = asyncio.run(client.complete("prompt", stop=("<|end_search_query|>",),
                                       include_stop_str_in_output=True, top_k=3))
    fields = ("prompt_ids", "max_tokens", "temperature", "top_k", "top_p", "min_p",
              "repetition_penalty", "min_tokens", "stop", "include_stop_str")
    reqs = [{f: getattr(r, f) for f in fields} for r in eng.requests]
    for r in eng.requests:
        assert type(r) is ns.engine.GenerationRequest
    return (chat.type, chat.content, calls, chat.finish_reason, dataclasses.asdict(chat.usage),
            dataclasses.asdict(chat2), dataclasses.asdict(comp), reqs)


def test_engine_client_requests_equal():
    """The same prompt ids and sampler settings reach the engine (the port's
    ``GenerationRequest``), and generated tool calls parse alike."""
    j, t = _engine_client_scenario(JAX), _engine_client_scenario(PORT)
    assert j == t
    reqs = t[-1]
    assert reqs[0]["min_tokens"] == 16 and reqs[1]["min_tokens"] == 0
    assert reqs[2]["stop"] == ("<|end_search_query|>",) and reqs[2]["include_stop_str"]
    assert t[2][0]["function"]["name"] == "deep_websearch"


def test_make_tool_call_shape_equal():
    j = JAX.client.make_tool_call("deep_websearch", {"search_query": "q"})
    t = PORT.client.make_tool_call("deep_websearch", {"search_query": "q"})
    assert {k: v for k, v in j.items() if k != "id"} == {k: v for k, v in t.items() if k != "id"}
    assert t["id"].startswith("call_") and len(t["id"]) == len(j["id"])
