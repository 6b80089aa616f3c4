"""The product path through the port's CLI on its engine, against JAX's.

``cli/deep_search.py --mode solve --backend engine --search_backend replay``
runs the whole tool loop: chat template → engine decode → ``<tool_call>``
parse → replay search → explorer on a co-served aux engine → tool-result
re-entry with prefix reuse → boxed answer → trace JSON.

1. The scripted scenario of ``tests/test_product_path_engine.py``: both
   engines serve position-scripted families (greedy decode at absolute
   position ``p`` emits ``script[p + 1]``), the scripts computed from a dry
   run of the agent stack with recording clients — in both packages, whose
   recorded prompts must be equal. JAX's CLI and the port's CLI
   (``--device cpu``) must then write equal trace rows, serve the same
   number of engine requests and count the same prefix-cache hits.
2. The in-repo golden checkpoint ``qwen3-test``: the first policy turn's
   prompt token ids are equal through both CLIs, and, where the logits are
   tie-free (checked here: the gap between the two best penalized logits
   exceeds the golden-logits bound of 0.2 at every step), so are that
   turn's first 16 greedy tokens.
"""
from __future__ import annotations

import importlib
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer, parse_tool_calls
from deepsearch_tts_tpu_torch.models import registry as tregistry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRICES = os.path.join(REPO, "model_config", "aihubmix_price.json")
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden", "qwen3-test")
PKGS = ("deepsearch_tts_tpu", "deepsearch_tts_tpu_torch")
TOK = ByteTokenizer()
SCRIPT_LEN = 6144
MAIN, AUX = "script-main-parity", "script-aux-parity"
GOLDEN_BOUND = 0.2   # golden logits' max error (tests/test_weights.py:411)


def _tool_call(query: str, intent: str) -> str:
    body = json.dumps({"name": "deep_websearch",
                       "arguments": {"search_query": query, "search_intent": intent}},
                      ensure_ascii=False)
    # the leading newline of ChatTemplate's re-render of a tool-call turn
    return "\n<tool_call>\n" + body + "\n</tool_call>"


QUESTION = "What is the capital of France? Answer with the city name."
MAIN_REPLIES = [_tool_call("capital of France", "find the capital city of France"),
                _tool_call("Paris population", "find the population of Paris"),
                "I found it. The capital of France is \\boxed{Paris}."]
AUX_REPLIES = ["**Final Information**\nParis is the capital of France.",
               "**Final Information**\nAbout 2.1 million people live in Paris proper."]
REPLAY = {
    "searches": {
        "capital of France": [
            {"id": 1, "title": "France - Factbook", "url": "https://example.org/france",
             "site_name": "example.org", "date": "2024-01-01",
             "snippet": "Paris is the capital and largest city of France."},
            {"id": 2, "title": "Geography of France", "url": "https://example.org/geo",
             "site_name": "example.org", "date": "2024-01-02",
             "snippet": "France's capital city is Paris, on the Seine."}],
        "Paris population": [
            {"id": 1, "title": "Paris demographics", "url": "https://example.org/paris-pop",
             "site_name": "example.org", "date": "2024-02-01",
             "snippet": "The city of Paris has about 2.1 million residents within its "
                        "administrative limits."}],
    },
    "pages": {
        "https://example.org/france":
            "France is a country in Western Europe. Paris is the capital and largest city "
            "of France. It is known for the Eiffel Tower and the Louvre.",
        "https://example.org/geo":
            "Geography of France. France's capital city is Paris, on the Seine. The "
            "country borders Belgium, Germany, and Spain.",
        "https://example.org/paris-pop":
            "Paris demographics. The city of Paris has about 2.1 million residents within "
            "its administrative limits. The wider metropolitan area holds over 12 million "
            "people.",
    },
}


def _ids_renamed(obj):
    """``obj`` (JSON-like) with the random tool-call ids (``parse_tool_calls``
    draws them from uuid4; the chat template does not render them) renamed
    in order of appearance."""
    names: dict[str, str] = {}
    text = json.dumps(obj)
    for cid in re.findall(r'"(?:id|tool_call_id)": "(call_[0-9a-f]+)"', text):
        names.setdefault(cid, f"call_{len(names)}")
    for cid, name in names.items():
        text = text.replace(cid, name)
    return json.loads(text)


def _mods(pkg):
    return {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "agents.client", "agents.policy", "agents.websearch", "cli.deep_search",
        "engine.engine")}


class RecordingClient:
    """Plays planned replies in order; records (prompt, reply) pairs."""

    def __init__(self, client_mod, chat_replies=(), complete_replies=()):
        self.mod = client_mod
        self.chat_replies, self.complete_replies = list(chat_replies), list(complete_replies)
        self.chat_calls, self.complete_calls = [], []

    async def chat(self, messages, tools=None, **opts):
        out = self.chat_replies.pop(0)
        self.chat_calls.append((json.loads(json.dumps(messages)), list(tools or []), out))
        content, calls = parse_tool_calls(out)
        return self.mod.ChatResponse(type="tool" if calls else "normal", content=content,
                                     tool_calls=calls, finish_reason="stop")

    async def complete(self, prompt, **opts):
        out = self.complete_replies.pop(0)
        self.complete_calls.append((prompt, out))
        return self.mod.CompletionResponse(out, "stop")


def _argv(tmp_path, pkg):
    argv = ["--mode", "solve", "--backend", "engine", "--search_backend", "replay",
            "--replay_path", str(tmp_path / "replay.json"),
            "--input_path", str(tmp_path / "problems.json"),
            "--output_dir", str(tmp_path / pkg), "--model_name", MAIN, "--aux_model_name", AUX,
            "--engine_max_slots", "4", "--engine_page_size", "16", "--engine_pages", "1025",
            "--engine_max_seq_len", "4096", "--engine_prefill_lane", "0",
            "--temperature", "0.0", "--max_tokens", "512", "--max_search_calls", "5",
            "--price_config_path", PRICES]
    return argv + (["--device", "cpu"] if pkg == PKGS[1] else [])


def _dry_run(pkg, args):
    """The real agent/search stack of ``pkg`` with recording clients: the
    exact prompts the engine run will see."""
    import asyncio

    m = _mods(pkg)
    backend, fetcher = m["cli.deep_search"].make_search(args)
    main = RecordingClient(m["agents.client"], chat_replies=MAIN_REPLIES)
    aux = RecordingClient(m["agents.client"], complete_replies=AUX_REPLIES)
    gen = {"temperature": args.temperature, "top_p": args.top_p, "min_p": args.min_p,
           "top_k_sampling": args.top_k_sampling,
           "repetition_penalty": args.repetition_penalty,
           "max_tokens": min(args.max_tokens, 16384)}
    tool = m["agents.websearch"].WebSearchTool(backend, fetcher, aux, top_k=args.top_k,
                                               gen_opts=gen)
    agent = m["agents.policy"].PolicyAgent(main, search_tool=tool,
                                           max_search_calls=args.max_search_calls,
                                           gen_opts=gen)
    res = asyncio.run(agent.solve(QUESTION))
    assert res.answer == "Paris", res
    assert not main.chat_replies and not aux.complete_replies
    return main, aux


def _script(segments) -> np.ndarray:
    """Reply ids (+ EOS) written at each prompt's encoded length; writes
    that overlap must agree."""
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
    script = params["script"]
    pos = positions
    if logits_indices is not None:
        pos = jnp.take_along_axis(positions, logits_indices[:, None], axis=1)
    nxt = script[jnp.clip(pos + 1, 0, script.shape[0] - 1)]
    return 30.0 * jax.nn.one_hot(nxt, cfg.vocab_size, dtype=jnp.float32), (k_pages, v_pages)


def torch_script_forward(params, cfg, tokens, positions, *, k_pages=None, v_pages=None,
                         logits_indices=None, **kw):
    """Greedy decode at absolute position ``p`` emits ``script[p + 1]``."""
    script = params["script"]
    pos = positions
    if logits_indices is not None:
        pos = torch.gather(positions, 1, logits_indices[:, None])
    nxt = script[torch.clamp(pos + 1, 0, script.shape[0] - 1)]
    logits = 30.0 * torch.nn.functional.one_hot(nxt, cfg.vocab_size).to(torch.float32)
    return logits, (k_pages, v_pages)


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("product")
    (tmp / "replay.json").write_text(json.dumps(REPLAY))
    (tmp / "problems.json").write_text(json.dumps([{"Question": QUESTION}]))
    recs = {}
    for pkg in PKGS:
        args = _mods(pkg)["cli.deep_search"].build_parser().parse_args(_argv(tmp, pkg))
        recs[pkg] = _dry_run(pkg, args)
    (jm, ja), (tm, ta) = recs[PKGS[0]], recs[PKGS[1]]
    assert _ids_renamed(jm.chat_calls) == _ids_renamed(tm.chat_calls)
    assert ja.complete_calls == ta.complete_calls
    main = _script((TOK.apply_chat_template(msgs, tools, add_generation_prompt=True), out)
                   for msgs, tools, out in tm.chat_calls)
    aux = _script(ta.complete_calls)
    for name, s in ((MAIN, main), (AUX, aux)):
        jregistry.register(name, _JaxScriptCfg(), lambda cfg, key, s=s: {"script": jnp.asarray(s)},
                           _jax_forward, lambda: {})
        tregistry.register(name, _TorchScriptCfg(), torch_script_forward,
                           init_params=lambda cfg, *, seed, device, s=s: {
                               "script": torch.from_numpy(s).long().to(device)})
    return tmp


def _run_cli(tmp, pkg):
    _mods(pkg)["cli.deep_search"].main(_argv(tmp, pkg))
    out = tmp / pkg
    rows = json.loads(sorted(out.glob("policy_results_*.json"))[-1].read_text())
    stats = json.loads(sorted(out.glob("statistics_*.json"))[-1].read_text())
    return rows, stats


def test_scripted_solve_on_engine_equal(scripted):
    (jrows, jstats), (trows, tstats) = (_run_cli(scripted, pkg) for pkg in PKGS)
    assert _ids_renamed(trows) == _ids_renamed(jrows)
    row = trows[0]
    assert row["pred_answer"] == "Paris"
    assert [w["search_query"] for w in row["web_search"]] == ["capital of France",
                                                              "Paris population"]
    assert "capital of France" in row["web_search"][0]["extracted_info"]
    assert [m["role"] for m in row["messages"]] == ["system", "user", "assistant", "tool",
                                                    "assistant", "tool", "assistant"]
    assert "\\boxed{Paris}" in row["messages"][-1]["content"]
    je, te = jstats["engine"], tstats["engine"]
    assert te["requests"] == je["requests"] == 3
    assert te["prefix_cache"]["hits"] == je["prefix_cache"]["hits"] >= 1
    assert te["prefix_cache"]["tokens_reused"] == je["prefix_cache"]["tokens_reused"] > 0
    for key in ("token_usage", "api_counters", "cost"):
        assert tstats[key] == jstats[key], key


def _golden_run(tmp, pkg, monkeypatch):
    """Solve on the golden checkpoint through ``pkg``'s CLI, the engine's
    requests and results recorded."""
    m = _mods(pkg)
    eng = m["engine.engine"].Engine
    seen = []
    submit = eng.submit

    def recording(self, req):
        fut = submit(self, req)
        seen.append((req, fut))
        return fut

    monkeypatch.setattr(eng, "submit", recording)
    argv = ["--mode", "solve", "--backend", "engine", "--search_backend", "replay",
            "--input_path", str(tmp / "in.json"), "--output_dir", str(tmp / pkg),
            "--model_name", "qwen3-test", "--aux_model_name", "qwen3-test",
            "--weights_path", GOLDEN, "--engine_max_slots", "2", "--engine_page_size", "16",
            "--engine_pages", "512", "--engine_max_seq_len", "4096", "--temperature", "0.0",
            "--max_tokens", "16", "--max_search_calls", "1", "--engine_prefill_lane", "0",
            "--price_config_path", PRICES]
    m["cli.deep_search"].main(argv + (["--device", "cpu"] if pkg == PKGS[1] else []))
    rows = json.loads(sorted((tmp / pkg).glob("policy_results_*.json"))[-1].read_text())
    req, fut = seen[0]
    return list(map(int, req.prompt_ids)), list(map(int, fut.result().token_ids)), rows


def test_golden_first_turn_equal(tmp_path, monkeypatch):
    """The port's CLI on ``qwen3-test``: the reference trace schema, the
    first turn's prompt ids equal to JAX's, and JAX's greedy tokens where
    the logits are tie-free."""
    from deepsearch_tts_tpu_torch.engine.weights import load_or_init_params
    from deepsearch_tts_tpu_torch.models import qwen3

    (tmp_path / "in.json").write_text(json.dumps([{"Question": "What is the capital of "
                                                               "France?", "answer": "Paris"}]))
    jp, jt, _ = _golden_run(tmp_path, PKGS[0], monkeypatch)
    tp, tt, rows = _golden_run(tmp_path, PKGS[1], monkeypatch)
    assert {"Question", "answer", "pred_answer", "messages", "web_search"} <= set(rows[0])
    assert rows[0]["messages"][0]["role"] == "system" and len(rows[0]["messages"]) >= 3
    assert tp == jp and len(tp) > 1000
    assert len(tt) == 16
    # tie-free: the penalized top-2 gap of the port's no-cache forward
    # along the port's stream exceeds the bound between the two stacks
    params, _ = load_or_init_params("qwen3-test", GOLDEN)
    cfg = qwen3.QWEN3_CONFIGS["qwen3-test"]
    ids = torch.tensor([tp + tt[:-1]])
    logits, _ = qwen3.forward(params, cfg, ids, torch.arange(ids.shape[1])[None])
    for i in range(16):
        row = logits[0, len(tp) - 1 + i].float().clone()
        seen = torch.tensor(sorted(set(tp + tt[:i])))
        row[seen] = torch.where(row[seen] > 0, row[seen] / 1.05, row[seen] * 1.05)
        top = torch.topk(row, 2)
        assert int(top.indices[0]) == tt[i], i
        assert float(top.values[0] - top.values[1]) > GOLDEN_BOUND, (i, top)
    assert tt == jt
