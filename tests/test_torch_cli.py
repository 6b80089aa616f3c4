"""The port's ``cli/deep_search.py`` against the JAX original.

``build_parser`` has JAX's flags with JAX's defaults (``--engine_prefill_lane
16`` included), plus ``--device`` and ``--seed``; ``--engine_tp > 1`` in
one process raises ``ValueError`` (its ranks come from torchrun), an MLA
model with the default lane JAX's
``ValueError``, and ``--device cuda`` without a card raises. ``--backend fake`` runs every mode through both CLIs on the
same inputs: the result rows and statistics (wall time left out) and the
``search`` mode's printed result must be equal. And the port's CLI runs
with ``jax`` and the JAX package blocked from import.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from deepsearch_tts_tpu.cli import deep_search as jds
from deepsearch_tts_tpu_torch.cli import deep_search as tds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRICES = os.path.join(REPO, "model_config", "aihubmix_price.json")
ADDED = {"device": "cuda", "seed": 0}
CHANGED = {}   # flags whose default differs from JAX's: none


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_flags_and_defaults_are_jaxs():
    j, t = _actions(jds.build_parser()), _actions(tds.build_parser())
    assert set(t) == set(j) | set(ADDED)
    for dest, a in j.items():
        b = t[dest]
        assert (a.option_strings, a.type, a.choices, a.nargs, a.const) == (
            b.option_strings, b.type, b.choices, b.nargs, b.const), dest
        if dest in CHANGED:
            assert (a.default, b.default) == CHANGED[dest]
        else:
            assert a.default == b.default, dest
    for dest, default in ADDED.items():
        assert t[dest].default == default
    # the reference flag surface of tests/test_cli.py parses alike
    argv = ["--mode", "solve", "--input_path", "x.json", "--concurrent_limit", "100",
            "--use_custom_api", "--custom_api_url", "http://x", "--use_aihubmix",
            "--aihubmix_api_keys", "a,b", "--use_bing_pro", "--bing_pro_token", "t",
            "--use_google_pro", "--google_pro_api_key", "g", "--query", "q",
            "--pred_answer", "a", "--context", "c", "--budget_forcing", "logit",
            "--min_thinking_tokens", "128", "--n_samples", "3"]
    ja, ta = vars(jds.build_parser().parse_args(argv)), vars(tds.build_parser().parse_args(argv))
    assert {k: v for k, v in ta.items() if k not in ADDED and k not in CHANGED} == \
        {k: v for k, v in ja.items() if k not in CHANGED}


@pytest.mark.parametrize("argv,err", [
    # one process: --engine_tp's ranks come from torchrun
    (["--engine_tp", "2"], ValueError),
    # MLA has no prefill-lane path, in JAX too: the default lane of 16 refuses it
    (["--model_name", "deepseek-v3-test", "--aux_model_name", "deepseek-v3-test"], ValueError),
    (["--device", "cuda"], RuntimeError),
    (["--device", "meta"], ValueError),
])
def test_engine_backend_refusals(argv, err):
    if argv[:2] == ["--device", "cuda"] and torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: --device cuda is valid here")
    args = tds.build_parser().parse_args(
        ["--backend", "engine", "--model_name", "qwen3-test", "--aux_model_name", "qwen3-test",
         "--engine_max_slots", "2", "--engine_pages", "16", "--engine_page_size", "8",
         "--engine_max_seq_len", "64", "--device", "cpu"] + argv)
    with pytest.raises(err):
        tds.make_clients(args)


def _inputs(tmp_path):
    data = [{"Question": "q1", "answer": "a1", "id": 1},
            {"problem": "q2", "answer": "a2", "id": 2},
            {"Question": "q3", "pred_answer": "p3", "id": 3,
             "messages": [{"role": "system", "content": "s"},
                          {"role": "user", "content": "q3"},
                          {"role": "assistant", "content": "got stuck"}]}]
    inp = tmp_path / "in.json"
    inp.write_text(json.dumps(data))
    return inp


def _rows(out_dir):
    (res,) = list(out_dir.glob("*_results_*.json"))
    (stats,) = list(out_dir.glob("statistics_*.json"))
    s = json.loads(stats.read_text())
    s.pop("wall_time_s")
    return res.name.split("_results_")[0], json.loads(res.read_text()), s


@pytest.mark.parametrize("mode", ["solve", "verify", "solve_budget_forcing",
                                  "verify_budget_forcing", "solve_bestofn"])
def test_fake_backend_rows_equal(mode, tmp_path):
    inp = _inputs(tmp_path)
    outs = []
    for name, mod in (("j", jds), ("t", tds)):
        out = tmp_path / name
        mod.main(["--mode", mode, "--backend", "fake", "--search_backend", "replay",
                  "--input_path", str(inp), "--output_dir", str(out),
                  "--concurrent_limit", "2", "--n_samples", "2",
                  "--budget_forcing", "logit", "--price_config_path", PRICES])
        outs.append(_rows(out))
    assert outs[0] == outs[1]
    prefix, rows, stats = outs[1]
    assert prefix == ("verifier" if mode.startswith("verify") else "policy")
    assert len(rows) == 3 and all(r["pred_answer"] for r in rows)
    assert {"pred_answer", "messages", "web_search"} <= set(rows[0])
    assert {"api_counters", "token_usage", "cost"} <= set(stats)
    if mode.startswith("verify"):
        assert "confidence_score" in rows[0] and "verification_searches" in rows[0]
    if mode.endswith("budget_forcing"):
        assert any("additional search" in (m.get("content") or "")
                   for m in rows[2]["messages"] if m["role"] == "user")


def test_fake_backend_search_mode_equal(tmp_path, capsys):
    outs = []
    for name, mod in (("j", jds), ("t", tds)):
        mod.main(["--mode", "search", "--backend", "fake", "--search_backend", "replay",
                  "--query", "anything", "--context", "ctx",
                  "--output_dir", str(tmp_path / name), "--price_config_path", PRICES])
        out = capsys.readouterr().out
        outs.append(json.loads(out[out.index("{"):]))
    assert outs[0] == outs[1]
    assert set(outs[1]) >= {"extracted_info", "search_query", "search_intent"}
    with pytest.raises(SystemExit):
        tds.main(["--mode", "search", "--backend", "fake", "--search_backend", "replay",
                  "--output_dir", str(tmp_path / "x")])


JAX_FREE = r"""
import json, os, sys
sys.modules["jax"] = None      # any import of jax now raises ImportError
sys.modules["deepsearch_tts_tpu"] = None      # and of the JAX package
from deepsearch_tts_tpu_torch.cli import deep_search as ds
out = sys.argv[1]
inp = os.path.join(out, "in.json")
json.dump([{"Question": "q1"}], open(inp, "w"))
for mode in ("solve", "solve_bestofn"):
    ds.main(["--mode", mode, "--backend", "fake", "--search_backend", "replay",
             "--input_path", inp, "--output_dir", out, "--n_samples", "2"])
ds.main(["--mode", "search", "--backend", "fake", "--search_backend", "replay",
         "--query", "q", "--output_dir", out])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "ml_dtypes", "transformers", "deepsearch_tts_tpu")
    and sys.modules[m] is not None)
assert not loaded, loaded
print("OK")
"""


def test_cli_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", JAX_FREE, str(tmp_path)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("OK"), proc.stdout[-2000:]
