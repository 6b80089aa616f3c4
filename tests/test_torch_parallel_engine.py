"""The port's sharded engine (``Engine(mesh=)``, gloo ranks, one process
each) against the JAX package's mesh engine on the ``mesh8`` CPU devices
and against the port's own unsharded engine, on the same weights:

* qwen3-test in float32 over tp=2 (paged, slot, Ulysses past the
  sequence-parallel gate) and tp=4 (one q head a rank, the two kv heads
  replicated; ring prefill past its gate, JAX's
  ``test_ring_prefill_matches_unsharded`` routing): greedy streams equal to
  JAX's mesh engine and to the port's unsharded engine;
* the bf16 forward's logits over tp=2 and tp=4 within the suite's bf16
  bounds of JAX's (max error < 0.2, rtol 5e-2);
* qwen3-moe-test over ep=2 x tp=2 (capacity and ragged dispatch, and
  int8 experts: JAX's ``test_moe_engine_expert_parallel`` and
  ``test_moe_engine_int8_experts_ep``) and MLA over tp=4, on the port's
  seed-0 weights, against the port's unsharded engines (which the other
  ``test_torch_*`` files hold to JAX's);
* the port's counterpart of ``__graft_entry__.dryrun_multichip(4)``'s
  serving and sequence-parallel parts;
* every rank's stream equal to rank 0's (each samples from the same
  all-gathered logits);
* ``cli/deep_search.py --engine_tp 2``: only rank 0 writes results.

Three spawns (2, 4 and 4 ranks) serve every test here."""
import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

import _torch_parallel_ranks as ranks
from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.parallel.mesh import make_mesh
from deepsearch_tts_tpu_torch.parallel.launch import run_ranks

NAME = "par-f32"
ENGINE_KW = dict(max_slots=2, page_size=4, n_pages=128, max_seq_len=256, decode_chunk_len=4)
# two prompts of one bucket (32) and one past the sequence-parallel gate
# (bucket 64 = ring_prefill_len): two prefill programs a JAX engine
PROMPTS = [list(range(40, 60)), [(5 * i + 11) % 256 for i in range(30)]]
LONG = [(7 * i + 3) % 512 for i in range(60)]
MOE_PROMPT = list(range(30, 50))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_streams(params, cfg, tp, prompts, n=8):
    jregistry.register(NAME, cfg, jqwen3.init_params, jqwen3.forward,
                       lambda: jqwen3.logical_axes(cfg))
    mesh = make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
    eng = jengine.Engine(NAME, ByteTokenizer(), params=params, mesh=mesh, **ENGINE_KW)
    futs = eng.submit_many([jengine.GenerationRequest(prompt_ids=list(p), max_tokens=n,
                                                      temperature=0.0, repetition_penalty=1.0)
                            for p in prompts])
    out = [(r.token_ids, r.finish_reason) for r in (f.result(timeout=300) for f in futs)]
    eng.shutdown()
    return out


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(mesh8, tmp_path_factory):
    cfg = dataclasses.replace(jqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    jp = jqwen3.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int64)
    bf = jax.tree.map(lambda a: a.astype(jax.numpy.bfloat16), jp)
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    logits = np.asarray(jqwen3.forward(bf, bcfg, tokens, np.broadcast_to(
        np.arange(24), tokens.shape))[0], np.float32)
    tmp = tmp_path_factory.mktemp("deep_search")
    (tmp / "in.json").write_text(json.dumps([{"Question": "What is the capital of France?",
                                              "answer": "Paris"}]))
    argv = ["--mode", "solve", "--backend", "engine", "--search_backend", "replay",
            "--input_path", str(tmp / "in.json"), "--model_name", "qwen3-test",
            "--aux_model_name", "qwen3-test", "--weights_path",
            os.path.join(REPO, "tests", "fixtures", "golden", "qwen3-test"),
            "--engine_max_slots", "2", "--engine_page_size", "16", "--engine_pages", "512",
            "--engine_max_seq_len", "4096", "--temperature", "0.0", "--max_tokens", "8",
            "--max_search_calls", "1", "--engine_prefill_lane", "0", "--device", "cpu",
            "--price_config_path", os.path.join(REPO, "model_config", "aihubmix_price.json")]
    case = {"params": _np(jp), "prompts": PROMPTS, "long": LONG, "tokens": tokens,
            "moe_prompt": MOE_PROMPT, "deep_search": {"argv": argv, "out": str(tmp)}}
    # the ranks run while JAX's mesh engines run here
    with ThreadPoolExecutor(1) as ex:
        spawned = ex.submit(lambda: [run_ranks(body, n, (case,), device_type="cpu",
                                               timeout_s=120)
                                     for body, n in ((ranks.engines2_rank, 2),
                                                     (ranks.engines4_rank, 4),
                                                     (ranks.moe4_rank, 4))])
        want = {"tp2": _jax_streams(jp, cfg, 2, PROMPTS + [LONG]),
                "tp4": _jax_streams(jp, cfg, 4, PROMPTS + [LONG]), "logits_bf16": logits}
        got2, got4, moe4 = spawned.result()
    return want, got2, got4, moe4


def _agree(got, key):
    """Every rank's streams equal rank 0's; returns them."""
    for r in got[1:]:
        assert r[key] == got[0][key], key
    return got[0][key]


def test_tp2_streams_match_jax_mesh_engine_and_unsharded(runs):
    want, got2, _, _ = runs
    assert got2[0]["local_heads"] == (2, 1, 1)
    # a mesh engine's decode and prefill programs run their bodies eagerly
    assert all(r["programs"] == ("eager", "eager") for r in got2)
    unsharded = got2[0]["unsharded"]
    assert unsharded == want["tp2"]
    for key in ("paged", "slot"):
        assert _agree(got2, key) == want["tp2"][:2], key
    assert all(len(t) == 8 for t, _ in want["tp2"])


def test_tp2_ulysses_prefill_routes_and_matches(runs):
    want, got2, _, _ = runs
    assert _agree(got2, "ulysses") == want["tp2"][2:]
    assert all(r["ulysses_routed"] == 1 for r in got2)


def test_tp4_streams_with_replicated_kv_match_jax_mesh_engine(runs):
    want, _, got4, _ = runs
    # 4 q heads over 4 ranks: one a rank; 2 kv heads: each held by 2 ranks
    assert got4[0]["tp4_kv"] == (1, 1, 2)
    assert _agree(got4, "tp4") == want["tp4"][:2]


def test_tp4_ring_prefill_routes_and_matches(runs):
    want, _, got4, _ = runs
    assert got4[0]["ring_gate"] == (True, False, False)
    assert _agree(got4, "ring") == want["tp4"][2:]
    assert all(r["ring_routed"] == 1 for r in got4)


@pytest.mark.parametrize("which", ["got2", "got4"])
def test_bf16_sharded_forward_logits_within_bounds(runs, which):
    want, got2, got4, _ = runs
    got = {"got2": got2, "got4": got4}[which]
    for r in got:
        err = np.abs(r["logits_bf16"] - want["logits_bf16"]).max()
        assert err < 0.2, err
        np.testing.assert_allclose(r["logits_bf16"], want["logits_bf16"], rtol=5e-2, atol=0.2)


@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_moe_engine_expert_parallel(runs, impl):
    """As JAX's ``test_moe_engine_expert_parallel`` (capacity factor 8: no
    drop) on an ep=2 x tp=2 mesh; in float32 the streams equal the
    unsharded engine's outright."""
    _, _, _, got4 = runs
    key = f"moe_{impl}"
    out = _agree(got4, key)
    ref = got4[1][key + "_unsharded"]
    assert out == ref
    assert len(out[0][0]) == 6 and out[0][1] in ("stop", "length")


def test_moe_engine_int8_experts_ep(runs):
    """JAX's ``test_moe_engine_int8_experts_ep``: int8 experts sharded over
    ep with their scales; the engine serves end to end, and its stream
    equals the single-device int8 engine's."""
    _, _, _, got4 = runs
    dtype, q_shape, s_shape = got4[0]["moe_capacity_int8_leaf"]
    # 8 experts over ep=2, 96 columns over tp=2: [L, 4, 64, 48] and its scales
    assert dtype == "torch.int8" and q_shape == (2, 4, 64, 48) and s_shape == (2, 4, 1, 48)
    out = _agree(got4, "moe_capacity_int8")
    assert len(out[0][0]) == 6 and out[0][1] in ("stop", "length")
    assert out == got4[2]["moe_capacity_int8_unsharded"]


def test_mla_engine_over_tp4(runs):
    _, _, got4, _ = runs
    assert _agree(got4, "mla") == got4[3]["mla_unsharded"]


def test_multichip_dryrun_counterpart(runs):
    _, _, got4, _ = runs
    for r in got4:
        res = r["dryrun"]
        assert res["serve"] == got4[0]["dryrun"]["serve"]
        assert len(res["serve"][0][0]) == 6
        assert max(res["sp_err"]) < 1e-5, res["sp_err"]


def test_deep_search_engine_tp2(runs):
    """``cli/deep_search.py --engine_tp 2`` on two gloo ranks: rank 0 runs
    the agents on the sharded policy engine and writes the results and
    statistics; rank 1 follows the engine and writes nothing."""
    _, got2, _, _ = runs
    files = got2[0]["deep_search"]
    assert any(f.startswith("policy_results_") for f in files), files
    assert got2[1]["deep_search"] == []
