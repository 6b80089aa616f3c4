"""The torch port's serving engine against the JAX engine, on the CPU.

Both engines run the same float32 config (registered in both registries) on
the same params, with fused decode layers on (as
``tests/test_fused_layer.py:121`` runs the JAX engine), and must emit the
same greedy token streams: three concurrent requests, a multi-turn prefix
hit and a ``min_tokens`` request. Also: the options the port does not
carry raise, JAX's exclusions of the prefill lane and ``chunk_trim`` raise
JAX's errors, the OpenAI server round trip, and a subprocess that serves from
the port with ``jax`` and ``deepsearch_tts_tpu`` unimportable.
"""
import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine.weights import params_from_jax
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.models import registry as tregistry

torch.set_num_threads(1)

NAME = "qwen3-torch-parity"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(max_slots=4, page_size=4, n_pages=128, max_seq_len=128,
                 decode_chunk_len=4, seed=0, layer_fusion=True)


def _greedy(ids, n, **kw):
    return dict(prompt_ids=list(ids), max_tokens=n, temperature=0.0, top_k=0,
                top_p=1.0, min_p=0.0, repetition_penalty=1.0, **kw)


def _engine_pair(**kw):
    """A JAX and a torch engine on the same float32 params."""
    jcfg = dataclasses.replace(jqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    tcfg = dataclasses.replace(tqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    jregistry.register(NAME, jcfg, jqwen3.init_params, jqwen3.forward,
                       lambda: jqwen3.logical_axes(jcfg))
    tregistry.register(NAME, tcfg, tqwen3.forward)
    jp = jqwen3.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    tok = ByteTokenizer()
    je = jengine.Engine(NAME, tok, params=jp, **ENGINE_KW, **kw)
    te = tengine.Engine(NAME, tok, params=tp, device="cpu", **ENGINE_KW, **kw)
    assert je.layer_fusion and te.layer_fusion
    return je, te


@pytest.fixture(scope="module")
def engines():
    je, te = _engine_pair()
    yield je, te
    je.shutdown()
    te.shutdown()


def _both(engines, reqs):
    out = []
    for mod, eng in zip((jengine, tengine), engines):
        futs = eng.submit_many([mod.GenerationRequest(**r) for r in reqs])
        out.append([f.result(timeout=300) for f in futs])
    return out


def test_concurrent_greedy_streams_match_jax(engines):
    rng = np.random.default_rng(0)
    reqs = [_greedy(rng.integers(0, 256, n), 16) for n in (9, 17, 30)]
    jres, tres = _both(engines, reqs)
    for j, t in zip(jres, tres):
        assert len(t.token_ids) >= 8       # a stream long enough to diverge
        assert t.token_ids == j.token_ids
        assert (t.finish_reason, t.prompt_tokens, t.completion_tokens) == (
            j.finish_reason, j.prompt_tokens, j.completion_tokens)


def test_multiturn_prefix_hit_matches_jax(engines):
    rng = np.random.default_rng(1)
    first = list(rng.integers(0, 256, 21))
    jres, tres = _both(engines, [_greedy(first, 8)])
    assert tres[0].token_ids == jres[0].token_ids
    follow = first + tres[0].token_ids + list(rng.integers(0, 256, 6))
    jres, tres = _both(engines, [_greedy(follow, 8)])
    assert tres[0].cached_prompt_tokens > 0
    assert tres[0].cached_prompt_tokens == jres[0].cached_prompt_tokens
    assert tres[0].token_ids == jres[0].token_ids
    assert engines[1].telemetry()["prefix_cache"]["hits"] >= 1


def test_min_tokens_matches_jax(engines):
    """EOS is made the greedy first token of this prompt, so an unforced
    request stops at once and a forced one must run past min_tokens."""
    je, te = engines
    prompt = list(range(40, 60))
    eos = te.generate(tengine.GenerationRequest(**_greedy(prompt, 1))).token_ids[0]
    tok = ByteTokenizer()
    tok.eos_id = eos
    saved = je.tokenizer
    je.tokenizer = te.tokenizer = tok
    je._decode_fn_cache.clear()   # the JAX programs bake eos_id in
    je._jit_cache.clear()
    try:
        jres, tres = _both(engines, [_greedy(prompt, 12), _greedy(prompt, 12, min_tokens=6)])
    finally:
        je.tokenizer = te.tokenizer = saved
        je._decode_fn_cache.clear()
        je._jit_cache.clear()
    free, forced = tres
    assert free.finish_reason == "stop" and free.completion_tokens == 1
    assert forced.completion_tokens >= 6 and eos not in forced.token_ids[:5]
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
    assert [r.completion_tokens for r in tres] == [r.completion_tokens for r in jres]


def test_fresh_prefill_engine_matches_jax():
    """Without a prefix cache every group takes the fresh causal prefill
    branch (``causal_attention`` over the chunk) in both engines."""
    je, te = _engine_pair(enable_prefix_cache=False)
    try:
        assert te.prefix_cache is None
        rng = np.random.default_rng(2)
        reqs = [_greedy(rng.integers(0, 256, n), 12) for n in (5, 23)]
        jres, tres = _both((je, te), reqs)
        for j, t in zip(jres, tres):
            assert len(t.token_ids) >= 8 and t.cached_prompt_tokens == 0
            assert t.token_ids == j.token_ids
    finally:
        je.shutdown()
        te.shutdown()


def test_preempted_sequence_resumes_token_identical():
    """Decode growth exhausts a 19-page pool: one sequence is preempted,
    requeued and resumed, and both streams equal an unpressured run (as
    ``tests/test_engine_robustness.py`` holds the JAX engine)."""
    prompts = [list(range(40, 60)), list(range(140, 160))]
    kw = dict(device="cpu", max_slots=2, page_size=4, max_seq_len=128,
              decode_chunk_len=4, seed=0)
    reqs = [tengine.GenerationRequest(**_greedy(p, 24)) for p in prompts]
    ref = tengine.Engine("qwen3-test", ByteTokenizer(), n_pages=128, **kw)
    try:
        want = [ref.generate(r).token_ids for r in reqs]
    finally:
        ref.shutdown()
    eng = tengine.Engine("qwen3-test", ByteTokenizer(), n_pages=20, **kw)
    try:
        got = [f.result(timeout=300) for f in eng.submit_many(reqs)]
        assert eng.stats["preemptions"] >= 1
        assert [r.token_ids for r in got] == want
        assert [r.completion_tokens for r in got] == [24, 24]
        # every page is free or held by the prefix cache (page 0 never handed out)
        assert all(not s.active and s.req is None for s in eng.slots)
        assert eng.allocator.num_free + len(eng.allocator._refs) == eng.n_pages - 1
    finally:
        eng.shutdown()


class _FakeMesh:
    """What the engine reads of a mesh before it builds anything: the axis
    names and sizes."""

    mesh_dim_names = ("dp", "pp", "fsdp", "ep", "tp")

    def __init__(self, **sizes):
        self.mesh = torch.zeros(tuple(sizes.get(a, 1) for a in self.mesh_dim_names))


@pytest.mark.parametrize("model,kw,err,match", [
    # JAX's exclusions of the prefill lane and chunk_trim (engine.py:210-213,
    # 239-243, 560-563)
    ("qwen3-test", {"cache_mode": "slot", "speculative": "ngram", "prefill_lane": 16},
     ValueError, "mutually exclusive"),
    ("qwen3-test", {"chunk_trim": True, "prefill_lane": 16}, ValueError, "chunk_trim"),
    ("qwen3-test", {"cache_mode": "slot", "chunk_trim": True, "speculative": "ngram"},
     ValueError, "chunk_trim"),
    ("deepseek-v3-test", {"prefill_lane": 16}, ValueError, "no prefill-lane path"),
    # what the sharded engine refuses: a mesh with dp > 1 (ROADMAP.md C), a
    # pipeline or fsdp axis, an unknown sequence-parallel strategy
    ("qwen3-test", {"cache_mode": "slot", "mesh": _FakeMesh(dp=2, tp=2)}, ValueError,
     "ROADMAP.md C"),
    ("qwen3-test", {"mesh": _FakeMesh(pp=2)}, ValueError, "tp and ep only"),
    ("qwen3-test", {"sp_impl": "zigzag"}, ValueError, "sp_impl"),
])
def test_unported_engine_options_raise(model, kw, err, match):
    with pytest.raises(err, match=match):
        tengine.Engine(model, ByteTokenizer(), device="cpu", **kw)
    # JAX refuses the same combinations with the same error type (its mesh
    # checks are GSPMD's, so those cases are the port's own)
    if err is ValueError and "mesh" not in kw and "sp_impl" not in kw:
        with pytest.raises(err, match=match):
            jengine.Engine(model, ByteTokenizer(), **kw)


def test_unported_models_lora_and_missing_card_raise(monkeypatch, tmp_path):
    # the MLA family is served, but not with int8 weights: the reference
    # cannot serve those either
    with pytest.raises(NotImplementedError, match="deepseek_v3.py:283"):
        tengine.Engine("deepseek-v3-test", ByteTokenizer(), device="cpu", quantize="int8")
    # LoRA hot-load (ROADMAP A12) restores the adapter and merges it: a
    # zero-B adapter gives new tensors with the old values
    from deepsearch_tts_tpu_torch.engine.weights import unpack_matmul_params
    from deepsearch_tts_tpu_torch.train.checkpoint import save_params
    from deepsearch_tts_tpu_torch.train.lora import init_lora

    eng = tengine.Engine("qwen3-test", ByteTokenizer(), device="cpu", max_slots=1)
    with pytest.raises(FileNotFoundError):
        eng.load_lora_adapter("/nonexistent")
    old = eng.params["layers"]
    eng.load_lora_adapter(save_params(str(tmp_path / "lora"),
                                      init_lora(unpack_matmul_params(eng.params, eng.cfg))))
    for k in ("wqkv", "wo", "w_gateup", "w_down"):
        assert eng.params["layers"][k] is not old[k]
        assert torch.equal(eng.params["layers"][k], old[k])
    # --device cuda without a card raises; it never falls back to the CPU
    from deepsearch_tts_tpu_torch.cli.serve import build_engine, build_parser
    from deepsearch_tts_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine(build_parser().parse_args(["--model", "qwen3-test"]))
    # --tp 2 in one process: the ranks come from torchrun
    with pytest.raises(ValueError, match="torchrun"):
        build_engine(build_parser().parse_args(["--model", "qwen3-test", "--tp", "2"]))


def test_openai_server_round_trip_on_cpu():
    from deepsearch_tts_tpu_torch.engine.server import OpenAIServer

    eng = tengine.Engine("qwen3-test", ByteTokenizer(), device="cpu", max_slots=2,
                         page_size=8, n_pages=64, max_seq_len=256,
                         decode_chunk_len=4)
    loop = asyncio.new_event_loop()
    server = OpenAIServer(eng, "127.0.0.1", 0)
    loop.run_until_complete(server.start())
    port = server._server.sockets[0].getsockname()[1]
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"

    def post(path, payload):
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()

    try:
        code, body = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello"}], "max_tokens": 5,
            "temperature": 0.0})
        out = json.loads(body)
        assert code == 200 and out["object"] == "chat.completion"
        assert out["usage"]["completion_tokens"] >= 1
        code, body = post("/v1/completions", {"prompt": "abc", "max_tokens": 3})
        assert code == 200 and json.loads(body)["usage"]["completion_tokens"] >= 1
        code, body = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "stream"}], "max_tokens": 4,
            "stream": True})
        assert code == 200 and body.rstrip().endswith("data: [DONE]")
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        assert health["engine"]["requests"] >= 3
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=30)
        loop.run_until_complete(server.stop())
        loop.close()
        eng.shutdown()


JAX_FREE = r"""
import sys
sys.modules["jax"] = None      # any import of jax now raises ImportError
sys.modules["deepsearch_tts_tpu"] = None      # and of the JAX package
from deepsearch_tts_tpu_torch.cli.serve import build_engine, build_parser
from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest
args = build_parser().parse_args(["--model", "qwen3-test", "--device", "cpu",
    "--max_slots", "2", "--page_size", "8", "--pages", "32",
    "--max_seq_len", "128", "--decode_chunk", "2"])
eng = build_engine(args)
res = eng.generate(GenerationRequest(prompt_ids=list(range(30, 50)), max_tokens=4))
eng.shutdown()
assert len(res.token_ids) == 4, res
assert type(eng.prefix_cache).__name__ == "NativePrefixCache"   # the port's C++ index
# the slot cache and the attention kernels' plain versions, too
from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu_torch.engine.engine import Engine
eng = Engine("qwen3-test", ByteTokenizer(), device="cpu", cache_mode="slot",
             attn_impl="pallas", enable_prefix_cache=False, max_slots=2,
             max_seq_len=128, decode_chunk_len=2)
slot = eng.generate(GenerationRequest(prompt_ids=list(range(30, 50)), max_tokens=4))
eng.shutdown()
assert len(slot.token_ids) == 4, slot
# the Qwen3-MoE family through the same construction (fused decode: B3, B7
# and the grouped expert FFN's plain versions)
args = build_parser().parse_args(["--model", "qwen3-moe-test", "--device", "cpu",
    "--max_slots", "2", "--page_size", "8", "--pages", "32",
    "--max_seq_len", "128", "--decode_chunk", "2"])
eng = build_engine(args)
assert eng.layer_fusion
moe = eng.generate(GenerationRequest(prompt_ids=list(range(30, 50)), max_tokens=4))
eng.shutdown()
assert len(moe.token_ids) == 4, moe
# int8 weights and int8 KV on the paged path (B10 and B12's plain versions)
eng = Engine("qwen3-test", ByteTokenizer(), device="cpu", quantize="int8",
             kv_quantize="int8", max_slots=2, page_size=8, n_pages=32,
             max_seq_len=128, decode_chunk_len=2)
assert eng.k_pages.dtype.is_floating_point is False and eng.layer_fusion
i8 = eng.generate(GenerationRequest(prompt_ids=list(range(30, 50)), max_tokens=4))
eng.shutdown()
assert len(i8.token_ids) == 4, i8
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "ml_dtypes", "transformers", "deepsearch_tts_tpu")
    and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", res.token_ids)
"""


def test_port_serves_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", JAX_FREE], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout
