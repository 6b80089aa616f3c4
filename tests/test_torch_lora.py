"""The port's LoRA layer (``train/lora.py``, ``Engine.load_lora_adapter``)
against the JAX package's, on the CPU.

JAX's adapters (``init_lora``'s tree, A and B drawn from a seed) cross
over leaf for leaf through ``params_from_jax`` — ``None`` leaves and the
``alpha`` / ``rank`` numbers included — and merge to JAX's numbers: bf16
within one ulp, float32 within 1e-6, on the dense, MoE (expert stacks,
lead dims (L, NE)) and MLA trees (whose ``w_kb`` / ``w_vb`` / ``w_qb`` are
unpadded in both packages). ``unpack_matmul_params`` against JAX's, the
trainable mask's structure, the port's own deterministic ``init_lora``
draw, and the hot-load: greedy streams after the load equal JAX's engine
on the paged and the slot cache, a prompt that hits the prefix cache (or a
parked slot) included — neither engine flushes it, so both reuse the KV
computed with the old weights —, ``scale``, int8 weights refused as in
JAX, a sibling engine on the same tree unchanged, the memory-bounded
merge equal to unpack → apply → pack, and the HTTP route.
"""
import asyncio
import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.engine.weights import pack_matmul_params as jpack
from deepsearch_tts_tpu.engine.weights import unpack_matmul_params as junpack
from deepsearch_tts_tpu.models import deepseek_v3 as jdv
from deepsearch_tts_tpu.models import qwen3 as jq
from deepsearch_tts_tpu.models import qwen3_moe as jqm
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.train import checkpoint as jck
from deepsearch_tts_tpu.train import lora as jlora
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import weights as tweights
from deepsearch_tts_tpu_torch.engine.weights import params_from_jax
from deepsearch_tts_tpu_torch.models import qwen3 as tq
from deepsearch_tts_tpu_torch.models import registry as tregistry
from deepsearch_tts_tpu_torch.train import checkpoint as tck
from deepsearch_tts_tpu_torch.train import lora as tlora

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = {
    "qwen3-test-bf16": (jq, jq.QWEN3_CONFIGS["qwen3-test"], "bfloat16"),
    "qwen3-test-f32": (jq, jq.QWEN3_CONFIGS["qwen3-test"], "float32"),
    "qwen3-moe-test": (jqm, jqm.QWEN3_MOE_CONFIGS["qwen3-moe-test"], "bfloat16"),
    "deepseek-v3-test": (jdv, jdv.DEEPSEEK_V3_CONFIGS["deepseek-v3-test"], "bfloat16"),
}
NAME = "qwen3-torch-lora-parity"
ENGINE_KW = dict(max_slots=2, page_size=4, n_pages=64, max_seq_len=128, decode_chunk_len=4,
                 seed=0, layer_fusion=True)


def _np(tree):
    """A JAX tree → numpy leaves (Python numbers and None kept)."""
    return jax.tree.map(lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _jax_adapter(params, seed: int = 1, rank: int = 2, alpha: float = 4.0, std: float = 0.5):
    """JAX's ``init_lora`` tree with every A drawn as ``init_lora`` scales it
    (N(0, 1/in)) and every B drawn N(0, std), both from ``seed`` (numpy):
    ``init_lora`` keys its own A draws by ``hash(path)``, which Python
    salts per process, so the adapter would differ from run to run."""
    lora = jlora.init_lora(params, rank=rank, alpha=alpha)
    rng = np.random.default_rng(seed)

    def fill(ad):
        if isinstance(ad, dict) and "a" in ad:
            a = rng.standard_normal(ad["a"].shape).astype(np.float32) * ad["a"].shape[-2] ** -0.5
            b = rng.standard_normal(ad["b"].shape).astype(np.float32) * std
            return {**ad, "a": jnp.asarray(a.astype(ad["a"].dtype)),
                    "b": jnp.asarray(b.astype(ad["b"].dtype))}
        return ad

    return jax.tree.map(fill, lora, is_leaf=lambda v: v is None or (
        isinstance(v, dict) and "a" in v))


@functools.lru_cache(maxsize=None)
def _tree(key: str):
    mod, cfg, dtype = TREES[key]
    cfg = dataclasses.replace(cfg, dtype=dtype)
    jp = mod.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, _jax_adapter(jp)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.dtype == torch.bfloat16:
        return int((a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max())
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def _walk(a, b, fn, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a.keys(), b.keys())
        for k in a:
            _walk(a[k], b[k], fn, f"{path}.{k}")
    else:
        fn(path, a, b)


@pytest.mark.parametrize("key", list(TREES))
def test_apply_lora_matches_jax(key):
    cfg, jp, jl = _tree(key)
    want = params_from_jax(_np(jlora.apply_lora(jp, jl)))
    tl = params_from_jax(_np(jl))
    got = tlora.apply_lora(params_from_jax(_np(jp)), tl)

    def check(path, g, w):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if g.dtype == torch.bfloat16:
            assert _ulps(g, w) <= 1, path
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)

    _walk(got, want, check)
    # the adapters sit on the same leaves, with the same lead dims
    for name, leaf in (("wq", "layers"), ("w_gate", "layers"), ("w_kb", "moe_layers"),
                       ("w_gate", "moe_layers")):
        ad = tl.get(leaf, {}).get(name) if isinstance(tl.get(leaf), dict) else None
        w = got.get(leaf, {}).get(name) if isinstance(got.get(leaf), dict) else None
        if ad is not None:
            assert ad["a"].shape[:-2] == w.shape[:-2] == ad["b"].shape[:-2]
            assert ad["a"].shape[-2] == w.shape[-2] and ad["b"].shape[-1] == w.shape[-1]
            assert isinstance(ad["alpha"], float) and isinstance(ad["rank"], int)


@pytest.mark.parametrize("key", ["qwen3-test-bf16", "qwen3-moe-test", "deepseek-v3-test"])
def test_init_lora_structure_matches_jax(key):
    cfg, jp, _ = _tree(key)
    jl = jlora.init_lora(jp, rank=3, alpha=6.0)
    tl = tlora.init_lora(params_from_jax(_np(jp)), rank=3, alpha=6.0)

    def same(path, t, j):
        if j is None:
            assert t is None, path
        elif isinstance(t, torch.Tensor):
            assert tuple(t.shape) == tuple(j.shape) and str(t.dtype).endswith(str(j.dtype)), path
        else:
            assert t == j, path

    _walk(tl, _np(jl), same)
    # zero B: the merge is the identity, bit for bit
    params = params_from_jax(_np(jp))
    _walk(tlora.apply_lora(params, tl), params,
          lambda path, a, b: torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                                         else a, b.view(torch.int16) if b.dtype ==
                                         torch.bfloat16 else b) or pytest.fail(path))
    # A: normal · in^-1/2 (JAX's distribution; the draw is the port's own)
    a = tl["layers"]["wq"]["a"].float() if "layers" in tl else tl["dense_layers"]["w_qb"]["a"]
    assert abs(float(a.float().std()) * a.shape[-2] ** 0.5 - 1) < 0.1


def test_init_lora_draw_is_deterministic_across_processes():
    params = tweights.random_params(tq.QWEN3_CONFIGS["qwen3-test"], seed=0)
    a = tlora.init_lora(params, seed=3)["layers"]["wo"]["a"]
    assert torch.equal(a, tlora.init_lora(params, seed=3)["layers"]["wo"]["a"])
    assert not torch.equal(a, tlora.init_lora(params, seed=4)["layers"]["wo"]["a"])
    code = ("import torch; from deepsearch_tts_tpu_torch.engine import weights; "
            "from deepsearch_tts_tpu_torch.models import qwen3; "
            "from deepsearch_tts_tpu_torch.train import lora; "
            "p = weights.random_params(qwen3.QWEN3_CONFIGS['qwen3-test'], seed=0); "
            "a = lora.init_lora(p, seed=3)['layers']['wo']['a']; "
            "print(a.float().sum().item(), a.float().abs().sum().item())")
    # another process with a hash seed of its own draws the same A
    hashseed = "2" if os.environ.get("PYTHONHASHSEED") == "1" else "1"
    env = {**os.environ, "PYTHONHASHSEED": hashseed, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(a.float().sum().item()), str(a.float().abs().sum().item())]


def test_lora_trainable_mask_matches_jax():
    cfg, jp, jl = _tree("qwen3-moe-test")
    jf, jtr = jlora.lora_trainable_mask(jp, jl)
    tf, ttr = tlora.lora_trainable_mask(params_from_jax(_np(jp)), params_from_jax(_np(jl)))
    assert tf == jax.tree.map(bool, jf) and ttr == jtr
    assert ttr["layers"]["wq"] == {"a": True, "b": True, "alpha": False, "rank": False}
    assert ttr["embed"] is None and tf["layers"]["ln1"] is False


@pytest.mark.parametrize("key", ["qwen3-test-bf16", "qwen3-moe-test"])
def test_unpack_matmul_params_matches_jax(key):
    cfg, jp, _ = _tree(key)
    tcfg = tregistry.get_model(key.replace("-bf16", "")).config
    jun = junpack(jpack(jp), cfg)
    packed = tweights.pack_matmul_params(params_from_jax(_np(jp)))
    tun = tweights.unpack_matmul_params(packed, tcfg)
    _walk(tun, params_from_jax(_np(jun)), lambda p, a, b: torch.equal(a, b) or pytest.fail(p))
    # views of the packed leaves: no copy
    assert tun["layers"]["wk"].data_ptr() > packed["layers"]["wqkv"].data_ptr()
    assert tun["layers"]["wq"].data_ptr() == packed["layers"]["wqkv"].data_ptr()
    assert tweights.unpack_matmul_params({"embed": 1}, tcfg) == {"embed": 1}
    from deepsearch_tts_tpu_torch.ops.quant import quantize_params

    with pytest.raises(ValueError, match="cannot unpack int8-quantized packed weights"):
        tweights.unpack_matmul_params(quantize_params(packed), tcfg)


@pytest.mark.parametrize("key", ["qwen3-test-bf16", "qwen3-moe-test", "deepseek-v3-test"])
def test_merge_lora_equals_unpack_apply_pack(key):
    cfg, jp, jl = _tree(key)
    tcfg = tregistry.get_model(key.replace("-bf16", "")).config
    params = tweights.pack_matmul_params(params_from_jax(_np(jp)))
    lora = params_from_jax(_np(jl))
    before = {k: v.clone() for k, v in params.get("layers", params.get("moe_layers")).items()}
    got = tlora.merge_lora(params, lora, tcfg)
    want = tweights.pack_matmul_params(
        tlora.apply_lora(tweights.unpack_matmul_params(params, tcfg), lora))
    _walk(got, want, lambda p, a, b: torch.equal(a, b) or pytest.fail(p))
    stack = params.get("layers", params.get("moe_layers"))
    for k, v in stack.items():   # nothing of the old tree was written
        assert torch.equal(v, before[k]), k
    assert got["embed"] is params["embed"]   # leaves without an adapter are shared
    # scale: every adapter's alpha = scale · rank
    scaled = tlora.rescale_lora(lora, 0.5)
    assert all(ad["alpha"] == 0.5 * ad["rank"] for ad in scaled[next(
        k for k in ("layers", "moe_layers") if k in scaled)].values() if ad is not None)


def _register():
    jcfg = dataclasses.replace(jq.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    tcfg = dataclasses.replace(tq.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    jregistry.register(NAME, jcfg, jq.init_params, jq.forward, lambda: jq.logical_axes(jcfg))
    tregistry.register(NAME, tcfg, tq.forward)
    return jq.init_params(jcfg, jax.random.PRNGKey(0))


def _greedy(ids, n):
    return dict(prompt_ids=[int(i) for i in ids], max_tokens=n, temperature=0.0, top_k=0,
                top_p=1.0, min_p=0.0, repetition_penalty=1.0)


def _adapter_dirs(tmp_path, jp):
    """JAX's adapter saved with orbax for its engine, and converted and
    saved as safetensors for the port's."""
    jl = _jax_adapter(jp, std=0.3)
    jpath = jck.save_params(str(tmp_path / "jax_adapter"), jl)
    tpath = tck.save_params(str(tmp_path / "port_adapter"), params_from_jax(_np(jl)))
    return jl, jpath, tpath


@pytest.mark.parametrize("cache_mode", ["paged", "slot"])
def test_hot_load_streams_match_jax(tmp_path, cache_mode):
    jp = _register()
    jl, jpath, tpath = _adapter_dirs(tmp_path, jp)
    kw = dict(ENGINE_KW)
    if cache_mode == "slot":
        kw.update(cache_mode="slot", attn_impl="pallas")
    tok = ByteTokenizer()
    je = jengine.Engine(NAME, tok, params=jp, **kw)
    te = tengine.Engine(NAME, tok, params=params_from_jax(_np(jp)), device="cpu", **kw)
    first, fresh = list(range(20, 44)), list(range(100, 121))
    out = []
    try:
        for mod, eng, path in ((jengine, je, jpath), (tengine, te, tpath)):
            r0 = eng.generate(mod.GenerationRequest(**_greedy(first, 8)))
            eng.load_lora_adapter(path)
            # the first prompt again, extended: a prefix-cache hit (paged) or
            # a parked-row re-entry (slot) over KV of the old weights
            again = eng.generate(mod.GenerationRequest(**_greedy(first + r0.token_ids, 8)))
            new = eng.generate(mod.GenerationRequest(**_greedy(fresh, 8)))
            hits = (again.cached_prompt_tokens if cache_mode == "paged"
                    else eng.stats["slot_park_hits"])
            out.append((r0.token_ids, again.token_ids, new.token_ids, hits))
    finally:
        je.shutdown()
        te.shutdown()
    assert out[1] == out[0] and out[1][3] > 0, out
    # the merged weights equal JAX's merged and repacked tree
    jw = params_from_jax(_np(je.params))
    _walk(te.params, jw, lambda p, a, b: np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6))
    # a fresh engine on the merged weights, with no stale KV, answers the
    # extended prompt otherwise: the hit above reused the old weights' KV
    ref = tengine.Engine(NAME, tok, params=te.params, device="cpu", **kw)
    clean = ref.generate(tengine.GenerationRequest(**_greedy(first + out[1][0], 8)))
    ref.shutdown()
    assert clean.token_ids != out[1][1]


def test_hot_load_scale_matches_jax(tmp_path):
    jp = _register()
    jl, jpath, tpath = _adapter_dirs(tmp_path, jp)
    tok = ByteTokenizer()
    je = jengine.Engine(NAME, tok, params=jp, **ENGINE_KW)
    te = tengine.Engine(NAME, tok, params=params_from_jax(_np(jp)), device="cpu", **ENGINE_KW)
    je.load_lora_adapter(jpath, scale=0.25)
    te.load_lora_adapter(tpath, scale=0.25)
    _walk(te.params, params_from_jax(_np(je.params)), lambda p, a, b:
          np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6))
    # against the merge at alpha = 0.25 · rank, by hand
    base = params_from_jax(_np(jp))
    lora = tck.restore_params(tpath)
    lora["layers"]["wq"]["alpha"] = 0.25 * lora["layers"]["wq"]["rank"]
    want = tlora.apply_lora(base["layers"]["wq"], lora["layers"]["wq"])
    hd = tq.QWEN3_CONFIGS["qwen3-test"].n_heads * tq.QWEN3_CONFIGS["qwen3-test"].head_dim
    assert torch.equal(te.params["layers"]["wqkv"][..., :hd], want)
    je.shutdown()
    te.shutdown()


def test_hot_load_refuses_int8_weights_like_jax(tmp_path):
    jp = jq.init_params(jq.QWEN3_CONFIGS["qwen3-test"], jax.random.PRNGKey(0))
    jl, jpath, tpath = _adapter_dirs(tmp_path, jp)
    tok = ByteTokenizer()
    te = tengine.Engine("qwen3-test", tok, device="cpu", quantize="int8", max_slots=1)
    with pytest.raises(ValueError, match="cannot unpack int8-quantized packed weights"):
        te.load_lora_adapter(tpath)
    te.shutdown()
    je = jengine.Engine("qwen3-test", tok, params=jp, quantize="int8", max_slots=1)
    with pytest.raises(ValueError, match="cannot unpack int8-quantized packed weights"):
        je.load_lora_adapter(jpath)
    je.shutdown()


def test_hot_load_leaves_a_sibling_engine_unchanged(tmp_path):
    params = tweights.random_params(tq.QWEN3_CONFIGS["qwen3-test"], seed=0)
    tok = ByteTokenizer()
    kw = dict(ENGINE_KW, layer_fusion=None)
    a = tengine.Engine("qwen3-test", tok, params=params, device="cpu", **kw)
    b = tengine.Engine("qwen3-test", tok, params=params, device="cpu", **kw)
    assert a.params["layers"]["wqkv"] is b.params["layers"]["wqkv"]   # one copy, shared
    snap = {k: v.clone() for k, v in params["layers"].items()}
    req = _greedy(range(30, 50), 8)
    before = b.generate(tengine.GenerationRequest(**req)).token_ids
    lora = tlora.init_lora(tweights.unpack_matmul_params(params, a.cfg), rank=4, seed=1)
    for ad in lora["layers"].values():
        if ad is not None:
            ad["b"] = torch.randn(ad["b"].shape, generator=torch.Generator().manual_seed(2)
                                  ).to(ad["b"].dtype) * 0.2
    a.load_lora_adapter(tck.save_params(str(tmp_path / "lora"), lora))
    assert a.params["layers"]["wqkv"] is not b.params["layers"]["wqkv"]
    for k, v in b.params["layers"].items():
        assert v is params["layers"][k] and torch.equal(v, snap[k]), k
    assert b.generate(tengine.GenerationRequest(**req)).token_ids == before
    assert a.generate(tengine.GenerationRequest(**req)).token_ids != before
    a.shutdown()
    b.shutdown()


def test_hot_load_mla_engine(tmp_path):
    """A JAX adapter of the MLA tree (``w_qb`` / ``w_kb`` / ``w_vb`` on the
    unpadded widths both packages keep) hot-loaded into the port's
    ``deepseek-v3-test`` engine equals JAX's merge; the served forward is
    the no-cache forward on the merged tree."""
    cfg, jp, jl = _tree("deepseek-v3-test")
    te = tengine.Engine("deepseek-v3-test", ByteTokenizer(), params=params_from_jax(_np(jp)),
                        device="cpu", max_slots=1, page_size=4, n_pages=32, max_seq_len=64)
    te.load_lora_adapter(tck.save_params(str(tmp_path / "mla"), params_from_jax(_np(jl))))
    want = params_from_jax(_np(jlora.apply_lora(jp, jl)))
    _walk(te.params, want, lambda p, a, b: _ulps(a, b) <= 1 or pytest.fail(p))
    for key in ("w_qb", "w_kb", "w_vb"):
        assert te.params["moe_layers"][key].shape == tuple(jp["moe_layers"][key].shape)
    te.shutdown()


def test_hot_load_over_http(tmp_path):
    from deepsearch_tts_tpu_torch.engine.server import OpenAIServer

    params = tweights.random_params(tq.QWEN3_CONFIGS["qwen3-test"], seed=0)
    eng = tengine.Engine("qwen3-test", ByteTokenizer(), params=params, device="cpu",
                         max_slots=2, page_size=8, n_pages=64, max_seq_len=256,
                         decode_chunk_len=4)
    lora = tlora.init_lora(tweights.unpack_matmul_params(params, eng.cfg), rank=2, seed=0)
    lora["layers"]["wo"]["b"] = torch.full_like(lora["layers"]["wo"]["b"], 0.1)
    path = tck.save_params(str(tmp_path / "adapter"), lora)
    loop = asyncio.new_event_loop()
    server = OpenAIServer(eng, "127.0.0.1", 0)
    loop.run_until_complete(server.start())
    port = server._server.sockets[0].getsockname()[1]
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/load_lora_adapter",
            data=json.dumps({"lora_name": "a", "lora_path": path, "scale": 2.0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and json.loads(r.read()) == {"status": "ok", "lora_name": "a"}
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=30)
        loop.run_until_complete(server.stop())
        loop.close()
        eng.shutdown()
    lora["layers"]["wo"]["alpha"] = 2.0 * lora["layers"]["wo"]["rank"]
    want = tlora.apply_lora(params["layers"]["wo"], lora["layers"]["wo"])
    assert torch.equal(eng.params["layers"]["wo"], want)
    assert eng.params["embed"] is params["embed"]
    assert torch.equal(eng.params["layers"]["wqkv"], params["layers"]["wqkv"])   # B = 0
