"""The port's deployment planner (``parallel/plan.py``, its own copy)
against the JAX planner and the port's engine: the analytic param table,
the counts and the per-device param bytes equal JAX's exactly; the table
matches the port's (unpacked) param tree; the KV pool bytes equal what the
port's engine allocates (bf16 paged and slot pools, int8 KV with its
scales, MLA's 576-wide latent rows, local kv heads under tp)."""
import math

import pytest
import torch

from deepsearch_tts_tpu.parallel import plan as jplan
from deepsearch_tts_tpu_torch.engine.engine import Engine
from deepsearch_tts_tpu_torch.engine.kvcache import init_kv_pages
from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu_torch.engine.weights import random_params, unpack_matmul_params
from deepsearch_tts_tpu_torch.models.deepseek_v3 import DEEPSEEK_V3_CONFIGS
from deepsearch_tts_tpu_torch.models.qwen3 import QWEN3_CONFIGS
from deepsearch_tts_tpu_torch.models.qwen3_moe import QWEN3_MOE_CONFIGS
from deepsearch_tts_tpu_torch.parallel import plan as tplan
from deepsearch_tts_tpu_torch.parallel.sharding import kv_heads_local

MODELS = sorted([*QWEN3_CONFIGS, *QWEN3_MOE_CONFIGS, *DEEPSEEK_V3_CONFIGS])


def _leaves(table):
    return [(l.name, l.shape, l.axes, l.f32) for l in table]


@pytest.mark.parametrize("model", MODELS)
def test_param_table_and_counts_match_jax(model):
    assert _leaves(tplan.param_table(model)) == _leaves(jplan.param_table(model))
    assert tplan.count_params(model) == jplan.count_params(model)
    assert tplan.active_params(model) == jplan.active_params(model)


@pytest.mark.parametrize("mesh", [{}, {"tp": 2}, {"tp": 4}, {"ep": 2, "tp": 2}, {"tp": 8}])
@pytest.mark.parametrize("dtype", [None, "int8"])
def test_param_device_bytes_match_jax(mesh, dtype):
    for model in ("qwen3-8b", "qwen3-30b-a3b", "deepseek-v3", "qwen3-test"):
        cfg = tplan._resolve(model)[1]
        jcfg = jplan._resolve(model)[1]
        assert tplan.param_device_bytes(cfg, mesh, weight_dtype=dtype) == \
            jplan.param_device_bytes(jcfg, mesh, weight_dtype=dtype)


@pytest.mark.parametrize("model", ["qwen3-test", "qwen3-moe-test", "deepseek-v3-test"])
def test_param_table_matches_the_ports_tree(model):
    cfg = tplan._resolve(model)[1]
    tree = unpack_matmul_params(random_params(cfg, device="cpu"), cfg)

    def flat(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, tuple(v.shape)

    assert dict(flat(tree)) == {l.name: l.shape for l in tplan.param_table(cfg)}


def _storage_bytes(*tensors) -> int:
    return sum(t.untyped_storage().nbytes() for t in tensors if t is not None)


@pytest.mark.parametrize("model,kw", [
    ("qwen3-test", dict(cache_mode="paged")),
    ("qwen3-test", dict(cache_mode="slot")),
    ("qwen3-test", dict(cache_mode="paged", kv_quantize="int8")),
    ("qwen3-moe-test", dict(cache_mode="paged")),
    ("deepseek-v3-test", dict(cache_mode="paged", prefill_lane=0)),
    ("deepseek-v3-test", dict(cache_mode="slot", prefill_lane=0)),
])
def test_kv_pool_bytes_equal_the_engines_allocations(model, kw):
    slots, seq, ps = 3, 40, 8
    cfg = tplan._resolve(model)[1]
    n_pages = slots * -(-seq // ps) + 1
    eng = Engine(model, ByteTokenizer(), device="cpu", max_slots=slots, max_seq_len=seq,
                 page_size=ps, n_pages=n_pages, **kw)
    want = _storage_bytes(eng.k_pages, eng.v_pages, eng.k_scales, eng.v_scales)
    got, viol = tplan.kv_pool_device_bytes(cfg, {}, max_slots=slots, max_seq_len=seq,
                                           page_size=ps, cache_mode=kw["cache_mode"],
                                           kv_quantize=kw.get("kv_quantize"))
    assert got == want and not viol


@pytest.mark.parametrize("model,tp", [("qwen3-8b", 2), ("qwen3-8b", 16), ("qwen3-30b-a3b", 8),
                                      ("qwen3-test", 4)])
def test_kv_pool_bytes_at_local_kv_heads(model, tp):
    """Under tp the pools hold the local kv heads (one head a rank where tp
    exceeds them), as the sharded engine builds them."""
    cfg = tplan._resolve(model)[1]
    slots, seq, ps = 2, 128, 64
    n_pages = slots * -(-seq // ps) + 1
    k, v = init_kv_pages(cfg.n_layers, n_pages, ps, kv_heads_local(cfg.n_kv_heads, tp)[0],
                         cfg.head_dim, dtype=torch.bfloat16, device="meta")
    want = 2 * (math.prod(k.shape) + k.shape[3] * k.shape[4]) * 2
    got, viol = tplan.kv_pool_device_bytes(cfg, {"tp": tp}, max_slots=slots, max_seq_len=seq,
                                           page_size=ps, cache_mode="paged")
    assert got == want and not viol


def test_plan_and_recommend_on_h100():
    p = tplan.plan("qwen3-8b", {}, max_slots=16, max_seq_len=4096, cache_mode="slot")
    assert p.fits and p.hbm_gib == tplan.H100_HBM_GIB
    assert "FITS" in p.summary() and p.kv_capacity_tokens > 16 * 4096
    assert not tplan.plan("qwen3-235b-a22b", {}).fits
    best = tplan.recommend("qwen3-235b-a22b", 8, weight_dtype="int8")
    assert best and best[0].fits and best[0].mesh["tp"] * best[0].mesh["ep"] > 1


def test_cli_smoke(capsys):
    tplan.main(["qwen3-30b-a3b", "--devices", "1", "4"])
    out = capsys.readouterr().out
    assert "qwen3-30b-a3b" in out and "4 x H100" in out and "FITS" in out
