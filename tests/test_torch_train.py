"""The port's training layer (``deepsearch_tts_tpu_torch/train/``) against the
JAX package's ``train/``, on the CPU.

The same inputs, made from a seed with numpy, go through both: the SFT
data pipeline (arrays equal), the loss and the learning-rate schedule
(against optax at every step), the optimizer on equal gradients, and one
to three ``make_train_step`` steps from JAX's init (``params_from_jax``) on
``qwen3-test``, ``qwen3-moe-test`` (ragged and capacity dispatch) and
``deepseek-v3-test``.

The float32 configs of both packages round every layer product to bf16
(``preferred_element_type=bfloat16``); a float32 difference of one ulp
upstream (XLA's and torch's reductions and cos) flips an occasional bf16
rounding, so the steps are held twice: with those rounding points widened
to float32 in both packages (the training machinery itself: forward
composition, gradients, clipping, AdamW, schedule) at tight bounds, and
as the packages stand at the bounds their rounding permits. Also:
``train_loop`` with eval and checkpoints, the safetensors checkpoint
round trip (a LoRA tree's ``None`` and scalar leaves included), the
refusal of int8 params and of every hand-written kernel reached under
autograd, and the grouped expert pair's and ``dot_bf16``'s gradients
against JAX's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from deepsearch_tts_tpu.models import deepseek_v3 as jdv
from deepsearch_tts_tpu.models import qwen3 as jq
from deepsearch_tts_tpu.models import qwen3_moe as jqm
from deepsearch_tts_tpu.ops import moe as jmoe_ops
from deepsearch_tts_tpu.train import data as jdata
from deepsearch_tts_tpu.train import trainer as jt
from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu_torch.engine.weights import params_from_jax
from deepsearch_tts_tpu_torch.models import common as tcommon
from deepsearch_tts_tpu_torch.models import deepseek_v3 as tdv
from deepsearch_tts_tpu_torch.models import qwen3 as tq
from deepsearch_tts_tpu_torch.models import qwen3_moe as tqm
from deepsearch_tts_tpu_torch.ops import moe as tmoe_ops
from deepsearch_tts_tpu_torch.train import checkpoint as tck
from deepsearch_tts_tpu_torch.train import data as tdata
from deepsearch_tts_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

# (JAX module, port module, config name, config changes)
FAMILIES = {
    "qwen3-test": (jq, tq, jq.QWEN3_CONFIGS, tq.QWEN3_CONFIGS, {}),
    "qwen3-moe-test-ragged": (jqm, tqm, jqm.QWEN3_MOE_CONFIGS, tqm.QWEN3_MOE_CONFIGS, {}),
    "qwen3-moe-test-capacity": (jqm, tqm, jqm.QWEN3_MOE_CONFIGS, tqm.QWEN3_MOE_CONFIGS,
                                {"moe_impl": "capacity"}),
    "deepseek-v3-test": (jdv, tdv, jdv.DEEPSEEK_V3_CONFIGS, tdv.DEEPSEEK_V3_CONFIGS, {}),
}
LR, STEPS, WARMUP, TOTAL = 1e-3, 3, 1, 10


def _configs(key: str, dtype: str):
    jmod, tmod, jcfgs, tcfgs, rep = FAMILIES[key]
    name = key.replace("-ragged", "").replace("-capacity", "")
    return (jmod, tmod, dataclasses.replace(jcfgs[name], dtype=dtype, **rep),
            dataclasses.replace(tcfgs[name], dtype=dtype, **rep))


def _batch(vocab: int, B: int = 2, T: int = 17):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    return toks, mask


def _run_steps(key: str, dtype: str, steps: int = STEPS):
    """``steps`` train steps of both packages from JAX's init on one batch:
    (per-step JAX and port metrics, JAX's and the port's final leaves)."""
    jmod, tmod, jcfg, tcfg = _configs(key, dtype)
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    toks, mask = _batch(jcfg.vocab_size)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(jt.lr_schedule(LR, TOTAL, WARMUP), weight_decay=0.01))
    js = jt.TrainState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jt.make_train_step(jmod.forward, jcfg, opt)
    topt = tt.AdamW(tt.lr_schedule(LR, TOTAL, WARMUP), weight_decay=0.01, grad_clip=1.0)
    ts = tt.TrainState(tp, topt.init(tp), torch.zeros((), dtype=torch.int32))
    tstep = tt.make_train_step(tmod.forward, tcfg, topt)
    jm, tm = [], []
    for _ in range(steps):
        js, m = jstep(js, jnp.asarray(toks), jnp.asarray(mask))
        jm.append({k: float(v) for k, v in m.items()})
        ts, m = tstep(ts, toks, mask)
        tm.append({k: float(v) for k, v in m.items()})
    assert int(ts.step) == steps and int(ts.opt_state.count) == steps
    jl = [np.asarray(x, np.float32) for x in jax.tree.leaves(js.params)]
    tl = [x.float().numpy() for x in tt._leaves(ts.params)]
    assert [x.shape for x in jl] == [x.shape for x in tl]
    assert not any(x.requires_grad for x in tt._leaves(ts.params))
    return jm, tm, jl, tl


@pytest.fixture
def float32_products(monkeypatch):
    """Both packages' layer products with float32 results (their bf16
    rounding points widened): JAX's ``maybe_int8_dot`` as imported by the
    three families, the port's ``maybe_int8_dot`` / ``dot_bf16`` as its
    families call them."""
    def jdot(x, w):
        return jnp.dot(x, w, preferred_element_type=jnp.float32)

    def tdot(x, w, plain=False):
        return torch.matmul(x.float(), w.float())

    for mod in (jq, jqm, jdv):
        monkeypatch.setattr(mod, "maybe_int8_dot", jdot)
    monkeypatch.setattr(tq, "maybe_int8_dot", tdot)
    monkeypatch.setattr(tdv, "dot_bf16", tdot)
    monkeypatch.setattr(tcommon, "dot_bf16", tdot)


@pytest.mark.parametrize("key", list(FAMILIES))
def test_train_step_matches_jax_float32(key, float32_products):
    jm, tm, jl, tl = _run_steps(key, "float32")
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(jl, tl)])
    # Adam's update is near ±lr wherever |g| >> eps: a gradient near zero
    # whose sign differs moves a parameter up to 2·lr a step
    assert (d <= 1e-6).mean() >= 0.999, (d > 1e-6).mean()
    assert d.max() <= 2 * LR * STEPS, d.max()


@pytest.mark.parametrize("key", list(FAMILIES))
def test_train_step_matches_jax_with_bf16_round_points(key):
    jm, tm, jl, tl = _run_steps(key, "float32")
    # an occasional bf16 flip (1/256 of an element) upstream of the loss;
    # DeepSeek's group-limited routing turns a flip into another expert
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=5e-3)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=5e-3)
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(jl, tl)])
    assert d.max() <= 2 * LR * STEPS, d.max()


def test_train_step_bf16_matches_jax():
    jm, tm, _, _ = _run_steps("qwen3-test", "bfloat16")
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-2)
    assert tm[-1]["loss"] < tm[0]["loss"]


def test_sft_data_matches_jax(tmp_path):
    rows = [{"prompt": "Q: ab\nA:", "completion": " cd"}, {"text": "just text"},
            {"prompt": "Q: x\nA:", "completion": " y"}, {"text": "x"},
            {"prompt": "a long prompt " * 4, "completion": "and its completion " * 3},
            {"prompt": "P", "completion": ""}]
    path = tmp_path / "sft.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    for max_len, add_eos in ((32, True), (12, True), (64, False)):
        je = jdata.load_sft_examples(str(path), JByteTokenizer(), max_len, add_eos)
        te = tdata.load_sft_examples(str(path), ByteTokenizer(), max_len, add_eos)
        assert [(e.loss_start, e.tokens.tolist()) for e in te] == \
            [(e.loss_start, e.tokens.tolist()) for e in je]
        assert all(e.tokens.dtype == np.int32 for e in te)
        for kw in ({"batch_size": 2, "seed": 1}, {"batch_size": 3, "seq_len": 16, "epochs": 2},
                   {"batch_size": 4, "drop_remainder": False, "seed": 5}):
            jb, tb = list(jdata.batches(je, **kw)), list(tdata.batches(te, **kw))
            assert len(jb) == len(tb) > 0
            for (jt_, jm_), (tt_, tm_) in zip(jb, tb):
                np.testing.assert_array_equal(tt_, jt_)
                np.testing.assert_array_equal(tm_, jm_)
                assert tt_.dtype == jt_.dtype and tm_.dtype == jm_.dtype
    assert list(tdata.batches([], 2)) == []


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 33)) * 4).astype(np.float32)
    targets = rng.integers(0, 33, (3, 7)).astype(np.int32)
    for mask in ((rng.random((3, 7)) > 0.4).astype(np.float32), np.zeros((3, 7), np.float32)):
        want = float(jt.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                           jnp.asarray(mask)))
        got = tt.cross_entropy_loss(torch.tensor(logits), torch.tensor(targets),
                                    torch.tensor(mask))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # bf16 logits are widened first
    lb = torch.tensor(logits).to(torch.bfloat16)
    want = float(jt.cross_entropy_loss(jnp.asarray(lb.float().numpy()).astype(jnp.bfloat16),
                                       jnp.asarray(targets), jnp.asarray(mask)))
    np.testing.assert_allclose(float(tt.cross_entropy_loss(lb, torch.tensor(targets),
                                                           torch.tensor(mask))), want,
                               rtol=1e-6)


@pytest.mark.parametrize("peak,total,warmup", [(1e-3, 100, 10), (3e-4, 5, 0), (1e-5, 20, 5),
                                               (2e-4, 4, 9), (1e-3, 1, 0), (0.0, 10, 2)])
def test_lr_schedule_matches_optax(peak, total, warmup):
    js, ts = jt.lr_schedule(peak, total, warmup), tt.lr_schedule(peak, total, warmup)
    for i in range(total + 4):
        got = ts(i)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(js(i)), rtol=1e-6, atol=1e-12)
    if warmup:
        assert float(ts(0)) == 0.0   # step 1 takes lr 0 under warmup


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax_on_equal_gradients(schedule, dtype):
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 16, 8), "b": {"c": (40,), "d": (3, 5)}}

    def tree(scale):
        def mk(s):
            if isinstance(s, dict):
                return {k: mk(v) for k, v in s.items()}
            return (rng.standard_normal(s) * scale).astype(np.float32)
        return mk(shapes)

    p0 = tree(1.0)
    grads = [tree(s) for s in (0.5, 0.03, 0.2, 0.004)]   # clipped, then not
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    lr = jt.lr_schedule(1e-2, 6, 2) if schedule else 1e-2
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=0.01))
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p0)
    jst = opt.init(jp)
    topt = tt.AdamW(tt.lr_schedule(1e-2, 6, 2) if schedule else 1e-2, 0.01, 1.0)
    tp = tt._like(p0, lambda x: torch.tensor(x).to(tdt))
    tst = topt.init(tp)
    for g in grads:
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), g)
        u, jst = opt.update(jg, jst, jp)
        jp = optax.apply_updates(jp, u)
        tg = tt._like(g, lambda x: torch.tensor(x).to(tdt))
        np.testing.assert_allclose(float(tt.global_norm(tg)),
                                   float(optax.global_norm(jg)), rtol=1e-5 if dtype ==
                                   "float32" else 1e-2)
        tst = topt.step_(tg, tst, tp)
        for a, b in zip(jax.tree.leaves(jp), tt._leaves(tp)):
            a = np.asarray(a, np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7)
            else:   # bf16 arithmetic: the scalars round to bf16 in JAX
                assert b.dtype == torch.bfloat16
                np.testing.assert_allclose(b.float().numpy(), a, rtol=2e-2, atol=1e-2)
    assert all(m.dtype == tdt for m in tt._leaves(tst.mu) + tt._leaves(tst.nu))
    assert int(tst.count) == len(grads)


def test_train_loop_with_eval_and_checkpoints(tmp_path):
    ids = np.asarray(ByteTokenizer().encode("hello world"), np.int32)
    exs = [tdata.SFTExample(ids, 1)] * 4
    logs = []
    state, history = tt.train_loop(
        "qwen3-test", None, tdata.batches(exs, batch_size=4, seq_len=16, epochs=30),
        eval_batches=list(tdata.batches(exs, batch_size=4, seq_len=16)), total_steps=12,
        learning_rate=5e-3, warmup_steps=2, eval_every=6, checkpoint_dir=str(tmp_path / "ck"),
        checkpoint_every=6, log_every=4, log=logs.append, device="cpu")
    assert len(history) == 12 and [h["step"] for h in history] == list(range(1, 13))
    assert history[-1]["loss"] < history[0]["loss"] * 0.8
    assert "eval_loss" in history[5] and "eval_loss" in history[11]
    assert "eval_loss" not in history[4]
    assert history[11]["eval_loss"] <= history[5]["eval_loss"]
    assert [r["step"] for r in logs] == [4, 8, 12]
    assert tck.latest_step_dir(str(tmp_path / "ck")).endswith("step_12")
    back = tck.restore_params(tck.latest_step_dir(str(tmp_path / "ck")))
    for a, b in zip(tt._leaves(back), tt._leaves(state.params)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    assert not any(t.requires_grad for t in tt._leaves(state.params))
    # eval equals the next step's loss on the same params
    fam_fwd, cfg = tq.forward, tq.QWEN3_CONFIGS["qwen3-test"]
    toks, mask = next(tdata.batches(exs, batch_size=4, seq_len=16))
    ev = float(tt.make_eval_step(fam_fwd, cfg)(state.params, toks, mask))
    _, m = tt.make_train_step(fam_fwd, cfg, tt.make_optimizer(1e-3))(
        tt.TrainState(state.params, tt.make_optimizer(1e-3).init(state.params),
                      state.step), toks, mask)
    assert float(m["loss"]) == ev


def test_sharded_training_is_not_ported():
    """Sharded training is ported (``test_torch_parallel_train.py``); what
    it still refuses: a pp axis (the pipeline trains through
    ``parallel/pipeline.make_pp_forward``) and a tp that does not divide the
    kv heads, before any process group is touched."""
    class FakeMesh:
        mesh_dim_names = ("dp", "pp", "fsdp", "ep", "tp")

        def __init__(self, **sizes):
            self.mesh = torch.zeros(tuple(sizes.get(a, 1) for a in self.mesh_dim_names))

    with pytest.raises(ValueError, match="pipeline"):
        tt.init_train_state("qwen3-test", FakeMesh(pp=2), device="cpu")
    with pytest.raises(ValueError, match="kv heads"):
        tt.train_loop("qwen3-test", FakeMesh(tp=4), iter(()), device="cpu")


def _eq_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _eq_tree(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert b.dtype == a.dtype and b.shape == a.shape and torch.equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_checkpoint_round_trip(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32).reshape(2, 4),
            "nested": {"b": torch.ones(3, dtype=torch.bfloat16) / 3,
                       "i": torch.tensor([1, -2], dtype=torch.int8),
                       "z": torch.zeros((0, 4), dtype=torch.float16)},
            "s": torch.tensor(2.5)}
    path = tck.save_params(str(tmp_path / "ckpt"), tree, step=7)
    assert path.endswith("step_7")
    assert tck.latest_step_dir(str(tmp_path / "ckpt")).endswith("step_7")
    tck.save_params(str(tmp_path / "ckpt"), tree, step=12)
    assert tck.latest_step_dir(str(tmp_path / "ckpt")).endswith("step_12")
    assert tck.latest_step_dir(str(tmp_path / "none")) is None
    _eq_tree(tree, tck.restore_params(path))
    like = {"w": torch.zeros(2, 4, dtype=torch.bfloat16),
            "nested": {"b": torch.zeros(3), "i": torch.zeros(2, dtype=torch.int64),
                       "z": torch.zeros((0, 4))}, "s": torch.zeros(())}
    back = tck.restore_params(path, like=like)
    assert back["w"].dtype == torch.bfloat16 and back["nested"]["b"].dtype == torch.float32
    assert back["nested"]["i"].tolist() == [1, -2]
    # a LoRA tree: None leaves and Python numbers, types kept
    lora = {"embed": None, "layers": {"ln1": None, "wq": {
        "a": torch.randn(2, 8, 4).to(torch.bfloat16), "b": torch.zeros(2, 4, 6),
        "alpha": 32.0, "rank": 4}, "flag": True}}
    _eq_tree(lora, tck.restore_params(tck.save_params(str(tmp_path / "lora"), lora)))
    with pytest.raises(ValueError):
        tck.save_params(str(tmp_path / "bad"), {"a.b": torch.ones(1)})


def test_int8_params_refuse_training_like_jax():
    from deepsearch_tts_tpu.ops.quant import quantize_params as jquant
    from deepsearch_tts_tpu_torch.ops.quant import quantize_params

    cfg = tq.QWEN3_CONFIGS["qwen3-test"]
    jcfg = jq.QWEN3_CONFIGS["qwen3-test"]
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    toks, mask = _batch(cfg.vocab_size)
    tp = quantize_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    with pytest.raises(TypeError, match="int8"):
        tt.loss_and_grads(tq.forward, cfg, tp, toks, mask)
    jqp = jquant(jp)
    with pytest.raises(TypeError, match="int8"):
        jax.grad(lambda p: jq.forward(p, jcfg, jnp.asarray(toks), jnp.asarray(
            np.broadcast_to(np.arange(17), (2, 17))))[0].sum())(jqp)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype, device="meta", requires_grad=dtype.is_floating_point)


def _kernel_calls():
    """Each hand-written kernel entry on meta tensors (not the CPU: so the
    wrapper takes its kernel branch) of shapes its checks accept."""
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import quant, sampling_prep, slot_attention
    from deepsearch_tts_tpu_torch.ops.flash_attention import flash_attention
    from deepsearch_tts_tpu_torch.ops.paged_attention import pallas_paged_decode

    E, H, K, D, F, L, B = 128, 2, 1, 128, 128, 2, 4
    C = (H + 2 * K) * D
    idx = dict(dtype=torch.int64)
    cs = _meta(B, D // 2, dtype=torch.float32)
    return {
        "B3 fused_qkv_stacked": lambda: fl.fused_qkv_stacked(
            _meta(B, E), _meta(L, E), _meta(L, E, C), _meta(L, D), _meta(L, D), cs, cs, 0,
            n_heads=H, n_kv=K, head_dim=D),
        "B4 fused_out_mlp_stacked": lambda: fl.fused_out_mlp_stacked(
            _meta(B, H * D), _meta(B, E), _meta(L, H * D, E), _meta(L, E),
            _meta(L, E, 2 * F), _meta(L, F, E), 0),
        "B7 fused_out_router_stacked": lambda: fl.fused_out_router_stacked(
            _meta(B, H * D), _meta(B, E), _meta(L, H * D, E), _meta(L, E), _meta(L, E, 128), 0),
        "B8 fused_mlp_stacked": lambda: fl.fused_mlp_stacked(
            _meta(B, E), _meta(L, E), _meta(L, E, F), _meta(L, E, F), _meta(L, F, E), 0),
        "B11 fused_mlp": lambda: fl.fused_mlp(
            _meta(B, E), _meta(E), _meta(E, F), _meta(E, F), _meta(F, E)),
        "B10 fused_qkv_stacked_i8": lambda: fl.fused_qkv_stacked_i8(
            _meta(B, E), _meta(L, E), _meta(L, E, C, dtype=torch.int8),
            _meta(L, 1, C, dtype=torch.float32), _meta(L, D), _meta(L, D), cs, cs, 0,
            n_heads=H, n_kv=K, head_dim=D),
        "B10 int8_product": lambda: fl.int8_product(
            _meta(B, E), _meta(E, F, dtype=torch.int8), _meta(1, F, dtype=torch.float32)),
        "B12 quantize_int8": lambda: quant.quantize_int8(_meta(E, F)),
        "B5 sampling_prep": lambda: sampling_prep.sampling_prep(
            _meta(B, 512, dtype=torch.float32), torch.zeros(B, 512, dtype=torch.bool,
                                                            device="meta"),
            _meta(B, dtype=torch.float32), _meta(B, dtype=torch.float32),
            torch.zeros(B, dtype=torch.bool, device="meta")),
        "K1 slot_attention": lambda: slot_attention.slot_attention(
            _meta(B, H, D), _meta(B, 16, K, D), _meta(B, 16, K, D),
            torch.ones(B, device="meta", **idx), 0, n_rows=B, slot_ctx=16),
        "K1 pallas_paged_decode": lambda: pallas_paged_decode(
            _meta(B, 1, H, D), _meta(8, 4, K, D), _meta(8, 4, K, D),
            torch.zeros(B, 2, device="meta", **idx), torch.ones(B, device="meta", **idx)),
        "K2 flash_attention": lambda: flash_attention(
            _meta(1, 8, H, D), _meta(1, 8, K, D), _meta(1, 8, K, D)),
        "int8 grouped_gateup_i8": lambda: tmoe_ops.grouped_gateup_i8(
            _meta(8, E), {"q": _meta(2, E, 2 * F, dtype=torch.int8),
                          "scales": _meta(2, 1, 2 * F, dtype=torch.float32)}, None,
            torch.zeros(3, dtype=torch.int32, device="meta"), 8),
        "int8 grouped_down_i8": lambda: tmoe_ops.grouped_down_i8(
            _meta(8, F), {"q": _meta(2, F, E, dtype=torch.int8),
                          "scales": _meta(2, 1, E, dtype=torch.float32)},
            torch.zeros(3, dtype=torch.int32, device="meta"), 8),
    }


@pytest.mark.parametrize("name", list(_kernel_calls()))
def test_kernels_refuse_tensors_that_require_grad(name):
    call = _kernel_calls()[name]
    with pytest.raises(RuntimeError, match="no gradient"):
        call()
    # without autograd recording the wrapper goes on to its kernel checks
    with torch.no_grad():
        with pytest.raises(Exception) as err:
            call()
    assert "no gradient" not in str(err.value)


def test_grouped_expert_pair_gradients_match_jax():
    """``_expert_ffn_ragged`` through its ``autograd.Function`` pair (on the
    CPU: the plain forward, and as backward the plain VJP recomputed)
    against JAX's gradient of its ``lax.ragged_dot`` path, float32,
    packed and unpacked gate|up, one expert empty."""
    rng = np.random.default_rng(11)
    NE, E, Fi = 4, 16, 24
    sizes = np.array([5, 0, 9, 3])
    S = int(sizes.sum())
    x = rng.standard_normal((S, E)).astype(np.float32)
    wg, wu = (rng.standard_normal((NE, E, Fi)).astype(np.float32) * 0.3 for _ in range(2))
    wd = rng.standard_normal((NE, Fi, E)).astype(np.float32) * 0.3
    c = rng.standard_normal((S, E)).astype(np.float32)

    def jloss(x, wg, wu, wd):
        y = jmoe_ops._expert_ffn_ragged(x, wg, wu, wd, jnp.asarray(sizes, jnp.int32))
        return jnp.sum(y * c)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, wg, wu, wd)))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    for packed in (False, True):
        tx, twg, twu, twd = (torch.tensor(a, requires_grad=True) for a in (x, wg, wu, wd))
        gate = torch.cat([twg, twu], -1) if packed else twg
        y = tmoe_ops._expert_ffn_ragged(tx, gate, None if packed else twu, twd, offsets)
        assert y.grad_fn is not None and "Grouped" in type(y.grad_fn).__name__
        got = torch.autograd.grad((y * torch.tensor(c)).sum(), [tx, twg, twu, twd])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert float(got[1][1].abs().max()) == 0.0   # the empty expert


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_bf16_gradient_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    c = rng.standard_normal((2, 5, 48)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    from deepsearch_tts_tpu.ops.quant import maybe_int8_dot

    def jloss(x, w):
        return jnp.sum(maybe_int8_dot(x, w).astype(jnp.float32) * c)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    tx = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.tensor(w).to(getattr(torch, dtype)).requires_grad_()
    y = tcommon.dot_bf16(tx, tw)
    got = torch.autograd.grad((y.float() * torch.tensor(c)).sum(), [tx, tw])
    for g, wnt in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(wnt, np.float32))
