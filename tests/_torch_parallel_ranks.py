"""Rank bodies of the parallel tests (``test_torch_parallel_*.py``).

Each function here runs in a process of its own, started by
``deepsearch_tts_tpu_torch.parallel.launch.run_ranks`` with gloo on the CPU,
and imports torch and the port only (no jax): the tests compute the JAX
package's results in their own process and pass them in as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEV = "cpu"


def to_torch(tree, dtype=None):
    """A numpy tree (float32 for floating leaves) → torch on the CPU, the
    floating leaves cast to ``dtype`` where given."""
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def greedy(eng, prompts, n):
    """Rank 0: greedy streams of ``prompts`` submitted together."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest

    futs = eng.submit_many([GenerationRequest(prompt_ids=list(p), max_tokens=n,
                                              temperature=0.0, repetition_penalty=1.0)
                            for p in prompts])
    return [(r.token_ids, r.finish_reason) for r in (f.result(timeout=120) for f in futs)]


def serve(rank, eng, prompts, n):
    """Every rank: rank 0 serves ``prompts`` and stops the engine, the others
    follow it; each returns the streams it saw (a follower its copies)."""
    if rank == 0:
        try:
            return greedy(eng, prompts, n)
        finally:
            eng.shutdown()
    eng.follow()
    return [(r.token_ids, r.finish_reason)
            for r in (f.result(timeout=60) for f in eng.mirrored)]


def register(name, family, dtype, **cfg_kw):
    """A test config of ``family`` ("qwen3", "qwen3_moe", "deepseek_v3")
    registered under ``name``."""
    from deepsearch_tts_tpu_torch.models import deepseek_v3, qwen3, qwen3_moe, registry

    mod, base = {"qwen3": (qwen3, qwen3.QWEN3_CONFIGS["qwen3-test"]),
                 "qwen3_moe": (qwen3_moe, qwen3_moe.QWEN3_MOE_CONFIGS["qwen3-moe-test"]),
                 "deepseek_v3": (deepseek_v3,
                                 deepseek_v3.DEEPSEEK_V3_CONFIGS["deepseek-v3-test"])}[family]
    cfg = dataclasses.replace(base, dtype=dtype, **cfg_kw)
    registry.register(name, cfg, mod.forward, logical_axes=mod.logical_axes)
    return cfg


def engine(name, params, mesh=None, **kw):
    from deepsearch_tts_tpu_torch.engine.engine import Engine
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer

    base = dict(max_slots=2, page_size=4, n_pages=128, max_seq_len=256, decode_chunk_len=4)
    return Engine(name, ByteTokenizer(), params=params, device=DEV, mesh=mesh, **{**base, **kw})


# ------------------------------------------------------------------- ops

def ops_rank(rank, cases):
    """ring / Ulysses attention and ``moe_ep_alltoall`` on this rank's shard
    over a 4-rank axis; the collectives' algebra."""
    torch.set_num_threads(1)
    from deepsearch_tts_tpu_torch.ops.attention import causal_attention
    from deepsearch_tts_tpu_torch.ops.moe import moe_ep_alltoall
    from deepsearch_tts_tpu_torch.parallel import collectives as C
    from deepsearch_tts_tpu_torch.parallel.mesh import make_mesh

    out = {}
    mesh = make_mesh(tp=4, device_type=DEV)
    n = 4
    for name in ("ring", "ulysses_split", "ulysses_rep"):
        q, k, v = (torch.from_numpy(cases[name][x]) for x in "qkv")
        Tc = q.shape[1] // n
        sl = slice(rank * Tc, (rank + 1) * Tc)
        impl = "ring" if name == "ring" else "ulysses"
        out[name] = causal_attention(q[:, sl], k[:, sl], v[:, sl], impl=impl, ring_mesh=mesh,
                                     ring_axis="tp").numpy()
    # the Ulysses split-kv case again with flash attention's plain version inside
    q, k, v = (torch.from_numpy(cases["ulysses_split"][x]) for x in "qkv")
    Tc = q.shape[1] // n
    sl = slice(rank * Tc, (rank + 1) * Tc)
    out["ulysses_pallas"] = causal_attention(q[:, sl], k[:, sl], v[:, sl], impl="ulysses",
                                             ring_mesh=mesh, inner_impl="pallas").numpy()
    ep_mesh = make_mesh(ep=4, device_type=DEV)
    group = ep_mesh.get_group("ep")
    for name, c in cases["moe"].items():
        x = torch.from_numpy(c["x"])
        Tl = x.shape[0] // n
        per = c["w_gate"].shape[0] // n
        w = {k: torch.from_numpy(c[k][rank * per:(rank + 1) * per])
             for k in ("w_gate", "w_up", "w_down")}
        y, keep = moe_ep_alltoall(x[rank * Tl:(rank + 1) * Tl], torch.from_numpy(c["router"]),
                                  w["w_gate"], w["w_up"], w["w_down"], c["top_k"], group,
                                  capacity_factor=c["cf"], return_keep=True)
        out["moe_" + name] = (y.numpy(), keep.numpy())
    # the collectives on this rank's values, against what they must give
    g = mesh.get_group("tp")
    t = torch.arange(24, dtype=torch.float32).reshape(2, 12) + 100 * rank
    out["all_reduce"] = C.all_reduce(t, g).numpy()
    out["all_gather"] = C.all_gather(t, 1, g).numpy()
    out["all_to_all"] = C.all_to_all(t, 1, 0, g).numpy()
    out["ppermute"] = C.ppermute(t, g).numpy()
    out["bf16_reduce"] = C.all_reduce((t % 8).to(torch.bfloat16), g).float().numpy()
    return out


# ----------------------------------------------------------- engines, tp=2

def engines2_rank(rank, case):
    """2 ranks: qwen3-test float32 over tp=2 (paged, slot, Ulysses fresh
    prefill past its gate), and its bf16 forward's logits."""
    torch.set_num_threads(1)
    from deepsearch_tts_tpu_torch.parallel.mesh import make_mesh

    register("par-f32", "qwen3", "float32")
    params = to_torch(case["params"])
    prompts, long_prompt = case["prompts"], case["long"]
    mesh = make_mesh(tp=2, device_type=DEV)
    out = {}
    if rank == 0:
        ref = engine("par-f32", params)
        out["unsharded"] = greedy(ref, prompts + [long_prompt], 8)
        ref.shutdown()
    eng = engine("par-f32", params, mesh)
    out["local_heads"] = (eng.fcfg.n_heads, eng.fcfg.n_kv_heads, eng.k_pages.shape[3])
    out["programs"] = tuple(eng.telemetry()[k] for k in ("decode_program", "prefill_program"))
    out["paged"] = serve(rank, eng, prompts, 8)
    eng = engine("par-f32", params, mesh, cache_mode="slot")
    out["slot"] = serve(rank, eng, prompts, 8)
    eng = engine("par-f32", params, mesh, enable_prefix_cache=False, ring_prefill_len=64,
                 sp_impl="ulysses")
    out["ulysses"] = serve(rank, eng, [long_prompt], 8)
    out["ulysses_routed"] = eng.sp_prefills
    out["logits_bf16"] = forward_logits(rank, mesh, case, "par-bf16")
    out["deep_search"] = deep_search_rank(rank, case["deep_search"])
    return out


def deep_search_rank(rank, c):
    """``cli/deep_search.py --engine_tp 2`` on this process group (as under
    torchrun): rank 0 runs the agents and writes the results, rank 1
    follows the policy engine. Returns the result files this rank wrote."""
    import glob
    import os

    from deepsearch_tts_tpu_torch.cli import deep_search

    out_dir = os.path.join(c["out"], f"rank{rank}")
    deep_search.main(c["argv"] + ["--output_dir", out_dir, "--engine_tp", "2"])
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(out_dir, "*.json")))


def forward_logits(rank, mesh, case, name):
    """The sharded no-cache forward of bf16 qwen3-test (its weights the
    case's, rounded to bf16) on the case's tokens: float32 logits."""
    from deepsearch_tts_tpu_torch.engine.engine import _mesh_parallel, _shard_params
    from deepsearch_tts_tpu_torch.models.registry import get_model

    register(name, "qwen3", "bfloat16")
    fam = get_model(name)
    par = _mesh_parallel(mesh, fam)
    params, cfg = _shard_params(to_torch(case["params"], torch.bfloat16), fam, par, None)
    toks = torch.from_numpy(case["tokens"])
    pos = torch.arange(toks.shape[1])[None].expand_as(toks)
    with torch.no_grad():
        return fam.forward(params, cfg, toks, pos, par=par)[0].float().numpy()


# ----------------------------------------------------------- engines, 4 ranks

def engines4_rank(rank, case):
    """4 ranks: qwen3-test float32 over tp=4 (each rank one q head, the kv
    heads replicated: 2 kv heads over 4 ranks) with ring prefill; MLA over
    tp=4 (the port's seed-0 weights; its unsharded reference on rank 3
    meanwhile); the bf16 forward over tp=4; and the multichip dry run."""
    torch.set_num_threads(1)
    from deepsearch_tts_tpu_torch.parallel.mesh import make_mesh

    out = {}
    register("par-f32", "qwen3", "float32")
    register("par-mla", "deepseek_v3", "float32")
    if rank == 3:
        solo = engine("par-mla", None, prefill_lane=0)
        out["mla_unsharded"] = greedy(solo, case["prompts"], 8)
        solo.shutdown()

    params = to_torch(case["params"])
    prompts, long_prompt = case["prompts"], case["long"]
    tp4 = make_mesh(tp=4, device_type=DEV)
    eng = engine("par-f32", params, tp4)
    out["tp4_kv"] = (eng.fcfg.n_heads, eng.fcfg.n_kv_heads, eng.par.kv_rep)
    out["tp4"] = serve(rank, eng, prompts, 8)
    eng = engine("par-f32", params, tp4, enable_prefix_cache=False, ring_prefill_len=64)
    out["ring_gate"] = (eng._ring_prefill(64, True), eng._ring_prefill(32, True),
                        eng._ring_prefill(64, False))
    out["ring"] = serve(rank, eng, [long_prompt], 8)
    out["ring_routed"] = eng.sp_prefills
    out["logits_bf16"] = forward_logits(rank, tp4, case, "par-bf16")

    # MLA over tp=4: q heads split, the single latent row on every rank
    eng = engine("par-mla", None, tp4, prefill_lane=0)
    out["mla"] = serve(rank, eng, prompts, 8)
    out["dryrun"] = dryrun_rank(rank)
    return out


def moe4_rank(rank, case):
    """4 ranks: the MoE engine over ep=2 x tp=2 (capacity, ragged, int8
    capacity) on the port's seed-0 weights (every engine draws the same);
    the unsharded references on ranks 1 and 2 meanwhile."""
    torch.set_num_threads(1)
    from deepsearch_tts_tpu_torch.parallel.mesh import make_mesh

    out = {}
    moe = (("capacity", None), ("ragged", None), ("capacity", "int8"))
    for impl, _ in moe:
        register(f"par-moe-{impl}", "qwen3_moe", "float32", moe_impl=impl, capacity_factor=8.0)
    if rank == 1:
        for impl, _ in moe[:2]:
            solo = engine(f"par-moe-{impl}", None)
            out[f"moe_{impl}_unsharded"] = greedy(solo, [case["moe_prompt"]], 6)
            solo.shutdown()
    elif rank == 2:
        solo = engine("par-moe-capacity", None, quantize="int8")
        out["moe_capacity_int8_unsharded"] = greedy(solo, [case["moe_prompt"]], 6)
        solo.shutdown()
    epm = make_mesh(ep=2, tp=2, device_type=DEV)
    for impl, quant in moe:
        kw = {} if quant is None else {"quantize": quant}
        key = f"moe_{impl}" + (f"_{quant}" if quant else "")
        eng = engine(f"par-moe-{impl}", None, epm, **kw)
        if quant:
            w = eng.params["layers"]["w_gate"]
            out[key + "_leaf"] = (str(w["q"].dtype), tuple(w["q"].shape), tuple(w["scales"].shape))
        out[key] = serve(rank, eng, [case["moe_prompt"]], 6)
    return out


def dryrun_rank(rank):
    """The port's counterpart of ``__graft_entry__.dryrun_multichip(4)``'s
    serving and sequence-parallel parts on its mesh (``_factor_mesh(4)``:
    tp=4): a tiny capacity-dispatch MoE served over the mesh for 6 tokens,
    and ring / Ulysses attention against the plain causal attention."""
    from deepsearch_tts_tpu_torch.ops.attention import causal_attention
    from deepsearch_tts_tpu_torch.parallel.mesh import make_mesh

    tp = 4
    mesh = make_mesh(tp=tp, device_type=DEV)
    register("dryrun-moe", "qwen3_moe", "bfloat16", vocab_size=max(256, 64 * tp), hidden=64,
             n_layers=2, n_heads=4 * tp, n_kv_heads=max(tp, 2), head_dim=16,
             n_experts=max(8, 2), top_k=2, moe_intermediate=32 * tp, moe_impl="capacity",
             tie_embeddings=True)
    eng = engine("dryrun-moe", None, mesh, max_seq_len=64, n_pages=64)
    res = serve(rank, eng, [list(range(30, 50))], 6)
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(1, 64, 8, 16, generator=gen)
    k = torch.randn(1, 64, 4, 16, generator=gen)
    v = torch.randn(1, 64, 4, 16, generator=gen)
    want = causal_attention(q, k, v)
    sl = slice(rank * 16, (rank + 1) * 16)
    errs = [float((causal_attention(q[:, sl], k[:, sl], v[:, sl], impl=impl, ring_mesh=mesh)
                   - want[:, sl]).abs().max()) for impl in ("ring", "ulysses")]
    return {"serve": res, "sp_err": errs}


# -------------------------------------------------------- training, 4 ranks

def _widen(on: bool, saved={}):
    """The port's layer products with float32 results (their bf16 rounding
    points widened), as ``test_torch_train.py``'s ``float32_products``
    widens them; ``on=False`` restores them."""
    from deepsearch_tts_tpu_torch.models import common, deepseek_v3, qwen3

    if not saved:
        saved.update(q_dot=qwen3.maybe_int8_dot, q_row=qwen3.row_dot_bf16,
                     c_dot=common.dot_bf16, c_row=common.row_dot_bf16)
    if not on:
        qwen3.maybe_int8_dot, qwen3.row_dot_bf16 = saved["q_dot"], saved["q_row"]
        common.dot_bf16, common.row_dot_bf16 = saved["c_dot"], saved["c_row"]
        deepseek_v3.dot_bf16, deepseek_v3.row_dot_bf16 = saved["c_dot"], saved["c_row"]
        return

    def dot(x, w, plain=False):
        return torch.matmul(x.float(), w.float())

    def row(x, w, par=None):
        part = torch.matmul(x.float(), w.float())
        return part if par is None or par.tp == 1 else par.reduce(part)

    qwen3.maybe_int8_dot, qwen3.row_dot_bf16 = dot, row
    common.dot_bf16, common.row_dot_bf16 = dot, row
    deepseek_v3.dot_bf16, deepseek_v3.row_dot_bf16 = dot, row


def train_rank(rank, case):
    """Sharded train steps (``train/trainer.py`` with a mesh) of each case's
    family and mesh on the case's weights, the products widened;
    ``train_loop`` over a mesh; the pipeline forward's logits, loss and
    gradients beside the plain forward's."""
    torch.set_num_threads(1)
    from deepsearch_tts_tpu_torch.models import qwen3
    from deepsearch_tts_tpu_torch.models.registry import get_model
    from deepsearch_tts_tpu_torch.parallel.mesh import make_mesh
    from deepsearch_tts_tpu_torch.parallel.pipeline import make_pp_forward
    from deepsearch_tts_tpu_torch.parallel.sharding import TRAIN_RULES
    from deepsearch_tts_tpu_torch.train import trainer as tt

    out = {}
    for key, c in case["steps"].items():
        name = f"train-{key}"
        register(name, c["family"], "float32", **c.get("cfg", {}))
        mesh = make_mesh(device_type=DEV, **c["mesh"])
        sf = tt.ShardedForward(get_model(name), mesh, TRAIN_RULES)
        params = sf.shard(to_torch(c["params"]))
        opt = tt.make_optimizer(c["lr"])
        state = tt.TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
        step = tt.make_train_step(sf, sf.cfg, opt, sync=sf)
        _widen(True)
        try:
            metrics = []
            for _ in range(c["steps"]):
                state, m = step(state, c["tokens"], c["mask"])
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        finally:
            _widen(False)
        out[key] = metrics

    # train_loop over dp=2 x tp=2: eval, per-rank checkpoints
    register("train-loop", "qwen3", "float32")
    mesh = make_mesh(dp=2, tp=2, device_type=DEV)
    tokens = case["steps"]["dense_dp_tp"]["tokens"]
    batches = [(tokens, np.ones(tokens.shape, np.float32))] * 3
    state, hist = tt.train_loop("train-loop", mesh, iter(batches), eval_batches=batches[:1],
                                total_steps=3, learning_rate=5e-3, eval_every=3,
                                checkpoint_dir=case["ckpt"], checkpoint_every=3, log_every=0,
                                device=DEV)
    out["loop"] = [(h["loss"], h.get("eval_loss")) for h in hist]

    # the pipeline over pp=4, two microbatches, against the plain forward
    cfg = register("pp-f32", "qwen3", "float32", n_layers=4)
    pp = case["pp"]
    params = to_torch(pp["params"])
    toks = torch.from_numpy(pp["tokens"])
    pos = torch.arange(toks.shape[1])[None].expand_as(toks)
    fwd = make_pp_forward(cfg, mesh=make_mesh(pp=4, device_type=DEV), n_microbatches=2)
    with torch.no_grad():
        logits = fwd(params, cfg, toks, pos)[0]
    # the gradients with the products widened: the microbatches' bf16
    # rounding of the weight products' sums would differ from the whole
    # batch's by an ulp
    mask = torch.ones(toks.shape)
    _widen(True)
    try:
        loss, grads = tt.loss_and_grads(fwd, cfg, params, toks, mask)
        ref_loss, ref_grads = tt.loss_and_grads(qwen3.forward, cfg, params, toks, mask)
    finally:
        _widen(False)
    per = cfg.n_layers // 4
    rows = slice(rank * per, (rank + 1) * per)
    out["pp"] = {"logits": logits.numpy(), "loss": float(loss), "ref_loss": float(ref_loss),
                 # this stage's layer rows, and every other leaf, against the plain grads
                 "stage": {k: (g[rows].numpy(), ref_grads["layers"][k][rows].numpy(),
                               float(g[:rank * per].abs().sum() + g[(rank + 1) * per:].abs().sum()))
                           for k, g in grads["layers"].items()},
                 "other": {k: (grads[k].numpy(), ref_grads[k].numpy())
                           for k in grads if k != "layers"},
                 "ref_norm": float(tt.global_norm(ref_grads))}
    return out
