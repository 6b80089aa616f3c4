"""Sharded training and the pipeline of the port (``train/trainer.py`` with
a mesh, ``parallel/pipeline.py``), each rank a gloo process, against the
JAX package's mesh train step and pipeline on the ``mesh8`` CPU devices:

* three train steps on JAX's seed-0 init with both packages' layer
  products widened to float32, against JAX's mesh step under
  ``TRAIN_RULES`` (loss and grad norm at rtol 1e-4, the float32 bound of
  ``test_torch_train.py``): dense over dp=2 x tp=2 and over fsdp=2 x tp=2
  (leaves gathered, gradients reduce-scattered), MoE over ep=2 x tp=2 and
  over dp=2 x ep=2 (the capacity dispatch's places over the whole batch,
  from all-gathered counts, as on JAX's global array), MLA over
  ep=2 x tp=2;
* ``train_loop`` over a mesh (eval, per-rank checkpoints);
* the pipeline over pp=4 with two microbatches: logits and loss within the
  suite's forward bounds of JAX's ``make_pp_forward``, the loss equal to the
  port's plain forward's, each stage's layer gradients and every other
  leaf's equal to the plain forward's (products widened to float32).

One spawn of 4 ranks serves every test here."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import _torch_parallel_ranks as ranks
from deepsearch_tts_tpu.models import deepseek_v3 as jdv
from deepsearch_tts_tpu.models import qwen3 as jq
from deepsearch_tts_tpu.models import qwen3_moe as jqm
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.parallel.mesh import make_mesh
from deepsearch_tts_tpu.parallel.pipeline import make_pp_forward
from deepsearch_tts_tpu.parallel.sharding import TRAIN_RULES, logical_to_spec
from deepsearch_tts_tpu.train.trainer import cross_entropy_loss, init_train_state, make_train_step
from deepsearch_tts_tpu_torch.parallel.launch import run_ranks

LR, STEPS = 5e-3, 3
CASES = {  # key: (family, mesh, config fields)
    "dense_dp_tp": ("qwen3", dict(dp=2, tp=2), {}),
    "moe_ep_tp": ("qwen3_moe", dict(ep=2, tp=2), dict(moe_impl="capacity")),
    "dense_fsdp_tp": ("qwen3", dict(fsdp=2, tp=2), {}),
    "moe_dp_ep": ("qwen3_moe", dict(dp=2, ep=2), dict(moe_impl="capacity")),
    "mla_ep_tp": ("deepseek_v3", dict(ep=2, tp=2), {}),
}
FAMILIES = {  # family: (JAX module, its test config)
    "qwen3": (jq, jq.QWEN3_CONFIGS["qwen3-test"]),
    "qwen3_moe": (jqm, jqm.QWEN3_MOE_CONFIGS["qwen3-moe-test"]),
    "deepseek_v3": (jdv, jdv.DEEPSEEK_V3_CONFIGS["deepseek-v3-test"]),
}


def _jax_dot(x, w):
    return jnp.dot(x, w, preferred_element_type=jnp.float32)


def _jax_case(family, cfg_kw):
    """(module, config, JAX's init as numpy: what ``init_train_state`` draws
    from seed 0)."""
    mod, base = FAMILIES[family]
    cfg = dataclasses.replace(base, dtype="float32", **cfg_kw)
    return mod, cfg, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  mod.init_params(cfg, jax.random.PRNGKey(0)))


def _jax_steps(key, mod, cfg, mesh_kw, tokens, mask):
    name = f"train-{key}"
    jregistry.register(name, cfg, mod.init_params, mod.forward, lambda: mod.logical_axes(cfg))
    mesh = make_mesh(devices=jax.devices()[:4], **mesh_kw)
    with pytest.MonkeyPatch.context() as mp:
        for m in (jq, jqm, jdv):
            mp.setattr(m, "maybe_int8_dot", _jax_dot)
        with mesh:
            state, opt, fam = init_train_state(name, mesh, learning_rate=LR)
            step = make_train_step(fam.forward, fam.config, opt)
            bs = NamedSharding(mesh, logical_to_spec(("batch", "seq"), TRAIN_RULES))
            out = []
            for _ in range(STEPS):
                state, m = step(state, jax.device_put(jnp.asarray(tokens), bs),
                                jnp.asarray(mask))
                out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.fixture(scope="module")
def runs(mesh8, tmp_path_factory):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 16)).astype(np.int64)
    mask = np.ones((4, 16), np.float32)
    mask[:, :4] = 0.0                       # a prompt part the loss skips
    jax_cases, steps = {}, {}
    for key, (family, mesh_kw, cfg_kw) in CASES.items():
        mod, cfg_, params = _jax_case(family, cfg_kw)
        jax_cases[key] = (mod, cfg_, mesh_kw)
        steps[key] = {"family": family, "mesh": mesh_kw, "cfg": cfg_kw,
                      "params": params, "tokens": tokens, "mask": mask, "lr": LR,
                      "steps": STEPS}
    cfg = dataclasses.replace(jq.QWEN3_CONFIGS["qwen3-test"], dtype="float32", n_layers=4)
    jp = jq.init_params(cfg, jax.random.PRNGKey(0))
    pp_tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64)
    pos = np.broadcast_to(np.arange(16), pp_tokens.shape)
    pp_fwd = make_pp_forward(cfg, mesh=make_mesh(pp=4, devices=jax.devices()[:4]),
                             n_microbatches=2)
    run = jax.jit(lambda p, t, q: pp_fwd(p, cfg, t, q)[0])   # eager shard_map is slow
    pp_logits = np.asarray(run(jp, pp_tokens, pos), np.float32)
    ones = jnp.ones(pp_tokens.shape, jnp.float32)
    pp_loss = float(cross_entropy_loss(run(jp, pp_tokens[:, :-1], pos[:, :-1]),
                                       pp_tokens[:, 1:], ones[:, 1:]))
    case = {"steps": steps, "ckpt": str(tmp_path_factory.mktemp("ckpt")),
            "pp": {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                   "tokens": pp_tokens}}
    # the ranks run while JAX's mesh steps run here
    with ThreadPoolExecutor(1) as ex:
        spawned = ex.submit(run_ranks, ranks.train_rank, 4, (case,), device_type="cpu",
                            timeout_s=120)
        want = {key: _jax_steps(key, mod, cfg_, mesh_kw, tokens, mask)
                for key, (mod, cfg_, mesh_kw) in jax_cases.items()}
        got = spawned.result()
    return want, {"logits": pp_logits, "loss": pp_loss}, got, case


@pytest.mark.parametrize("key", list(CASES))
def test_sharded_train_steps_match_jax_mesh_step(runs, key):
    want, _, got, _ = runs
    for r in got:
        assert r[key] == got[0][key]           # the loss and norm are the global ones
    for (jl, jn), (tl, tn) in zip(want[key], got[0][key]):
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(tn, jn, rtol=1e-4)
    assert got[0][key][-1][0] < got[0][key][0][0]


def test_train_loop_over_a_mesh(runs):
    import os

    _, _, got, case = runs
    loop = got[0]["loop"]
    assert len(loop) == 3 and loop[-1][0] < loop[0][0] and loop[-1][1] is not None
    for r in range(4):   # each rank its own slices
        assert os.path.exists(os.path.join(case["ckpt"], f"rank{r}"))


def test_pipeline_matches_jax_and_the_plain_forward(runs):
    _, jpp, got, _ = runs
    for r, res in enumerate(got):
        pp = res["pp"]
        # the port's forward against JAX's at the suite's forward bound
        # (test_torch_model.py's TOL; JAX's pipeline equals its plain forward)
        np.testing.assert_allclose(pp["logits"], jpp["logits"], rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(pp["loss"], jpp["loss"], rtol=5e-3)
        assert abs(pp["loss"] - pp["ref_loss"]) <= 1e-6 * abs(pp["ref_loss"])
        for name, (g, ref, elsewhere) in pp["stage"].items():
            np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-6, err_msg=f"{r} {name}")
            assert elsewhere == 0.0, (r, name)   # other stages' rows are theirs
        for name, (g, ref) in pp["other"].items():
            np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-6, err_msg=f"{r} {name}")


def test_sharded_training_refusals():
    """A pp axis trains through the pipeline; tp must divide the kv heads."""
    from deepsearch_tts_tpu_torch.models.registry import get_model
    from deepsearch_tts_tpu_torch.train.trainer import ShardedForward

    class FakeMesh:
        mesh_dim_names = ("dp", "pp", "fsdp", "ep", "tp")

        def __init__(self, **sizes):
            self.mesh = torch.zeros(tuple(sizes.get(a, 1) for a in self.mesh_dim_names))

    fam = get_model("qwen3-test")
    with pytest.raises(ValueError, match="pipeline"):
        ShardedForward(fam, FakeMesh(pp=2), None)
    with pytest.raises(ValueError, match="kv heads"):
        ShardedForward(fam, FakeMesh(tp=4), None)
