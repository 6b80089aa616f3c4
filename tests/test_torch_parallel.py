"""The port's parallel layer (``deepsearch_tts_tpu_torch/parallel/``) against
the JAX package's, in one process: mesh shapes, sharding rules, logical
axes, the quantized axes, and every rank's slice of every leaf against the
shard JAX places on the same mesh coordinates (``mesh8``). The multi-rank
paths run as gloo ranks in ``test_torch_parallel_ops.py`` and
``test_torch_parallel_engine.py``."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.models import deepseek_v3 as jds
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.models import qwen3_moe as jmoe
from deepsearch_tts_tpu.ops import quant as jquant
from deepsearch_tts_tpu.parallel import mesh as jmesh
from deepsearch_tts_tpu.parallel import sharding as jsharding
from deepsearch_tts_tpu_torch.models import deepseek_v3 as tds
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.models import qwen3_moe as tmoe
from deepsearch_tts_tpu_torch.parallel import collectives as tcoll
from deepsearch_tts_tpu_torch.parallel import distributed as tdist
from deepsearch_tts_tpu_torch.parallel import mesh as tmesh
from deepsearch_tts_tpu_torch.parallel import sharding as tsharding


@pytest.mark.parametrize("n,prefer", list(itertools.product(range(1, 17), (None, 1, 2, 3, 4, 8))))
def test_best_mesh_shape_matches_jax(n, prefer):
    assert tmesh.best_mesh_shape(n, prefer) == jmesh.best_mesh_shape(n, prefer)


def test_axes_and_rules_match_jax():
    assert tmesh.AXES == jmesh.AXES
    for name in ("SERVING_RULES", "TRAIN_RULES"):
        assert getattr(tsharding, name).rules == getattr(jsharding, name).rules
    axes = [("vocab", "embed"), ("layer", "embed", "heads"), ("batch", "seq"),
            ("layer", "expert", "embed", "expert_mlp"), (None, "mlp"), ("unknown",)]
    for rules in ("SERVING_RULES", "TRAIN_RULES"):
        for ax in axes:
            got = tsharding.logical_to_spec(ax, getattr(tsharding, rules))
            want = jsharding.logical_to_spec(ax, getattr(jsharding, rules))
            assert got == tuple(want), (rules, ax)


@pytest.mark.parametrize("fam", ["qwen3-test", "qwen3-8b", "qwen3-moe-test",
                                 "deepseek-v3-test"])
def test_logical_axes_match_jax(fam):
    for jm, tm, table in ((jqwen3, tqwen3, "QWEN3_CONFIGS"),
                          (jmoe, tmoe, "QWEN3_MOE_CONFIGS"),
                          (jds, tds, "DEEPSEEK_V3_CONFIGS")):
        if fam in getattr(tm, table):
            assert tm.logical_axes(getattr(tm, table)[fam]) == \
                jm.logical_axes(getattr(jm, table)[fam])


def test_quantized_logical_axes_match_jax():
    cfg = jmoe.QWEN3_MOE_CONFIGS["qwen3-moe-test"]
    params = jquant.quantize_params(jmoe.init_params(cfg, jax.random.PRNGKey(0)))
    want = jquant.quantized_logical_axes(params, jmoe.logical_axes(cfg))
    tparams = jax.tree.map(lambda a: np.zeros(1), params)   # the structure only
    got = tsharding.quantized_logical_axes(tparams, tmoe.logical_axes(tmoe.QWEN3_MOE_CONFIGS[
        "qwen3-moe-test"]))
    assert got == want


def _slices_match(params, axes, jmesh_, rules):
    """Every leaf's JAX shard on every device against the port's
    ``local_slice`` at that device's mesh coordinates."""
    placed = jsharding.shard_pytree(params, axes, jmesh_, rules)
    names = jmesh_.axis_names
    sizes = dict(zip(names, jmesh_.devices.shape))
    where = {d.id: idx for idx, d in np.ndenumerate(jmesh_.devices)}
    n = 0
    for (path, leaf), (_, ax) in zip(
            jax.tree_util.tree_flatten_with_path(placed)[0],
            jax.tree_util.tree_flatten_with_path(axes, is_leaf=lambda x: isinstance(x, tuple))[0]):
        full = np.asarray(leaf)
        spec = rules.spec(*ax)
        for shard in leaf.addressable_shards:
            coords = dict(zip(names, where[shard.device.id]))
            got = tsharding.local_slice(torch.from_numpy(full.copy()), tuple(spec), sizes, coords)
            assert np.array_equal(got.numpy(), np.asarray(shard.data)), (path, coords)
            n += 1
    return n


def test_local_slices_equal_jax_shards(mesh8):
    cfg = dataclasses.replace(jqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
    params = jqwen3.init_params(cfg, jax.random.PRNGKey(0))
    assert _slices_match(params, jqwen3.logical_axes(cfg), mesh8, jsharding.SERVING_RULES) > 0
    moe = dataclasses.replace(jmoe.QWEN3_MOE_CONFIGS["qwen3-moe-test"], dtype="float32")
    mparams = jmoe.init_params(moe, jax.random.PRNGKey(1))
    mesh = jmesh.make_mesh(dp=2, ep=2, tp=2)
    for rules in (jsharding.SERVING_RULES, jsharding.TRAIN_RULES):
        assert _slices_match(mparams, jmoe.logical_axes(moe), mesh, rules) > 0


def test_shard_pytree_pads_the_vocab_and_refuses_uneven_dims():
    coords = {"tp": 3}
    sizes = {"tp": 4}
    emb = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    # 10 rows padded to 12: the last rank holds row 9 and two zero rows
    got = tsharding.local_slice(emb, ("tp", None), sizes, coords, pad_dims=(0,))
    assert torch.equal(got[:1], emb[9:10]) and torch.equal(got[1:], torch.zeros(2, 3))
    with pytest.raises(ValueError, match="does not split"):
        tsharding.local_slice(emb, ("tp", None), sizes, coords)


def test_kv_heads_and_local_config():
    assert tsharding.kv_heads_local(8, 2) == (4, 1)
    assert tsharding.kv_heads_local(2, 4) == (1, 2)
    assert tsharding.kv_heads_local(1, 4) == (1, 4)
    with pytest.raises(ValueError, match="kv heads"):
        tsharding.kv_heads_local(6, 4)
    cfg = tsharding.local_config(tqwen3.QWEN3_CONFIGS["qwen3-8b"], 2)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.intermediate, cfg.vocab_size) == (16, 4, 6144, 151936)
    moe = tsharding.local_config(tmoe.QWEN3_MOE_CONFIGS["qwen3-30b-a3b"], 2)
    assert (moe.n_heads, moe.n_kv_heads, moe.moe_intermediate, moe.n_experts) == (16, 2, 384, 128)
    mla = tsharding.local_config(tds.DEEPSEEK_V3_CONFIGS["deepseek-v3"], 4)
    assert (mla.n_heads, mla.n_kv_heads, mla.dense_intermediate) == (32, 1, 4608)
    assert tsharding.local_config(cfg, 1) is cfg


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    got = tsharding.spec_placements(tsharding.TRAIN_RULES.spec("batch", "vocab"), tmesh.AXES)
    assert got == [Shard(0), Replicate(), Shard(0), Replicate(), Shard(1)]


def test_make_mesh_device_count_mismatch_and_single_process_init(monkeypatch):
    # JAX raises the same ValueError for a mesh larger than its devices
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_mesh(tp=2, device_type="cpu")
    with pytest.raises(ValueError):
        jmesh.make_mesh(tp=16)
    # no torchrun environment: initialize_multihost is a no-op, as JAX's
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    tdist.initialize_multihost(device_type="cpu")
    assert not torch.distributed.is_initialized()
    assert tdist.backend_for("cpu", 4) == "gloo"
    assert tdist.local_device("cpu") == torch.device("cpu")


def test_collectives_are_the_identity_on_one_rank():
    t = torch.arange(12.0).reshape(3, 4)
    for out in (tcoll.all_reduce(t, None), tcoll.all_gather(t, 0, None),
                tcoll.all_to_all(t, 0, 1, None), tcoll.ppermute(t, None)):
        assert out is t


class _FakeMesh:
    """A mesh's shape and one rank's coordinates, no process group."""
    mesh_dim_names = tmesh.AXES

    def __init__(self, coords, **sizes):
        self.mesh = torch.zeros(tuple(sizes.get(a, 1) for a in self.mesh_dim_names))
        self._coords = [coords.get(a, 0) for a in self.mesh_dim_names]

    def get_coordinate(self):
        return self._coords


def _leaf_items(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaf_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# (model, mesh, quantize): tp below and above the kv heads, experts over ep,
# MLA, int8 scales of column- and row-parallel products
LOCAL_DRAWS = [
    ("qwen3-test", dict(tp=2), None),
    ("qwen3-test", dict(tp=4), "int8"),
    ("qwen3-moe-test", dict(ep=2, tp=2), None),
    ("qwen3-moe-test", dict(ep=2, tp=2), "int8"),
    ("deepseek-v3-test", dict(ep=2, tp=2), None),
]


def _sliced_whole(whole, fam, sizes, coords, quantize):
    """The whole tree unpacked, quantized whole and sliced by
    ``shard_pytree`` (this rank's kv head where tp exceeds the kv heads)."""
    from deepsearch_tts_tpu_torch.engine.weights import unpack_matmul_params
    from deepsearch_tts_tpu_torch.ops.quant import QUANT_KEYS, quantize_params

    cfg, axes = fam.config, fam.logical_axes(fam.config)
    params = unpack_matmul_params(whole, cfg)
    if quantize:
        params = quantize_params(params, keys=QUANT_KEYS)
    tp = sizes.get("tp", 1)
    if "layers" in params and tp > cfg.n_kv_heads:
        kv, D = coords.get("tp", 0) // (tp // cfg.n_kv_heads), cfg.head_dim
        lp = dict(params["layers"])
        for name in ("wk", "wv"):
            w = lp[name]
            lp[name] = ({k: w[k][..., kv * D:(kv + 1) * D] for k in ("q", "scales")}
                        if isinstance(w, dict) else w[..., kv * D:(kv + 1) * D])
        params = dict(params, layers=lp)
        axes = dict(axes, layers=dict(axes["layers"], wk=("layer", "embed", None),
                                      wv=("layer", "embed", None)))
    axes = tsharding.quantized_logical_axes(params, axes)
    return tsharding.shard_pytree(params, axes, _FakeMesh(coords, **sizes),
                                  tsharding.SERVING_RULES)


@pytest.mark.parametrize("name,sizes,quantize", LOCAL_DRAWS)
def test_local_draw_equals_the_whole_draw_sliced(name, sizes, quantize):
    """Every rank's slices cut one matrix at a time (``LocalDraw``): drawn
    from a seed (what ``Engine(mesh=)`` builds) and placed from a whole
    tree (a loaded checkpoint) both equal the whole draw's, unpacked,
    quantized whole and sliced by ``shard_pytree``, bit for bit."""
    from types import SimpleNamespace

    from deepsearch_tts_tpu_torch.engine.engine import _shard_params
    from deepsearch_tts_tpu_torch.engine.weights import init_params
    from deepsearch_tts_tpu_torch.models.registry import get_model

    fam = get_model(name)
    axes = [a for a in tmesh.AXES if sizes.get(a, 1) > 1]
    whole = init_params(fam, device="cpu", seed=3)
    full = {a: sizes.get(a, 1) for a in tmesh.AXES}
    for pos in itertools.product(*(range(sizes[a]) for a in axes)):
        coords = dict(zip(axes, pos))
        want = dict(_leaf_items(_sliced_whole(whole, fam, sizes, coords, quantize)))
        for params in (None, whole):
            par = SimpleNamespace(sizes=full, tp=full["tp"], tp_rank=coords.get("tp", 0),
                                  coords={a: coords.get(a, 0) for a in tmesh.AXES})
            got, cfg = _shard_params(params, fam, par, quantize, device="cpu", seed=3)
            assert cfg == tsharding.local_config(fam.config, full["tp"])
            got = dict(_leaf_items(got))
            assert got.keys() == want.keys(), (coords, got.keys() ^ want.keys())
            for k in want:
                assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), \
                    (params is None, coords, k)


@pytest.mark.parametrize("name,sizes", [("qwen3-test", dict(fsdp=2, tp=2)),
                                        ("qwen3-moe-test", dict(fsdp=2, ep=2)),
                                        ("deepseek-v3-test", dict(fsdp=2, tp=2))])
def test_local_draw_under_train_rules(name, sizes):
    """``TRAIN_RULES`` (fsdp on the embed dims: norms and the embedding
    too): ``ShardedForward.init``'s draw equals ``shard_pytree`` of the
    whole draw unpacked, bit for bit."""
    from deepsearch_tts_tpu_torch.engine.weights import (
        init_params,
        random_params,
        unpack_matmul_params,
    )
    from deepsearch_tts_tpu_torch.models.registry import get_model

    fam = get_model(name)
    axes_tree = fam.logical_axes(fam.config)
    whole = unpack_matmul_params(init_params(fam, device="cpu", seed=1), fam.config)
    axes = [a for a in tmesh.AXES if sizes.get(a, 1) > 1]
    for pos in itertools.product(*(range(sizes[a]) for a in axes)):
        coords = dict(zip(axes, pos))
        mesh = _FakeMesh(coords, **sizes)
        draw = tsharding.LocalDraw(fam.config, axes_tree, tsharding.TRAIN_RULES,
                                   tmesh.mesh_shape(mesh),
                                   dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())))
        got = dict(_leaf_items(random_params(fam.config, device="cpu", seed=1, local=draw)))
        want = dict(_leaf_items(tsharding.shard_pytree(whole, axes_tree, mesh,
                                                       tsharding.TRAIN_RULES)))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (coords, k)
