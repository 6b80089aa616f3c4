"""Ring and Ulysses attention (both GQA branches), ``moe_ep_alltoall`` and
the collectives of the port, each rank a gloo process, against the JAX
package's functions on the ``mesh8`` CPU devices (float32, rtol 1e-5; the
kept / dropped assignments exactly). One spawn of 4 ranks serves every
test here (``_torch_parallel_ranks.ops_rank``)."""
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel_ranks as ranks
from deepsearch_tts_tpu.ops.moe import moe_ep_alltoall, route_topk
from deepsearch_tts_tpu.ops.ring_attention import ring_attention
from deepsearch_tts_tpu.ops.ulysses import ulysses_attention
from deepsearch_tts_tpu.parallel.mesh import make_mesh
from deepsearch_tts_tpu_torch.parallel.launch import run_ranks

N = 4
RTOL, ATOL = 1e-5, 1e-6


def _qkv(rng, B, T, H, K, D):
    return {n: rng.standard_normal((B, T, h, D)).astype(np.float32)
            for n, h in (("q", H), ("k", K), ("v", K))}


def _moe_case(rng, T, E, NE, F, top_k, cf):
    mk = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)   # noqa: E731
    return {"x": mk(T, E), "router": mk(E, NE), "w_gate": mk(NE, E, F), "w_up": mk(NE, E, F),
            "w_down": mk(NE, F, E), "top_k": top_k, "cf": cf}


def _jax_keep(c, n):
    """The assignments JAX's ``moe_ep_alltoall`` keeps, each rank's tokens
    routed by JAX's ``route_topk`` and bucketed by its rule."""
    T_l = c["x"].shape[0] // n
    per = c["router"].shape[1] // n
    cap = max(1, -(-int(c["cf"] * T_l * c["top_k"]) // n))
    keep = []
    for r in range(n):
        x = jnp.asarray(c["x"][r * T_l:(r + 1) * T_l])
        logits = jnp.dot(x, jnp.asarray(c["router"]), preferred_element_type=jnp.float32)
        _, top_e = route_topk(logits, c["top_k"], True)
        dest = np.asarray(top_e).reshape(-1) // per
        seen = np.zeros(n, np.int64)
        k = np.zeros(dest.shape, bool)
        for i, d in enumerate(dest):
            k[i] = seen[d] < cap
            seen[d] += 1
        keep.append(k.reshape(T_l, c["top_k"]))
    return keep


def _jax_results(cases):
    """JAX's ring / Ulysses attention and ``moe_ep_alltoall`` on the
    cases, and the assignments its all-to-all keeps."""
    tp = make_mesh(tp=N, devices=jax.devices()[:N])
    ring = jax.jit(partial(ring_attention, mesh=tp, axis="tp"))
    uly = jax.jit(partial(ulysses_attention, mesh=tp, axis="tp"))
    want = {"ring": ring(*(jnp.asarray(cases["ring"][x]) for x in "qkv")),
            **{name: uly(*(jnp.asarray(cases[name][x]) for x in "qkv"))
               for name in ("ulysses_split", "ulysses_rep")}}
    want = {k: np.asarray(v) for k, v in want.items()}
    ep = make_mesh(ep=N, devices=jax.devices()[:N])
    for name, c in cases["moe"].items():
        moe = jax.jit(lambda *a, c=c: moe_ep_alltoall(*a, c["top_k"], ep,
                                                      capacity_factor=c["cf"]))
        want["moe_" + name] = np.asarray(moe(*(jnp.asarray(c[k]) for k in (
            "x", "router", "w_gate", "w_up", "w_down"))))
        want["keep_" + name] = _jax_keep(c, N)
    return want


@pytest.fixture(scope="module")
def results(mesh8):
    rng = np.random.default_rng(0)
    cases = {"ring": _qkv(rng, 2, 32, 4, 2, 16),
             "ulysses_split": _qkv(rng, 2, 32, 8, 4, 16),     # K % n == 0: kv all-to-all
             "ulysses_rep": _qkv(rng, 2, 32, 8, 2, 16),       # n % K == 0: kv gathered
             "moe": {"wide": _moe_case(rng, 32, 16, 8, 12, 2, 8.0),
                     "drops": _moe_case(rng, 32, 16, 8, 12, 2, 0.5)}}
    # the ranks run while JAX's functions run here, jitted as the JAX
    # package runs them (eager shard_map is ~20x slower)
    with ThreadPoolExecutor(1) as ex:
        spawned = ex.submit(run_ranks, ranks.ops_rank, N, (cases,), device_type="cpu",
                            timeout_s=120)
        want = _jax_results(cases)
        got = spawned.result()
    return cases, want, got


def _chunk(a, r):
    T = a.shape[1] // N
    return a[:, r * T:(r + 1) * T]


@pytest.mark.parametrize("name", ["ring", "ulysses_split", "ulysses_rep"])
def test_sequence_parallel_attention_matches_jax(results, name):
    _, want, got = results
    for r in range(N):
        np.testing.assert_allclose(got[r][name], _chunk(want[name], r), rtol=RTOL, atol=ATOL)


def test_ulysses_inner_flash_plain_matches_jax(results):
    """Ulysses with ``inner_impl="pallas"``: flash attention (its plain
    version on the CPU) at H/n local heads."""
    _, want, got = results
    for r in range(N):
        np.testing.assert_allclose(got[r]["ulysses_pallas"], _chunk(want["ulysses_split"], r),
                                   rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("name", ["wide", "drops"])
def test_moe_ep_alltoall_matches_jax(results, name):
    cases, want, got = results
    T_l = cases["moe"][name]["x"].shape[0] // N
    dropped = 0
    for r in range(N):
        y, keep = got[r]["moe_" + name]
        assert np.array_equal(keep, want["keep_" + name][r])
        dropped += int((~keep).sum())
        np.testing.assert_allclose(y, want["moe_" + name][r * T_l:(r + 1) * T_l],
                                   rtol=RTOL, atol=1e-5)
    assert (dropped > 0) == (name == "drops"), dropped


def test_collectives_algebra(results):
    _, _, got = results
    base = np.arange(24, dtype=np.float32).reshape(2, 12)
    vals = [base + 100 * r for r in range(N)]
    total = sum(vals)
    for r in range(N):
        np.testing.assert_array_equal(got[r]["all_reduce"], total)
        np.testing.assert_array_equal(got[r]["bf16_reduce"], sum(v % 8 for v in vals))
        np.testing.assert_array_equal(got[r]["all_gather"], np.concatenate(vals, 1))
        # split dim 1 four ways, block j to rank j, concatenated on dim 0
        np.testing.assert_array_equal(got[r]["all_to_all"],
                                      np.concatenate([v[:, 3 * r:3 * r + 3] for v in vals], 0))
        np.testing.assert_array_equal(got[r]["ppermute"], vals[(r - 1) % N])
