"""Parity of the torch port's sampler with the JAX package.

B5 (``sampling_prep``): the port's plain version against the JAX Pallas
kernel in interpret mode. ``sample``: greedy tokens must be identical on
tie-free logits; the random streams differ by design (Philox vs threefry),
so sampled rows are held to the JAX sampler's keep mask instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import sampling as jsampling
from deepsearch_tts_tpu.ops.sampling_prep import sampling_prep as jprep
from deepsearch_tts_tpu_torch.engine import sampling as tsampling
from deepsearch_tts_tpu_torch.ops import sampling_prep as tprep

torch.set_num_threads(1)

EOS = 7
# float32 end to end; only the order of the logsumexp sum differs
TOL = 1e-5


def _inputs(B, V, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "logits": (rng.standard_normal((B, V)) * 3).astype(np.float32),
        "seen": rng.random((B, V)) < 0.1,
        "pen": np.array([1.0, 1.05, 1.3, 2.0] * B, np.float32)[:B],
        "temp": np.array([0.7, 1.0, 0.3, 1.5] * B, np.float32)[:B],
        "sup": np.array([True, False] * B)[:B],
    }


@pytest.mark.parametrize("eos_id", [EOS, -1])
def test_sampling_prep_plain_matches_jax_kernel(eos_id):
    p = _inputs(4, 4096)
    js, jl = jprep(jnp.asarray(p["logits"]), jnp.asarray(p["seen"]),
                   jnp.asarray(p["pen"]), jnp.asarray(p["temp"]),
                   jnp.asarray(p["sup"]), eos_id, interpret=True)
    args = (torch.from_numpy(p["logits"]), torch.from_numpy(p["seen"]),
            torch.from_numpy(p["pen"]), torch.from_numpy(p["temp"]),
            torch.from_numpy(p["sup"]), eos_id)
    ts, tl = tprep.sampling_prep(*args)        # CPU tensors → plain version
    ps, pl_ = tprep.sampling_prep_plain(*args)
    assert torch.equal(ts, ps) and torch.equal(tl, pl_)
    assert ts.shape == (4, 4096) and tl.shape == (4, 1)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    if eos_id >= 0:
        assert (ts[:, eos_id][torch.from_numpy(p["sup"])] < -1e29).all()
    assert tprep.sampling_prep.launches == 0


def test_sampling_prep_never_falls_back_off_cpu():
    p = _inputs(2, 256)
    meta = [torch.from_numpy(p[k]).to("meta") for k in ("logits", "seen", "pen",
                                                        "temp", "sup")]
    with pytest.raises(ValueError):
        tprep.sampling_prep(*meta, EOS)


def _jax_keep_mask(scaled, lse, params, window):
    """The keep mask of deepsearch_tts_tpu/engine/sampling.py:sample
    (lines 112-139), evaluated with the JAX package's own ops."""
    vals, _ = jax.lax.approx_max_k(scaled, window, recall_target=1.0)
    col = jax.lax.broadcasted_iota(jnp.int32, vals.shape, 1)
    keep = (col < params.top_k[:, None]) | (params.top_k[:, None] <= 0)
    probs = jnp.exp(vals - lse)
    cum_prev = jnp.cumsum(probs, axis=-1) - probs
    keep &= (cum_prev < params.top_p[:, None]) | (params.top_p[:, None] >= 1.0)
    keep &= ((vals - vals[:, :1]) >= jnp.log(jnp.maximum(params.min_p, 1e-10))[:, None]) \
        | (params.min_p[:, None] <= 0.0)
    return np.asarray(keep)


def _params(B):
    temp = np.array([0.0, 0.8, 1.0, 0.6, 0.0, 1.2], np.float32)[:B]
    top_k = np.array([20, 5, 0, 0, 0, 50], np.int32)[:B]
    top_p = np.array([0.8, 1.0, 0.9, 1.0, 1.0, 0.5], np.float32)[:B]
    min_p = np.array([0.05, 0.0, 0.0, 0.2, 0.0, 0.1], np.float32)[:B]
    pen = np.array([1.05, 1.0, 1.3, 1.0, 1.0, 1.1], np.float32)[:B]
    jp = jsampling.SamplingParams(*(jnp.asarray(a) for a in (temp, top_k, top_p, min_p, pen)))
    tp = tsampling.SamplingParams(*(torch.from_numpy(a) for a in (temp, top_k, top_p, min_p, pen)))
    return jp, tp


@pytest.mark.parametrize("V", [512, 151936])
def test_sample_greedy_and_keep_mask_match_jax(V):
    """Greedy rows give JAX's tokens exactly; the top-k/top-p/min-p keep
    mask over the 128-wide window equals JAX's; every sampled token lies in
    that mask. V=151936 is the real Qwen3 vocab."""
    B = 6
    rng = np.random.default_rng(V)
    logits = (rng.standard_normal((B, V)) * 4).astype(np.float32)  # tie-free
    seen = rng.random((B, V)) < 0.05
    jp, tp = _params(B)
    jtok = np.asarray(jsampling.sample(jnp.asarray(logits), jp, jnp.asarray(seen),
                                       jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    ttok = tsampling.sample(torch.from_numpy(logits), tp, torch.from_numpy(seen), gen)
    greedy = np.asarray(tp.temperature) <= 0
    assert (ttok.numpy()[greedy] == jtok[greedy]).all()

    scaled, lse, vals, idx = tsampling.prep_window(torch.from_numpy(logits), tp,
                                                   torch.from_numpy(seen))
    keep = tsampling.keep_mask(vals, lse, tp).numpy()
    jkeep = _jax_keep_mask(jnp.asarray(scaled.numpy()), jnp.asarray(lse.numpy()),
                           jp, 128)
    np.testing.assert_array_equal(keep, jkeep)
    ids = idx.numpy()
    for b in range(B):
        unfiltered = tp.top_k[b] <= 0 and tp.top_p[b] >= 1 and tp.min_p[b] <= 0
        if not greedy[b] and not unfiltered:
            assert ttok[b].item() in set(ids[b][keep[b]].tolist())
            assert jtok[b] in set(ids[b][keep[b]].tolist())


def test_sample_min_tokens_suppresses_eos():
    V = 512
    logits = np.zeros((2, V), np.float32)
    logits[:, EOS] = 10.0
    logits[:, 3] = 5.0
    _, tp = _params(2)
    tp = tp._replace(temperature=torch.zeros(2), min_tokens=torch.tensor([4, 4]),
                     tokens_generated=torch.tensor([1, 4]), eos_id=EOS)
    tok = tsampling.sample(torch.from_numpy(logits), tp, torch.zeros((2, V), dtype=torch.bool))
    assert tok.tolist() == [3, EOS]


def test_update_seen_matches_jax():
    seen = np.zeros((3, 64), bool)
    seen[1, 5] = True
    toks = np.array([4, 5, 63], np.int32)
    want = np.asarray(jsampling.update_seen(jnp.asarray(seen), jnp.asarray(toks)))
    got = tsampling.update_seen(torch.from_numpy(seen.copy()), torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), want)
