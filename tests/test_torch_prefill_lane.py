"""The prefill lane and ``chunk_trim`` of the torch port against the JAX
package, on the CPU.

* ``forward`` with the lane arguments (a T=1 decode step carrying one whole
  prompt as Tp extra rows) against JAX's on the same inputs: paged and slot
  layouts, bf16 and int8 weights, int8 KV, the MoE family, a lane with
  padding and a full one. The B+1 logits rows, the written pools (padding
  writes nothing) and the next step's logits, which read the lane's KV.
* ``_plan_lane`` / ``_lane_arrays`` equal JAX's exactly on the same queued
  lane state, and admission routes each request as JAX's does.
* Engine scenarios, the counterparts of ``tests/test_prefill_lane.py``,
  driven by hand (``_admit`` / ``_decode_chunk``, no thread) so that the
  lane engages deterministically: lane streams equal the lane-less
  engine's and JAX's lane-less engine's, in both layouts and both Qwen3
  families; aborts; the ``lane_max_act`` override; MLA is refused.
* ``chunk_trim``, the counterpart of ``tests/test_engine.py:287-316``.

Tolerances are JAX's own: forwards rtol 5e-2; streams exactly, on float32
configs (tie-free logits).
"""
import concurrent.futures
import dataclasses
import threading
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.engine.weights import pack_matmul_params as jpack
from deepsearch_tts_tpu.models import qwen3 as jqwen3
from deepsearch_tts_tpu.models import qwen3_moe as jmoe
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.ops import quant as jquant
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.engine.weights import params_from_jax
from deepsearch_tts_tpu_torch.models import qwen3 as tqwen3
from deepsearch_tts_tpu_torch.models import qwen3_moe as tmoe
from deepsearch_tts_tpu_torch.models import registry as tregistry

torch.set_num_threads(1)

TOL = 5e-2   # ROADMAP.md's forward bound (tests/test_torch_model.py TOL)
# the 128-wide configs JAX's int8 (tests/test_ring_quant.py:203-205) and MoE
# (tests/test_moe.py:123-125) fused kernels tile
WIDE = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=2, n_kv_heads=2,
            head_dim=128, intermediate=256, tie_embeddings=True)
MOE_WIDE = dict(vocab_size=256, hidden=128, n_layers=2, n_heads=2, n_kv_heads=2,
                head_dim=128, n_experts=4, top_k=2, moe_intermediate=128,
                tie_embeddings=True)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------- the forward

def _model(family, dtype, int8):
    """(JAX forward, port forward, JAX config, packed JAX params, port
    params) of a small config of ``family``."""
    if family == "moe":
        jcfg = jmoe.Qwen3MoeConfig(**MOE_WIDE, dtype=dtype)
        tcfg = tmoe.Qwen3MoeConfig(**MOE_WIDE, dtype=dtype)
        jp = jpack(jmoe.init_params(jcfg, jax.random.PRNGKey(0)))
        jf, tf = jmoe.forward, tmoe.forward
    else:
        if int8:
            jcfg, tcfg = jqwen3.Qwen3Config(**WIDE, dtype=dtype), tqwen3.Qwen3Config(**WIDE, dtype=dtype)
        else:
            jcfg = dataclasses.replace(jqwen3.QWEN3_CONFIGS["qwen3-test"], dtype=dtype)
            tcfg = dataclasses.replace(tqwen3.QWEN3_CONFIGS["qwen3-test"], dtype=dtype)
        jp = jpack(jqwen3.init_params(jcfg, jax.random.PRNGKey(0)))
        if int8:
            jp = jquant.quantize_params(jp)
        jf, tf = jqwen3.forward, tqwen3.forward
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jf, tf, jcfg, tcfg, jp, tp


class _Pools:
    """Both packages' pools of one layout (paged: 24 pages of 4 tokens, rows
    0-2 own pages 1-6, 7-12, 13-18; slot: three 32-token rows), with int8
    KV's scales pools where asked (JAX's int8 rows int32-packed)."""

    def __init__(self, jcfg, tcfg, slot: bool, kv_int8: bool):
        L, Kh, D = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
        N, ps = (3, 32) if slot else (24, 4)
        self.slot, self.kv_int8, self.ps = slot, kv_int8, ps
        self.table = (np.arange(3, dtype=np.int32)[:, None] if slot
                      else np.arange(1, 19, dtype=np.int32).reshape(3, 6))
        if kv_int8:
            self.j = [jnp.zeros((L, N, ps, Kh, D // 4), jnp.int32) for _ in range(2)]
            self.j += [jnp.zeros((L, N, ps, Kh), jnp.float32) for _ in range(2)]
            self.t = list(tkv.init_kv_pages(L, N, ps, Kh, D, torch.int8))
            self.t += list(tkv.init_kv_scales(L, N, ps, Kh))
        else:
            self.j = list(jkv.init_kv_pages(L, N, ps, Kh, D, jcfg.jnp_dtype))
            self.t = list(tkv.init_kv_pages(L, N, ps, Kh, D, tcfg.torch_dtype))

    def kw(self, which):
        p = self.j if which == "j" else self.t
        out = dict(k_pages=p[0], v_pages=p[1])
        if self.kv_int8:
            out.update(k_scales=p[2], v_scales=p[3])
        return out

    def values(self, which):
        """The pools as float32 (int8 rows dequantized with their scales)."""
        p = self.j if which == "j" else self.t
        if not self.kv_int8:
            return [_f32(p[0]), _f32(p[1])]
        rows = [np.asarray(jkv.unpack_int8_rows(x)) if which == "j" else x.numpy()
                for x in p[:2]]
        return [r.astype(np.float32) * _f32(s)[..., None] for r, s in zip(rows, p[2:])]


def _step(jf, tf, jcfg, tcfg, jp, tp, pools, tokens, positions, seq_lens, **kw):
    """One serving forward in both packages; logits and pools must agree.
    Returns the port's logits."""
    arrays = {k: kw.pop(k) for k in list(kw) if isinstance(kw[k], (np.ndarray, np.generic))}
    jl, cache = jf(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                   page_table=jnp.asarray(pools.table), seq_lens=jnp.asarray(seq_lens),
                   **pools.kw("j"), **{k: jnp.asarray(v) for k, v in arrays.items()}, **kw)
    pools.j = list(cache)
    tl, _ = tf(tp, tcfg, _t(tokens), _t(positions), page_table=_t(pools.table),
               seq_lens=_t(seq_lens), **pools.kw("t"), **{k: _t(v) for k, v in arrays.items()},
               **kw)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=TOL, atol=TOL)
    for a, b in zip(pools.values("t"), pools.values("j")):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    return tl


CASES = {
    # id: (family, dtype, int8 weights, slot layout, int8 KV, impl)
    "paged-f32": ("dense", "float32", False, False, False, "xla"),
    "paged-bf16": ("dense", "bfloat16", False, False, False, "xla"),
    "slot-bf16": ("dense", "bfloat16", False, True, False, "xla"),
    "slot-bf16-pallas": ("dense", "bfloat16", False, True, False, "pallas"),
    "paged-int8": ("dense", "bfloat16", True, False, False, "xla"),
    "paged-int8-kv8": ("dense", "bfloat16", True, False, True, "xla"),
    "paged-bf16-kv8": ("dense", "bfloat16", False, False, True, "xla"),
    "moe-paged": ("moe", "bfloat16", False, False, False, "xla"),
    "moe-slot": ("moe", "bfloat16", False, True, False, "xla"),
}


@pytest.mark.parametrize("n_prompt", [5, 8], ids=["padded", "full"])
@pytest.mark.parametrize("case", list(CASES))
def test_lane_forward_matches_jax(case, n_prompt):
    """Rows 0 and 1 prefill 8 and 6 tokens; a fused T=1 decode step then
    carries a prompt of ``n_prompt`` tokens for row 2 in a Tp=8 lane (its
    KV into row 2's pages, padding to the spare row); then row 2 decodes
    beside them, reading what the lane wrote."""
    family, dtype, int8, slot, kv8, impl = CASES[case]
    jf, tf, jcfg, tcfg, jp, tp = _model(family, dtype, int8)
    pools = _Pools(jcfg, tcfg, slot, kv8)
    args = (jf, tf, jcfg, tcfg, jp, tp, pools)
    rng = np.random.default_rng(len(case) + n_prompt)
    toks = rng.integers(0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    lens0 = [8, 6]
    tokens = np.zeros((2, 8), np.int32)
    positions = np.full((2, 8), -1, np.int32)
    for b, n in enumerate(lens0):
        tokens[b, :n], positions[b, :n] = toks[b, :n], np.arange(n)
    pools.table, table3 = pools.table[:2], pools.table
    _step(*args, tokens, positions, np.array(lens0, np.int32),
          logits_indices=np.array([7, 5], np.int32), fresh_prefill=True)
    pools.table = table3
    before = [v.copy() for v in pools.values("t")]

    Tp = 8
    lane_tok = np.zeros((Tp,), np.int32)
    lane_pos = np.full((Tp,), -1, np.int32)
    lane_tok[:n_prompt], lane_pos[:n_prompt] = toks[2, :n_prompt], np.arange(n_prompt)
    dec = dict(fused_decode=True, impl=impl)
    if slot:
        dec.update(slot_decode=True, slot_ctx=32)
    lens = np.array([8, 6, 0], np.int32)
    act = np.array([True, True, False])
    logits = _step(*args, toks[:, 8:9], np.where(act, lens, -1).astype(np.int32)[:, None],
                   (lens + act).astype(np.int32), lane_tokens=lane_tok,
                   lane_positions=lane_pos, lane_table=pools.table[2],
                   lane_logit_row=np.int32(n_prompt - 1), **dec)
    assert logits.shape[0] == 4      # B decode rows + the lane's row
    # what the lane step wrote: the decode rows' positions and the prompt's
    # n_prompt positions of row 2; padding wrote nothing
    ps, L = pools.ps, jcfg.n_layers
    want = {(l, int(pools.table[row, pos // ps]), pos % ps) for l in range(L)
            for row, pos in [(0, 8), (1, 6)] + [(2, q) for q in range(n_prompt)]}
    for a, b in zip(pools.values("t"), before):
        changed = set(zip(*(x.tolist() for x in np.nonzero(np.any(a != b, axis=(-2, -1))))))
        assert changed == want, changed ^ want
    # row 2 decodes from its lane-written prefix beside rows 0 and 1
    lens = np.array([9, 7, n_prompt], np.int32)
    _step(*args, toks[:, 9:10], lens[:, None].copy(), lens + 1, **dec)


def test_lane_logits_row_is_the_lane_rows_projection():
    """``logits[B]`` is lane row ``lane_logit_row`` of the same step: the
    port's lane step, projected at every lane row in turn, equals the
    no-cache forward of the prompt at that position."""
    _, tf, _, tcfg, _, tp = _model("dense", "float32", False)
    prompt = torch.tensor([5, 17, 3, 99, 41, 7])
    want, _ = tf(tp, tcfg, prompt[None], torch.arange(6)[None])
    L, Kh, D = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    for row in range(6):
        kp, vp = tkv.init_kv_pages(L, 8, 4, Kh, D, torch.float32)
        lane_tok = torch.zeros(8, dtype=torch.int64)
        lane_tok[:6] = prompt
        lane_pos = torch.where(torch.arange(8) < 6, torch.arange(8), -1)
        got, _ = tf(tp, tcfg, torch.zeros((1, 1), dtype=torch.int64),
                    torch.full((1, 1), -1), k_pages=kp, v_pages=vp,
                    page_table=torch.tensor([[1, 2]]), seq_lens=torch.zeros(1, dtype=torch.int64),
                    fused_decode=True, lane_tokens=lane_tok, lane_positions=lane_pos,
                    lane_table=torch.tensor([3, 4]), lane_logit_row=torch.tensor(row))
        np.testing.assert_allclose(got[1, 0].numpy(), want[0, row].numpy(), rtol=TOL, atol=TOL)


# -------------------------------------------------------- host logic, exact

def _float32_name(family):
    """A float32 config of ``family`` registered in both registries (tie-free
    logits, so greedy streams compare exactly)."""
    if family == "moe":
        name = "qwen3-moe-lane-f32"
        jcfg = dataclasses.replace(jmoe.QWEN3_MOE_CONFIGS["qwen3-moe-test"], dtype="float32")
        tcfg = dataclasses.replace(tmoe.QWEN3_MOE_CONFIGS["qwen3-moe-test"], dtype="float32")
        jregistry.register(name, jcfg, jmoe.init_params, jmoe.forward,
                           lambda: jmoe.logical_axes(jcfg))
        tregistry.register(name, tcfg, tmoe.forward)
        jp = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    else:
        name = "qwen3-lane-f32"
        jcfg = dataclasses.replace(jqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
        tcfg = dataclasses.replace(tqwen3.QWEN3_CONFIGS["qwen3-test"], dtype="float32")
        jregistry.register(name, jcfg, jqwen3.init_params, jqwen3.forward,
                           lambda: jqwen3.logical_axes(jcfg))
        tregistry.register(name, tcfg, tqwen3.forward)
        jp = jqwen3.init_params(jcfg, jax.random.PRNGKey(0))
    return name, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def dense():
    return _float32_name("dense")


@pytest.fixture(scope="module")
def moe():
    return _float32_name("moe")


KW = dict(max_slots=4, page_size=4, n_pages=128, max_seq_len=128, decode_chunk_len=4, seed=0,
          layer_fusion=True)


def _req(mod, ids, n=6, **kw):
    return mod.GenerationRequest(prompt_ids=[int(i) for i in ids], max_tokens=n,
                                 temperature=0.0, top_k=0, top_p=1.0, min_p=0.0,
                                 repetition_penalty=1.0, **kw)


def _queue(eng, mod, prompts, n=6, ids=None):
    futs = []
    for i, p in enumerate(prompts):
        fut = Future()
        rid = {} if ids is None else {"request_id": ids[i]}
        eng._queue.put((_req(mod, p, n, **rid), fut))
        futs.append(fut)
    return futs


def _routing(eng):
    """(slots queued in the lane, slots active) after an admission (a JAX
    lane entry wraps its prepared request in ``p``)."""
    return ([e.get("p", e)["slot"].idx for e in eng._lane],
            sorted(s.idx for s in eng.slots if s.active))


def _pair(name, jp, tp, **kw):
    tok = ByteTokenizer()
    common = dict(KW, **kw)
    return (jengine.Engine(name, tok, params=jp, **common),
            tengine.Engine(name, tok, params=tp, device="cpu", **common))


@pytest.mark.parametrize("cache_mode", ["paged", "slot"])
def test_plan_lane_and_lane_arrays_equal_jax(dense, cache_mode):
    """The same queued lane state in both engines: a decoding row, then six
    prompts (one of exactly Tp tokens, one aborted before planning) behind
    ``lane_max_act=3``: two chunks' plans and arrays are equal."""
    name, jp, tp = dense
    Tp = 8
    je, te = _pair(name, jp, tp, prefill_lane=Tp, lane_max_act=3, cache_mode=cache_mode,
                   decode_chunk_len=8, max_slots=8)
    try:
        for eng, mod in ((je, jengine), (te, tengine)):
            _queue(eng, mod, [[1, 2, 3]], n=40)
            eng._admit()
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, 250, n) for n in (5, Tp, 3, 7, 2, 6)]
        rids = [f"r{i}" for i in range(6)]
        for eng, mod in ((je, jengine), (te, tengine)):
            _queue(eng, mod, prompts, ids=rids)
            eng._admit()
            eng.abort("r2")
            eng._apply_aborts()
        assert _routing(je) == _routing(te)
        for _ in range(2):
            jplan, tplan = je._plan_lane(8), te._plan_lane(8)
            for key in ("n_tokens", "max_tokens_needed"):
                assert jplan[key] == tplan[key], key
            assert len(jplan["per_step"]) == len(tplan["per_step"]) == 8
            for js, ts in zip(jplan["per_step"], tplan["per_step"]):
                assert (js is None) == (ts is None)
                if js is not None:
                    assert (js["slot"], js["row"]) == (ts["slot"], ts["row"])
                    assert np.array_equal(js["toks"], ts["toks"])
                    assert np.array_equal(js["pos"], ts["pos"])
            assert [(a["i"], a["step"], a["slot"]) for a in jplan["acts"]] == \
                [(a["i"], a["step"], a["slot"]) for a in tplan["acts"]]
            P = min(2, te.max_pages_per_seq)
            for ja, ta in zip(je._lane_arrays(jplan, 8, P), te._lane_arrays(tplan, 8, P)):
                ja = np.asarray(ja)
                assert ja.dtype == ta.dtype and np.array_equal(ja, ta)
        assert jplan["n_tokens"] > 0 and len(tplan["acts"]) == 2   # 5 queued, 3 a chunk
    finally:
        je.shutdown()
        te.shutdown()


def test_admission_routes_as_jax(dense):
    """A cold burst goes batched; while a row decodes, prompts of at most Tp
    tokens join the lane up to ``decode_chunk_len`` of them, and a longer
    prompt, a prefix-cache hit and the overflow go batched."""
    name, jp, tp = dense
    je, te = _pair(name, jp, tp, prefill_lane=8, decode_chunk_len=3, max_slots=10)
    seen = []
    try:
        for eng, mod in ((je, jengine), (te, tengine)):
            # cold burst, one token each: prefilled batched and finished at
            # once, the first prompt's full pages into the prefix cache
            cold = _queue(eng, mod, [list(range(1, 9)), [4, 5, 6]], n=1)
            eng._admit()
            assert all(f.done() for f in cold) and not eng._lane
            _queue(eng, mod, [[9, 9, 9]], n=40)
            eng._admit()
            # a prefix-cache hit (4 of 7 tokens), a 9-token prompt, then four
            # short ones: three fill the backlog (decode_chunk_len), one overflows
            _queue(eng, mod, [[1, 2, 3, 4, 5, 6, 99], list(range(30, 39)),
                              [1], [2, 2], [3, 3, 3], [4]])
            eng._admit()
            seen.append(_routing(eng))
            hit = [s for s in eng.slots if s.active and s.cached_len > 0]
            assert len(hit) == 1 and hit[0].cached_len == 4
        assert seen[0] == seen[1]
        lane, active = seen[1]
        assert lane == [3, 4, 5] and active == [0, 1, 2, 6]
    finally:
        je.shutdown()
        te.shutdown()


# ------------------------------------------------------- engine scenarios

def _run_by_hand(eng, first=([1, 2, 3, 4, 5, 6], 24), later=((5, 9, 14), 6), after=1,
                 abort_after=None):
    """The staggered scenario of ``tests/test_prefill_lane.py:_run_staggered``
    on the port's scheduler driven by hand: ``first`` decodes alone for
    ``after`` chunks, then the ``later`` prompts (``range(10, 10 + n)``)
    arrive. Returns the futures' results in order."""
    futs = _queue(eng, tengine, [first[0]], n=first[1])
    chunks = 0
    while not all(f.done() for f in futs):
        if chunks == after:
            lens, n = later
            futs += _queue(eng, tengine, [list(range(10, 10 + m)) for m in lens], n=n,
                           ids=[f"late{i}" for i in range(len(lens))])
        eng._apply_aborts()
        eng._admit()
        if chunks == after and abort_after is not None:
            # the prompt waits in the lane queue; aborted there, it is freed
            lane_ids = lambda: [p["req"].request_id for p in eng._lane]   # noqa: E731
            assert abort_after in lane_ids()
            eng.abort(abort_after)
            eng._apply_aborts()
            assert abort_after not in lane_ids()
        if any(s.active for s in eng.slots) or eng._lane:
            eng._decode_chunk()
        chunks += 1
        assert chunks < 200
    return [f.result(timeout=0) if not f.cancelled() else None for f in futs]


def _run_jax(eng, first=([1, 2, 3, 4, 5, 6], 24), later=((5, 9, 14), 6)):
    """The same requests through JAX's engine on its own thread (greedy
    streams do not depend on when the later prompts arrive)."""
    futs = [eng.submit(_req(jengine, first[0], first[1]))]
    lens, n = later
    futs += [eng.submit(_req(jengine, list(range(10, 10 + m)), n)) for m in lens]
    return [f.result(timeout=600) for f in futs]


def _tengine(name, tp, **kw):
    return tengine.Engine(name, ByteTokenizer(), params=tp, device="cpu", **dict(KW, **kw))


def _streams(results):
    return [(r.token_ids, r.finish_reason, r.completion_tokens) for r in results]


LAYOUTS = {"paged": dict(enable_prefix_cache=False), "paged-prefix": {},
           "slot": dict(cache_mode="slot")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_lane_streams_equal_laneless_and_jax(dense, layout):
    """Prompts of 5, 9 and 14 tokens arriving while a row decodes ride the
    lane whole (``lane_tokens`` = 28, each activated); every stream equals
    the lane-less engine's and JAX's lane-less engine's."""
    name, jp, tp = dense
    kw = LAYOUTS[layout]
    want = _streams(_run_by_hand(_tengine(name, tp, **kw)))
    eng = _tengine(name, tp, prefill_lane=16, **kw)
    got = _streams(_run_by_hand(eng))
    assert eng.stats["lane_tokens"] == 5 + 9 + 14
    assert eng.stats["requests"] == 4 and eng.stats["prefill_rows"] == 1
    assert got == want
    je = jengine.Engine(name, ByteTokenizer(), params=jp, **dict(KW, **kw))
    try:
        assert _streams(_run_jax(je)) == got
    finally:
        je.shutdown()
    # nothing leaked: every slot idle, every page free or held by the prefix cache
    assert all(not s.active and s.req is None for s in eng.slots) and not eng._lane
    if layout != "slot":
        assert eng.allocator.num_free + len(eng.allocator._refs) == eng.n_pages - 1


def test_slot_lane_equals_paged_engine(dense):
    name, _, tp = dense
    want = _streams(_run_by_hand(_tengine(name, tp, enable_prefix_cache=False)))
    eng = _tengine(name, tp, prefill_lane=16, cache_mode="slot")
    assert _streams(_run_by_hand(eng)) == want and eng.stats["lane_tokens"] > 0


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_moe_lane_streams_equal_laneless_and_jax(moe, layout):
    """The MoE family: lane steps run B3, attention, B7 and the experts
    over B+Tp rows (the plain versions here); streams equal the lane-less
    engine's and JAX's (unfused there: JAX's B7 cannot tile E=64)."""
    name, jp, tp = moe
    kw = dict(cache_mode="slot") if layout == "slot" else dict(enable_prefix_cache=False)
    later = ((3, 11), 5)
    want = _streams(_run_by_hand(_tengine(name, tp, **kw), first=([1, 2, 3], 16),
                                 later=later))
    eng = _tengine(name, tp, prefill_lane=16, **kw)
    assert eng.layer_fusion
    got = _streams(_run_by_hand(eng, first=([1, 2, 3], 16), later=later))
    assert eng.stats["lane_tokens"] == 3 + 11 and got == want
    je = jengine.Engine(name, ByteTokenizer(), params=jp, **dict(KW, layer_fusion=False, **kw))
    try:
        assert _streams(_run_jax(je, first=([1, 2, 3], 16), later=later)) == got
    finally:
        je.shutdown()


def test_prompt_longer_than_the_lane_takes_batched_prefill(dense):
    """A 60-token prompt is not lane-eligible: it prefills batched while the
    first row decodes, and decodes as it does without a lane."""
    name, _, tp = dense
    long = [int(x) for x in np.random.default_rng(1).integers(1, 250, 60)]

    def run(eng):
        futs = _queue(eng, tengine, [[7, 8, 9]], n=30)
        eng._admit()
        eng._decode_chunk()
        futs += _queue(eng, tengine, [long], n=6)
        while not all(f.done() for f in futs):
            eng._admit()
            eng._decode_chunk()
        return _streams(f.result() for f in futs)

    want = run(_tengine(name, tp, enable_prefix_cache=False))
    eng = _tengine(name, tp, prefill_lane=16, enable_prefix_cache=False)
    assert run(eng) == want and eng.stats["lane_tokens"] == 0


def test_lane_max_act_override(dense):
    """``lane_max_act=2``: at most two prompts complete a chunk, the third
    waits for the next; streams stay those of the lane-less engine."""
    name, _, tp = dense
    want = _streams(_run_by_hand(_tengine(name, tp)))
    eng = _tengine(name, tp, prefill_lane=16, lane_max_act=2)
    assert eng.LANE_MAX_ACT == 2 and tengine.Engine.LANE_MAX_ACT == 8
    acts = []
    plan = eng._plan_lane

    def spy(chunk):
        out = plan(chunk)
        acts.append(len(out["acts"]))
        return out

    eng._plan_lane = spy
    assert _streams(_run_by_hand(eng)) == want
    assert max(acts) == 2 and sum(acts) == 3 and eng.stats["lane_tokens"] == 28


def test_lane_abort_while_queued(dense):
    """A lane prompt aborted before its chunk is freed at once: its future
    is cancelled, the others finish as without it, no page leaks."""
    name, _, tp = dense
    want = _streams(_run_by_hand(_tengine(name, tp), later=((5, 14), 6)))
    eng = _tengine(name, tp, prefill_lane=16)
    res = _run_by_hand(eng, later=((5, 9, 14), 6), abort_after="late1")
    assert res[2] is None                      # the aborted prompt: cancelled
    assert _streams([r for r in res if r is not None]) == want
    assert eng.stats["lane_tokens"] == 5 + 14
    assert all(not s.active and s.req is None for s in eng.slots)
    assert eng.allocator.num_free + len(eng.allocator._refs) == eng.n_pages - 1


def test_lane_abort_mid_stream_on_the_thread(dense):
    """JAX's ``test_lane_abort_mid_stream`` on the port's own loop thread:
    the victim is cancelled before its step or finishes "aborted" after
    activation; the long request completes and the engine stays sound."""
    name, _, tp = dense
    eng = _tengine(name, tp, prefill_lane=16)
    try:
        first = threading.Event()
        f0 = eng.submit(_req(tengine, [3, 4, 5], 40, on_delta=lambda _t: first.set()))
        assert first.wait(timeout=300)
        victim = eng.submit(_req(tengine, list(range(20, 30)), 6, request_id="lane-victim"))
        eng.abort("lane-victim")
        assert f0.result(timeout=600).completion_tokens == 40
        try:
            assert victim.result(timeout=600).finish_reason == "aborted"
        except concurrent.futures.CancelledError:
            pass
        assert eng.generate(_req(tengine, [9, 9, 9], 4)).completion_tokens == 4
        assert eng.allocator.num_free + len(eng.allocator._refs) == eng.n_pages - 1
    finally:
        eng.shutdown()


def test_cold_burst_takes_batched_prefill(dense):
    name, _, tp = dense
    eng = _tengine(name, tp, prefill_lane=4)
    try:
        futs = eng.submit_many([_req(tengine, [i, i + 1, i + 2], 4) for i in range(4)])
        assert all(f.result(timeout=600).completion_tokens == 4 for f in futs)
        assert eng.stats["lane_tokens"] == 0 and eng.stats["prefill_rows"] == 4
    finally:
        eng.shutdown()


def test_lane_first_token_seen_mask(dense):
    """An activated prompt's seen mask holds exactly its prompt's tokens and
    its first token, as batched prefill builds it."""
    name, _, tp = dense
    eng = _tengine(name, tp, prefill_lane=16)
    _queue(eng, tengine, [[1, 2, 3]], n=20)
    eng._admit()
    prompt = [40, 41, 41, 300]
    _queue(eng, tengine, [prompt], n=6)
    eng._admit()
    assert len(eng._lane) == 1
    slot = eng._lane[0]["slot"]
    eng._decode_chunk()
    assert slot.active and eng.seq_lens[slot.idx] == len(prompt) and len(slot.generated) == 1
    assert eng.last_tok[slot.idx] == slot.generated[0]
    got = set(torch.nonzero(eng.seen[slot.idx]).flatten().tolist())
    assert got == set(prompt) | set(slot.generated)


def test_warmup_runs_a_lane_step_and_writes_nothing(dense):
    name, _, tp = dense
    eng = _tengine(name, tp, prefill_lane=16)
    k0, v0 = eng.k_pages.clone(), eng.v_pages.clone()
    eng.warmup()
    assert torch.equal(eng.k_pages, k0) and torch.equal(eng.v_pages, v0)
    assert not eng.seen.any() and eng.stats["requests"] == 0


def test_mla_has_no_lane_path_as_in_jax():
    with pytest.raises(ValueError) as t_err:
        tengine.Engine("deepseek-v3-test", ByteTokenizer(), device="cpu", prefill_lane=16)
    with pytest.raises(ValueError) as j_err:
        jengine.Engine("deepseek-v3-test", ByteTokenizer(), prefill_lane=16)
    assert str(t_err.value) == str(j_err.value)


# ------------------------------------------------------------- chunk_trim

def _greedy_reqs(mod):
    prompts = [[i, i + 1, i + 2, i + 3] for i in range(5, 37, 8)]
    # max_tokens just past a chunk boundary: the tail chunk trims
    return [_req(mod, p, n) for p, n in zip(prompts, [9, 11, 13, 10])]


def test_chunk_trim_matches_untrimmed_greedy(dense):
    """``tests/test_engine.py:287-316`` on the port: the trimmed engine
    (after ``warmup()``) trims and its greedy streams equal the untrimmed
    engine's and JAX's trimmed engine's."""
    name, jp, tp = dense
    kw = dict(KW, max_seq_len=64, decode_chunk_len=8, cache_mode="slot")
    a = tengine.Engine(name, ByteTokenizer(), params=tp, device="cpu", **kw)
    b = tengine.Engine(name, ByteTokenizer(), params=tp, device="cpu", chunk_trim=True, **kw)
    j = jengine.Engine(name, ByteTokenizer(), params=jp, chunk_trim=True,
                       context_buckets=False, **kw)
    b.warmup()
    j.warmup()
    try:
        out = []
        for eng in (a, b, j):
            mod = jengine if eng is j else tengine
            futs = [eng.submit(r) for r in _greedy_reqs(mod)]
            out.append(_streams(f.result(timeout=600) for f in futs))
        assert out[0] == out[1] == out[2]
        assert b.stats["trim_chunks"] > 0 and a.stats["trim_chunks"] == 0
    finally:
        for eng in (a, b, j):
            eng.shutdown()


def _trim_by_hand(eng, n=11):
    """One greedy request of ``n`` tokens on a 8-step chunk, by hand."""
    futs = _queue(eng, tengine, [[5, 6, 7, 8]], n=n)
    while not futs[0].done():
        eng._admit()
        eng._decode_chunk()
    return futs[0].result()


@pytest.mark.parametrize("cache_mode", ["paged", "slot"])
def test_chunk_trim_min_rows_override_and_warm_buckets(dense, cache_mode):
    """``trim_min_rows=1``: the chunk trims exactly when a row is within
    half a chunk of ``max_tokens`` (11 tokens: prefill 1, a full chunk to
    9, a half chunk to 11), and only at registered buckets: ``warmup()``
    registers the two widest, and without it nothing trims. The stream
    never changes."""
    name, _, tp = dense
    kw = dict(KW, decode_chunk_len=8, cache_mode=cache_mode, enable_prefix_cache=False)
    want = _trim_by_hand(_tengine(name, tp, **kw))
    cold = _tengine(name, tp, chunk_trim=True, **kw)
    cold.trim_min_rows = 1
    assert _trim_by_hand(cold).token_ids == want.token_ids
    assert cold.stats["trim_chunks"] == 0           # no warmup: no bucket registered
    eng = _tengine(name, tp, chunk_trim=True, **kw)
    eng.warmup()
    assert eng._trim_warm == set(eng._decode_variants()[-2:])
    eng.trim_min_rows = 1
    eng._trim_warm = set(eng._decode_variants())    # every bucket: the run's too
    got = _trim_by_hand(eng)
    assert got.token_ids == want.token_ids and eng.stats["trim_chunks"] == 1
    assert eng.stats["slot_steps"] == 8 + 4
    eng.trim_min_rows = 2                           # one near row is below 2
    assert _trim_by_hand(eng).token_ids == want.token_ids
    eng.trim_min_rows, eng._trim_warm = 1, set()    # no bucket registered
    assert _trim_by_hand(eng).token_ids == want.token_ids
    assert eng.stats["trim_chunks"] == 1


def test_chunk_trim_gate_amortises_the_gap(dense):
    """JAX's gate: ``n_near >= gap·max_slots / (half·step wall)`` once both
    are measured, ``max_slots // 8`` before."""
    name, _, tp = dense
    eng = _tengine(name, tp, chunk_trim=True, decode_chunk_len=8, max_slots=16)
    eng._trim_warm = {(1, None)}
    for s in eng.slots[:3]:
        s.stop = type("St", (), {"max_tokens": 10, "n_tokens": 7})()
    active = np.array([True] * 3 + [False] * 13)
    assert eng._trim(active, (1, None))             # 3 >= 16 // 8
    eng._chunk_ema, eng._gap_ema = 0.08, 0.004      # step 10 ms: thr = 1.6
    assert eng._trim(active, (1, None))
    eng._gap_ema = 0.008                            # thr = 3.2
    assert not eng._trim(active, (1, None))
    assert not eng._trim(active, (2, None))         # a bucket warmup did not register


@pytest.mark.parametrize("kw", [dict(page_size=4, max_seq_len=128), dict(page_size=16, max_seq_len=100),
                                dict(page_size=12, max_seq_len=96),
                                dict(cache_mode="slot", max_seq_len=128),
                                dict(cache_mode="slot", max_seq_len=48)])
def test_decode_buckets_are_every_bucket_a_chunk_reads(dense, kw):
    """The (page bucket, slot bucket) pairs ``warmup()`` builds programs
    for are exactly those a chunk reads, narrowest first."""
    name, _, tp = dense
    eng = _tengine(name, tp, **dict(kw, n_pages=64))
    every = {(eng._page_bucket(n), eng._slot_bucket(n)) for n in range(1, eng.max_seq_len + 1)}
    got = eng._decode_variants()
    assert set(got) == every and len(got) == len(every)
    assert got[-1] == (eng._page_bucket(eng.max_seq_len), eng._slot_bucket(eng.max_seq_len))
