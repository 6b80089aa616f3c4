"""Parity of the torch port's DeepSeek-V3 / Kimi-K2 (MLA) slice with the JAX
package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its counterpart in ``deepsearch_tts_tpu_torch``: ``route_v3``, B8's
plain version against JAX's ``fused_mlp_stacked`` in interpret mode, the
latent (v = k) plain versions of B1 and the three B6 entries against JAX's
kernels in interpret mode, the plain attention helpers with a value
narrower than the key, the latent row writes, the ``deepseek-v3-test``
forwards over every serving branch, the fused decode layer, the golden
checkpoint, the random-init tree, greedy token streams of the paged and
slot engines, and the engine's refusals. The CUDA kernels themselves (B8
and K3) are held against these plain versions on the card by
``chip_smoke.py``.

JAX pads the latent cache row (``kv_lora_rank + qk_rope_head_dim``) to a
multiple of 128 columns for its TPU tiling; the port keeps it unpadded.
Pools are compared on their first ``raw_row_dim`` columns, attention
outputs on the first ``kv_lora_rank``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import engine as jengine
from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.engine import weights as jweights
from deepsearch_tts_tpu.engine.tokenizer import ByteTokenizer
from deepsearch_tts_tpu.models import deepseek_v3 as jds
from deepsearch_tts_tpu.models import registry as jregistry
from deepsearch_tts_tpu.ops import attention as jattn
from deepsearch_tts_tpu.ops import fused_layer as jfused
from deepsearch_tts_tpu.ops import paged_attention as jpa
from deepsearch_tts_tpu.ops import slot_attention as jsa
from deepsearch_tts_tpu_torch.engine import engine as tengine
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.engine import weights as tweights
from deepsearch_tts_tpu_torch.models import deepseek_v3 as tds
from deepsearch_tts_tpu_torch.models import registry as tregistry
from deepsearch_tts_tpu_torch.ops import attention as tattn
from deepsearch_tts_tpu_torch.ops import fused_layer as tfused
from deepsearch_tts_tpu_torch.ops import moe as tmoe_ops
from deepsearch_tts_tpu_torch.ops import paged_attention as tpa
from deepsearch_tts_tpu_torch.ops import slot_attention as tsa

torch.set_num_threads(1)

BF16 = np.dtype(ml_dtypes.bfloat16)
CFG = "deepseek-v3-test"
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden", CFG)
# B8: bf16 outputs that round at the same points in both packages (the JAX
# suite's bound for the stacked fused kernels, tests/test_fused_layer.py:181)
RTOL, ATOL = 2e-2, 1e-2
# the attention kernels against their plain versions (tests/test_kernels.py:131)
ATTN_RTOL, ATTN_ATOL = 5e-2, 2e-2
# whole MLA forwards (tests/test_deepseek.py:71, :128, :211)
FWD_RTOL, FWD_ATOL = 5e-2, 6e-2
# the 128-aligned config of tests/test_deepseek.py:137-142, whose dense and
# shared-expert MLP widths B8 (and JAX's fused_mlp_stacked) can tile
ALIGNED = dict(vocab_size=256, hidden=128, n_layers=3, n_heads=2, q_lora_rank=64,
               kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
               v_head_dim=32, dense_intermediate=128, first_k_dense=1,
               n_routed_experts=4, n_shared_experts=1, moe_intermediate=128,
               top_k=2, n_group=2, topk_group=1, tie_embeddings=True)


def _np(rng, *shape, scale=1.0, dtype=np.float32):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(dtype)


def _t(a):
    a = np.array(a)   # a writable copy (JAX hands out read-only buffers)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pad(a, width):
    """Zero-pad the last axis of a numpy array to ``width`` (JAX's row)."""
    return np.concatenate([a, np.zeros(a.shape[:-1] + (width - a.shape[-1],), a.dtype)], -1)


def _cfgs(name=CFG, **kw):
    j = dataclasses.replace(jds.DEEPSEEK_V3_CONFIGS[name], **kw)
    t = dataclasses.replace(tds.DEEPSEEK_V3_CONFIGS[name], **kw)
    return j, t


def _params(jcfg):
    """JAX's host-side random init of ``jcfg`` (bf16 values, widened to the
    config's dtype) and the port's copy of it."""
    jp = jax.tree.map(lambda a: a.astype(jcfg.jnp_dtype) if a.dtype == jnp.bfloat16 else a,
                      jweights.fast_random_params(jcfg, seed=0))
    return jp, tweights.params_from_jax(jax.tree.map(np.asarray, jp))


# ------------------------------------------------------------------ config

def test_configs_and_registry_match_jax():
    assert set(tds.DEEPSEEK_V3_CONFIGS) == set(jds.DEEPSEEK_V3_CONFIGS)
    for name, jcfg in jds.DEEPSEEK_V3_CONFIGS.items():
        tcfg = tds.DEEPSEEK_V3_CONFIGS[name]
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.n_kv_heads == 1 and tcfg.latent_cache
        # the port's row is unpadded; JAX pads it to a multiple of 128
        assert tcfg.head_dim == tcfg.raw_row_dim == jcfg.raw_row_dim
        assert jcfg.head_dim == -(-jcfg.raw_row_dim // 128) * 128
        fam = tregistry.get_model(name)
        assert fam.config is tcfg and fam.forward is tds.forward
        assert fam.convert is tweights.convert_deepseek_v3
    assert ([f.name for f in dataclasses.fields(tds.DeepSeekV3Config)]
            == [f.name for f in dataclasses.fields(jds.DeepSeekV3Config)])
    assert tds.DEEPSEEK_V3_CONFIGS["deepseek-v3"].head_dim == 576
    assert not hasattr(tregistry, "_NOT_PORTED")


# ------------------------------------------------------------------ routing

@pytest.mark.parametrize("n_group", [2, 1])
def test_route_v3_matches_jax(n_group):
    """Expert ids equal and weights within 1e-6, with a selection bias that
    moves the choice, on tie-free scores."""
    jcfg, tcfg = _cfgs(n_group=n_group, topk_group=1, top_k=3)
    rng = np.random.default_rng(0)
    x = _np(rng, 12, jcfg.hidden, dtype=BF16)
    rw = _np(rng, jcfg.hidden, jcfg.n_routed_experts, scale=0.5, dtype=BF16)
    bias = _np(rng, jcfg.n_routed_experts, scale=0.3)
    jw, je = jds.route_v3(jnp.asarray(x), jnp.asarray(rw), jnp.asarray(bias), jcfg)
    tw, te = tds.route_v3(_t(x), _t(rw), _t(bias), tcfg)
    assert te.tolist() == np.asarray(je).tolist()
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), tcfg.routed_scaling_factor, rtol=1e-5)


def test_moe_v3_matches_jax():
    """Routed (grouped expert FFN's plain versions over the shared dispatch)
    plus shared experts on one layer's weights."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _np(np.random.default_rng(1), 2, 5, jcfg.hidden, dtype=BF16)
    jl = jax.tree.map(lambda a: a[1], jp["moe_layers"])
    want = jds._moe_v3(jcfg, jl, jnp.asarray(x))
    got = tds._moe_v3(tcfg, tp["moe_layers"], 1, _t(x))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)
    ref = tds._moe_v3(tcfg, tp["moe_layers"], 1, _t(x), plain=True)
    assert torch.equal(ref, got)


# ------------------------------------------------------------------- B8

@pytest.mark.parametrize("norm_residual", [(True, True), (False, False)],
                         ids=["dense", "shared"])
@pytest.mark.parametrize("layer", [0, 2])
def test_fused_mlp_stacked_plain_matches_jax_kernel(norm_residual, layer):
    """B8 at a 128-aligned shape (E=128, F=256, L=3) with norm and residual
    (MLA's dense layers) and with neither (its shared experts)."""
    norm, residual = norm_residual
    rng = np.random.default_rng(2)
    B, E, F, L = 3, 128, 256, 3
    x = _np(rng, B, E, dtype=BF16)
    ln = (1 + _np(rng, L, E, scale=0.1)).astype(BF16)
    wg = _np(rng, L, E, F, scale=E ** -0.5, dtype=BF16)
    wu = _np(rng, L, E, F, scale=E ** -0.5, dtype=BF16)
    wd = _np(rng, L, F, E, scale=F ** -0.5, dtype=BF16)
    kw = dict(eps=1e-6, norm=norm, residual=residual)
    want = jfused.fused_mlp_stacked(*(jnp.asarray(v) for v in (x, ln, wg, wu, wd)),
                                    jnp.int32(layer), interpret=True, **kw)
    args = tuple(_t(v) for v in (x, ln, wg, wu, wd)) + (layer,)
    got = tfused.fused_mlp_stacked(*args, **kw)      # CPU → plain version
    plain = tfused.fused_mlp_stacked_plain(*args, **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert torch.equal(got, plain)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=ATOL)
    assert tfused.mlp_shapes_ok(E, F) and not tfused.mlp_shapes_ok(E, 48)


def test_mla_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU never reaches a plain version: off the
    CPU, B8 and K3's entries (B1 with ``v_pool=None``, the three B6 entries
    with the pool as k and v) launch their CUDA kernel or raise (here: meta
    tensors, which are neither), as do shapes K3 cannot take (a T>1 chunk,
    a value width other than 512)."""
    meta = dict(dtype=torch.bfloat16, device="meta")
    B, E, F, L = 2, 128, 256, 2
    x = torch.zeros((B, E), **meta)
    with pytest.raises(ValueError):
        tfused.fused_mlp_stacked(x, torch.zeros((L, E), **meta), torch.zeros((L, E, F), **meta),
                                 torch.zeros((L, E, F), **meta), torch.zeros((L, F, E), **meta),
                                 0, norm=False, residual=False)
    with pytest.raises(ValueError):     # F not a multiple of 128
        tfused.fused_mlp_stacked(x, torch.zeros((L, E), **meta), torch.zeros((L, E, 48), **meta),
                                 torch.zeros((L, E, 48), **meta),
                                 torch.zeros((L, 48, E), **meta), 0)
    q = torch.zeros((B, 16, 576), **meta)
    pool = torch.zeros((2 * B, 64, 1, 576), **meta)
    lim = torch.ones((B,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tsa.slot_attention(q, pool, None, lim, 1, n_rows=B, slot_ctx=64, v_width=512)
    with pytest.raises(ValueError):
        tsa.slot_attention(q, pool, None, lim, 1, n_rows=B, slot_ctx=64, v_width=576)
    # 64 heads, the query heads of one K3 block (LATENT_HEADS): the shape
    # suits K3, the device does not
    assert tpa.LATENT_HEADS == 64
    with pytest.raises(ValueError):
        tsa.slot_attention(torch.zeros((B, 64, 576), **meta), pool, None, lim, 1, n_rows=B,
                           slot_ctx=64, v_width=512)
    table = torch.zeros((B, 2), dtype=torch.int64, device="meta")
    qpos = torch.zeros((B, 1), dtype=torch.int64, device="meta")
    for name in ("pallas_paged_attention", "pallas_paged_decode", "pallas_paged_decode_clamp"):
        extra = (qpos,) if name == "pallas_paged_attention" else ()
        with pytest.raises(ValueError):
            getattr(tpa, name)(q[:, None], pool, pool, table, lim, *extra, v_width=512)
    with pytest.raises(ValueError):     # K3 holds one query token a row
        tpa.pallas_paged_attention(torch.zeros((B, 2, 16, 576), **meta), pool, pool, table,
                                   lim, torch.zeros((B, 2), dtype=torch.int64, device="meta"),
                                   v_width=512)
    assert tfused.fused_mlp_stacked.launches == 0
    assert tsa.slot_attention_latent.launches == tpa.paged_attention_latent.launches == 0


# ---------------------------------------------------------- latent attention

# one latent row: kv_lora_rank 48 + rope 16 = 64 columns (JAX: padded to 128)
KL, QR, HL = 48, 16, 8


def _latent_q_pool(rng, B, n_pool, ps):
    q = _np(rng, B, HL, KL + QR, dtype=BF16)
    pool = _np(rng, n_pool, ps, 1, KL + QR, dtype=BF16)
    return q, pool


@pytest.mark.parametrize("layer", [0, 1])
def test_latent_slot_attention_plain_matches_jax(layer):
    """B1's shared variant (``v_pool=None``) at a latent row narrower than
    JAX's padded one, over a two-layer slot pool; ragged limits with an
    inactive row (limit 0, clamped to one key); the scale is MLA's
    ``(qk_nope + qk_rope)^-1/2``, not the row width's."""
    rng = np.random.default_rng(3)
    B, ps = 4, 32
    q, pool = _latent_q_pool(rng, B, 2 * B, ps)
    lim = np.array([1, 17, 0, 32], np.int32)
    scale = 24 ** -0.5
    want = jsa.slot_attention(jnp.asarray(_pad(q, 128)), jnp.asarray(_pad(pool, 128)), None,
                              jnp.asarray(lim), jnp.int32(layer), n_rows=B, slot_ctx=ps,
                              scale=scale, interpret=True)
    kw = dict(n_rows=B, slot_ctx=ps, scale=scale, v_width=KL)
    got = tsa.slot_attention(_t(q), _t(pool), None, _t(lim), layer, **kw)
    assert tuple(got.shape) == (B, HL, KL) and got.dtype == torch.bfloat16
    assert torch.equal(got, tsa.slot_attention_latent(_t(q), _t(pool), _t(lim), layer, **kw))
    np.testing.assert_allclose(_f32(got), _f32(want)[..., :KL], rtol=ATTN_RTOL,
                               atol=ATTN_ATOL)


@pytest.mark.parametrize("entry", ["pallas_paged_attention", "pallas_paged_decode",
                                   "pallas_paged_decode_clamp"])
def test_latent_paged_plain_matches_jax(entry):
    """The three B6 entries with the latent pool as k and v, over a shuffled
    page table, against JAX's kernels in interpret mode; and the port's
    ``paged_attention`` dispatch (``impl``) to the same entry."""
    rng = np.random.default_rng(4)
    B, ps, P = 3, 8, 4
    q, pages = _latent_q_pool(rng, B, 1 + B * P, ps)
    q = q[:, None]
    table = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    seq = np.array([5, 32, 17], np.int32)
    qpos = (seq - 1)[:, None].astype(np.int32)
    scale = 24 ** -0.5
    jq, jpg = jnp.asarray(_pad(q, 128)), jnp.asarray(_pad(pages, 128))
    jargs = (jq, jpg, jpg, jnp.asarray(table), jnp.asarray(seq))
    targs = (_t(q), _t(pages), _t(pages), _t(table), _t(seq))
    extra_j, extra_t = ((jnp.asarray(qpos),), (_t(qpos),)) if entry == "pallas_paged_attention" \
        else ((), ())
    want = getattr(jpa, entry)(*jargs, *extra_j, scale=scale, interpret=True)
    got = getattr(tpa, entry)(*targs, *extra_t, scale=scale, v_width=KL)
    assert tuple(got.shape) == (B, 1, HL, KL)
    np.testing.assert_allclose(_f32(got), _f32(want)[..., :KL], rtol=ATTN_RTOL,
                               atol=ATTN_ATOL)
    latent = tpa.paged_attention_latent(_t(q), _t(pages), _t(table), _t(seq),
                                        *extra_t, scale=scale, v_width=KL)
    assert torch.equal(got, latent)
    impl = {"pallas_paged_attention": "pallas", "pallas_paged_decode": "pallas2",
            "pallas_paged_decode_clamp": "clamp"}[entry]
    via = tattn.paged_attention(_t(q), _t(pages), _t(pages), _t(table), _t(seq), _t(qpos),
                                scale=scale, impl=impl, v_width=KL)
    assert torch.equal(via, got)
    # the gather branch (impl "xla") computes the same attention
    xla = tattn.paged_attention(_t(q), _t(pages), _t(pages), _t(table), _t(seq), _t(qpos),
                                scale=scale, v_width=KL)
    np.testing.assert_allclose(_f32(xla), _f32(got), rtol=ATTN_RTOL, atol=ATTN_ATOL)


@pytest.mark.parametrize("helper", ["causal", "masked_context", "prefix_chunk"])
def test_attention_helpers_take_a_narrower_value(helper):
    """MLA's value is the key's first ``kv_lora_rank`` columns (Dv 48 < Dk
    64 here, 512 < 576 on deepseek-v3): the plain helpers return [B,T,H,Dv]
    and agree with JAX given the full row as v and sliced after."""
    rng = np.random.default_rng(5)
    B, T, S = 2, 5, 12
    q = _np(rng, B, T, HL, KL + QR, dtype=BF16)
    rows = _np(rng, B, S, 1, KL + QR, dtype=BF16)
    new = _np(rng, B, T, 1, KL + QR, dtype=BF16)
    scale = 24 ** -0.5
    pos = np.stack([np.arange(4, 4 + T), np.arange(7, 7 + T)]).astype(np.int32)
    seq = (pos[:, -1] + 1).astype(np.int32)
    if helper == "causal":
        want = jattn.causal_attention(jnp.asarray(q), jnp.asarray(new), jnp.asarray(new),
                                      scale=scale)
        got = tattn.causal_attention(_t(q), _t(new), _t(new)[..., :KL], scale=scale)
    elif helper == "masked_context":
        want = jattn.masked_context_attention(
            jnp.asarray(q), jnp.asarray(rows), jnp.asarray(rows), jnp.asarray(seq),
            jnp.asarray(pos), scale=scale)
        got = tattn.masked_context_attention(_t(q), _t(rows), _t(rows)[..., :KL], _t(seq),
                                             _t(pos), scale=scale)
    else:
        start = pos[:, 0].astype(np.int32)
        want = jattn.prefix_chunk_attention(
            jnp.asarray(q), jnp.asarray(rows), jnp.asarray(rows), jnp.asarray(new),
            jnp.asarray(new), jnp.asarray(start), jnp.asarray(pos), scale=scale)
        got = tattn.prefix_chunk_attention(_t(q), _t(rows), _t(rows)[..., :KL], _t(new),
                                           _t(new)[..., :KL], _t(start), _t(pos), scale=scale)
    assert tuple(got.shape) == (B, T, HL, KL)
    np.testing.assert_allclose(_f32(got), _f32(want)[..., :KL], rtol=ATTN_RTOL,
                               atol=ATTN_ATOL)


def test_write_rows_flat_drops_padding_like_jax():
    """MLA's single-pool row write: padding positions go to the spare row
    (JAX drops them), so slot 0's token 0 keeps its row (fault C1's fix)."""
    rng = np.random.default_rng(6)
    L, N, ps, D = 2, 3, 4, 40
    k, _ = tkv.init_latent_pages(L, N, ps, D, dtype=torch.float32)
    jflat = jnp.zeros((L * N, ps, 1, D), jnp.float32)
    flat = k.view(L * N, ps, 1, D)
    table_l = np.array([[0, 1], [2, 0]], np.int32) + N     # layer 1
    for step in range(2):
        rows = _np(rng, 2, 3, 1, D)
        positions = np.array([[0, 1, 2], [5, -1, -1]] if step == 0
                             else [[-1, -1, 3], [6, 7, -1]], np.int32)
        jflat = jkv.write_rows_flat(jflat, jnp.asarray(rows), jnp.asarray(positions),
                                    jnp.asarray(table_l))
        out = tkv.write_rows_flat(flat, _t(rows), _t(positions), _t(table_l))
        assert out is flat
        np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert float(flat[0].abs().sum()) == 0.0       # layer 0 untouched


# ----------------------------------------------------------------- forwards

def test_no_cache_forward_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want, _ = jds.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos))
    got, cache = tds.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=FWD_RTOL, atol=FWD_ATOL)


# JAX's serving forward, compiled once per shape and branch (eager, each
# call would compile its layer scans anew)
_jforward = jax.jit(jds.forward, static_argnums=(1,), static_argnames=(
    "impl", "slot_decode", "slot_ctx", "fresh_prefill", "fused_decode"))


class _Pair:
    """One ``deepseek-v3-test`` serving state in both packages: pools of
    ``N`` pages of ``ps`` tokens (JAX's row padded to 128 columns, the
    port's unpadded), stepped together; every step's logits and pools
    must agree."""

    def __init__(self, jcfg, tcfg, jp, tp, N, ps):
        self.jcfg, self.tcfg, self.jp, self.tp = jcfg, tcfg, jp, tp
        L = jcfg.n_layers
        self.jk = jnp.zeros((L, N, ps, 1, jcfg.head_dim), jcfg.jnp_dtype)
        self.jv = jnp.zeros((L, 1, ps, 1, jcfg.head_dim), jcfg.jnp_dtype)
        self.tk, self.tv = tkv.init_latent_pages(L, N, ps, tcfg.head_dim,
                                                 dtype=tcfg.torch_dtype)

    def step(self, tokens, positions, seq_lens, table=None, logits_idx=None,
             tol=(FWD_RTOL, FWD_ATOL), **kw):
        jt = None if table is None else jnp.asarray(table)
        tt = None if table is None else torch.from_numpy(table)
        jl, (self.jk, self.jv) = _jforward(
            self.jp, self.jcfg, jnp.asarray(tokens), jnp.asarray(positions),
            k_pages=self.jk, v_pages=self.jv, page_table=jt, seq_lens=jnp.asarray(seq_lens),
            logits_indices=None if logits_idx is None else jnp.asarray(logits_idx), **kw)
        tl, (tk, tv) = tds.forward(
            self.tp, self.tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
            k_pages=self.tk, v_pages=self.tv, page_table=tt,
            seq_lens=torch.from_numpy(seq_lens),
            logits_indices=None if logits_idx is None else torch.from_numpy(logits_idx), **kw)
        assert tk is self.tk and tv is self.tv
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=tol[0], atol=tol[1])
        raw = self.tcfg.raw_row_dim
        np.testing.assert_allclose(_f32(self.tk), _f32(self.jk)[..., :raw],
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
        assert float(np.abs(_f32(self.jk)[..., raw:]).max(initial=0.0)) == 0.0
        return tl


def _prompt(toks, lens0, T):
    tokens = np.zeros((len(lens0), T), np.int32)
    positions = np.full((len(lens0), T), -1, np.int32)
    for b, n in enumerate(lens0):
        tokens[b, :n], positions[b, :n] = toks[b, :n], np.arange(n)
    return tokens, positions


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas2", "clamp"])
def test_paged_serving_branches_match_jax(impl):
    """Paged: fresh prefill → re-prefill over the cached prefix (the old
    rows read as k and v) → three T=1 decode steps through ``impl`` (the
    gather, or the B6 entries' latent plain versions against JAX's kernels),
    one row inactive on the last; logits and latent pools agree. float32:
    in bf16, tokens of these random-init streams sit on near-ties of the
    group-limited expert choice, where either package's rounding may pick
    either side (ROADMAP.md C)."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = _params(jcfg)
    pair = _Pair(jcfg, tcfg, jp, tp, 16, 4)
    table = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    lens0 = [8, 6]
    tokens, positions = _prompt(toks, lens0, 8)
    pair.step(tokens, positions, np.array(lens0, np.int32), table,
              np.array([7, 5], np.int32), fresh_prefill=True)
    tokens = np.stack([toks[b, n:n + 5] for b, n in enumerate(lens0)]).astype(np.int32)
    positions = np.stack([np.arange(n, n + 5) for n in lens0]).astype(np.int32)
    lens = np.array([n + 5 for n in lens0], np.int32)
    pair.step(tokens, positions, lens, table, np.array([4, 4], np.int32))
    for i in range(3):
        active = np.array([True, i < 2])
        pos = np.where(active, lens, -1).astype(np.int32)[:, None]
        pair.step(toks[:, 13 + i:14 + i].astype(np.int32), pos,
                  (lens + active).astype(np.int32), table, impl=impl)
        lens = lens + active


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_slot_serving_branches_match_jax(impl):
    """Slot: a prefill into each row, T=1 decode steps (``"pallas"``: B1's
    shared variant, against JAX's slot kernel in interpret mode; ``"xla"``:
    the masked gather over ``slot_ctx`` keys), then a 4-token window (the
    speculative verify step's branch, masked gather under either impl);
    float32, as above."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jp, tp = _params(jcfg)
    B, ps = 2, 32
    pair = _Pair(jcfg, tcfg, jp, tp, B, ps)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (B, 16)).astype(np.int32)
    lens0 = [7, 5]
    tokens, positions = _prompt(toks, lens0, 8)
    ident = np.arange(B, dtype=np.int32)[:, None]
    pair.step(tokens, positions, np.array(lens0, np.int32), ident,
              np.array([6, 4], np.int32))
    lens = np.array(lens0, np.int32)
    kw = dict(slot_decode=True, slot_ctx=16, impl=impl)
    for i in range(3):
        active = np.array([True, i != 1])
        pos = np.where(active, lens, -1).astype(np.int32)[:, None]
        pair.step(toks[:, 8 + i:9 + i].astype(np.int32), pos, (lens + active).astype(np.int32),
                  **kw)
        lens = lens + active
    W = 4
    pos = lens[:, None] + np.arange(W, dtype=np.int32)[None]
    pair.step(toks[:, 11:11 + W].astype(np.int32), pos.astype(np.int32),
              (lens + W).astype(np.int32), **kw)


def test_fused_decode_matches_jax_and_unfused():
    """B8 on the dense MLPs and the shared experts at T=1 (the 128-aligned
    config), against JAX's fused decode (its kernel in interpret mode) and
    against the port's own unfused decode (tests/test_deepseek.py:169-174's
    bound). float32, as the other serving tests: B8's bf16 round points are
    held to JAX's kernel by the B8 test above."""
    jcfg = jds.DeepSeekV3Config(**ALIGNED, dtype="float32")
    tcfg = tds.DeepSeekV3Config(**ALIGNED, dtype="float32")
    assert tcfg.fused_decode_fits(torch.device("cpu"))
    jp, tp = _params(jcfg)
    B, ps, ctx = 4, 8, 5
    pair = _Pair(jcfg, tcfg, jp, tp, 16, ps)
    table = np.array([[1 + 2 * b, 2 + 2 * b] for b in range(B)], np.int32)
    rng = np.random.default_rng(10)
    ptoks = rng.integers(0, jcfg.vocab_size, (B, ctx)).astype(np.int32)
    ppos = np.tile(np.arange(ctx, dtype=np.int32), (B, 1))
    pair.step(ptoks, ppos, np.full((B,), ctx, np.int32), table)
    ck, cv = tkv.init_latent_pages(jcfg.n_layers, 16, ps, tcfg.head_dim,
                                   dtype=torch.float32)
    ck.copy_(pair.tk)
    tok = np.array([[7], [9], [11], [13]], np.int32)
    pos = np.full((B, 1), ctx, np.int32)
    lens = np.full((B,), ctx + 1, np.int32)
    launches = tfused.fused_mlp_stacked.launches
    # fused decode's bound in the JAX suite (tests/test_deepseek.py:169-171)
    fused = pair.step(tok, pos, lens, table, tol=(0.08, 0.08), fused_decode=True)
    assert tfused.fused_mlp_stacked.launches == launches    # the CPU runs the plain version
    plain, _ = tds.forward(tp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos),
                           k_pages=ck, v_pages=cv, page_table=torch.from_numpy(table),
                           seq_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=0.08, atol=0.08)
    np.testing.assert_allclose(_f32(ck), _f32(pair.tk), rtol=0.08, atol=0.05)


def test_plain_experts_reference_bypasses_the_kernel_wrappers():
    """``plain_experts=True`` (the reference ``chip_smoke.py`` holds MLA's
    serving logits to) runs the routed experts without the grouped wrappers
    and gives the wrappers' own result."""
    _, tcfg = _cfgs()
    _, tp = _params(jds.DEEPSEEK_V3_CONFIGS[CFG])
    ids = torch.from_numpy(np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 7)))
    pos = torch.arange(7).repeat(2, 1)
    tmoe_ops.grouped_gateup.launches = tmoe_ops.grouped_down.launches = 0
    ref, _ = tds.forward(tp, tcfg, ids, pos, plain_experts=True)
    assert tmoe_ops.grouped_gateup.launches == tmoe_ops.grouped_down.launches == 0
    got, _ = tds.forward(tp, tcfg, ids, pos)
    assert torch.equal(ref, got)


# ------------------------------------------------------------------ weights

def test_deinterleave_rope_cols_matches_jax():
    w = np.random.default_rng(12).standard_normal((3, 5, 24)).astype(np.float32)
    for r in (8, 16):
        np.testing.assert_array_equal(tweights._deinterleave_rope_cols(w, r),
                                      jweights._deinterleave_rope_cols(w, r))
    assert not np.array_equal(tweights._deinterleave_rope_cols(w, 8), w)


def test_golden_logits_through_port_converter():
    """The in-repo HF checkpoint through the port's reader and
    ``convert_deepseek_v3`` (kv_b split, rope de-interleave, two stacks),
    against HuggingFace's float32 logits — the JAX suite's bounds
    (tests/test_weights.py:408-412); the same tree as JAX's converter."""
    cfg = tds.DEEPSEEK_V3_CONFIGS[CFG]
    raw = tweights._load_safetensors_dir(GOLDEN)
    params = tweights.convert_deepseek_v3(raw, cfg)
    want = jax.tree.map(np.asarray, jweights.convert_deepseek_v3(raw, cfg))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        params, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    assert set(map(str, flat_g)) == set(map(str, flat_w))
    for path, leaf in flat_w.items():
        np.testing.assert_array_equal(_f32(flat_g[path]), leaf.astype(np.float32))
    with open(os.path.join(GOLDEN, "meta.json")) as f:
        ids = torch.tensor([json.load(f)["input_ids"]])
    pos = torch.arange(ids.shape[1])[None]
    logits, _ = tds.forward(params, cfg, ids, pos)
    ours = logits[0].numpy()
    expected = np.load(os.path.join(GOLDEN, "expected_logits.npy"))
    err = np.abs(ours - expected)
    assert err.max() < 0.2, err.max()
    assert err.mean() < 0.01, err.mean()
    assert (ours.argmax(-1) == expected.argmax(-1)).mean() >= 0.9
    loaded, name = tweights.load_or_init_params(CFG, GOLDEN)
    assert name == CFG and torch.equal(loaded["moe_layers"]["router_bias"],
                                       params["moe_layers"]["router_bias"])


def test_random_init_tree_matches_jax_tree():
    """The port's random init has the keys, shapes and dtypes of JAX's
    two-stack tree and its scale (normal·fan_in^-½); packing hands the tree
    back unchanged, as in JAX."""
    want = jax.tree.map(np.asarray, jweights.fast_random_params(CFG, seed=0))
    cfg = tds.DEEPSEEK_V3_CONFIGS[CFG]
    got = tweights.random_params(cfg, seed=0)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    assert set(map(str, flat_g)) == set(map(str, flat_w))
    for path, leaf in flat_w.items():
        g = flat_g[path]
        want_dt = torch.float32 if leaf.dtype == np.float32 else torch.bfloat16
        assert tuple(g.shape) == leaf.shape and g.dtype == want_dt, path
        if leaf.ndim >= 2 and leaf.std() > 0:
            np.testing.assert_allclose(float(g.float().std()),
                                       float(leaf.astype(np.float32).std()), rtol=0.15)
    assert tweights.pack_matmul_params(got) is got


# ----------------------------------------------------------------- engines

NAME = "deepseek-v3-torch-parity"


def _greedy(ids, n):
    return dict(prompt_ids=[int(i) for i in ids], max_tokens=n, temperature=0.0,
                top_k=0, top_p=1.0, min_p=0.0, repetition_penalty=1.0)


def _engine_pair(**kw):
    """JAX and torch engines on the same float32 ``deepseek-v3-test`` params
    (B8 cannot tile its E=64: ``layer_fusion`` resolves off on both)."""
    jcfg, tcfg = _cfgs(dtype="float32")
    jregistry.register(NAME, jcfg, jds.init_params, jds.forward,
                       lambda: jds.logical_axes(jcfg))
    tregistry.register(NAME, tcfg, tds.forward)
    jp, tp = _params(jcfg)
    tok = ByteTokenizer()
    common = dict(max_slots=3, max_seq_len=128, decode_chunk_len=4, seed=0, **kw)
    return (jengine.Engine(NAME, tok, params=jp, **common),
            tengine.Engine(NAME, tok, params=tp, device="cpu", **common))


@pytest.mark.parametrize("kw", [dict(page_size=4, n_pages=128),
                                dict(cache_mode="slot", attn_impl="pallas"),
                                dict(cache_mode="slot", speculative="ngram", spec_k=3)],
                         ids=["paged", "slot", "speculative"])
def test_engine_greedy_streams_match_jax(kw):
    """Two concurrent requests, then a follow-up that extends the first
    conversation: a prefix-cache hit (paged) or a parked-row re-entry
    (slot, through B1's shared variant; speculative, whose 4-token verify
    windows take the masked gather, as in JAX); float32, so greedy streams
    on this random-init model have no near-ties and must be equal."""
    je, te = _engine_pair(**kw)
    try:
        assert not te.layer_fusion and te.latent_cache
        assert tuple(te.v_pages.shape[1:]) == (1, te.page_size, 1, te.cfg.head_dim)
        rng = np.random.default_rng(13)
        first = rng.integers(0, 256, 21)
        reqs = [_greedy(first, 8), _greedy(rng.integers(0, 256, 11), 10)]
        out = []
        for mod, eng in ((jengine, je), (tengine, te)):
            futs = eng.submit_many([mod.GenerationRequest(**r) for r in reqs])
            res = [f.result(timeout=300) for f in futs]
            follow = list(first) + res[0].token_ids + list(range(60, 66))
            res.append(eng.generate(mod.GenerationRequest(**_greedy(follow, 6))))
            out.append(res)
        for j, t in zip(*out):
            assert len(t.token_ids) >= 6
            assert t.token_ids == j.token_ids
            assert (t.finish_reason, t.prompt_tokens, t.cached_prompt_tokens) == (
                j.finish_reason, j.prompt_tokens, j.cached_prompt_tokens)
        assert out[1][-1].cached_prompt_tokens > 0
    finally:
        je.shutdown()
        te.shutdown()


def test_engine_refusals_match_jax():
    """int8 KV is refused as JAX refuses it (the MLA forward takes no
    scales); int8 weights name ROADMAP A8 (the int8 routed-expert FFN)."""
    tok = ByteTokenizer()
    jp, tp = _params(jds.DEEPSEEK_V3_CONFIGS[CFG])
    with pytest.raises(ValueError, match="does not support int8 KV") as jerr:
        jengine.Engine(CFG, tok, params=jp, max_slots=1, kv_quantize="int8")
    with pytest.raises(ValueError, match="does not support int8 KV") as terr:
        tengine.Engine(CFG, tok, params=tp, device="cpu", max_slots=1, kv_quantize="int8")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match="A8"):
        tengine.Engine(CFG, tok, device="cpu", max_slots=1, quantize="int8")
    with pytest.raises(NotImplementedError, match="A8"):
        tweights.random_params(tds.DEEPSEEK_V3_CONFIGS[CFG], quantize="int8")


def test_cli_serves_deepseek_test_on_cpu():
    """``cli/serve.py --model deepseek-v3-test --device cpu``: the engine it
    builds answers a chat request through the OpenAI handler."""
    import asyncio

    from deepsearch_tts_tpu_torch.cli.serve import build_engine, build_parser
    from deepsearch_tts_tpu_torch.engine.server import _handle_chat

    args = build_parser().parse_args([
        "--model", CFG, "--device", "cpu", "--max_slots", "2", "--page_size", "8",
        "--pages", "32", "--max_seq_len", "128", "--decode_chunk", "2", "--warmup", "8"])
    eng = build_engine(args)
    try:
        assert eng.latent_cache and eng.attn_impl == "xla"
        body = asyncio.run(_handle_chat(eng, {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "temperature": 0.0}))
        assert body["object"] == "chat.completion"
        assert body["usage"]["completion_tokens"] >= 1, body
    finally:
        eng.shutdown()
