"""K2's int8 mode (the int8-KV engine's prefill attention,
``flash_attention_paged`` given ``k_scales`` / ``v_scales``) on the CPU.

On the card the mode is two launches: ``widen_kv_pages`` (each row's int8
pages below its ``seq_lens`` widened with their scales into bf16 scratch
pages ``b·P + p``, the plain path's values bit for bit) and then the bf16
paged mode over the scratch pages. Here that composition runs on its plain
versions (``widen_kv_pages_plain``, then ``flash_attention_paged_plain``
without scales) and is held to the int8 branch of JAX's
``paged_attention`` (``deepsearch_tts_tpu/ops/attention.py:122-139``:
gather, ``(int8 * scale).astype(bf16)``, ``masked_context_attention``) on
every real query at the suite's bf16 tolerance (rtol 5e-2, atol 2e-2), and
to the port's CPU path (``flash_attention_paged_plain`` given the scales)
bit for bit on every row, padding rows included.

The wrapper's launches are checked on ``meta`` tensors with a library that
records its calls. The kernels themselves run on the card only:
``python3 chip_smoke.py`` holds them to the plain version at qwen3-32b's
widths.
"""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.engine import kvcache as jkv
from deepsearch_tts_tpu.ops import attention as jattn
from deepsearch_tts_tpu_torch.engine import kvcache as tkv
from deepsearch_tts_tpu_torch.ops import flash_attention as tflash

D = 64
HD = 128           # the kernels' head_dim
BF16_TOL = dict(rtol=5e-2, atol=2e-2)
KV = 2


def _case(rng, G: int, ps: int, case: str):
    """Random bf16 K / V rows quantized by both packages over a table of
    distinct pages (page 0 in none), q, seq_lens and positions:
    ``"prefix"`` one row of 7 new tokens after a mid-page prefix;
    ``"ragged"`` four rows: other prefixes, one from position 0, one with
    tail padding, a whole padding row; ``"followup"`` 2 new tokens after a
    6-page prefix, padded to 4."""
    P = 8
    starts, valid, T = {"prefix": ([3 * ps + 5], [7], 7),
                        "ragged": ([ps - 1, 0, 2 * ps, -1], [7, 7, 4, 0], 7),
                        "followup": ([6 * ps + 3], [2], 4)}[case]
    B = len(starts)
    n_pages = 1 + B * P
    rows = [rng.standard_normal((n_pages, ps, KV, D)).astype(ml_dtypes.bfloat16)
            for _ in range(2)]
    jpools = [jkv.quantize_kv_rows(jnp.asarray(r)) for r in rows]
    tpools = [tkv.quantize_kv_rows(torch.from_numpy(np.asarray(r, np.float32)).to(
        torch.bfloat16)) for r in rows]
    table = (1 + rng.permutation(n_pages - 1)[: B * P]).reshape(B, P).astype(np.int32)
    pos = np.full((B, T), -1, np.int64)
    for b, (s0, n) in enumerate(zip(starts, valid)):
        if s0 >= 0:
            pos[b, :n] = s0 + np.arange(n)
    seq = np.array([s0 + n if s0 >= 0 else 0 for s0, n in zip(starts, valid)], np.int32)
    q = rng.standard_normal((B, T, G * KV, D)).astype(ml_dtypes.bfloat16)
    return q, jpools, tpools, table, seq, pos


@pytest.mark.parametrize("case", ["prefix", "ragged", "followup"])
@pytest.mark.parametrize("ps", [8, 16, 48, 64])
@pytest.mark.parametrize("G", [1, 5, 8])
def test_int8_mode_matches_jax(G, ps, case):
    """The widening then the bf16 paged mode, on their plain versions,
    against JAX's int8 branch on every real query; bit for bit the port's
    CPU path on every row; padding rows and whole tail-padding blocks 0."""
    rng = np.random.default_rng(1000 * G + 10 * ps + len(case))
    q, jpools, tpools, table, seq, pos = _case(rng, G, ps, case)
    (jk, jks), (jv, jvs) = jpools
    want = np.asarray(jattn.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(seq),
        jnp.asarray(np.maximum(pos, 0)), k_scales=jks, v_scales=jvs).astype(jnp.float32))
    (tk, tks), (tv, tvs) = tpools
    tq = torch.from_numpy(np.asarray(q, np.float32)).to(torch.bfloat16)
    tt, ts = torch.from_numpy(table).long(), torch.from_numpy(seq).long()
    tp = torch.from_numpy(pos)
    kw, vw, wt = tflash.widen_kv_pages_plain(tk, tv, tks, tvs, tt, ts)
    got = tflash.flash_attention_paged_plain(tq, kw, vw, wt, ts, tp)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    real = pos >= 0
    np.testing.assert_allclose(got.float().numpy()[real], want[real], **BF16_TOL)
    cpu = tflash.flash_attention_paged(tq, tk, tv, tt, ts, tp, k_scales=tks, v_scales=tvs)
    assert torch.equal(got, cpu)
    lim = tflash.paged_key_limits(ts, tp, table.shape[1] * ps, G)
    assert torch.all(got[lim == 0] == 0)


class _FakeLib:
    """Records the C entries a wrapper called, and with what."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dstts_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.mark.parametrize("B,T,H,KV,ps,P", [(1, 3044, 64, 8, 64, 48), (1, 128, 64, 8, 64, 64),
                                           (16, 64, 64, 8, 64, 48), (2, 701, 40, 8, 48, 16)])
def test_int8_mode_launches_the_widening_then_the_paged_mode(monkeypatch, B, T, H, KV, ps, P):
    """With the scales, ``flash_attention_paged`` on a device (``meta``:
    tensors without data, so any read on the host would raise) calls
    ``dstts_widen_kv_pages`` over the int8 pools, then
    ``dstts_flash_attention_paged`` over the B·P bf16 scratch pages it
    wrote, then the merge where :func:`paged_splits_allowed`; it allocates
    the plan's workspace, the partials where split, and the scratch pages
    and their table, and counts one int8 launch."""
    from deepsearch_tts_tpu_torch.ops import fused_layer, paged_attention

    lib = _FakeLib()
    monkeypatch.setattr(paged_attention, "_lib", lambda: lib)
    monkeypatch.setattr(paged_attention, "_sm_count", lambda dev: 132)
    for mod, name in ((paged_attention, "_check_index"), (fused_layer, "_check")):
        monkeypatch.setattr(mod, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    made, empty = [], torch.empty

    def record(*a, **k):
        t = empty(*a, **k)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", record)
    meta = torch.device("meta")
    N = 1 + B * P
    q = empty((B, T, H, HD), dtype=torch.bfloat16, device=meta)
    k = empty((N, ps, KV, HD), dtype=torch.int8, device=meta)
    s = empty((N, ps, KV), dtype=torch.float32, device=meta)
    table = empty((B, P), dtype=torch.int64, device=meta)
    seq = empty((B,), dtype=torch.int64, device=meta)
    pos = empty((B, T), dtype=torch.int64, device=meta)
    monkeypatch.setattr(tflash.flash_attention_paged, "i8_launches", 0)
    out = tflash.flash_attention_paged(q, k, k, table, seq, pos, k_scales=s, v_scales=s)
    assert out.shape == (B, T, H, HD) and out.device == meta
    assert tflash.flash_attention_paged.i8_launches == 1
    split = tflash.paged_splits_allowed(B, T, H // KV, KV, P * ps, 132)
    names = [n for n, _ in lib.calls]
    assert names == ["dstts_widen_kv_pages", "dstts_flash_attention_paged"] + [
        "dstts_flash_paged_merge"] * split
    widen, paged = lib.calls[0][1], lib.calls[1][1]
    assert widen[6:10] == (B, P, ps, KV)
    # the paged mode reads the B·P widened pages (R), P a row
    assert paged[4] == P and paged[8:14] == (B, T, H, KV, B * P, ps)
    assert paged[-3:-1] == (132, int(split))
    n_ws, n_slots = tflash.paged_plan_sizes(B, T, H // KV, KV, 132, split)
    assert [(t.dtype, t.numel()) for t in made] == [(torch.int32, n_ws)] + [
        (torch.float32, n_slots * tflash.TILE_ROWS * HD),
        (torch.float32, n_slots * tflash.TILE_ROWS * 2)] * split + [
        (torch.bfloat16, B * P * ps * KV * HD), (torch.int64, B * P)]
