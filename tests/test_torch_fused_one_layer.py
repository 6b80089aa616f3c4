"""Parity of B11, the port's one-layer fused functions (``fused_mlp``,
``fused_qkv``, ``fused_out_mlp``), with the JAX package's Pallas kernels.

The same inputs, made from a numpy seed, go through the JAX function in
``interpret=True`` (as ``tests/test_fused_layer.py`` runs it on the CPU)
and through the port's wrapper, which takes its plain version because the
tensors lie on the CPU. Widths: ``tests/test_fused_layer.py``'s (B=8,
E=256, F=384, H=4, K=2, D=64) and one case at the kernels' head width
D=128. Tolerance: rtol 5e-2, atol 2e-2, the bound that file holds these
kernels to (bf16 outputs; float32 sums in another order round the bf16
intermediates xn, x2 and h differently now and then).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu.models.common import rope_angles
from deepsearch_tts_tpu.ops import fused_layer as jfused
from deepsearch_tts_tpu_torch.ops import fused_layer as tfused

import jax.numpy as jnp

torch.set_num_threads(1)

EPS = 1e-6
RTOL, ATOL = 5e-2, 2e-2
BF16 = np.dtype(ml_dtypes.bfloat16)
# (B, E, F, H, K, D): tests/test_fused_layer.py's widths, then D = 128
WIDTHS = [(8, 256, 384, 4, 2, 64), (4, 256, 256, 2, 1, 128)]


def _bf16(rng, *shape, scale=0.05, shift=0.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale + shift).astype(BF16)


def _t(a):
    a = np.array(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("w", WIDTHS)
def test_fused_mlp_plain_matches_jax_kernel(w):
    B, E, F, H, K, D = w
    rng = np.random.default_rng(0)
    x, ln = _bf16(rng, B, E, scale=1.0), _bf16(rng, E, scale=0.1, shift=1.0)
    wg, wu, wd = _bf16(rng, E, F), _bf16(rng, E, F), _bf16(rng, F, E)
    want = jfused.fused_mlp(*map(jnp.asarray, (x, ln, wg, wu, wd)), eps=EPS, block_f=128,
                            interpret=True)
    got = tfused.fused_mlp(*map(_t, (x, ln, wg, wu, wd)), eps=EPS, block_f=128)
    assert got.dtype == torch.bfloat16 and got.shape == (B, E)
    _close(got, want)
    assert tfused.fused_mlp.launches == 0


@pytest.mark.parametrize("w", WIDTHS)
def test_fused_qkv_plain_matches_jax_kernel(w):
    B, E, F, H, K, D = w
    rng = np.random.default_rng(1)
    x, ln = _bf16(rng, B, E, scale=1.0), _bf16(rng, E, scale=0.1, shift=1.0)
    wqkv = _bf16(rng, E, (H + 2 * K) * D)
    qn, kn = _bf16(rng, D, scale=0.1, shift=0.9), _bf16(rng, D, scale=0.1, shift=1.2)
    cos, sin = rope_angles(jnp.arange(B, dtype=jnp.int32)[:, None] * 3, D, 10000.0)
    # the model dtype, as the JAX function takes them
    cos, sin = (np.asarray(c[:, 0].astype(jnp.bfloat16)) for c in (cos, sin))
    kw = dict(n_heads=H, n_kv=K, head_dim=D, eps=EPS)
    want = jfused.fused_qkv(*map(jnp.asarray, (x, ln, wqkv, qn, kn, cos, sin)),
                            interpret=True, **kw)
    got = tfused.fused_qkv(*map(_t, (x, ln, wqkv, qn, kn, cos, sin)), **kw)
    for g, r, n in zip(got, want, (H, K, K)):
        assert g.dtype == torch.bfloat16 and g.shape == (B, n * D)
        _close(g, r)
    assert tfused.fused_qkv.launches == 0


@pytest.mark.parametrize("w", WIDTHS)
def test_fused_qkv_bf16_and_float32_cos_sin_match_jax(w):
    """bf16 cos / sin (the model dtype, which the kernel reads as stored)
    and the same tables widened to float32 give the same bits, both within
    the bound of JAX's ``fused_qkv`` in interpret mode on the bf16 tables."""
    B, E, F, H, K, D = w
    rng = np.random.default_rng(2)
    x, ln = _bf16(rng, B, E, scale=1.0), _bf16(rng, E, scale=0.1, shift=1.0)
    wqkv = _bf16(rng, E, (H + 2 * K) * D)
    qn, kn = _bf16(rng, D, scale=0.1, shift=0.9), _bf16(rng, D, scale=0.1, shift=1.2)
    cos, sin = rope_angles(jnp.arange(B, dtype=jnp.int32)[:, None] * 7 + 100, D, 1e6)
    cos, sin = (np.asarray(c[:, 0].astype(jnp.bfloat16)) for c in (cos, sin))
    kw = dict(n_heads=H, n_kv=K, head_dim=D, eps=EPS)
    want = jfused.fused_qkv(*map(jnp.asarray, (x, ln, wqkv, qn, kn, cos, sin)),
                            interpret=True, **kw)
    args = tuple(map(_t, (x, ln, wqkv, qn, kn)))
    got_bf = tfused.fused_qkv(*args, _t(cos), _t(sin), **kw)
    got_f32 = tfused.fused_qkv(*args, _t(cos).float(), _t(sin).float(), **kw)
    for gb, gf, r in zip(got_bf, got_f32, want):
        assert torch.equal(gb, gf)
        _close(gb, r)
    assert tfused.fused_qkv.launches == 0


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("packed", [False, True])
def test_fused_out_mlp_plain_matches_jax_kernel(w, packed):
    B, E, F, H, K, D = w
    rng = np.random.default_rng(2)
    a, x = _bf16(rng, B, H * D, scale=1.0), _bf16(rng, B, E, scale=1.0)
    wo, ln = _bf16(rng, H * D, E), _bf16(rng, E, scale=0.1, shift=1.0)
    wg, wu, wd = _bf16(rng, E, F), _bf16(rng, E, F), _bf16(rng, F, E)
    if packed:
        wg = wu = np.concatenate([wg, wu], axis=1)
    want = jfused.fused_out_mlp(*map(jnp.asarray, (a, x, wo, ln, wg, wu, wd)), eps=EPS,
                                packed_gateup=packed, interpret=True)
    got = tfused.fused_out_mlp(*map(_t, (a, x, wo, ln, wg, wu, wd)), eps=EPS,
                               packed_gateup=packed)
    assert got.dtype == torch.bfloat16 and got.shape == (B, E)
    _close(got, want)
    assert tfused.fused_out_mlp.launches == 0


@pytest.mark.parametrize("w", WIDTHS)
def test_fused_out_mlp_packed_and_unpacked_are_bit_equal(w):
    """The packed [E,2F] passed as both gate and up and the two [E,F]
    matrices give the same bits on the CPU: one function, two layouts."""
    B, E, F, H, K, D = w
    rng = np.random.default_rng(3)
    a, x = _t(_bf16(rng, B, H * D, scale=1.0)), _t(_bf16(rng, B, E, scale=1.0))
    wo, ln = _t(_bf16(rng, H * D, E)), _t(_bf16(rng, E, scale=0.1, shift=1.0))
    wg, wu, wd = (_t(_bf16(rng, *s)) for s in ((E, F), (E, F), (F, E)))
    gateup = torch.cat([wg, wu], dim=1)
    unpacked = tfused.fused_out_mlp(a, x, wo, ln, wg, wu, wd, eps=EPS)
    packed = tfused.fused_out_mlp(a, x, wo, ln, gateup, gateup, wd, eps=EPS,
                                  packed_gateup=True)
    assert torch.equal(unpacked, packed)


def test_one_layer_forms_equal_the_stacked_plain_versions_at_l1():
    """B11 is B8 / B3 / B4 at L = 1: the one-layer plain versions equal the
    stacked ones on the same matrices viewed as one-layer stacks."""
    B, E, F, H, K, D = WIDTHS[0]
    rng = np.random.default_rng(4)
    x, a = _t(_bf16(rng, B, E, scale=1.0)), _t(_bf16(rng, B, H * D, scale=1.0))
    ln = _t(_bf16(rng, E, scale=0.1, shift=1.0))
    wg, wu, wd = (_t(_bf16(rng, *s)) for s in ((E, F), (E, F), (F, E)))
    wo, wqkv = _t(_bf16(rng, H * D, E)), _t(_bf16(rng, E, (H + 2 * K) * D))
    qn, kn = _t(_bf16(rng, D, shift=1.0)), _t(_bf16(rng, D, shift=1.0))
    cos, sin = (torch.from_numpy(rng.standard_normal((B, D // 2), dtype=np.float32))
                for _ in range(2))
    assert torch.equal(tfused.fused_mlp(x, ln, wg, wu, wd),
                       tfused.fused_mlp_stacked(x, ln[None], wg[None], wu[None], wd[None], 0))
    kw = dict(n_heads=H, n_kv=K, head_dim=D)
    for g, r in zip(tfused.fused_qkv(x, ln, wqkv, qn, kn, cos, sin, **kw),
                    tfused.fused_qkv_stacked(x, ln[None], wqkv[None], qn[None], kn[None],
                                             cos, sin, 0, **kw)):
        assert torch.equal(g, r)
    gateup = torch.cat([wg, wu], dim=1)
    assert torch.equal(
        tfused.fused_out_mlp(a, x, wo, ln, gateup, gateup, wd, packed_gateup=True),
        tfused.fused_out_mlp_stacked(a, x, wo[None], ln[None], gateup[None], wd[None], 0))
