"""B3 (and B11 ``fused_qkv``) on Hopper, the three launches it keeps (the
input norm ``rms_norm_rows``, the split-K product ``gemm_partial``, the
epilogue ``qkv_epilogue`` in ``ops/csrc/fused_layer.cu``): the host side
and the kernels' arithmetic, in plain Python and torch.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to the
plain version there; ``tests/test_torch_layers.py`` holds the product's
K split, ``fused_layer._splits``, at model widths). Here: the epilogue's
split sums in split order and its per-head norm (a thread a column, the
warps' sums in order) and rope, which read
bf16 cos / sin widened, equal the plain epilogue within B3's bound; the
input norm modelled in plain torch in ``rms_norm_rows``' reduction order
(each thread the squares of its 8 values, a warp's lanes by xor
butterfly, the warps' sums in order), whose xn is bit-equal to
``fused_qkv_stacked_plain``'s on every row whose 1/rms both orders round
alike. Also: the wrappers raise for a tensor that is neither on the CPU
nor on a card, whatever dtype cos / sin have.
"""
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu_torch.models.common import rms_norm
from deepsearch_tts_tpu_torch.ops import fused_layer as fl

torch.set_num_threads(1)

def _epilogue_model(partials: torch.Tensor, qn, kn, cos, sin, H: int, KV: int, eps: float):
    """``qkv_epilogue`` in plain torch, in its order: the split sums added
    in split order; per (row, head) block a thread a column: the squares
    summed over each warp's 32 columns by xor butterfly, the four warps'
    sums in order; n = (y · rsqrt(ss/128 + eps)) · w; rotate-half rope with
    the partner column j ± 64; cos / sin widened to float32."""
    S, B, C = partials.shape
    y = torch.zeros((B, C))
    for s_ in range(S):
        y = y + partials[s_]
    out = y.clone()
    lanes = torch.arange(32)
    c = torch.cat([cos, cos], -1).float()
    s2 = torch.cat([sin, sin], -1).float()
    sign = torch.cat([-torch.ones(64), torch.ones(64)])
    for head in range(H + KV):
        yh = y[:, head * 128:(head + 1) * 128]
        v = (yh * yh).view(B, 4, 32)
        for o in (16, 8, 4, 2, 1):
            v = v + v[:, :, lanes ^ o]
        t = torch.zeros((B,))
        for w_ in range(4):
            t = t + v[:, w_, 0]
        w = (qn if head < H else kn).float()
        n = (yh * torch.rsqrt(t[:, None] / 128.0 + eps)) * w
        partner = torch.cat([n[:, 64:], n[:, :64]], -1)
        out[:, head * 128:(head + 1) * 128] = n * c + sign * partner * s2
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("cs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 16])
def test_epilogue_matches_the_plain_epilogue(B, cs_dtype):
    """The split partials of x @ w, finished in the epilogue's order with
    cos / sin read as stored (float32, or bf16 widened), give the plain
    epilogue's q / k / v within B3's bound (bf16 rounding of the output;
    float32 sums in another order)."""
    from deepsearch_tts_tpu_torch.models.common import rope_angles

    H, KV, E, S, eps = 4, 2, 512, 4, 1e-6
    C = (H + 2 * KV) * 128
    rng = np.random.default_rng(B)
    x = torch.from_numpy(rng.standard_normal((B, E), dtype=np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((E, C), dtype=np.float32) * E ** -0.5
                         ).to(torch.bfloat16)
    qn = torch.from_numpy(rng.standard_normal(128, dtype=np.float32) * 0.1 + 1).to(torch.bfloat16)
    kn = torch.from_numpy(rng.standard_normal(128, dtype=np.float32) * 0.1 + 1).to(torch.bfloat16)
    cos, sin = (c.to(cs_dtype) for c in rope_angles(torch.arange(B) * 37 + 5, 128, 1_000_000.0))
    partials = torch.stack([x[:, k::S].float() @ w[k::S].float() for k in range(S)])
    got = _epilogue_model(partials, qn, kn, cos, sin, H, KV, eps)
    want = torch.cat(fl._qkv_epilogue(x.float() @ w.float(), x, qn, kn, cos, sin, n_heads=H,
                                      n_kv=KV, head_dim=128, eps=eps), 1)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=1e-2)


def _rms_norm_rows_inv(x: torch.Tensor, eps: float) -> torch.Tensor:
    """1/rms of each row of x [B, E] in ``rms_norm_rows``' order (one block
    a row of nt = E/8 rounded up to whole warps, at most 1024, threads):
    thread t adds the squares of its 8-value chunk t (chunks t + nt, ...
    each summed on their own first, for rows past 8192) one at a time (fma
    of exact products: a float32 add each); each warp adds its lanes' sums
    by xor butterfly (offsets 16, 8, 4, 2, 1); the warps' sums are added in
    warp order; then rsqrt(sum / E + eps)."""
    B, E = x.shape
    n8 = E // 8
    nt = min(1024, max(32, -(-n8 // 32) * 32))
    rounds = -(-n8 // nt)
    chunks = torch.zeros((B, rounds * nt, 8), dtype=torch.float32)
    chunks[:, :n8] = x.float().view(B, n8, 8)
    chunks = chunks.view(B, rounds, nt, 8)
    ss = torch.zeros((B, nt), dtype=torch.float32)
    for q in range(rounds):
        part = torch.zeros((B, nt), dtype=torch.float32)
        for e in range(8):
            f = chunks[:, q, :, e]
            part = part + f * f
        ss = part if q == 0 else ss + part
    v = ss.view(B, nt // 32, 32)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, :, lanes ^ o]
    t = torch.zeros((B,), dtype=torch.float32)
    for w in range(nt // 32):
        t = t + v[:, w, 0]
    return torch.rsqrt(t / float(E) + eps)[:, None]


@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("E", [128, 2048, 4096])
def test_rms_norm_rows_order_matches_plain_xn(E, B):
    """xn = bf16((x * 1/rms) * ln), with the kernel's order of the sum of
    squares, equals ``fused_qkv_stacked_plain``'s xn (``rms_norm``) bit for
    bit on every row whose float32 1/rms comes out the same in both orders;
    on the others (the two orders may round the sum one float32 ulp apart)
    all but one element in a thousand at most are equal, and none is more
    than one bf16 ulp off; the model's sum is the exact one (float64) to
    float32 rounding."""
    rng = np.random.default_rng(E + B)
    x = torch.from_numpy(rng.standard_normal((B, E), dtype=np.float32)).to(torch.bfloat16)
    ln = torch.from_numpy(rng.standard_normal(E, dtype=np.float32) * 0.1 + 1).to(torch.bfloat16)
    eps = 1e-6
    inv = _rms_norm_rows_inv(x, eps)
    xn = ((x.float() * inv) * ln.float()).to(torch.bfloat16)
    want = rms_norm(x, ln, eps)
    plain_inv = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps)
    same = (inv == plain_inv)[:, 0]
    assert torch.equal(xn[same], want[same])
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=1e-30))) - 7)
    assert bool(((xn.float() - want.float()).abs() <= ulp).all())
    # the two orders' 1/rms differ by an ulp on some rows; xn feels it on
    # one element in thousands at most
    assert int((xn != want).sum()) <= max(1, xn.numel() // 1000)
    exact = x.double().square().sum(-1, keepdim=True) / E
    np.testing.assert_allclose((inv ** -2).double() - eps, exact, rtol=3 * 2.0 ** -23)


def test_rms_norm_rows_model_sees_a_dropped_chunk():
    """The model of ``rms_norm_rows`` is sharp: leaving one thread's chunk
    out of the sum of squares changes xn."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 4096), dtype=np.float32)).to(torch.bfloat16)
    ln = torch.ones(4096, dtype=torch.bfloat16)
    xd = x.clone()
    xd[:, 8 * 5:8 * 6] = 0      # chunk 5 (thread 5) missing from the sum
    inv_d = _rms_norm_rows_inv(xd, 1e-6)
    xn_d = ((x.float() * inv_d) * ln.float()).to(torch.bfloat16)
    assert not torch.equal(xn_d, rms_norm(x, ln, 1e-6))


@pytest.mark.parametrize("cs_dtype", [torch.float32, torch.bfloat16])
def test_qkv_wrappers_never_fall_back_off_cpu(cs_dtype):
    E, H, K, D, B = 256, 2, 1, 128, 4
    meta = dict(device="meta")
    x = torch.zeros((B, E), dtype=torch.bfloat16, **meta)
    ln = torch.zeros((1, E), dtype=torch.bfloat16, **meta)
    w = torch.zeros((1, E, (H + 2 * K) * D), dtype=torch.bfloat16, **meta)
    qn = torch.zeros((1, D), dtype=torch.bfloat16, **meta)
    cos = torch.zeros((B, D // 2), dtype=cs_dtype, **meta)
    kw = dict(n_heads=H, n_kv=K, head_dim=D)
    fl.fused_qkv_stacked.launches = fl.fused_qkv.launches = 0
    with pytest.raises(ValueError):
        fl.fused_qkv_stacked(x, ln, w, qn, qn, cos, cos, 0, **kw)
    with pytest.raises(ValueError):
        fl.fused_qkv(x, ln[0], w[0], qn[0], qn[0], cos, cos, **kw)
    assert fl.fused_qkv_stacked.launches == fl.fused_qkv.launches == 0
