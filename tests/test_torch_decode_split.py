"""K1's and K3's split of the context (``ops/paged_attention.py``): the
host-side choice of splits (``decode_splits``, ``latent_splits``), and the
algebra of split partials and their merge.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it to
the plain versions there). Here the choice is checked as pure Python, and
the algebra of the split, modelled below in plain torch (float32 p, no
per-warp parts: the kernel's own rounding is the chip check's business),
against the one-pass plain version the CPU path runs.
"""
import inspect

import numpy as np
import pytest
import torch

from deepsearch_tts_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)

H100_SXM_SMS = 132   # the card the split policy was timed on
H100_PCIE_SMS = 114


def decode_partials_plain(qg, k, v, lim, chunk: int, scale: float):
    """K1's split in plain torch: qg [N,R,D] query rows of one kv head each,
    k / v [N,S,D], lim [N,R] key limits. Split z covers keys ``[z·chunk,
    (z+1)·chunk)`` and keeps, per row, its score maximum m (log2 units,
    -inf where it sees no key), its sum l and its unnormalised value
    product o: [Z,N,R,D], [Z,N,R], [Z,N,R]."""
    S = k.shape[1]
    s = torch.einsum("nrd,nsd->nrs", qg.float(), k.float()) * (scale / np.log(2.0))
    mask = torch.arange(S, device=qg.device) < lim[..., None]
    ms, ls, os = [], [], []
    for z0 in range(0, S, chunk):
        sz = s[..., z0:z0 + chunk].masked_fill(~mask[..., z0:z0 + chunk], -torch.inf)
        m = sz.amax(-1)
        p = torch.exp2(sz - torch.where(m == -torch.inf, 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        os.append(torch.einsum("nrs,nsd->nrd", p, v[:, z0:z0 + chunk].float()))
    return torch.stack(os), torch.stack(ms), torch.stack(ls)


def merge_partials_plain(o, m, l):
    """``decode_merge`` in plain torch: the splits' partials [Z,...] →
    normalised rows. A split that saw no key (m = -inf) weighs 0 and its o
    is not used; a row no split saw comes out 0."""
    M = m.amax(0)
    w = torch.exp2(m - torch.where(M == -torch.inf, 0.0, M))
    L = (l * w).sum(0)
    acc = torch.where(w[..., None] > 0, o * w[..., None], 0.0).sum(0)
    return acc / L.clamp(min=1e-30)[..., None]


def _check_cover(B, KV, s_max, sms):
    splits, chunk = pa.decode_splits(B, KV, s_max, sms)
    fill = pa.BLOCKS_PER_SM * sms
    assert splits >= 1 and chunk % pa.KEY_TILE == 0
    assert splits * chunk >= s_max                 # the chunks cover S_max
    assert (splits - 1) * chunk < s_max            # and none lies wholly past it
    if splits > 1:
        assert chunk >= pa.MIN_CHUNK_TILES * pa.KEY_TILE
        assert B * KV < fill
        # no more blocks than twice the fill asks for, unless one split is enough
        assert B * KV * (splits - 1) < 2 * fill


@pytest.mark.parametrize("B", [1, 2, 16, 64])
@pytest.mark.parametrize("KV", [1, 4, 8])
@pytest.mark.parametrize("s_max", [1, 63, 64, 255, 256, 1000, 4096, 32768])
def test_decode_splits_cover_the_context_in_whole_tiles(B, KV, s_max):
    _check_cover(B, KV, s_max, H100_SXM_SMS)


@pytest.mark.parametrize("B", [1, 16, 25, 64])
@pytest.mark.parametrize("KV", [1, 8])
@pytest.mark.parametrize("s_max", [63, 256, 4096, 32768])
def test_decode_splits_cover_the_context_on_a_smaller_card(B, KV, s_max):
    _check_cover(B, KV, s_max, H100_PCIE_SMS)


def test_decode_splits_read_no_tensor_value():
    """The choice takes sizes only: a host sync on ``seq_lens`` would stall
    a host-bound step and break CUDA-graph capture. The card's SM count
    comes in as a number."""
    params = list(inspect.signature(pa.decode_splits).parameters)
    assert params == ["B", "KV", "s_max", "sms"]
    assert (pa.decode_splits(B=16, KV=8, s_max=4096, sms=H100_SXM_SMS)
            == pa.decode_splits(16, 8, 4096, H100_SXM_SMS))


def test_decode_splits_at_the_serving_shapes():
    sms = H100_SXM_SMS
    fill = pa.BLOCKS_PER_SM * sms
    # one split where B·KV already fills the card
    assert pa.decode_splits(64, 8, 4096, sms)[0] == 1
    assert pa.decode_splits(fill, 1, 1 << 16, sms)[0] == 1
    assert pa.decode_splits(fill - 1, 1, 1 << 16, sms)[0] > 1
    # the smoke's decode batch: 16 rows x 8 kv heads, 4096-token rows
    splits, chunk = pa.decode_splits(16, 8, 4096, sms)
    assert 2 <= splits and 16 * 8 * splits >= fill
    # one long row: as many splits as 256-key chunks allow
    assert pa.decode_splits(1, 8, 4096, sms) == (16, 256)
    # a context shorter than one minimum chunk stays whole
    assert pa.decode_splits(1, 8, 200, sms) == (1, 256)


def test_decode_splits_follow_the_sm_count():
    """A card with fewer SMs is filled by fewer blocks: at B·KV between the
    two fills only the larger card splits."""
    base = pa.BLOCKS_PER_SM * H100_PCIE_SMS
    assert pa.decode_splits(base, 1, 4096, H100_PCIE_SMS)[0] == 1
    assert pa.decode_splits(base, 1, 4096, H100_SXM_SMS)[0] > 1


def test_split_partials_merge_to_the_one_pass_plain_version():
    """Rows of limit 0 (no key: the output is 0, no 0/0), 1, exactly one
    chunk, one key past it, and ``max_keys`` (the whole context), cut into
    chunks with splits that see no key of a row: merged, they equal the
    one-pass plain version of the B6 entries (float32 p)."""
    rng = np.random.default_rng(0)
    B, H, K, D, chunk = 5, 4, 1, 16, 64
    S = 4 * chunk                                  # max_keys
    seq = torch.tensor([0, 1, chunk, chunk + 1, S])
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, K, D), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, K, D), dtype=np.float32))
    # the identity page table: row b is page b, one page of S keys
    table = torch.arange(B)[:, None]
    want = pa.pallas_paged_decode_plain(q, k, v, table, seq)
    scale = D ** -0.5
    lim = seq[:, None].expand(B, H)                # every head of a row: the same limit
    o, m, l = decode_partials_plain(q[:, 0], k[:, :, 0], v[:, :, 0], lim, chunk, scale)
    assert o.shape == (S // chunk, B, H, D)
    assert bool((m[1:, 0] == -torch.inf).all()) and bool((m[1:, 1] == -torch.inf).all())
    got = merge_partials_plain(o, m, l)
    assert bool(torch.isfinite(got).all())
    assert bool((got[0] == 0).all())               # limit 0: no key, output 0
    torch.testing.assert_close(got, want[:, 0], rtol=1e-5, atol=1e-5)


def test_merge_never_reads_an_empty_split():
    """An empty split's o is never read: garbage there (the kernel leaves
    it unwritten) changes nothing, NaN included."""
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.standard_normal((3, 2, 4), dtype=np.float32))
    m = torch.tensor([[0.5, -torch.inf], [-torch.inf, -torch.inf], [1.5, -torch.inf]])
    l = torch.tensor([[2.0, 0.0], [0.0, 0.0], [1.0, 0.0]])
    clean = merge_partials_plain(o, m, l)
    o[1] = torch.nan
    o[:, 1] = torch.nan
    dirty = merge_partials_plain(o, m, l)
    assert torch.equal(clean[0], dirty[0])
    assert bool((dirty[1] == 0).all())


# ------------------------------------------------------------------ K3

def _check_latent_cover(B, head_tiles, s_max, sms):
    splits, chunk = pa.latent_splits(B, head_tiles, s_max, sms)
    assert splits >= 1 and chunk % pa.KEY_TILE == 0
    assert splits * chunk >= s_max                 # the chunks cover S_max
    assert (splits - 1) * chunk < s_max            # and none lies wholly past it
    if splits > 1:
        assert chunk >= pa.LATENT_MIN_CHUNK_TILES * pa.KEY_TILE
        assert B * head_tiles < sms                # one K3 block an SM
        assert B * head_tiles * (splits - 1) < 2 * sms


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("B", [1, 2, 16, 64, 200])
@pytest.mark.parametrize("head_tiles", [1, 2])     # kimi-k2's 64 heads, deepseek-v3's 128
@pytest.mark.parametrize("s_max", [1, 63, 64, 255, 256, 1000, 4096, 32768])
def test_latent_splits_cover_the_context_in_whole_tiles(sms, B, head_tiles, s_max):
    _check_latent_cover(B, head_tiles, s_max, sms)


def test_latent_splits_read_no_tensor_value():
    """K3's choice takes sizes and the SM count only, as K1's does."""
    params = list(inspect.signature(pa.latent_splits).parameters)
    assert params == ["B", "head_tiles", "s_max", "sms"]


def test_latent_splits_at_the_serving_shapes():
    sms = H100_SXM_SMS
    assert pa.LATENT_HEADS == 64                   # one wgmma m64 tile of query heads
    # the MLA slot engine's decode batch: 16 rows x 2 head tiles, 4096-key rows
    splits, chunk = pa.latent_splits(16, 2, 4096, sms)
    assert splits > 1 and 16 * 2 * splits >= sms
    # one long row: as many splits as the least chunk allows
    assert pa.latent_splits(1, 2, 4096, sms) == (
        4096 // (pa.LATENT_MIN_CHUNK_TILES * pa.KEY_TILE),
        pa.LATENT_MIN_CHUNK_TILES * pa.KEY_TILE)
    # B·head tiles that fill the card (one block an SM): no split
    assert pa.latent_splits(66, 2, 4096, sms)[0] == 1
    assert pa.latent_splits(65, 2, 4096, sms)[0] > 1
    # a context shorter than one least chunk stays whole
    assert pa.latent_splits(1, 2, 100, sms)[0] == 1
    # a smaller card is filled by fewer blocks
    assert pa.latent_splits(60, 2, 4096, H100_PCIE_SMS)[0] == 1
    assert pa.latent_splits(60, 2, 4096, sms)[0] > 1
