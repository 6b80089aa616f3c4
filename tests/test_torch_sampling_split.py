"""B5 (``sampling_prep``) split across the card: the host-side split of
each row into chunks (``sampling_prep.prep_splits``, from V, B and the SM
count only) and the merge of the chunks' (max, sum) partials into the row's
logsumexp, in plain torch.

The Triton kernel runs only on the card (``chip_smoke.py`` holds it to the
plain version there, and an lse that leaves out one chunk to the bound).
Here: the chunks cover every column of every V once, the grid fills the
card, and the partials a program leaves (its chunk's max and the sum of
exp(x - max)) merged in chunk order equal ``torch.logsumexp`` and
``sampling_prep_plain``'s lse.
"""
import numpy as np
import pytest
import torch

from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

torch.set_num_threads(1)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
VOCABS = [151936, 129280, 50257, 512]   # Qwen3, DeepSeek-V3, GPT-2, the test configs
# float32 end to end; only the order of the lse sum differs
TOL = 1e-5


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("B", [1, 16, 64, 65, 384])
@pytest.mark.parametrize("V", VOCABS)
def test_chunks_cover_the_row_once(V, B, sms):
    """S chunks of ``chunk`` columns (a multiple of ``BLOCK_V``, the last
    one ragged) cover [0, V) once; the grid holds about PROGRAMS_PER_SM
    programs an SM unless the rows alone fill it or one chunk is the whole
    row."""
    S, chunk = sp.prep_splits(B, V, sms)
    assert S >= 1 and chunk % sp.BLOCK_V == 0
    seen = np.zeros(V, dtype=np.int64)
    for j in range(S):
        seen[j * chunk:min(V, (j + 1) * chunk)] += 1
    assert (seen == 1).all() and (S - 1) * chunk < V
    want = sp.PROGRAMS_PER_SM * sms
    if B < want and chunk > sp.BLOCK_V:
        # one block narrower would overshoot: the chunks are the widest that fill the card
        assert B * S <= want + B and B * -(-V // (chunk - sp.BLOCK_V)) > want - B
    if B >= want:
        assert S == 1


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
def test_split_follows_the_sm_count_and_rows(sms):
    """More rows, fewer chunks a row; a smaller card, no more chunks."""
    for V in VOCABS:
        s = [sp.prep_splits(B, V, sms)[0] for B in (1, 2, 16, 64, 384)]
        assert s == sorted(s, reverse=True)
        assert sp.prep_splits(16, V, H100_PCIE_SMS)[0] <= sp.prep_splits(16, V, H100_SXM_SMS)[0]


def _partials(scaled, S, chunk):
    """Each chunk's (max, sum of exp(x - max)), as a program leaves them."""
    m, s = [], []
    for j in range(S):
        x = scaled[:, j * chunk:(j + 1) * chunk]
        mx = x.max(-1).values
        m.append(mx)
        s.append(torch.exp(x - mx[:, None]).sum(-1))
    return torch.stack(m, 1), torch.stack(s, 1)


@pytest.mark.parametrize("sms", [H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("B", [1, 16, 65])
@pytest.mark.parametrize("V", VOCABS)
def test_partials_merged_in_chunk_order_are_the_lse(V, B, sms):
    """The row's partials merged in chunk order (the largest max, then the
    sums rescaled to it and added chunk by chunk) equal torch.logsumexp and
    ``sampling_prep_plain``'s lse within 1e-5, on rows with a repetition
    penalty, a suppressed EOS column (-1e30) and temperatures; the split
    of B rows, computed on three of them."""
    S, chunk = sp.prep_splits(B, V, sms)
    rng = np.random.default_rng(V + B)
    n = 3
    logits = torch.from_numpy((rng.standard_normal((n, V)) * 3).astype(np.float32))
    seen = torch.from_numpy(rng.random((n, V)) < 0.1)
    pen = torch.tensor([1.0, 1.3, 2.0])
    temp = torch.tensor([0.7, 1.0, 0.3])
    sup = torch.tensor([True, False, True])
    scaled, lse = sp.sampling_prep_plain(logits, seen, pen, temp, sup, V - 1)
    pm, ps = _partials(scaled, S, chunk)
    big = pm.max(-1).values
    tot = torch.zeros(n)
    for j in range(S):
        tot = tot + ps[:, j] * torch.exp(pm[:, j] - big)
    merged = (big + torch.log(tot))[:, None]
    torch.testing.assert_close(merged, torch.logsumexp(scaled, -1, keepdim=True),
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(merged, lse, rtol=TOL, atol=TOL)
    if S > 1:   # one chunk left out is far outside the bound
        keep = torch.arange(S) != S // 2
        off = (big + torch.log((ps[:, keep] * torch.exp(pm[:, keep] - big[:, None])).sum(-1)))
        assert bool(((off[:, None] - lse).abs() > TOL + TOL * lse.abs()).any())
