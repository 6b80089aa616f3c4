"""Speculative decoding: n-gram drafts for K+1-token verify steps (port of
``engine/speculative.py``).

Prompt-lookup speculation: deep-search traces quote tool results and restate
earlier turns, so the next K tokens often already appear earlier in the
sequence. The engine drafts them on the device from its token history and
verifies all K+1 window positions in ONE forward: a decode step bound by
weight bytes reads the weights once for the whole window.

Exact-match acceptance: every window position is sampled from the true
conditional (the forward was fed the drafts), and a draft is accepted only
when the sample equals it, so greedy streams are identical to plain decoding
and sampled streams follow the same distribution (within one window the
repetition penalty sees the window-start ``seen`` set).

Both functions are plain torch on integer tensors and give the JAX
functions' results exactly.
"""
from __future__ import annotations

import torch


def ngram_draft(hist: torch.Tensor, lens: torch.Tensor, k: int, n: int = 2) -> torch.Tensor:
    """``k`` draft tokens per row [B, k]: the continuation of the most recent
    earlier occurrence of the row's last ``n``-gram.

    ``hist`` [B, S]: token at each absolute position, valid up to ``lens[b]``
    (the token about to be fed). A matched gram must end before the current
    one starts (``j <= lens - n``); continuation positions past ``lens`` and
    rows without a match repeat the last token."""
    B, S = hist.shape
    lens = lens.long()
    dev = hist.device
    gram = [torch.gather(hist, 1, (lens - (n - 1 - d)).clamp(0, S - 1)[:, None])
            for d in range(n)]
    M = S - n + 1
    match = torch.ones((B, M), dtype=torch.bool, device=dev)
    for d in range(n):
        match &= hist[:, d:M + d] == gram[d]
    j = torch.arange(M, device=dev)[None, :]
    valid = j <= (lens - n)[:, None]
    best = torch.where(match & valid, j, -1).amax(dim=1)
    cont = best[:, None] + n + torch.arange(k, device=dev)[None, :]
    ok = (best >= 0)[:, None] & (cont <= lens[:, None])
    draft = torch.gather(hist, 1, cont.clamp(0, S - 1))
    last = torch.gather(hist, 1, lens.clamp(0, S - 1)[:, None])
    return torch.where(ok, draft, last)


def accept_drafts(sampled: torch.Tensor, draft: torch.Tensor, active: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-match acceptance of ``sampled`` [B, K+1] (a true sample at each
    window position) against the fed ``draft`` [B, K]: the longest prefix of
    samples equal to their drafts, plus the first mismatching sample.

    Returns ``(ncons [B] tokens emitted (0 on inactive rows), nxt [B] the
    last emitted token, alive [B, K+1] emission mask, column 0 always
    true)``."""
    B, K1 = sampled.shape
    match = (sampled[:, :K1 - 1] == draft).to(torch.int32)
    alive = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=sampled.device),
                       torch.cumprod(match, dim=1).bool()], dim=1)
    ncons = torch.where(active, alive.sum(dim=1), 0)
    nxt = torch.gather(sampled, 1, (ncons - 1).clamp(0, K1 - 1)[:, None])[:, 0]
    return ncons, nxt, alive
