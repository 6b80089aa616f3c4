"""On-device sampling: repetition penalty → temperature → top-k → top-p →
min-p → categorical draw (port of ``engine/sampling.py``).

Everything is masking on the [B, V] logits with per-row parameters, so
heterogeneous requests share one batched call. The pre-window pass (penalty,
EOS suppression for ``min_tokens``, temperature, row logsumexp) always goes
through :func:`ops.sampling_prep.sampling_prep` — kernel B5 for a CUDA
tensor, its plain version for a CPU one. Then one exact top-``window``
(``torch.topk``, the port of ``approx_max_k(recall_target=1.0)``) replaces a
full-vocab sort; top-k / top-p / min-p are masks over the sorted window, with
top-p mass measured against the full-vocab softmax. Gumbel noise comes from
the caller's ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.sampling_prep import sampling_prep

NEG_INF = -1e30


class SamplingParams(NamedTuple):
    """Per-row sampler settings, all [B]-shaped tensors."""

    temperature: torch.Tensor        # 0 ⇒ greedy
    top_k: torch.Tensor              # 0 ⇒ disabled
    top_p: torch.Tensor              # 1.0 ⇒ disabled
    min_p: torch.Tensor              # 0.0 ⇒ disabled
    repetition_penalty: torch.Tensor  # 1.0 ⇒ disabled
    # logit-level budget forcing: suppress EOS until the row has produced
    # min_tokens (sequential budget forcing on-device, no re-prompt)
    min_tokens: torch.Tensor | None = None        # [B] int; 0 ⇒ disabled
    tokens_generated: torch.Tensor | None = None  # [B] int running count
    eos_id: int = -1


def _gumbel(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)).clamp(min=tiny))


def keep_mask(vals: torch.Tensor, lse: torch.Tensor, params: SamplingParams
              ) -> torch.Tensor:
    """Top-k / top-p / min-p keep mask over the sorted window ``vals``."""
    col = torch.arange(vals.shape[1], device=vals.device)[None, :]
    top_k = params.top_k[:, None]
    keep = (col < top_k) | (top_k <= 0)
    probs = torch.exp(vals - lse)
    cum_prev = torch.cumsum(probs, dim=-1) - probs
    top_p = params.top_p[:, None]
    keep &= (cum_prev < top_p) | (top_p >= 1.0)
    min_p = params.min_p[:, None]
    keep &= ((vals - vals[:, :1]) >= torch.log(min_p.clamp(min=1e-10))) \
        | (min_p <= 0.0)
    return keep


def prep_window(logits: torch.Tensor, params: SamplingParams,
                seen: torch.Tensor, window: int = 128):
    """Scaled logits, row lse and the sorted top-``window`` (values, ids)."""
    B, V = logits.shape
    window = min(window, V)
    temp_c = params.temperature.float().clamp(min=1e-6)
    if params.min_tokens is not None and params.eos_id >= 0:
        suppress = params.tokens_generated < params.min_tokens
        eos_id = params.eos_id
    else:
        suppress = torch.zeros((B,), dtype=torch.bool, device=logits.device)
        eos_id = -1
    scaled, lse = sampling_prep(logits.float().contiguous(), seen,
                                params.repetition_penalty.float().contiguous(),
                                temp_c.contiguous(), suppress.contiguous(), eos_id)
    vals, idx = torch.topk(scaled, window, dim=-1, sorted=True)
    return scaled, lse, vals, idx


def sample(logits: torch.Tensor, params: SamplingParams, seen: torch.Tensor,
           generator: torch.Generator | None = None, window: int = 128
           ) -> torch.Tensor:
    """Draw next tokens [B] (int64). Rows with temperature <= 0 are greedy.

    Exactness as in the JAX sampler: top-k exact for k <= window; top-p
    exact when the nucleus fits the window; rows with every filter disabled
    sample the full vocabulary by gumbel-argmax."""
    scaled, lse, vals, idx = prep_window(logits, params, seen, window)
    # the window is sorted, so column 0 is the argmax (temperature is a
    # positive per-row scalar: argmax(scaled) == argmax(penalized logits))
    greedy = idx[:, 0]
    keep = keep_mask(vals, lse, params)
    wvals = torch.where(keep, vals, torch.full_like(vals, NEG_INF))
    noise = _gumbel(wvals.shape, generator, wvals.device)
    win_col = torch.argmax(wvals + noise, dim=-1)
    sampled = torch.gather(idx, 1, win_col[:, None])[:, 0]

    # the full-vocab draw is computed unconditionally: branching on whether
    # some row needs it would sync the host with the device every step
    unfiltered = (params.top_k <= 0) & (params.top_p >= 1.0) & (params.min_p <= 0.0)
    full = torch.argmax(scaled + _gumbel(scaled.shape, generator, scaled.device),
                        dim=-1)
    sampled = torch.where(unfiltered, full, sampled)
    return torch.where(params.temperature <= 0.0, greedy, sampled)


def update_seen(seen: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mark newly produced tokens [B] in the presence mask [B, V] (in place)."""
    seen[torch.arange(tokens.shape[0], device=seen.device), tokens.long()] = True
    return seen
