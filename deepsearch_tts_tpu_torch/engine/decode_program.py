"""Decode programs: one decode chunk as one unit of device work (port of the
JAX engine's one-program ``lax.scan`` chunk, ``engine.py:644-988``).

JAX jits ``decode_chunk_len`` steps, sampling inside, into one program per
``(slot_ctx, lane, spec, chunk_len)`` (and per page-table width, through the
table's shape). Here the chunk body is a function of engine-wide static
buffers (:class:`DecodeBuffers`): the carry (``last``, ``lens``), the
per-row sampler fields, ``min_tokens``, ``prompt_lens``, the page tables,
the admission-injection rows / tokens and the prefill lane's arrays. It
writes ``last`` and ``lens`` back in place (that write *is* the carry the
next chunk starts from), marks the engine's seen mask (and a speculative
engine's token history) in place and returns the chunk's tokens.

:class:`~.program.Program` holds one key ``(P, slot_ctx, lane, spec,
chunk_len)``: ``P`` the page-table width the chunk reads (JAX's jit
specialises on it through the table's shape), ``chunk_len`` None for a full
chunk; on CUDA it is captured once and replayed (``program.py``).
"""
from __future__ import annotations

import torch

from .sampling import SamplingParams, sample, update_seen
from .speculative import accept_drafts, ngram_draft


class DecodeBuffers:
    """The engine-wide static inputs of every decode program, one set for
    ``B`` rows: the carry ``last`` / ``lens``, ``act``, the page tables at
    their full width (a program reads ``[:, :P]``), the sampler's per-row
    fields, ``min_tokens``, ``prompt_lens``, ``n_inject`` groups of
    injected first tokens and their rows (``B``: dropped) and, with a
    prefill lane of ``lane`` rows, the lane's arrays for ``chunk`` steps
    (``lane_max_act`` activations, slot ``B``: none). ``last_ext`` has one
    row past ``last`` that takes the dropped injection scatters."""

    def __init__(self, B: int, max_pages: int, chunk: int, n_inject: int, max_group: int,
                 lane: int, lane_max_act: int, device):
        i64 = dict(dtype=torch.int64, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.last_ext = torch.zeros((B + 1,), **i64)
        self.last = self.last_ext[:B]
        self.lens = torch.zeros((B,), **i64)
        self.act = torch.zeros((B,), dtype=torch.bool, device=device)
        self.tables = torch.zeros((B, max_pages), **i64)
        self.temperature = torch.full((B,), 0.7, **f32)
        self.top_k = torch.full((B,), 20, dtype=torch.int32, device=device)
        self.top_p = torch.full((B,), 0.8, **f32)
        self.min_p = torch.full((B,), 0.05, **f32)
        self.repetition_penalty = torch.full((B,), 1.05, **f32)
        self.min_tokens = torch.zeros((B,), **i64)
        self.prompt_lens = torch.zeros((B,), **i64)
        self.inj_rows = torch.full((n_inject, max_group), B, **i64)
        self.inj_toks = torch.zeros((n_inject, max_group), **i64)
        if lane:
            self.ltok = torch.zeros((chunk, lane), **i64)
            self.lpos = torch.full((chunk, lane), -1, **i64)
            self.ltab = torch.zeros((chunk, max_pages), **i64)
            self.lrow = torch.zeros((chunk,), **i64)
            self.act_slots = torch.full((lane_max_act,), B, **i64)
            self.act_steps = torch.zeros((lane_max_act,), **i64)


def chunk_body(eng, key: tuple):
    """The body of decode program ``key`` on engine ``eng``: admission
    injection into ``last``, then ``chunk_len`` decode (or verify) steps,
    then the lane's first tokens; writes the carry back."""
    P, slot_ctx, lane, spec, chunk_len = key
    chunk = chunk_len or eng.decode_chunk_len

    def body() -> dict:
        bufs, B = eng._bufs, eng.max_slots
        # injected rows take their first token from the prefill's output
        bufs.last_ext.scatter_(0, bufs.inj_rows.view(-1), bufs.inj_toks.view(-1))
        tables = bufs.tables[:, :P].contiguous()
        eos = -1 if eng.tokenizer.eos_id is None else eng.tokenizer.eos_id
        samp = SamplingParams(bufs.temperature, bufs.top_k, bufs.top_p, bufs.min_p,
                              bufs.repetition_penalty, min_tokens=bufs.min_tokens, eos_id=eos)
        if spec:
            out = _spec_steps(eng, bufs, tables, samp, slot_ctx, chunk)
        else:
            out = _steps(eng, bufs, tables, samp, P, slot_ctx, lane, chunk)
        bufs.last.copy_(out.pop("last"))
        bufs.lens.copy_(out.pop("lens"))
        return out

    return body


def _steps(eng, bufs, tables, samp, P, slot_ctx, lane, chunk) -> dict:
    """Plain decode steps (JAX ``engine.py:719-750``); the lane variant
    carries the lane's rows on every step, padding (position -1) on steps
    with no prompt, as JAX's lane program does (``engine.py:912-947``)."""
    last, lens, act, plens = bufs.last, bufs.lens, bufs.act, bufs.prompt_lens
    B = last.shape[0]
    act_i = act.long()
    toks, lane_logits = [], []
    for i in range(chunk):
        sp = samp._replace(tokens_generated=lens - plens + 1)
        pos = torch.where(act, lens, torch.full_like(lens, -1))[:, None]
        kw = {} if not lane else dict(lane_tokens=bufs.ltok[i], lane_positions=bufs.lpos[i],
                                      lane_table=bufs.ltab[i, :P], lane_logit_row=bufs.lrow[i])
        logits, _ = eng._forward(last[:, None], pos, tables, lens + act_i, slot_ctx=slot_ctx,
                                 **kw)
        if lane:
            lane_logits.append(logits[B, 0])
        nxt = sample(logits[:B, 0], sp, eng.seen, eng.generator)
        nxt = torch.where(act, nxt, last)
        update_seen(eng.seen, nxt)
        lens = lens + act_i
        last = nxt
        toks.append(nxt)
    out = {"toks": torch.stack(toks, dim=1), "last": last, "lens": lens}
    if lane:
        out["act_first"] = _lane_first(eng, bufs, torch.stack(lane_logits), samp, chunk)
    return out


def _lane_first(eng, bufs, lane_logits, samp, chunk: int) -> torch.Tensor:
    """First tokens [A] of the prompts the lane completed this chunk (JAX
    ``engine.py:957-986``): each activation's seen row is its prompt's
    token presence, built on the device from its step's lane tokens,
    sampled from that step's lane logits; slot ``B`` (no activation) lands
    in the seen mask's spare row."""
    B, V = eng.max_slots, eng.cfg.vocab_size
    slots, steps = bufs.act_slots, bufs.act_steps.clamp(0, chunk - 1)
    slot_c = slots.clamp(0, B - 1)
    toks = bufs.ltok[steps]                                   # [A, Tp]
    ok = (bufs.lpos[steps] >= 0) & (toks < V)
    # scatters of scalars and device tensors only: a capture copies no host value
    seen_a = torch.zeros((toks.shape[0], V + 1), dtype=torch.bool, device=toks.device)
    seen_a = seen_a.scatter_(1, torch.where(ok, toks, V), True)[:, :V].contiguous()
    sp = SamplingParams(*(f[slot_c] for f in samp[:5]), min_tokens=samp.min_tokens[slot_c],
                        tokens_generated=torch.zeros_like(slots), eos_id=samp.eos_id)
    eng._seen_ext.index_copy_(0, slots, seen_a)
    first = sample(lane_logits[steps], sp, seen_a, eng.generator)
    eng._seen_ext.index_put_((slots, first), torch.ones_like(first, dtype=torch.bool))
    return first


def _repeat_rows(t: torch.Tensor, k: int) -> torch.Tensor:
    """Each row of ``t`` k times in a row (``repeat_interleave`` by a
    constant, without its host-side size computation)."""
    return t[:, None].expand(t.shape[0], k, *t.shape[1:]).reshape(t.shape[0] * k,
                                                                   *t.shape[1:])


def _spec_steps(eng, bufs, tables, samp, slot_ctx, chunk) -> dict:
    """Speculative verify steps (JAX ``engine.py:794-874``): the history
    invariant ``hist[b, lens[b]] == last[b]`` first, then ``chunk`` verify
    steps with the per-row sampler fields repeated per window position."""
    last, lens = bufs.last, bufs.lens
    K1, B, S = eng.spec_k + 1, last.shape[0], eng.max_seq_len
    eng.hist[torch.arange(B, device=last.device), lens.clamp(0, S - 1)] = last
    samp = SamplingParams(*(_repeat_rows(f, K1) for f in samp[:5]),
                          min_tokens=_repeat_rows(samp.min_tokens, K1), eos_id=samp.eos_id)
    toks, cnts = [], []
    for _ in range(chunk):
        last, lens, t, ncons = spec_step(eng, last, lens, bufs.act, tables, slot_ctx, samp,
                                         bufs.prompt_lens, eng.seen, eng.hist)
        toks.append(t)
        cnts.append(ncons)
    return {"toks": torch.stack(toks, dim=1), "cnts": torch.stack(cnts, dim=1),
            "last": last, "lens": lens}


def spec_step(eng, last, lens, act, tables, slot_ctx, samp, plens, seen, hist):
    """One speculative verify step (JAX ``engine.py:814-864``): draft
    ``spec_k`` tokens a row, one forward over the window ``[last, drafts]``
    at positions ``lens..lens+K`` (-1 on inactive rows), one sampler pass
    over all B·(K+1) positions, exact-match acceptance. ``samp`` holds the
    per-row sampler fields and ``min_tokens`` repeated per window position.
    Marks the emitted tokens in ``seen`` and ``hist`` (in place); returns
    ``(next last token, lens + emitted, window samples [B,K+1], emitted
    counts [B])``."""
    K1 = eng.spec_k + 1
    B, S = last.shape[0], eng.max_seq_len
    off = torch.arange(K1, device=last.device)[None, :]
    draft = ngram_draft(hist[:, :S], lens, eng.spec_k, n=eng.spec_ngram)
    win = torch.cat([last[:, None], draft], dim=1)
    pos = torch.where(act[:, None], lens[:, None] + off, -1)
    logits, _ = eng._forward(win, pos, tables, lens + K1 * act.long(), slot_ctx=slot_ctx)
    # the window sees the window-start seen set (JAX's documented
    # approximation); tokens_generated counts each position's own
    sp = samp._replace(tokens_generated=((lens - plens + 1)[:, None] + off).reshape(-1))
    t = sample(logits.reshape(B * K1, -1), sp, _repeat_rows(seen, K1),
               eng.generator).reshape(B, K1)
    ncons, nxt, alive = accept_drafts(t, draft, act)
    emit = alive & act[:, None]
    # unemitted positions re-mark a token already present: the row's
    # first sample (emitted) or, on an inactive row, its last token
    fill = torch.where(act, t[:, 0], last)[:, None]
    seen.scatter_(1, torch.where(emit, t, fill), True)
    posw = lens[:, None] + 1 + off
    hist.scatter_(1, torch.where(emit & (posw < S), posw, S), t)
    return torch.where(act, nxt, last), lens + ncons, t, ncons
