"""Prefill programs: one admission group's prefill as one unit of device
work (port of the JAX engine's ``_prefill_fn``, ``engine.py:1001-1106``).

JAX jits one program per ``(bucket, Gp, fresh, ring)``: the forward over
the group's rows padded to ``Gp`` (the ladder 1, 4, 16, capped by the token
budget), the first-token sample and the seen-mask fold, its first tokens
padded to ``MAX_PREFILL_GROUP`` so that admission injection feeds them to
the next decode chunk device to device. Here the body is a function of
static buffers (:class:`PrefillBuffers`) that the host fills before each
call, and the key gains ``P``: the page-table width the non-fresh branch
gathers (``None`` on the fresh branch, whose table covers the bucket). JAX
gathers the whole page budget; the port slices it, as its decode programs
do. On CUDA each key is one :class:`~.program.Program`, captured once into
the engine's graph pool and replayed.

Padding rows carry position -1 (no KV is written) and row ``max_slots``:
their seen-mask and token-history writes land in the spare row past the
engine's rows. Each row's seen row is the presence of its whole prompt
(uploaded at the key's context width, masked past the prompt's length)
plus its first token; a speculative engine's history row is the prompt.
"""
from __future__ import annotations

import torch

from .sampling import SamplingParams, sample


class PrefillBuffers:
    """The static inputs of every prefill program, ``G``
    (``MAX_PREFILL_GROUP``) rows: tokens and positions flat over ``n_tok``
    (a key reads ``[:Gp·bucket]`` as ``[Gp, bucket]``), the page tables at
    their full width (a key reads ``[:Gp, :width]``), ``seq_lens``,
    ``logits_idx``, ``rows`` (``B``: a padding row), the sampler's per-row
    fields, ``min_tokens``, and the prompts' ids flat over ``G ·
    max_seq_len`` (a key reads ``[:Gp·W]`` as ``[Gp, W]``)."""

    def __init__(self, G: int, B: int, n_tok: int, max_pages: int, max_seq_len: int, device):
        i64 = dict(dtype=torch.int64, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.tok = torch.zeros((n_tok,), **i64)
        self.pos = torch.full((n_tok,), -1, **i64)
        self.tables = torch.zeros((G, max_pages), **i64)
        self.seq_lens = torch.zeros((G,), **i64)
        self.logits_idx = torch.zeros((G,), **i64)
        self.rows = torch.full((G,), B, **i64)
        self.min_tokens = torch.zeros((G,), **i64)
        self.temperature = torch.full((G,), 0.7, **f32)
        self.top_k = torch.full((G,), 20, dtype=torch.int32, device=device)
        self.top_p = torch.full((G,), 0.8, **f32)
        self.min_p = torch.full((G,), 0.05, **f32)
        self.repetition_penalty = torch.full((G,), 1.05, **f32)
        self.ids = torch.zeros((G * max_seq_len,), **i64)

    def views(self, key: tuple, width: int, W: int) -> dict:
        """Key ``(bucket, Gp, ...)``'s views of the buffers: its rows, the
        page table at ``width`` pages and the prompts at ``W`` ids."""
        bucket, Gp = key[:2]
        n = Gp * bucket
        return {"tok": self.tok[:n].view(Gp, bucket), "pos": self.pos[:n].view(Gp, bucket),
                "tables": self.tables[:Gp, :width], "seq_lens": self.seq_lens[:Gp],
                "logits_idx": self.logits_idx[:Gp], "rows": self.rows[:Gp],
                "min_tokens": self.min_tokens[:Gp], "top_k": self.top_k[:Gp],
                "ids": self.ids[:Gp * W].view(Gp, W),
                **{f: getattr(self, f)[:Gp] for f in FLOAT_FIELDS}}


# the sampler's float fields, in the order the host uploads them
FLOAT_FIELDS = ("temperature", "top_p", "min_p", "repetition_penalty")


def prefill_body(eng, key: tuple):
    """The body of prefill program ``key = (bucket, Gp, fresh, ring, P)`` on
    engine ``eng``: the forward over the group's ``Gp`` rows (fresh causal,
    or over the cached prefix through ``P`` pages; ``ring``: sequence
    parallel over the mesh), the first-token sample of each row's last
    position, the seen-mask fold and a speculative engine's history rows.
    Returns ``{"first": [MAX_PREFILL_GROUP] int64}``, zero past ``Gp``."""
    bucket, Gp, fresh, ring, _ = key
    width, W = eng._prefill_widths_of(key)
    V = eng.cfg.vocab_size

    def body() -> dict:
        b = eng._pbufs.views(key, width, W)
        eos = -1 if eng.tokenizer.eos_id is None else eng.tokenizer.eos_id
        dev, seq_lens, rows = b["tok"].device, b["seq_lens"], b["rows"]
        logits, _ = eng._forward(b["tok"], b["pos"], b["tables"].contiguous(), seq_lens,
                                 logits_indices=b["logits_idx"], fresh=fresh,
                                 seq_parallel=eng.sp_impl if ring else None)
        # each row's prompt presence: ids past its length (and out of the
        # vocabulary) go to a spare column; a scatter of a scalar copies no
        # host value
        inside = torch.arange(W, device=dev)[None, :] < seq_lens[:, None]
        ids = b["ids"]
        seen_rows = torch.zeros((Gp, V + 1), dtype=torch.bool, device=dev)
        seen_rows = seen_rows.scatter_(1, torch.where(inside & (ids < V), ids, V),
                                       True)[:, :V].contiguous()
        sp = SamplingParams(*(b[f] for f in ("temperature", "top_k", "top_p", "min_p",
                                             "repetition_penalty")),
                            min_tokens=b["min_tokens"],
                            tokens_generated=torch.zeros_like(b["min_tokens"]), eos_id=eos)
        first = sample(logits[:, 0], sp, seen_rows, eng.generator)
        eng._seen_ext.index_copy_(0, rows, seen_rows)
        eng._seen_ext.index_put_((rows, first), torch.ones_like(first, dtype=torch.bool))
        if eng.hist is not None:
            hist_rows = torch.zeros((Gp, eng._hist_ext.shape[1]), dtype=torch.int64,
                                    device=dev)
            hist_rows[:, :W] = torch.where(inside, ids, 0)
            eng._hist_ext.index_copy_(0, rows, hist_rows)
        out = torch.zeros((eng.MAX_PREFILL_GROUP,), dtype=torch.int64, device=dev)
        out[:Gp] = first
        return {"first": out}

    return body
