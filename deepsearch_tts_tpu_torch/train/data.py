"""SFT data pipeline: JSONL → tokenized, padded, loss-masked batches (port
of ``train/data.py``, which is JAX-free: the same records, truncation,
padding, loss mask and ``np.random.default_rng(seed)`` shuffle).

Records are ``{"prompt": ..., "completion": ...}`` (loss on completion
tokens only — the SFT convention) or ``{"text": ...}`` (loss everywhere).
Examples are tokenized once with any tokenizer that has ``encode`` and
``eos_id`` (the port's ``engine/tokenizer.py``), truncated to ``max_len``,
padded to the batch max (or a pinned ``seq_len``), and shuffled per epoch
with a deterministic seed. Batches are numpy arrays; the trainer moves
them to its device.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class SFTExample:
    tokens: np.ndarray       # [T] int32, prompt + completion (+ eos)
    loss_start: int          # first position contributing to the loss


def load_sft_examples(path: str, tokenizer, max_len: int = 1024,
                      add_eos: bool = True) -> list[SFTExample]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "text" in rec:
                ids = tokenizer.encode(rec["text"])
                start = 1           # next-token loss from the first target
            else:
                p = tokenizer.encode(rec["prompt"])
                c = tokenizer.encode(rec["completion"])
                ids = list(p) + list(c)
                start = len(p)
            if add_eos and tokenizer.eos_id is not None:
                ids = list(ids) + [tokenizer.eos_id]
            ids = list(ids)[:max_len]
            if len(ids) < 2 or start >= len(ids):
                continue
            out.append(SFTExample(np.asarray(ids, np.int32), start))
    return out


def batches(examples: list[SFTExample], batch_size: int, *,
            seq_len: int | None = None, seed: int = 0, epochs: int = 1,
            drop_remainder: bool = True
            ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield ``(tokens [B, T], loss_mask [B, T])`` batches.

    ``loss_mask[b, t]`` weights the loss of PREDICTING token ``t`` (the
    trainer shifts internally: position t is predicted from t-1). Padding
    is token 0 with mask 0. ``seq_len`` pins T (one shape for every step);
    None pads each batch to its own max.
    """
    if not examples:
        return
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(len(examples))
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size and drop_remainder:
                continue
            exs = [examples[j] for j in idx]
            T = seq_len or max(len(e.tokens) for e in exs)
            toks = np.zeros((len(exs), T), np.int32)
            mask = np.zeros((len(exs), T), np.float32)
            for r, e in enumerate(exs):
                n = min(len(e.tokens), T)
                toks[r, :n] = e.tokens[:n]
                mask[r, e.loss_start:n] = 1.0
            yield toks, mask
