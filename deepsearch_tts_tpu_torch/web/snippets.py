"""Snippet-context matching: locate a search snippet inside a fetched page

The port's own copy of ``web/snippets.py`` (same behaviour; imports resolve in this package).
and return surrounding context.

Same contract as the reference's ``extract_snippet_with_context``
(reference: scripts/search/bing_search.py:124-171): sentence-split the page,
score each sentence by word-set F1 against the snippet, and if the best
score clears 0.2 return ±``context_chars`` around that sentence, else fall
back to the page head. Sentence splitting here is regex-based (no nltk
download in a zero-egress environment); the F1 scoring semantics match.
"""
from __future__ import annotations

import re

_SENT_RE = re.compile(r"(?<=[.!?。！？])\s+")
_WORD_RE = re.compile(r"\w+")


def word_set_f1(a: str, b: str) -> float:
    wa, wb = set(_WORD_RE.findall(a.lower())), set(_WORD_RE.findall(b.lower()))
    if not wa or not wb:
        return 0.0
    inter = len(wa & wb)
    if inter == 0:
        return 0.0
    p, r = inter / len(wb), inter / len(wa)
    return 2 * p * r / (p + r)


def split_sentences(text: str) -> list[str]:
    return [s for s in _SENT_RE.split(text) if s.strip()]


def extract_snippet_with_context(
    full_text: str, snippet: str, context_chars: int = 2500
) -> tuple[bool, str]:
    """Return (matched, context window) for a snippet within page text."""
    try:
        full_text = full_text[:50000]
        snippet = re.sub(r"\s+", " ", (snippet or "").lower().strip())
        snippet = snippet.rstrip("…").rstrip("...")
        best_score, best_sent = 0.2, None
        for sent in split_sentences(full_text):
            score = word_set_f1(snippet, sent)
            if score > best_score:
                best_score, best_sent = score, sent
        if best_sent is not None:
            idx = full_text.find(best_sent)
            start = max(0, idx - context_chars)
            end = min(len(full_text), idx + len(best_sent) + context_chars)
            return True, full_text[start:end]
        return False, full_text[: 2 * context_chars]
    except Exception as e:
        return False, f"Failed to extract snippet context due to {e}"
