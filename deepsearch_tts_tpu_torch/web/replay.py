"""Deterministic record/replay web backend.

The port's own copy of ``web/replay.py`` (same behaviour; imports resolve in this package).

The reference has no offline or fake backend at all — every test run hits
live APIs (SURVEY.md §4). This module supplies the hermetic layer the test
strategy requires:

* :class:`ReplayStore` — JSON fixture of query→results and url→page text.
  In ``record`` mode it wraps live backends and captures their traffic; in
  ``replay`` mode it serves only the fixture (zero egress).
* :class:`ReplaySearchBackend` / :func:`replay_fetcher` plug into the same
  seams as the live adapters.
* :func:`synthetic_store` — generates an internally consistent fake web
  (pages contain the facts the search snippets promise) for agent tests.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field


@dataclass
class ReplayStore:
    searches: dict[str, list[dict]] = field(default_factory=dict)
    pages: dict[str, str] = field(default_factory=dict)
    path: str | None = None

    @classmethod
    def load(cls, path: str) -> "ReplayStore":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(searches=data.get("searches", {}), pages=data.get("pages", {}),
                   path=path)

    def save(self, path: str | None = None) -> None:
        path = path or self.path
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"searches": self.searches, "pages": self.pages}, f,
                      ensure_ascii=False, indent=1)

    def record_search(self, query: str, results: list[dict]) -> None:
        self.searches[query] = results

    def record_page(self, url: str, text: str) -> None:
        self.pages[url] = text


class ReplaySearchBackend:
    def __init__(self, store: ReplayStore, strict: bool = False):
        self.store = store
        self.strict = strict
        self.calls = 0

    async def search(self, query: str, top_k: int = 10) -> list[dict]:
        self.calls += 1
        if query in self.store.searches:
            return self.store.searches[query][:top_k]
        if self.strict:
            raise KeyError(f"replay miss for query: {query!r}")
        # fuzzy: longest shared-word-count match
        qw = set(query.lower().split())
        best, best_n = None, 0
        for q, res in self.store.searches.items():
            n = len(qw & set(q.lower().split()))
            if n > best_n:
                best, best_n = res, n
        return (best or [])[:top_k]


def replay_fetcher(store: ReplayStore, strict: bool = False):
    """raw_fetch-compatible callable serving recorded pages."""

    def fetch(url: str) -> tuple[bytes, str]:
        if url in store.pages:
            return store.pages[url].encode("utf-8"), "text/plain; charset=utf-8"
        if strict:
            raise KeyError(f"replay miss for url: {url}")
        return b"", "text/plain"

    return fetch


def synthetic_store(facts: dict[str, str]) -> ReplayStore:
    """Build a consistent fake web: one page per fact, one search row per
    fact keyed on its question keywords.

    facts: {question-ish query: answer sentence}
    """
    store = ReplayStore()
    for i, (query, fact) in enumerate(facts.items()):
        url = f"https://replay.test/{hashlib.md5(query.encode()).hexdigest()[:10]}"
        page = (f"Reference article {i}.\n{fact}\n"
                "Additional unrelated text for context padding. " * 3)
        store.record_page(url, page)
        store.record_search(query, [{
            "id": 1, "title": f"Article about {query[:40]}", "url": url,
            "site_name": "replay.test", "date": "2025-01-01",
            "snippet": fact[:160], "context": "",
        }])
    return store
