"""Search engine adapters with a uniform result schema.

The port's own copy of ``web/search.py`` (same behaviour; imports resolve in this package).

Adapters for Serper (Google), Bing v7, and a deterministic replay backend
(web/replay.py). Result normalization matches the reference's
``extract_relevant_info`` family (reference: scripts/search/bing_search.py:414,
:912, :1197): every engine's response is flattened to rows of
``{id, title, url, site_name, date, snippet, context}``.

Network calls are gated: in a zero-egress environment only the replay
backend functions, which is exactly how the hermetic tests run (the
reference has no offline mode at all — SURVEY.md §4).
"""
from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Protocol

from .ratelimit import RateLimiter


def normalize_serper(data: dict, top_k: int = 10) -> list[dict]:
    out = []
    for i, item in enumerate(data.get("organic", [])[:top_k]):
        out.append({
            "id": i + 1,
            "title": item.get("title", ""),
            "url": item.get("link", ""),
            "site_name": item.get("source", ""),
            "date": item.get("date", ""),
            "snippet": item.get("snippet", ""),
            "context": "",
        })
    kg = data.get("knowledgeGraph")
    if kg and kg.get("description"):
        out.insert(0, {
            "id": 0, "title": kg.get("title", ""),
            "url": kg.get("website", kg.get("descriptionLink", "")),
            "site_name": "Knowledge Graph", "date": "",
            "snippet": kg.get("description", ""), "context": "",
        })
    return out


def normalize_bing(data: dict, top_k: int = 10) -> list[dict]:
    pages = (data.get("webPages") or {}).get("value", [])[:top_k]
    return [{
        "id": i + 1,
        "title": p.get("name", ""),
        "url": p.get("url", ""),
        "site_name": p.get("siteName", ""),
        "date": p.get("datePublished", "")[:10] if p.get("datePublished") else "",
        "snippet": p.get("snippet", ""),
        "context": "",
    } for i, p in enumerate(pages)]


class SearchBackend(Protocol):
    async def search(self, query: str, top_k: int = 10) -> list[dict]: ...


@dataclass
class SerperBackend:
    """Google results via the Serper API (the reference README's default)."""

    api_key: str
    endpoint: str = "https://google.serper.dev/search"
    rate: RateLimiter = field(default_factory=lambda: RateLimiter(10, burst=10))
    max_retries: int = 5

    async def search(self, query: str, top_k: int = 10) -> list[dict]:
        import urllib.request

        await self.rate.acquire()
        body = json.dumps({"q": query, "num": top_k}).encode()

        def _do():
            req = urllib.request.Request(
                self.endpoint, data=body,
                headers={"X-API-KEY": self.api_key, "Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read().decode())

        last_err: Exception | None = None
        for attempt in range(self.max_retries):
            try:
                data = await asyncio.get_running_loop().run_in_executor(None, _do)
                return normalize_serper(data, top_k)
            except Exception as e:
                last_err = e
                await asyncio.sleep(min(2 ** attempt, 30))
        raise RuntimeError(f"serper search failed after retries: {last_err}")


@dataclass
class BingBackend:
    """Bing Web Search v7."""

    subscription_key: str
    endpoint: str = "https://api.bing.microsoft.com/v7.0/search"
    market: str = "en-US"
    rate: RateLimiter = field(default_factory=lambda: RateLimiter(30, burst=10))
    max_retries: int = 5

    async def search(self, query: str, top_k: int = 10) -> list[dict]:
        import urllib.parse
        import urllib.request

        await self.rate.acquire()
        url = (f"{self.endpoint}?q={urllib.parse.quote(query)}"
               f"&count={top_k}&mkt={self.market}")

        def _do():
            req = urllib.request.Request(
                url, headers={"Ocp-Apim-Subscription-Key": self.subscription_key}
            )
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read().decode())

        last_err: Exception | None = None
        for attempt in range(self.max_retries):
            try:
                data = await asyncio.get_running_loop().run_in_executor(None, _do)
                return normalize_bing(data, top_k)
            except Exception as e:
                last_err = e
                await asyncio.sleep(min(2 ** attempt, 30))
        raise RuntimeError(f"bing search failed after retries: {last_err}")


@dataclass
class GoogleCSEBackend:
    """Google Programmable Search (Custom Search JSON API) — the reference's
    google_search.py capability (scripts/search/google_search.py)."""

    api_key: str
    cx: str
    endpoint: str = "https://www.googleapis.com/customsearch/v1"
    rate: RateLimiter = field(default_factory=lambda: RateLimiter(60, burst=10))
    max_retries: int = 5

    async def search(self, query: str, top_k: int = 10) -> list[dict]:
        import urllib.parse
        import urllib.request

        await self.rate.acquire()
        url = (f"{self.endpoint}?key={self.api_key}&cx={self.cx}"
               f"&q={urllib.parse.quote(query)}&num={min(top_k, 10)}")

        def _do():
            with urllib.request.urlopen(url, timeout=30) as r:
                return json.loads(r.read().decode())

        last_err: Exception | None = None
        for attempt in range(self.max_retries):
            try:
                data = await asyncio.get_running_loop().run_in_executor(None, _do)
                return [{
                    "id": i + 1,
                    "title": item.get("title", ""),
                    "url": item.get("link", ""),
                    "site_name": item.get("displayLink", ""),
                    "date": "",
                    "snippet": item.get("snippet", ""),
                    "context": "",
                } for i, item in enumerate(data.get("items", [])[:top_k])]
            except Exception as e:
                last_err = e
                await asyncio.sleep(min(2 ** attempt, 30))
        raise RuntimeError(f"google cse search failed after retries: {last_err}")


def normalize_pro(data: dict, top_k: int = 10) -> list[dict]:
    """Multi-source gateway normalizer (reference:
    scripts/search/bing_search.py:913-1052 extract_relevant_info_pro):
    handles Serper organic+knowledgeGraph payloads, Tencent Search pages
    (JSON strings under tencentSearchResults.Response.Pages), and Bing
    Search Pro (bingSearchProResults.webPages.value with dates/ratings)."""
    if "organic" in data and isinstance(data.get("organic"), list):
        return normalize_serper(data, top_k)

    out: list[dict] = []
    if not data or str(data.get("code")) != "200":
        return out

    tencent = data.get("tencentSearchResults")
    if tencent:
        pages = tencent.get("Response", {}).get("Pages", [])
        for i, page_str in enumerate(pages[:top_k]):
            try:
                page = json.loads(page_str)
            except (json.JSONDecodeError, TypeError):
                continue
            url = page.get("url", "")
            out.append({
                "id": i + 1,
                "title": page.get("title", ""),
                "url": url,
                "site_name": page.get("site", "") or
                             (url.split("/")[2] if url.count("/") >= 2 else ""),
                "date": page.get("date", "").split()[0] if page.get("date") else "",
                "snippet": page.get("passage", ""),
                "context": "",
            })
        return out

    bing = data.get("bingSearchProResults", {})
    for i, item in enumerate((bing.get("webPages") or {}).get("value", [])[:top_k]):
        info = {
            "id": i + 1,
            "title": item.get("name", ""),
            "url": item.get("url", ""),
            "site_name": item.get("displayUrl", "").split("/")[0]
                         if item.get("displayUrl") else "",
            "date": item.get("datePublished", "").split("T")[0]
                    if item.get("datePublished") else "",
            "snippet": item.get("snippet", ""),
            "context": "",
        }
        about = item.get("about") or []
        if about and "aggregateRating" in about[0]:
            r = about[0]["aggregateRating"]
            info["rating"] = {"value": r.get("ratingValue"),
                              "count": r.get("reviewCount"),
                              "max": r.get("bestRating")}
        out.append(info)
    return out


@dataclass
class BingProBackend:
    """Gateway search (the reference's Friday-API Bing-Search-Pro tier,
    bing_search.py:825-910): POST ``{"query", "api"}`` with bearer-token
    rotation over a comma-separated pool, rate-limited with randomized
    retry backoff; responses go through :func:`normalize_pro` so the same
    backend fronts Bing-Pro, Tencent, and Serper-shaped gateways.

    ``transport(url, payload, headers) -> dict`` is pluggable (tests /
    other gateways)."""

    token: str
    endpoint: str = "https://aigc.sankuai.com/v1/friday/api/search"
    api: str = "bing-search-pro"
    rate: RateLimiter = field(default_factory=lambda: RateLimiter(10, burst=10))
    max_retries: int = 8
    transport: object = None

    def _pick_token(self) -> str:
        import random

        toks = [t.strip() for t in self.token.split(",") if t.strip()]
        return random.choice(toks) if toks else ""

    def _do(self, payload: dict, headers: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(
            self.endpoint, data=json.dumps(payload).encode(), headers=headers)
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read().decode())

    async def search(self, query: str, top_k: int = 10) -> list[dict]:
        payload = {"query": query, "api": self.api}
        last_err: Exception | None = None
        for attempt in range(self.max_retries):
            await self.rate.acquire()
            headers = {"Authorization": f"Bearer {self._pick_token()}",
                       "Content-Type": "application/json"}
            try:
                if self.transport is not None:
                    data = self.transport(self.endpoint, payload, headers)
                else:
                    data = await asyncio.get_running_loop().run_in_executor(
                        None, self._do, payload, headers)
                return normalize_pro(data, top_k)
            except Exception as e:
                last_err = e
                await asyncio.sleep(min(1 + attempt, 10))
        raise RuntimeError(f"bing-pro search failed after retries: {last_err}")


def format_search_results(results: list[dict]) -> str:
    """Render normalized rows for an LLM prompt (JSON-lines style)."""
    blocks = []
    for r in results:
        blocks.append(json.dumps({
            "id": r.get("id"), "title": r.get("title"), "url": r.get("url"),
            "site_name": r.get("site_name"), "date": r.get("date"),
            "snippet": r.get("snippet"),
            "context": (r.get("context") or "")[:4000],
        }, ensure_ascii=False, indent=2))
    return "\n\n".join(blocks)
