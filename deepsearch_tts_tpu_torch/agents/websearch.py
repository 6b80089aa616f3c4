"""WebSearchTool: one ``deep_websearch`` tool call end-to-end.

The port's own copy of ``agents/websearch.py`` (same behaviour; imports resolve in this package).

Pipeline per call (reference: scripts/deep_search.py WebSearchTool :3424,
search_with_intent :3743-3905): search API → normalize top-k → fetch the
result pages concurrently → snippet-context matching per page → format docs
→ run the Deep Web Explorer sub-agent → extract its **Final Information**
summary. Returns the same dict shape the reference logs into its traces
(``extracted_info`` / ``search_query`` / ``search_intent`` /
``formatted_documents`` / ``analysis`` — only ``extracted_info`` re-enters
the policy conversation, :1855-1859).

Pure async on the caller's event loop — the reference's per-call fresh event
loop (:3926-3929) is gone by design.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..evaluate.extract import extract_answer_fn
from ..web.search import format_search_results
from ..web.snippets import extract_snippet_with_context
from .explorer import run_explorer


@dataclass
class WebSearchTool:
    search_backend: object
    fetcher: object
    aux_client: object
    top_k: int = 10
    stats: object = None
    use_explorer: bool = True
    search_cache: dict = field(default_factory=dict)
    gen_opts: dict = field(default_factory=dict)

    async def search(self, query: str, top_k: int | None = None) -> list[dict]:
        top_k = top_k or self.top_k
        if query in self.search_cache:
            return self.search_cache[query]
        if self.stats is not None:
            # per-backend category, like the reference's bing_search /
            # google_search / page_fetch counters (deep_search.py:3515-3523)
            name = type(self.search_backend).__name__.replace("Backend", "").lower()
            self.stats.record_search(f"{name}_search")
            self.stats.record_search("web_search")
        rows = await self.search_backend.search(query, top_k)
        self.search_cache[query] = rows
        return rows

    async def search_with_intent(self, search_query: str, search_intent: str) -> dict:
        try:
            rows = await self.search(search_query)
        except Exception as e:
            return {
                "extracted_info": f"Search failed: {e}",
                "search_query": search_query,
                "search_intent": search_intent,
                "formatted_documents": "",
                "analysis": "",
            }

        urls = [r["url"] for r in rows if r.get("url")]
        if self.stats is not None and urls:
            self.stats.record_search("page_fetch")
        try:
            pages = await self.fetcher.fetch_pages(urls)
        except Exception:
            pages = {}
        for r in rows:
            text = pages.get(r.get("url"), "")
            if text and not text.startswith("Error"):
                _, ctx = extract_snippet_with_context(text, r.get("snippet", ""),
                                                      context_chars=2000)
                r["context"] = ctx
        formatted = format_search_results(rows)

        if not self.use_explorer:
            return {
                "extracted_info": formatted[:8000],
                "search_query": search_query,
                "search_intent": search_intent,
                "formatted_documents": formatted,
                "analysis": "",
            }

        exp = await run_explorer(
            search_query, search_intent, formatted,
            aux_client=self.aux_client,
            search_backend=self.search_backend,
            fetcher=self.fetcher,
            stats=self.stats,
            top_k=self.top_k,
            gen_opts=self.gen_opts,
        )
        info = extract_answer_fn(exp.analysis, mode="summary", extract_answer=True)
        if not info:
            info = "No helpful information found."
        return {
            "extracted_info": info,
            "search_query": search_query,
            "search_intent": search_intent,
            "formatted_documents": formatted,
            "analysis": exp.analysis,
        }
