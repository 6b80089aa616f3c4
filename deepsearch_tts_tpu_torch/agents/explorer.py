"""Deep Web Explorer: the auxiliary-model ReAct sub-agent.

The port's own copy of ``agents/explorer.py`` (same behaviour; imports resolve in this package).

Reimplements the behavior of the reference's ``generate_deep_web_explorer``
(reference: scripts/deep_search.py:667-1108): an in-band token loop where the
aux model emits ``<|begin_search_query|>``/``<|begin_click_link|>`` actions,
the environment executes them (search API / page fetch + reader summary),
splices results back, and the loop continues until the model produces a
``**Final Information**`` summary or hits its budget — at which point a
finish is forced (:1077-1106). Per-trajectory dedup of repeated queries and
clicked URLs matches :819-859/:989-995; budgets (≈30k words, 10
interactions) match :695-696.

Unlike the reference this is a plain async function on one event loop — no
nested event loops, no thread executors.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

from ..evaluate.extract import extract_answer_fn
from ..prompts import qa as P

MAX_EXPLORER_WORDS = 30000
MAX_INTERACTIONS = 10


@dataclass
class ExplorerResult:
    analysis: str              # full raw interaction transcript (model side)
    prompt: str                # final prompt given to the model
    n_searches: int = 0
    n_clicks: int = 0


def _extract_between(text: str, begin: str, end: str) -> str | None:
    m = re.search(re.escape(begin) + r"(.*?)" + re.escape(end), text, re.DOTALL)
    return m.group(1).strip() if m else None


def _repair_dropped_stop(chunk: str) -> str:
    """Re-terminate in-band action tokens when a backend drops the stop
    string it matched (reference: scripts/deep_search.py:752-811 repairs
    <|end_search_query|>/<|end_click_link|> the same way)."""
    for begin, end in ((P.BEGIN_SEARCH_QUERY, P.END_SEARCH_QUERY),
                       (P.BEGIN_CLICK_LINK, P.END_CLICK_LINK)):
        if begin in chunk and end not in chunk.split(begin)[-1]:
            return chunk.rstrip() + end
    return chunk


async def run_explorer(
    search_query: str,
    search_intent: str,
    formatted_results: str,
    *,
    aux_client,
    search_backend,
    fetcher,
    stats=None,
    top_k: int = 10,
    max_interactions: int = MAX_INTERACTIONS,
    max_words: int = MAX_EXPLORER_WORDS,
    gen_opts: dict | None = None,
) -> ExplorerResult:
    from ..web.search import format_search_results

    gen_opts = dict(gen_opts or {})
    gen_opts.setdefault("max_tokens", 8192)
    prompt = P.get_deep_web_explorer_instruction(
        search_query, search_intent, formatted_results
    )
    output = ""
    seen_queries = {search_query}
    seen_urls: set[str] = set()
    n_search = n_click = 0
    interactions = 0
    finished = False

    stops = (P.END_SEARCH_QUERY, P.END_CLICK_LINK)
    while True:
        resp = await aux_client.complete(
            prompt + output, stop=stops, include_stop_str_in_output=True, **gen_opts
        )
        if stats is not None:
            stats.record_aux(resp.usage)
        chunk = _repair_dropped_stop(resp.text)
        output += chunk

        query = _extract_between(chunk, P.BEGIN_SEARCH_QUERY, P.END_SEARCH_QUERY)
        url = _extract_between(chunk, P.BEGIN_CLICK_LINK, P.END_CLICK_LINK)
        interactions += 1

        if "**Final Information" in chunk and query is None and url is None:
            finished = True
            break

        if query is not None:
            if query in seen_queries:
                result_block = "You already searched this query; use the results above."
            else:
                seen_queries.add(query)
                n_search += 1
                if stats is not None:
                    stats.record_search("explorer_search")
                try:
                    rows = await search_backend.search(query, top_k)
                    result_block = format_search_results(rows)
                except Exception as e:
                    result_block = f"Search error: {e}"
            output += f"\n{P.BEGIN_SEARCH_RESULT}\n{result_block}\n{P.END_SEARCH_RESULT}\n"
        elif url is not None:
            if url in seen_urls:
                result_block = "You already visited this page; its content was shown above."
            else:
                seen_urls.add(url)
                n_click += 1
                if stats is not None:
                    stats.record_search("page_fetch")
                try:
                    page = await fetcher.fetch_page(url)
                    reader_prompt = P.get_web_page_reader_instruction(
                        search_intent, page[:20000]
                    )
                    reader = await aux_client.complete(reader_prompt, max_tokens=2048)
                    if stats is not None:
                        stats.record_aux(reader.usage)
                    result_block = extract_answer_fn(reader.text, mode="summary",
                                                     extract_answer=True)
                except Exception as e:
                    result_block = f"Error reading page: {e}"
            output += f"\n{P.BEGIN_CLICK_RESULT}\n{result_block}\n{P.END_CLICK_RESULT}\n"
        else:
            # no action, no final marker → model is done talking
            finished = True
            break

        if interactions >= max_interactions or len(output.split()) > max_words:
            break

    if not finished and "**Final Information" not in output:
        # force a closing summary (reference :1077-1106)
        force_prompt = (
            prompt + output +
            "\n\nYou have used up your exploration budget. Based on everything "
            "above, produce your summary now, starting with **Final Information**\n\n"
            "**Final Information**"
        )
        resp = await aux_client.complete(force_prompt, **gen_opts)
        if stats is not None:
            stats.record_aux(resp.usage)
        output += "\n**Final Information**" + resp.text

    return ExplorerResult(analysis=output, prompt=prompt,
                          n_searches=n_search, n_clicks=n_click)
