"""Token-in-band search agent (the WebThinker/demo decoding loop).

The port's own copy of ``demo/inband.py`` (same behaviour; imports resolve in this package).

Reimplements the behavior of the reference's demo agent (reference:
demo/run_logit.py:342-419): generate with ``<|end_search_query|>`` as a stop
sequence; when the model emits a search query, derive the search intent with
the aux model, run the search + explorer, splice the result back between
``<|begin_search_result|>``/``<|end_search_result|>``, and continue decoding
from the grown prompt — until a final answer or the search budget is hit.

On the engine this continuation hits the prefix cache: the grown prompt
shares all pages with the previous round, so each resume prefills only the
spliced result (the decode→tool→re-prefill cycle, SURVEY.md §3.4).

Yields streaming events so a UI (cli/demo.py) can render progress live.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import AsyncIterator

from ..evaluate.extract import extract_answer_fn
from ..prompts import qa as P
from .environment import Environment


@dataclass
class Event:
    kind: str      # 'text' | 'search' | 'result' | 'final'
    payload: str


async def run_inband_agent(
    question: str,
    env: Environment,
    client,
    aux_client,
    search_tool,
    task: str = "openqa",
) -> AsyncIterator[Event]:
    instruction = {
        "openqa": P.get_task_instruction_openqa,
        "multihop": P.get_task_instruction_multi_hop,
        "math": P.get_task_instruction_math,
        "choose": P.get_task_instruction_choose,
        "code": P.get_task_instruction_code,
    }[task](question, env.max_search_limit)

    env.prompt = instruction
    searches = 0

    while True:
        resp = await client.complete(
            env.prompt + env.output_so_far,
            stop=(P.END_SEARCH_QUERY,),
            include_stop_str_in_output=True,
            **env.gen_opts(),
        )
        chunk = resp.text
        env.output_so_far += chunk
        env.total_tokens += len(chunk.split())
        yield Event("text", chunk)

        if P.BEGIN_SEARCH_QUERY in chunk and P.END_SEARCH_QUERY in chunk:
            query = chunk.split(P.BEGIN_SEARCH_QUERY)[-1].split(P.END_SEARCH_QUERY)[0].strip()
            env.interactions += 1
            if searches >= env.max_search_limit:
                block = "Search budget exhausted. Provide your final answer now."
            elif query in env.executed_search_queries:
                block = "You already searched this; use the earlier results."
            else:
                env.executed_search_queries.add(query)
                searches += 1
                yield Event("search", query)
                intent_resp = await aux_client.complete(
                    P.get_search_intent_instruction(env.output_so_far[-3000:]),
                    max_tokens=256,
                )
                result = await search_tool.search_with_intent(
                    query, intent_resp.text.strip() or query
                )
                block = result["extracted_info"]
                yield Event("result", block)
            env.output_so_far += (
                f"\n{P.BEGIN_SEARCH_RESULT}\n{block}\n{P.END_SEARCH_RESULT}\n"
            )
            if env.over_budget():
                env.output_so_far += "\nI must answer now based on what I found.\n"
            continue

        # no search token → the model finished its reasoning
        answer = extract_answer_fn(env.output_so_far, mode="qa", extract_answer=True)
        yield Event("final", answer or env.output_so_far[-2000:])
        return
