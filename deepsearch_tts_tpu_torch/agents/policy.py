"""Policy / verifier agent: the multi-turn tool-calling loop and its four
test-time-scaling modes.

Semantics match the reference's PolicyTool (reference:
scripts/deep_search.py:1112-3422):

* ``solve``  (:1723)  — tool loop until finish_reason=='stop' with a
  ``\\boxed{}`` answer (first boxed match is returned), search budget
  enforced with a "limit reached" tool message, iteration cap =
  max_search_calls + 5 returning an Error string.
* ``verify`` (:2116)  — same loop with the verifier system prompt and a
  ``[Question Start]...[Predicted Answer Start]...`` user message; the boxed
  value is a confidence score in [0,1].
* ``solve_budget_forcing`` (:1928) / ``verify_budget_forcing`` (:2323) —
  sequential test-time scaling: resume a *prior* message history with a
  user nudge granting extra search budget, re-entering the same loop.

Implementation differences by design: a single async state machine on one
event loop (the reference spawns a thread plus a fresh event loop per
search, :2643/:3926), trajectory state is an explicit dataclass, and the
model client may be the in-process engine (port of ``agents/policy.py``:
the same loop over the port's engine on a CUDA card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..evaluate.extract import extract_boxed, extract_confidence
from ..prompts import qa as P


@dataclass
class TrajectoryResult:
    answer: str
    messages: list[dict]
    search_results: list[dict]
    confidence: float | None = None
    n_search_calls: int = 0
    error: str | None = None
    selection: dict | None = None  # best-of-N selection trace


@dataclass
class PolicyAgent:
    client: Any
    search_tool: Any = None
    max_search_calls: int = 15
    gen_opts: dict = field(default_factory=dict)
    stats: Any = None
    tools: list = field(default_factory=lambda: [P.DEEP_WEBSEARCH_TOOL])
    verifier_version: int = 0
    # sequential-scaling mechanism for the *_budget_forcing modes:
    #   "text"  — the reference's user nudge only (scripts/deep_search.py:
    #             1935-1939 appends "I will give you up to N additional
    #             chances...")
    #   "logit" — the nudge PLUS on-device EOS suppression for the re-entry
    #             turn: the engine refuses to sample EOS until
    #             min_thinking_tokens have been generated
    #             (engine/sampling.py:80), forcing continued reasoning at the
    #             logit level instead of hoping the model obeys the prompt.
    #             The trace format is unchanged — the nudge message stays, so
    #             budget-forced runs remain diffable against reference runs.
    budget_forcing: str = "text"
    min_thinking_tokens: int = 512

    # ------------------------------------------------------------------ modes

    async def solve(self, question: str,
                    max_search_calls: int | None = None) -> TrajectoryResult:
        msc = max_search_calls or self.max_search_calls
        messages = [
            {"role": "system", "content": P.get_solver_system_prompt(msc)},
            {"role": "user", "content": question},
        ]
        return await self._run_loop(messages, msc, mode="solve")

    async def verify(self, question: str, pred_answer: str,
                     max_search_calls: int | None = None) -> TrajectoryResult:
        msc = max_search_calls or self.max_search_calls
        messages = [
            {"role": "system",
             "content": P.get_verifier_system_prompt(msc, self.verifier_version)},
            {"role": "user", "content": P.get_verify_user_message(question, pred_answer)},
        ]
        return await self._run_loop(messages, msc, mode="verify")

    async def solve_budget_forcing(self, messages: list[dict],
                                   max_search_calls: int | None = None) -> TrajectoryResult:
        msc = max_search_calls or self.max_search_calls
        messages = list(messages) + [{
            "role": "user", "content": P.get_budget_forcing_nudge(msc, "solve"),
        }]
        return await self._run_loop(messages, msc, mode="solve",
                                    first_turn_opts=self._force_opts())

    async def verify_budget_forcing(self, messages: list[dict],
                                    max_search_calls: int | None = None) -> TrajectoryResult:
        msc = max_search_calls or self.max_search_calls
        messages = list(messages) + [{
            "role": "user", "content": P.get_budget_forcing_nudge(msc, "verify"),
        }]
        return await self._run_loop(messages, msc, mode="verify",
                                    first_turn_opts=self._force_opts())

    def _force_opts(self) -> dict | None:
        """Extra generation opts for the budget-forcing re-entry turn."""
        if self.budget_forcing == "logit" and self.min_thinking_tokens > 0:
            return {"min_tokens": self.min_thinking_tokens}
        return None

    async def solve_best_of_n(
        self, question: str, n: int = 4,
        max_search_calls: int | None = None,
        verify_search_calls: int | None = None,
    ) -> TrajectoryResult:
        """Parallel test-time scaling with asymmetric verification — the
        paper's headline mode, first-class here (the reference realizes it as
        separate solve runs + verify runs + offline selection; SURVEY.md §0).

        N solver trajectories run concurrently (the engine batches them
        on the card); unique candidate answers are then fact-checked by the
        verifier, and the highest-confidence candidate wins (ties broken by
        majority vote among the N samples).
        """
        import asyncio

        solves = await asyncio.gather(
            *(self.solve(question, max_search_calls) for _ in range(n)),
            return_exceptions=True,
        )
        candidates: list[TrajectoryResult] = [
            s for s in solves
            if isinstance(s, TrajectoryResult) and not s.error and s.answer
        ]
        if not candidates:
            first = next((s for s in solves if isinstance(s, TrajectoryResult)), None)
            return first or TrajectoryResult(
                answer="Error: all samples failed", messages=[], search_results=[],
                error="all_samples_failed")

        counts: dict[str, int] = {}
        for c in candidates:
            counts[c.answer] = counts.get(c.answer, 0) + 1
        unique = list(counts)

        vbudget = verify_search_calls or max(1, (max_search_calls or
                                                 self.max_search_calls) // 2)
        verifies = await asyncio.gather(
            *(self.verify(question, ans, vbudget) for ans in unique),
            return_exceptions=True,
        )
        conf: dict[str, float] = {}
        for ans, v in zip(unique, verifies):
            conf[ans] = v.confidence if isinstance(v, TrajectoryResult) and \
                v.confidence is not None else 0.0

        best_ans = max(unique, key=lambda a: (conf[a], counts[a]))
        best = next(c for c in candidates if c.answer == best_ans)
        return TrajectoryResult(
            answer=best.answer, messages=best.messages,
            search_results=best.search_results,
            confidence=conf[best_ans],
            n_search_calls=sum(c.n_search_calls for c in candidates),
            selection={
                "candidates": [
                    {"answer": a, "votes": counts[a], "confidence": conf[a]}
                    for a in unique
                ],
                "n_samples": n,
            },
        )

    # ------------------------------------------------------------------- loop

    async def _run_loop(self, messages: list[dict], max_search_calls: int,
                        mode: str,
                        first_turn_opts: dict | None = None) -> TrajectoryResult:
        search_results: list[dict] = []
        search_calls = 0
        max_iterations = max_search_calls + 5
        iteration = 0

        while True:
            iteration += 1
            if iteration > max_iterations:
                return self._finish(
                    "Error: Maximum iterations reached without finding an answer.",
                    messages, search_results, mode, search_calls,
                    error="max_iterations",
                )

            # first_turn_opts (logit-level budget forcing) applies only to the
            # re-entry generation; subsequent turns sample normally
            opts = self.gen_opts
            if iteration == 1 and first_turn_opts:
                opts = {**self.gen_opts, **first_turn_opts}
            resp = await self.client.chat(messages, tools=self.tools, **opts)
            if self.stats is not None:
                self.stats.record_main(resp.usage)

            if resp.type == "error":
                return self._finish(resp.content or f"Error: {resp.error}",
                                    messages, search_results, mode, search_calls,
                                    error=resp.error or "client_error")

            messages.append(resp.message)

            if resp.type == "tool":
                for call in resp.tool_calls:
                    fn = call.get("function", {})
                    name = fn.get("name", "")
                    args = fn.get("arguments", "{}")
                    if isinstance(args, str):
                        import json as _json
                        try:
                            args = _json.loads(args)
                        except _json.JSONDecodeError:
                            args = {}
                    tool_msg = {"role": "tool", "tool_call_id": call.get("id", "")}
                    if name != "deep_websearch" or self.search_tool is None:
                        tool_msg["content"] = (
                            f"Tool {name} was called with arguments {args}"
                        )
                    elif search_calls >= max_search_calls:
                        tool_msg["content"] = (
                            f"You have reached the maximum number of search "
                            f"attempts ({max_search_calls}). Please provide your "
                            "final answer based on the information collected so far."
                        )
                    elif not args.get("search_query"):
                        tool_msg["content"] = ("Error: Empty search query. Please "
                                               "provide a valid search query.")
                    else:
                        search_calls += 1
                        result = await self.search_tool.search_with_intent(
                            args.get("search_query", ""),
                            args.get("search_intent", ""),
                        )
                        search_results.append(result)
                        tool_msg["content"] = result["extracted_info"]
                    messages.append(tool_msg)
                continue

            # normal text turn
            content = resp.content or ""
            has_boxed = "\\boxed{" in content
            if resp.finish_reason == "stop" and has_boxed:
                return self._finish(self._first_boxed(content), messages,
                                    search_results, mode, search_calls)
            # last-iteration fallback: budget exhausted and this is the final
            # pass before the iteration cap — return the best-effort answer
            # instead of an error row (was unreachable in r1: the cap check at
            # the loop head fired first)
            if search_calls >= max_search_calls and iteration >= max_iterations:
                ans = self._first_boxed(content) if has_boxed else content
                return self._finish(ans, messages, search_results, mode, search_calls)

    @staticmethod
    def _first_boxed(content: str) -> str:
        # balanced-brace scan (the reference's non-greedy regex truncates
        # nested \text{...}; we return the same first-match but intact)
        return extract_boxed(content, last=False) or content

    def _finish(self, answer: str, messages, search_results, mode, n_calls,
                error: str | None = None) -> TrajectoryResult:
        conf = None
        if mode == "verify":
            joined = answer if "\\boxed" in answer else f"\\boxed{{{answer}}}"
            conf = extract_confidence(joined)
            if conf is None:
                # answer may already be the bare boxed content
                try:
                    conf = max(0.0, min(1.0, float(answer.strip().rstrip("%")) /
                                        (100.0 if answer.strip().endswith("%") else 1.0)))
                except (ValueError, AttributeError):
                    conf = 0.0
        return TrajectoryResult(
            answer=answer, messages=messages, search_results=search_results,
            confidence=conf, n_search_calls=n_calls, error=error,
        )
