"""Batch trajectory runner: bounded-concurrency fan-out, periodic
checkpointing, graceful interrupt.

Reference semantics (reference: scripts/deep_search.py process_batch :2580,
verify_batch :2806, budget-forcing batches :3083/:3251): an asyncio
semaphore bounds in-flight trajectories (``--concurrent_limit``); partial
results are flushed to the output JSON every ``save_interval`` completions
and on SIGINT/exit; a failed trajectory becomes a result row with
``pred_answer = "Error: ..."`` instead of aborting the batch. Output rows
copy the input record and add ``pred_answer`` / ``messages`` /
``web_search`` (+ ``confidence_score`` / ``verification_searches`` for
verify modes, :2878-2880).

Because the model client is async end-to-end there are no thread executors;
hundreds of trajectories interleave on one loop while the engine batches
their steps on the card (port of ``agents/runner.py``).
"""
from __future__ import annotations

import asyncio
import json
import os
import signal
import time
from dataclasses import dataclass
from typing import Any, Sequence

from ..datasets.loaders import extract_question
from .policy import PolicyAgent, TrajectoryResult


@dataclass
class BatchRunner:
    agent: PolicyAgent
    output_dir: str = "./outputs"
    concurrent_limit: int = 32
    save_interval: int = 5
    mode: str = "solve"  # solve | verify | *_budget_forcing | solve_bestofn
    n_samples: int = 4   # best-of-N sample count
    stats: Any = None

    def result_path(self, timestamp: str | None = None) -> str:
        ts = timestamp or time.strftime("%Y%m%d_%H%M%S")
        prefix = "verifier_results" if self.mode.startswith("verify") else "policy_results"
        return os.path.join(self.output_dir, f"{prefix}_{ts}.json")

    async def run(self, problems: Sequence[dict],
                  result_file: str | None = None) -> list[dict]:
        os.makedirs(self.output_dir, exist_ok=True)
        result_file = result_file or self.result_path()
        self.last_result_file = result_file  # the path actually written
        sem = asyncio.Semaphore(self.concurrent_limit)
        lock = asyncio.Lock()
        done: list[dict] = []
        shutdown = asyncio.Event()

        def _save():
            with open(result_file, "w", encoding="utf-8") as f:
                json.dump(done, f, ensure_ascii=False, indent=2)

        async def one(problem: dict) -> dict | None:
            if shutdown.is_set():
                return None
            try:
                async with sem:
                    if shutdown.is_set():
                        return None
                    row = dict(problem)
                    tr = await self._run_one(problem)
                    row["pred_answer"] = tr.answer
                    row["messages"] = tr.messages
                    row["web_search"] = tr.search_results
                    if tr.confidence is not None:
                        row["confidence_score"] = tr.confidence
                        row["verification_searches"] = tr.n_search_calls
                    if tr.selection is not None:
                        row["best_of_n"] = tr.selection
            except Exception as e:
                row = dict(problem)
                row["pred_answer"] = f"Error: {e}"
                row["error"] = str(e)
            async with lock:
                done.append(row)
                if len(done) % self.save_interval == 0:
                    _save()
            return row

        loop = asyncio.get_running_loop()
        previous = None
        try:
            previous = signal.getsignal(signal.SIGINT)
            loop.add_signal_handler(signal.SIGINT, shutdown.set)
        except (NotImplementedError, ValueError):
            pass
        try:
            results = await asyncio.gather(*(one(p) for p in problems))
            results = [r for r in results if r is not None]
        finally:
            try:
                loop.remove_signal_handler(signal.SIGINT)
                if previous is not None:
                    signal.signal(signal.SIGINT, previous)
            except (NotImplementedError, ValueError):
                pass
            _save()
        return results

    async def _run_one(self, problem: dict) -> TrajectoryResult:
        question = extract_question(problem)
        if self.mode == "solve":
            return await self.agent.solve(question)
        if self.mode == "verify":
            pred = str(problem.get("pred_answer", problem.get("Pred_Answer", "")))
            return await self.agent.verify(question, pred)
        if self.mode == "solve_budget_forcing":
            return await self.agent.solve_budget_forcing(problem.get("messages", []))
        if self.mode == "verify_budget_forcing":
            return await self.agent.verify_budget_forcing(problem.get("messages", []))
        if self.mode == "solve_bestofn":
            return await self.agent.solve_best_of_n(question, n=self.n_samples)
        raise ValueError(f"unknown mode {self.mode!r}")

    def run_sync(self, problems: Sequence[dict],
                 result_file: str | None = None) -> list[dict]:
        return asyncio.run(self.run(problems, result_file))
