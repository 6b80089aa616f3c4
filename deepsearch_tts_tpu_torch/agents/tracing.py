"""Counters, cost accounting, and statistics files.

The port's own copy of ``agents/tracing.py`` (same behaviour; imports resolve in this package).

Reference-compatible telemetry (reference: scripts/deep_search.py —
api_counters :1204-1207 / :3515-3523, token_counters :1550-1563,
calculate_cost :1225-1265, save_statistics :2973-3016): same JSON schema,
plus engine-side metrics the reference cannot have (tokens/sec/chip, prefix
cache hit rate) merged into the statistics file.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Counters:
    """Thread-safe named counters."""

    counts: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def as_dict(self) -> dict:
        with self._lock:
            return dict(self.counts)


@dataclass
class TokenUsage:
    prompt_tokens: int = 0
    completion_tokens: int = 0

    def add(self, prompt: int, completion: int) -> None:
        self.prompt_tokens += prompt
        self.completion_tokens += completion

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens


DEFAULT_PRICE_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "model_config", "aihubmix_price.json")


def load_price_config(path: str | None) -> dict:
    """Per-1K-token price table (reference: model_config/aihubmix_price.json,
    schema ``{model: {prompt_tokens: $, completion_tokens: $}}``; the
    ``input``/``output`` aliases are accepted too). With no explicit path,
    the repo-shipped table is used; a missing file loads empty with a
    warning instead of silently."""
    if not path:
        path = DEFAULT_PRICE_CONFIG
    if not os.path.exists(path):
        import sys

        print(f"warning: price config {path!r} not found; costs will be 0",
              file=sys.stderr)
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def calculate_cost(usage: TokenUsage, model_name: str, prices: dict) -> float:
    entry = prices.get(model_name) or {}
    pin = float(entry.get("prompt_tokens",
                          entry.get("input", entry.get("prompt", 0.0))))
    pout = float(entry.get("completion_tokens",
                           entry.get("output", entry.get("completion", 0.0))))
    return usage.prompt_tokens / 1000.0 * pin + usage.completion_tokens / 1000.0 * pout


class RunStatistics:
    """Aggregates a batch run's counters/usage and writes statistics_<ts>.json."""

    def __init__(self, model_name: str = "", aux_model_name: str = "",
                 price_config_path: str | None = None):
        self.model_name = model_name
        self.aux_model_name = aux_model_name
        self.prices = load_price_config(price_config_path)
        self.api_counters = Counters()
        self.main_usage = TokenUsage()
        self.aux_usage = TokenUsage()
        self.started = time.time()
        self.engine_stats: dict = {}

    def record_main(self, usage) -> None:
        self.api_counters.inc("main_model")
        self.main_usage.add(usage.prompt_tokens, usage.completion_tokens)

    def record_aux(self, usage) -> None:
        self.api_counters.inc("aux_model")
        self.aux_usage.add(usage.prompt_tokens, usage.completion_tokens)

    def record_search(self, category: str = "web_search") -> None:
        self.api_counters.inc(category)

    def summary(self) -> dict:
        wall = time.time() - self.started
        out = {
            "model_name": self.model_name,
            "aux_model_name": self.aux_model_name,
            "api_counters": self.api_counters.as_dict(),
            "token_usage": {
                "main": {
                    "prompt_tokens": self.main_usage.prompt_tokens,
                    "completion_tokens": self.main_usage.completion_tokens,
                    "total_tokens": self.main_usage.total_tokens,
                },
                "aux": {
                    "prompt_tokens": self.aux_usage.prompt_tokens,
                    "completion_tokens": self.aux_usage.completion_tokens,
                    "total_tokens": self.aux_usage.total_tokens,
                },
            },
            "cost": {
                "main": calculate_cost(self.main_usage, self.model_name, self.prices),
                "aux": calculate_cost(self.aux_usage, self.aux_model_name, self.prices),
            },
            "wall_time_s": wall,
        }
        out["cost"]["total"] = out["cost"]["main"] + out["cost"]["aux"]
        if self.engine_stats:
            out["engine"] = self.engine_stats
        return out

    def save(self, output_dir: str, timestamp: str | None = None) -> str:
        ts = timestamp or time.strftime("%Y%m%d_%H%M%S")
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, f"statistics_{ts}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.summary(), f, ensure_ascii=False, indent=2)
        return path
