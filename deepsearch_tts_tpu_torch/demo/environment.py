"""Trajectory environment state for the token-in-band (demo) agent.

The port's own copy of ``demo/environment.py`` (same behaviour; imports resolve in this package).

Mirrors the role of the reference's Environment/SubEnvironment
(reference: demo/settings.py:6-181): one object holding the growing prompt,
token accounting, dedup sets, and the search/URL caches that the explorer
sub-environment shares. The model/search configuration lives on the
environment so a UI can rebuild agents cheaply per query.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Environment:
    model_name: str = "qwen3-8b"
    aux_model_name: str = "qwen3-4b"
    max_search_limit: int = 15
    max_tokens: int = 32768
    temperature: float = 0.7
    top_p: float = 0.8
    repetition_penalty: float = 1.05
    top_k: int = 20
    min_p: float = 0.05
    search_num: int = 10
    max_interaction_times: int = 10
    max_path_tokens: int = 20000
    keep_links: bool = True

    # mutable trajectory state
    prompt: str = ""
    output_so_far: str = ""
    total_tokens: int = 0
    executed_search_queries: set = field(default_factory=set)
    clicked_urls: set = field(default_factory=set)
    search_cache: dict = field(default_factory=dict)
    url_cache: dict = field(default_factory=dict)
    start_time: float = field(default_factory=time.time)
    interactions: int = 0

    def sub_environment(self) -> "Environment":
        """Explorer sub-env: fresh trajectory state, shared caches
        (reference: demo/settings.py SubEnvironment shares caches)."""
        sub = Environment(
            model_name=self.aux_model_name, aux_model_name=self.aux_model_name,
            max_search_limit=self.max_search_limit,
            search_num=self.search_num,
            max_interaction_times=self.max_interaction_times,
            keep_links=self.keep_links,
        )
        sub.search_cache = self.search_cache
        sub.url_cache = self.url_cache
        return sub

    def over_budget(self) -> bool:
        return (len(self.output_so_far.split()) > self.max_path_tokens
                or self.interactions >= self.max_interaction_times)

    def gen_opts(self) -> dict:
        return {
            "temperature": self.temperature, "top_p": self.top_p,
            "min_p": self.min_p, "top_k_sampling": self.top_k,
            "repetition_penalty": self.repetition_penalty,
            "max_tokens": min(self.max_tokens, 8192),
        }
