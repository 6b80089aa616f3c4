"""Async token-bucket rate limiter.

The port's own copy of ``web/ratelimit.py`` (same behaviour; imports resolve in this package).

Same role as the reference's RateLimiter guarding Jina/Serper/gateway quotas
(reference: scripts/search/bing_search.py:508-538 — 130/min Jina, 10/min
Serper); implementation is a monotonic-clock token bucket behind an asyncio
lock.
"""
from __future__ import annotations

import asyncio
import time


class RateLimiter:
    def __init__(self, rate_per_minute: int, burst: int | None = None):
        self.rate = rate_per_minute / 60.0
        self.capacity = burst if burst is not None else max(1, rate_per_minute // 10)
        self.tokens = float(self.capacity)
        self.updated = time.monotonic()
        self._lock = asyncio.Lock()

    async def acquire(self) -> None:
        while True:
            async with self._lock:
                now = time.monotonic()
                self.tokens = min(self.capacity, self.tokens + (now - self.updated) * self.rate)
                self.updated = now
                if self.tokens >= 1.0:
                    self.tokens -= 1.0
                    return
                wait = (1.0 - self.tokens) / self.rate
            await asyncio.sleep(wait)
