"""Programs: one unit of the engine's device work over static buffers, run
eagerly or captured once into a CUDA graph and replayed (the port of JAX's
jitted engine programs). The decode chunks (``decode_program.py``) and the
admission groups' prefills (``prefill_program.py``) are both programs.

A program's body is a function of engine-wide static buffers: the host
fills them before each call and the body reads nothing else the host
holds. :class:`Program` holds one key. On CUDA its first call runs the body
eagerly (building every kernel and every lazily allocated buffer it
touches, outside any capture) and then captures it into a
``torch.cuda.CUDAGraph`` in the engine's one graph pool on the engine's
capture stream, with the engine's generator registered; every later call
is a replay. On the CPU (the caller's explicit ``device="cpu"``) and under
a mesh the body runs eagerly every time.

A replay launches no Python: the kernel wrappers' launch counters
(``launches``, ``prefill_launches``) would not move. So a program records
each counter's change while it is captured, sets the counters back (a
capture launches nothing) and adds that change on each replay.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import torch

# the modules of the kernel wrappers that count their launches
_COUNTED = ("fused_layer", "moe", "sampling_prep", "slot_attention", "paged_attention",
            "flash_attention", "quant")
_counters: list | None = None


def launch_counters() -> list[tuple[object, str]]:
    """Every ``(wrapper, attribute)`` launch counter of the port's kernels."""
    global _counters
    if _counters is None:
        out = []
        for m in _COUNTED:
            mod = importlib.import_module(f"..ops.{m}", __package__)
            for fn in vars(mod).values():
                if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                    out += [(fn, a) for a in ("launches", "prefill_launches", "i8_launches")
                            if type(getattr(fn, a, None)) is int]
        _counters = out
    return _counters


class Program:
    """One key's device work: ``body()`` → its outputs, eager or
    (``capture``) captured once on ``stream`` into a CUDA graph in ``pool``
    with ``generator`` registered, and replayed from then on. ``free_cache``:
    give the allocator's cached blocks back to the device between the eager
    run and the capture (a prefill's wide intermediates, cached in the
    common pool, which the graph's private pool cannot take and a capture
    cannot free: else the widest key needs its peak twice)."""

    def __init__(self, key: tuple, body, *, capture: bool, generator=None, pool=None,
                 stream=None, free_cache: bool = False):
        self.key, self.body = key, body
        self.capture, self.generator, self.pool, self.stream = capture, generator, pool, stream
        self.free_cache = free_cache
        self.graph = None
        self.out: dict | None = None
        self.capture_s = 0.0
        self._deltas: list = []

    def __call__(self) -> dict:
        if self.graph is not None:
            self.graph.replay()
            for (fn, attr), d in self._deltas:
                setattr(fn, attr, getattr(fn, attr) + d)
            return self.out
        out = self.body()
        if self.capture:
            self._record()
        return out

    def _record(self) -> None:
        """Capture the body. A failure raises: there is no eager fallback."""
        counted = launch_counters()
        before = [getattr(fn, a) for fn, a in counted]
        if self.free_cache:
            torch.cuda.empty_cache()
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(self.generator)
        t0 = time.perf_counter()
        # on the engine's own side stream, without torch.cuda.graph's
        # device synchronize (a capture runs nothing); thread_local: the
        # server's threads keep running meanwhile
        with torch.cuda.stream(self.stream):
            g.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                out = self.body()
            except BaseException:
                with contextlib.suppress(Exception):
                    g.capture_end()
                raise
            g.capture_end()
        self.capture_s = time.perf_counter() - t0
        for (fn, a), b in zip(counted, before):
            if getattr(fn, a) != b:
                self._deltas.append(((fn, a), getattr(fn, a) - b))
                setattr(fn, a, b)
        self.graph, self.out = g, out
