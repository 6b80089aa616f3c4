"""Run a function on N ranks of one machine, each a process of its own
(``torch.multiprocessing``'s spawn start method), the way ``torchrun``
starts them: ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` set, then :func:`.distributed.initialize_multihost`.

:func:`run_ranks` is for tests and the card's smoke check: every rank gets
a collective timeout, the parent waits up to its own deadline, and on a
rank's failure or the deadline it kills every rank and raises with the
failing rank's traceback. Nothing is passed over.
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device_type, timeout_s, fn, args, out_q):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        import torch.distributed as dist

        from .distributed import initialize_multihost

        initialize_multihost(device_type=device_type, timeout_s=timeout_s)
        result = fn(rank, *args)
        out_q.put((rank, True, result))
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:   # reported to the parent, which fails the run
        out_q.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, args: tuple = (), *, device_type: str = "cpu",
              timeout_s: float = 120.0, collective_timeout_s: float | None = None) -> list:
    """``fn(rank, *args)`` on ``world`` ranks; returns their results in
    rank order. ``fn`` must be importable by module and name (the spawn
    start method re-imports it), its results picklable."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    ctimeout = collective_timeout_s or max(timeout_s - 5.0, 5.0)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, device_type, ctimeout, fn, args, out_q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                   f"did not finish within {timeout_s:.0f} s")
            try:
                rank, ok, val = out_q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and p.exitcode != 0 and r not in results]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [results[r] for r in range(world)]
