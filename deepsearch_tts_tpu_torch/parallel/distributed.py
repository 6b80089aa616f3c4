"""Multi-process initialization and cross-slice mesh construction (port of
``parallel/distributed.py``).

JAX runs one process that sees every device; PyTorch runs one process per
rank (``torchrun``). :func:`initialize_multihost` is therefore
``torch.distributed.init_process_group`` from its arguments, else from
torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), and a no-op for a single process, as JAX's is.

The backend follows the device the caller names, never a failure: gloo on
the CPU; on CUDA, NCCL when every rank of the host has a card of its own,
gloo when ranks share a card (NCCL refuses two ranks on one device), with
the transfers staged through host memory (``parallel/collectives.py``).
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

# a collective that waits longer than this fails the rank instead of hanging
DEFAULT_TIMEOUT_S = 300.0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: the CPU, or card ``LOCAL_RANK`` modulo the cards
    visible (ranks share a card when there are fewer cards than ranks)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r} (cpu or cuda)")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device type 'cuda' requested but no CUDA card is visible")
    return torch.device("cuda", local_rank() % n)


def backend_for(device_type: str, local_world: int) -> str:
    """gloo on the CPU and for ranks that share a card; NCCL when each of the
    host's ``local_world`` ranks has a card of its own."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device_type: str = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Initialize torch.distributed from the arguments or torchrun's env.

    No-op when single-process (the common dev case) or already initialized.
    On CUDA the rank's card becomes the current device first, so that
    NCCL and ``DeviceMesh`` see it.
    """
    if dist.is_initialized():
        return
    world = num_processes or int(os.environ.get("WORLD_SIZE", 1))
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None or world <= 1:
        return
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
        torch.cuda.init()
    dist.init_process_group(backend_for(device_type, local_world),
                            init_method=f"tcp://{coordinator_address}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))


def cross_slice_mesh(tp: int = 1, ep: int = 1, fsdp: int = 1, device_type: str = "cuda"):
    """Mesh with dp spanning hosts (outermost) and ep/tp innermost.

    Ranks are numbered host by host, so reshaping [dp, fsdp, ep, tp] keeps
    each inner group within one host as long as fsdp*ep*tp divides the
    ranks a host runs.
    """
    from .mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    inner = tp * ep * fsdp
    if n % inner:
        raise ValueError(f"{n} devices not divisible by fsdp*ep*tp={inner}")
    return make_mesh(dp=n // inner, fsdp=fsdp, ep=ep, tp=tp, device_type=device_type)
