"""Device mesh construction (port of ``parallel/mesh.py``).

Axis convention, outermost → innermost, as in JAX:

* ``dp``  — data parallel / independent batch shards
* ``pp``  — pipeline parallel over the layer stack
* ``fsdp``— parameter/optimizer sharding for training
* ``ep``  — expert parallel for MoE layers
* ``tp``  — tensor (Megatron-style) parallel (innermost: the fastest links)
* ``sp``  — sequence parallel for long prefill (aliases tp)

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
process group's ranks (one process a rank), with JAX's axis names in JAX's
order; its per-axis process groups carry the collectives.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

AXES = ("dp", "pp", "fsdp", "ep", "tp")


def make_mesh(dp: int = 1, fsdp: int = 1, ep: int = 1, tp: int = 1, pp: int = 1,
              device_type: str = "cuda"):
    """Build a named mesh with the standard axis order.

    The axis product must equal the number of ranks (``ValueError``
    otherwise, as JAX raises for devices). A single process with no process
    group gets a one-rank gloo group of its own.
    """
    from torch.distributed.device_mesh import DeviceMesh

    shape = (dp, pp, fsdp, ep, tp)
    want = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if want != have:
        raise ValueError(f"mesh {dict(zip(AXES, shape))} needs {want} devices, have {have}")
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    if device_type == "cuda" and not torch.cuda.is_initialized():
        # the rank's card must be current before DeviceMesh picks one
        from .distributed import local_device

        torch.cuda.set_device(local_device("cuda"))
        torch.cuda.init()
    ranks = torch.arange(want, dtype=torch.int).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axes_group(mesh, axes: tuple[str, ...]):
    """The process group of this rank's ranks along ``axes`` jointly (the
    others fixed), or None when they hold one rank. Every rank must call
    it, in the same order: each group is created on all of them."""
    import torch.distributed as dist

    names = tuple(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    size = math.prod(mesh.mesh.shape[i] for i in keep)
    if size == 1:
        return None
    other = [i for i in range(mesh.mesh.dim()) if i not in keep]
    rows = mesh.mesh.permute(other + keep).reshape(-1, size).tolist()
    mine = None
    for row in rows:
        g = dist.new_group(row)
        if dist.get_rank() in row:
            mine = g
    return mine


def best_mesh_shape(n_devices: int, prefer_tp: int | None = None) -> dict[str, int]:
    """Pick a serving-oriented mesh: as much TP as divides the device count
    (bounded by ``prefer_tp``), remainder to DP."""
    tp = prefer_tp or n_devices
    while tp > 1 and n_devices % tp:
        tp -= 1
    return {"dp": n_devices // tp, "pp": 1, "fsdp": 1, "ep": 1, "tp": tp}
