"""Logical-axis → mesh-axis sharding rules (port of ``parallel/sharding.py``).

Models annotate parameters with *logical* axis names ("vocab", "embed",
"heads", "mlp", "expert", ...); a :class:`ShardingRules` table maps those to
mesh axes, so changing the table re-lays-out the whole model (serving TP vs
training FSDP) without touching model code. In JAX the table drives GSPMD,
which inserts the collectives. Here every rank holds its local slice of
each leaf (:func:`shard_pytree`) and the sharded forward calls the
collectives itself (``parallel/collectives.py``), Megatron style.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True)
class ShardingRules:
    """Mapping of logical axis name → mesh axis (or None = replicate)."""

    rules: dict[str, Any] = field(default_factory=dict)

    def axis(self, logical: str | None):
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, *logical_axes: str | None) -> tuple:
        """The mesh axis (or axes, or None) of each tensor dim: JAX's
        ``PartitionSpec`` as a plain tuple."""
        return tuple(self.axis(a) for a in logical_axes)


# Serving layout: megatron TP over heads/mlp; batch over dp; experts over ep.
SERVING_RULES = ShardingRules({
    "batch": "dp",
    "vocab": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "expert": "ep",
    "expert_mlp": "tp",
    "embed": None,
    "seq": None,
})

# Training layout: parameters sharded over fsdp, batch over (dp, fsdp).
TRAIN_RULES = ShardingRules({
    "batch": ("dp", "fsdp"),
    "vocab": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "expert": "ep",
    "expert_mlp": "tp",
    "embed": "fsdp",
    "seq": None,
})


def logical_to_spec(logical_axes: tuple[str | None, ...], rules: ShardingRules) -> tuple:
    return rules.spec(*logical_axes)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(spec: tuple, mesh_dim_names: tuple[str, ...]) -> list:
    """A spec as ``DTensor`` placements, one per mesh axis: ``Shard(d)``
    where tensor dim d is split over that axis, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh_dim_names]
    for d, entry in enumerate(spec):
        for ax in _axes(entry):
            out[mesh_dim_names.index(ax)] = Shard(d)
    return out


def _block(entry, sizes: dict[str, int], coords: dict[str, int]) -> tuple[int, int]:
    """(blocks a tensor dim splits into over ``entry``'s mesh axes, this
    rank's block)."""
    axes = [a for a in _axes(entry) if sizes.get(a, 1) > 1]
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return math.prod(sizes[a] for a in axes), idx


def local_slice(x: torch.Tensor, spec: tuple, sizes: dict[str, int], coords: dict[str, int],
                pad_dims: tuple[int, ...] = ()) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each tensor dim split
    evenly over the product of its mesh axes, the block chosen by the
    rank's coordinates (row-major over a dim's axes, as JAX lays out a
    multi-axis dim). A dim in ``pad_dims`` that does not divide is padded
    with zeros to the next multiple (the vocab rows); any other raises."""
    for d, entry in enumerate(spec):
        n, idx = _block(entry, sizes, coords)
        if n == 1:
            continue
        size = x.shape[d]
        if size % n:
            if d not in pad_dims:
                raise ValueError(f"dim {d} of size {size} does not split over {entry} ({n})")
            pad = -(-size // n) * n - size
            x = torch.cat([x, x.new_zeros(x.shape[:d] + (pad,) + x.shape[d + 1:])], dim=d)
            size += pad
        x = x.narrow(d, idx * (size // n), size // n)
    return x.contiguous()


def kv_heads_local(n_kv_heads: int, tp: int) -> tuple[int, int]:
    """(kv heads a rank holds, ranks holding each): K/tp heads where tp
    divides K; one head shared by tp/K ranks where K divides tp (JAX
    replicates the KV there, ``engine.py:464-468``: each rank here keeps
    the head its q heads read)."""
    if n_kv_heads % tp == 0:
        return n_kv_heads // tp, 1
    if tp % n_kv_heads == 0:
        return 1, tp // n_kv_heads
    raise ValueError(f"{n_kv_heads} kv heads do not split over tp={tp} "
                     f"(need K % tp == 0 or tp % K == 0)")


def local_config(cfg, tp: int):
    """The config a tp-sharded forward runs with: local q heads, local kv
    heads (:func:`kv_heads_local`) and local MLP widths; the vocab, the
    expert count and every other field stay global."""
    import dataclasses

    if tp == 1:
        return cfg
    names = {f.name for f in dataclasses.fields(cfg)}
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.n_heads} heads do not split over tp={tp}")
    new = {"n_heads": cfg.n_heads // tp}
    if "n_kv_heads" in names:
        new["n_kv_heads"] = kv_heads_local(cfg.n_kv_heads, tp)[0]
    for f in ("intermediate", "moe_intermediate", "dense_intermediate"):
        if f in names:
            if getattr(cfg, f) % tp:
                raise ValueError(f"{f}={getattr(cfg, f)} does not split over tp={tp}")
            new[f] = getattr(cfg, f) // tp
    return dataclasses.replace(cfg, **new)


def _scale_axes(ax: tuple) -> tuple:
    """The axes of an int8 leaf's [..., 1, N] scales: the contracted dim's
    dropped."""
    return ax[:-2] + (None, ax[-1])


def quantized_logical_axes(params: dict, axes_tree: dict) -> dict:
    """Expand a logical-axes tree to match quantized params (JAX
    ``ops/quant.py:90``): each ``{q, scales}`` leaf gets the original axes
    for ``q`` and the same axes with the contracted dim dropped (None) for
    its ``[..., 1, N]`` scales — so the scales of a row-parallel product
    (contracted dim sharded) are replicated and those of a column-parallel
    one split with its columns."""
    out = {}
    for name, ax in axes_tree.items():
        p = params.get(name)
        if isinstance(ax, dict):
            out[name] = quantized_logical_axes(p or {}, ax)
        elif isinstance(p, dict) and "q" in p and "scales" in p:
            ax = tuple(ax)
            out[name] = {"q": ax, "scales": _scale_axes(ax)}
        else:
            out[name] = tuple(ax)
    return out


def shard_pytree(params: dict, logical_tree: dict, mesh, rules: ShardingRules) -> dict:
    """Each rank's local slice of every leaf, per its logical-axis
    annotation (``logical_tree`` mirrors ``params`` with tuples of logical
    axis names; a leaf missing from it is replicated). The slices are new
    tensors, so the full tree can be freed. Vocab rows that do not split
    evenly are padded with zero rows."""
    from .mesh import mesh_shape

    sizes = mesh_shape(mesh)
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))

    def place(x, axes):
        if isinstance(x, dict):
            return {k: place(v, (axes or {}).get(k)) for k, v in x.items()}
        if axes is None:
            return x
        pads = tuple(d for d, a in enumerate(axes) if a == "vocab")
        return local_slice(x, rules.spec(*axes), sizes, coords, pads)

    return place(params, logical_tree)


# the packed single-device leaves a random draw makes (engine/weights.py),
# and the unpacked leaves their columns hold, in order
_PACKED = {"wqkv": ("wq", "wk", "wv"), "w_gateup": ("w_gate", "w_up")}


class LocalDraw:
    """This rank's slices of a param tree, cut one matrix at a time, so a
    rank never holds more than its share of the weights and one matrix on
    its device: a random draw's as it is drawn
    (``engine/weights.random_params(local=...)``: every matrix is still
    drawn whole, in its usual order), or a whole tree's (:meth:`place`).
    The result equals :func:`shard_pytree` of the whole tree, unpacked
    (``unpack_matmul_params``) and, with ``quantize``, quantized whole —
    each matrix is quantized whole before it is cut, its scales by
    :func:`quantized_logical_axes`. ``kv_rep`` > 1: this rank's kv head
    (``kv_head``) of ``wk`` / ``wv``, replicated over its ranks, as the
    engine keeps it where tp exceeds the kv heads."""

    def __init__(self, cfg, axes: dict, rules: ShardingRules, sizes: dict[str, int],
                 coords: dict[str, int], kv_rep: int = 1, kv_head: int = 0):
        self.cfg, self.axes, self.rules = cfg, axes, rules
        self.sizes, self.coords = sizes, coords
        self.kv_rep, self.kv_head = kv_rep, kv_head
        self._kept: set[int] = set()

    def _axes(self, path: tuple) -> tuple | None:
        node = self.axes
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
        if path[-1] in ("wk", "wv") and self.kv_rep > 1:
            return node[:-1] + (None,)
        return None if node is None else tuple(node)

    def _parts(self, path: tuple, n_cols: int) -> list:
        """(leaf name, its columns of the drawn matrix, its logical axes)."""
        names = _PACKED.get(path[-1], (path[-1],))
        cfg = self.cfg
        if path[-1] == "wqkv":
            hd, kd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
            widths = (hd, kd, kd)
        else:
            widths = (n_cols // len(names),) * len(names)
        out, c0 = [], 0
        for name, w in zip(names, widths):
            cols = slice(c0, c0 + w)
            if name in ("wk", "wv") and self.kv_rep > 1:
                D = cfg.head_dim
                cols = slice(c0 + self.kv_head * D, c0 + (self.kv_head + 1) * D)
            out.append((name, cols, self._axes(path[:-1] + (name,))))
            c0 += w
        return out

    def stack(self, path: tuple, shape: tuple, dtype, device, quantize: str | None):
        return _LocalStack(self, self._parts(path, shape[-1]), shape, dtype, device, quantize)

    def _cut(self, x: torch.Tensor, axes: tuple | None, lead: int) -> torch.Tensor:
        """This rank's block of one matrix (the stack's trailing dims)."""
        if axes is None:
            return x
        pads = tuple(d - lead for d, a in enumerate(axes) if a == "vocab")
        return local_slice(x, self.rules.spec(*axes[lead:]), self.sizes, self.coords, pads)

    def _lead(self, axes: tuple | None, shape: tuple) -> list:
        """Per stack dim: (its local size, the first global index here)."""
        spec = self.rules.spec(*axes[:len(shape)]) if axes else (None,) * len(shape)
        out = []
        for size, entry in zip(shape, spec):
            n, idx = _block(entry, self.sizes, self.coords)
            if size % n:
                raise ValueError(f"stack dim of size {size} does not split over {entry} ({n})")
            out.append((size // n, idx * (size // n)))
        return out

    def finish(self, params: dict) -> dict:
        """The tree with the packed leaves split into their parts and every
        leaf not cut by a local stack (norms, the router bias, leaves
        already int8) sliced."""
        def walk(tree, path):
            out = {}
            for k, v in tree.items():
                p = path + (k,)
                if isinstance(v, _Parts):
                    out.update(v)
                elif id(v) in self._kept:
                    out[k] = v
                elif isinstance(v, dict) and not _is_int8(v):
                    out[k] = walk(v, p)
                elif _is_int8(v):
                    ax = self._axes(p)
                    out[k] = v if ax is None else {
                        "q": self._cut(v["q"], ax, 0),
                        "scales": self._cut(v["scales"], _scale_axes(ax), 0)}
                else:
                    out[k] = self._cut(v, self._axes(p), 0)
            return out

        return walk(params, ())

    def place(self, params: dict, device=None, quantize: str | None = None) -> dict:
        """This rank's slices of a whole tree (packed or unpacked, on any
        device: a checkpoint loaded on the host), on ``device`` (None: each
        leaf's own): each matrix is moved there on its own, quantized whole
        where ``quantize`` names its leaf, and cut."""
        from ..ops.quant import QUANT_KEYS

        def walk(tree, path):
            out = {}
            for k, v in tree.items():
                dev = v.device if isinstance(v, torch.Tensor) and device is None else device
                if _is_int8(v):
                    if k in _PACKED:
                        raise ValueError("cannot unpack int8-quantized packed weights")
                    out[k] = {n: t.to(dev or t.device) for n, t in v.items()}
                elif isinstance(v, dict):
                    out[k] = walk(v, path + (k,))
                elif v.ndim < 2:
                    out[k] = v.to(dev)
                else:
                    st = self.stack(path + (k,), tuple(v.shape), v.dtype, dev,
                                    quantize if k in QUANT_KEYS else None)
                    for idx in np.ndindex(*v.shape[:-2]):
                        st.set(idx, slice(None), v[idx].to(dev))
                    out[k] = st.out
            return out

        return self.finish(walk(params, ()))


def _is_int8(v) -> bool:
    return isinstance(v, dict) and "q" in v and "scales" in v


class _Parts(dict):
    """The local leaves one packed draw was split into."""


class _LocalStack:
    """``engine/weights._Stack``'s interface for :class:`LocalDraw`: each
    whole [K, N] matrix set into it is rounded to ``dtype`` (quantized whole
    with ``quantize``), split into its parts, and this rank's block of each
    part is copied into the part's local stack; a matrix of a stack index
    another rank holds (an expert over ``ep``) is dropped."""

    def __init__(self, draw: LocalDraw, parts: list, shape: tuple, dtype, device,
                 quantize: str | None):
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize {quantize!r} (None or 'int8')")
        self.draw, self.parts, self.dtype, self.quantize = draw, parts, dtype, quantize
        nl = len(shape) - 2
        self.leads, outs = [], {}
        for name, cols, axes in parts:
            lead = draw._lead(axes, shape[:nl])
            w = cols.stop - cols.start
            q = draw._cut(torch.empty((shape[-2], w), device="meta"), axes, nl)
            local = tuple(n for n, _ in lead) + tuple(q.shape)
            if quantize is None:
                outs[name] = torch.empty(local, dtype=dtype, device=device)
            else:
                outs[name] = {"q": torch.empty(local, dtype=torch.int8, device=device),
                              "scales": torch.empty(local[:-2] + (1, local[-1]),
                                                    dtype=torch.float32, device=device)}
            self.leads.append(lead)
        for v in outs.values():
            draw._kept.add(id(v))
        self.outs = outs
        self.out = _Parts(outs) if len(parts) > 1 else outs[parts[0][0]]

    def set(self, idx: tuple, cols: slice, mat: torch.Tensor, last: bool = True) -> None:
        """Matrix ``idx``, drawn whole (``cols`` every column)."""
        m = mat.to(self.dtype).contiguous()
        if self.quantize:
            from ..ops.quant import quantize_int8

            q, s = quantize_int8(m)
        nl = len(idx)
        for (name, c, axes), lead in zip(self.parts, self.leads):
            li = []
            for i, (n, first) in zip(idx, lead):
                if not first <= i < first + n:
                    break
                li.append(i - first)
            else:
                li, out = tuple(li), self.outs[name]
                if self.quantize is None:
                    out[li].copy_(self.draw._cut(m[:, c], axes, nl))
                else:
                    out["q"][li].copy_(self.draw._cut(q[:, c], axes, nl))
                    s_axes = None if axes is None else _scale_axes(axes)
                    out["scales"][li].copy_(self.draw._cut(s[:, c], s_axes, nl))
