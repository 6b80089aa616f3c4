"""The collectives XLA inserts for the JAX package's mesh path, called
explicitly by the port's sharded forward (Megatron style), and
:class:`Parallel`, a rank's place in the mesh.

* :func:`all_reduce` — the sum after a row-parallel product (``wo``,
  ``w_down``, the expert outputs) and of a vocab-parallel embedding.
* :func:`all_gather` — the logits of a column-parallel ``lm_head``.
* :func:`all_to_all` — JAX's tiled ``lax.all_to_all``: Ulysses' exchange,
  head- ↔ sequence-sharded activations, ``moe_ep_alltoall``'s dispatch.
* :func:`ppermute` — JAX's ``lax.ppermute`` on a ring (each rank sends to
  the next): ring attention's K/V rotation, the pipeline's hand-off.

Each takes a process group (None or a one-rank group: the identity). Where
the group's backend is gloo and the tensor lies on a card — ranks sharing
one card, which NCCL refuses — gloo has no CUDA form of most collectives,
so the transfer is staged through host memory here, and only here; the
compute stays on the card. A NCCL group takes the card's tensors as they
are.

These functions carry no gradient. The sharded training forward goes
through :class:`Parallel`'s methods, which under autograd take Megatron's
conjugate pairs (the ``autograd.Function`` classes below): the sum after a
row-parallel product is an all-reduce forward and the identity backward
(``_Sum``), the input of a column-parallel product the identity forward
and an all-reduce of its gradient backward (``_Enter``), the gathered
logits keep their own columns' gradient (``_Gather``), and an
FSDP-sharded leaf is all-gathered forward and its gradient reduce-scattered
backward (``_FsdpGather``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """gloo over a CUDA tensor: stage through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (a new tensor; ``t`` is left as it is)."""
    if group_size(group) == 1:
        return t
    if _staged(t, group):
        h = t.detach().to("cpu", copy=True)
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.detach().contiguous()
    dev = src.device
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(dev)


def all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``t`` split into n blocks along
    ``split_dim``, block j sent to rank j, the blocks received concatenated
    along ``concat_dim`` in source-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    split_dim %= t.dim()
    concat_dim %= t.dim()
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size {t.shape[split_dim]} "
                         f"does not split {n} ways")
    dev = t.device
    shape = list(t.shape)
    shape[split_dim:split_dim + 1] = [n, shape[split_dim] // n]
    send = t.detach().reshape(shape).movedim(split_dim, 0).contiguous()
    if _staged(send, group):
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j]: source j's block, whose dims keep t's order (the split dim
    # shrunk n-fold); the source index goes just before the concat dim and
    # the two merge
    recv = recv.to(dev).movedim(0, concat_dim)
    out_shape = list(recv.shape)
    out_shape[concat_dim:concat_dim + 2] = [out_shape[concat_dim] * out_shape[concat_dim + 1]]
    return recv.reshape(out_shape)


def ppermute(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Ring rotation: rank r sends ``t`` to rank r+shift and returns what
    rank r-shift sent (modulo the group size, group-local ranks)."""
    n = group_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    send = t.detach().contiguous()
    dev = send.device
    if _staged(send, group):
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(dev)


def _wants_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _Sum(torch.autograd.Function):
    """All-reduce forward, identity backward (after a row-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward (the input of
    a column-parallel product: each rank's gradient is its part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward keeps this rank's block of
    the gradient (the loss it feeds is computed alike on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n, ctx.me = dim, group_size(group), dist.get_rank(group)
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.me].contiguous(), None, None


class _FsdpGather(torch.autograd.Function):
    """A leaf sharded along ``dim``: all-gather forward, reduce-scatter (the
    sum over the group, this rank's block kept) of its gradient backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n, ctx.me, ctx.group = dim, group_size(group), dist.get_rank(group), group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group).chunk(ctx.n, dim=ctx.dim)[ctx.me].contiguous(), None, None


class _PPermute(torch.autograd.Function):
    """:func:`ppermute` by ``shift``; backward the gradient by ``-shift``."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ppermute(g, ctx.group, -ctx.shift), None, None


class _Replicate(torch.autograd.Function):
    """All-reduce forward (one rank's value, the others' zeros, made every
    rank's); backward the mean of the ranks' gradients: every rank computes
    the same loss from it, and the copies count once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group) / group_size(ctx.group), None


def shift(x: torch.Tensor, group, by: int = 1) -> torch.Tensor:
    """:func:`ppermute`, through ``_PPermute`` under autograd."""
    if group_size(group) > 1 and _wants_grad(x):
        return _PPermute.apply(x, group, by)
    return ppermute(x, group, by)


def replicate(x: torch.Tensor, group) -> torch.Tensor:
    """One rank's ``x`` (the others pass zeros) on every rank, through
    ``_Replicate`` under autograd."""
    if group_size(group) > 1 and _wants_grad(x):
        return _Replicate.apply(x, group)
    return all_reduce(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_reduce`, through ``_Sum`` under autograd."""
    if group_size(group) > 1 and _wants_grad(x):
        return _Sum.apply(x, group)
    return all_reduce(x, group)


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; under autograd its gradient is summed over ``group``."""
    if group_size(group) > 1 and _wants_grad(x):
        return _Enter.apply(x, group)
    return x


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`all_gather`, through ``_Gather`` under autograd."""
    if group_size(group) > 1 and _wants_grad(x):
        return _Gather.apply(x, dim, group)
    return all_gather(x, dim, group)


def fsdp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """An FSDP-sharded leaf whole along ``dim``, through ``_FsdpGather``
    under autograd."""
    if group_size(group) > 1 and _wants_grad(x):
        return _FsdpGather.apply(x, dim, group)
    return all_gather(x, dim, group)


def broadcast_object(obj, group, src: int = 0):
    """A picklable object from global rank ``src`` to every rank of
    ``group`` (the engine's control messages; host memory)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


class Parallel:
    """A rank's place in the mesh and the collectives the sharded forward
    calls. ``tp`` ranks split heads, MLP columns and the vocab; ``ep``
    ranks split the experts (their MLP columns split over ``tp`` too).
    Every method is the identity where its axis has one rank.

    The control group carries host objects (the engine's requests and
    aborts, broadcast from rank 0): the process group itself when it is
    gloo, else a gloo group over every rank, created here — so every rank
    must build its ``Parallel`` objects in the same order."""

    def __init__(self, mesh):
        from .mesh import mesh_shape

        self.mesh = mesh
        self.sizes = mesh_shape(mesh)
        self.coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.tp, self.ep = self.sizes["tp"], self.sizes["ep"]
        self.tp_rank, self.ep_rank = self.coords["tp"], self.coords["ep"]
        self.tp_group = mesh.get_group("tp") if self.tp > 1 else None
        self.ep_group = mesh.get_group("ep") if self.ep > 1 else None
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.ctrl = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
        # ranks holding each local kv head: > 1 where tp exceeds the kv
        # heads (each rank keeps the one head its q heads read; MLA's
        # single latent head on every rank), set by the sharding
        self.kv_rep = 1
        # (group, index, count) of the data ranks a sharded training step
        # splits its batch over; None when serving (one replica)
        self.data = None

    # -------------------------------------------------------- tensor parallel

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of a row-parallel product's partial results over ``tp``."""
        return sum_over(x, self.tp_group)

    def reduce_experts(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the local experts' partial outputs over ``tp`` and ``ep``."""
        return sum_over(sum_over(x, self.tp_group), self.ep_group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of this rank's column-parallel products (tp): the
        identity, whose gradient is summed over ``tp`` under autograd."""
        return enter(x, self.tp_group)

    def enter_experts(self, x: torch.Tensor) -> torch.Tensor:
        """The input of this rank's experts (and their routing weights):
        the identity, whose gradient is summed over ``tp`` and ``ep``."""
        return enter(enter(x, self.ep_group), self.tp_group)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel lookup: this rank's rows of the (padded) vocab,
        the others' tokens masked to 0, then the sum over ``tp``."""
        if self.tp == 1:
            return table[tokens.long()]
        n = table.shape[0]
        idx = tokens.long() - self.tp_rank * n
        hit = (idx >= 0) & (idx < n)
        x = table[idx.clamp(0, n - 1)] * hit[..., None].to(table.dtype)
        return self.reduce(x)

    def gather_vocab(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        """A column-parallel head's logits over the whole vocab (padding
        columns cut)."""
        if self.tp == 1:
            return logits
        return gather(logits, -1, self.tp_group)[..., :vocab]

    def experts(self, n_exp: int) -> tuple[int, int]:
        """(first global expert, count) of this rank's experts."""
        if n_exp % self.ep:
            raise ValueError(f"{n_exp} experts do not split over ep={self.ep}")
        per = n_exp // self.ep
        return self.ep_rank * per, per

    # ------------------------------------------------------ sequence parallel

    def heads_to_seq(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, h, D] head-sharded (full sequence) → [B, T/tp, tp·h, D]
        sequence-sharded (every head)."""
        return all_to_all(x, 1, 2, self.tp_group)

    def seq_to_heads(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`heads_to_seq`."""
        return all_to_all(x, 2, 1, self.tp_group)

    def seq_attention(self, q, k, v, sp_impl: str, inner_impl: str = "xla",
                      scale: float | None = None):
        """Fresh prefill's causal attention, sequence-parallel over ``tp``
        (the engine's ``ring_prefill_len`` path), on head-sharded q / k / v
        [B, T, h, D]: JAX's ``shard_map`` with the reshards GSPMD inserts
        around it. Ulysses' per-rank layout — local heads, the whole
        sequence — is the one the forward already holds, so its two
        exchanges and the reshards around them cancel: ``inner_impl`` runs
        on the local heads as they are. Ring attention needs the sequence
        sharded with every head: one all-to-all each (a kv head held by
        ``kv_rep`` ranks is kept once), the ring over the axis
        (:func:`..ops.attention.causal_attention`), and the output back to
        head-sharded. T must divide by ``tp``."""
        from ..ops import attention as attn_ops

        if sp_impl == "ulysses":
            return attn_ops.causal_attention(q, k, v, scale=scale, impl=inner_impl)
        qs, ks, vs = self.heads_to_seq(q), self.heads_to_seq(k), self.heads_to_seq(v)
        if self.kv_rep > 1:
            ks, vs = ks[:, :, ::self.kv_rep], vs[:, :, ::self.kv_rep]
        o = attn_ops.causal_attention(qs, ks, vs, scale=scale, impl=sp_impl,
                                      ring_mesh=self.mesh, ring_axis="tp",
                                      inner_impl=inner_impl)
        return self.seq_to_heads(o)

    # ---------------------------------------------------------------- control

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank."""
        return broadcast_object(obj, self.ctrl)

    def barrier(self) -> None:
        """Every rank here (on the control group): a rank that leaves after
        its last broadcast waits until the others have received it."""
        dist.barrier(group=self.ctrl)
