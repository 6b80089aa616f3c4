"""SFT training step, schedule and loop (port of ``train/trainer.py``).

The step runs the family's no-cache forward (``forward(params, cfg,
inputs, positions)``, ``impl="xla"``: plain attention) under autograd, as
JAX's jitted step differentiates its XLA forward. The JAX trainer reaches
no Pallas kernel; on the card the port's no-cache forward reaches two
hand-written ones, the grouped expert kernel pair of the MoE families
(``ops/moe.py``, an ``autograd.Function`` whose backward is the plain
version's vector-Jacobian product) and nothing else: every other kernel
entry raises when it is reached with a tensor that requires grad.

The optimizer is optax's ``chain(clip_by_global_norm(grad_clip),
adamw(lr, weight_decay=0.01))`` written as plain functions on tensors, in
optax's order of operations: the clip scales by ``max_norm / g_norm`` only
when ``g_norm >= max_norm``; Adam's moments are kept in the params' dtype
(b1 0.9, b2 0.999, eps 1e-8, no eps_root), the bias corrections use the
incremented count, the decay applies to every leaf, and the learning rate
is the schedule's value at the count before the increment. The step
updates params and moments in place (JAX's step donates both); the state
it returns holds the same tensors, which never require grad, so a trained
tree serves as it is. Leaves are visited in sorted key order, as
``jax.tree.leaves`` visits them (the order of the global norm's sum).

With a ``mesh`` (one process a rank, ``parallel/mesh.make_mesh``) the
params are each rank's ``TRAIN_RULES`` slices (JAX ``trainer.py:75-130``,
where GSPMD inserts the collectives): ``fsdp`` on the embed dims, ``tp``
on heads, MLP columns and the vocab, ``ep`` on the experts, the batch's
rows over ``dp`` × ``fsdp``. :class:`ShardedForward` slices the params,
runs the family's forward on them Megatron style (``parallel/collectives.py``: the
conjugate all-reduce pairs around the column- and row-parallel products,
the vocab-parallel embedding and the gathered logits), all-gathers the
FSDP leaves before it (their gradients reduce-scattered back), and after
the backward sums each gradient over the data ranks (and ``q_norm`` /
``k_norm``'s over ``tp``: they see only this rank's heads). It is the
step's ``sync``: the one train step takes this rank's rows of the global
batch, and its loss's denominator and the norm are the global batch's and
tree's; on one device the sync (``ONE_DEVICE``) does nothing. The
products (``dot_bf16``, ``matmul_f32``, the grouped expert pair) run on the
local shards. ``device`` is explicit and the card is the default; the
tests ask for the CPU.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..parallel.collectives import all_reduce


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor       # 0-d int32


class AdamWState(NamedTuple):
    count: torch.Tensor      # 0-d int32: steps taken (the schedule's count)
    mu: Any                  # first moments, the params' tree and dtypes
    nu: Any                  # second moments


def _leaves(tree) -> list:
    """The tensor leaves of a tree of dicts, in sorted key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [] if tree is None else [tree]


def _like(tree, fn):
    """The tree with every tensor leaf ``t`` replaced by ``fn(t)``."""
    if isinstance(tree, dict):
        return {k: _like(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _unflatten(tree, leaves: list):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return None if t is None else next(it)

    return build(tree)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor, group=None) -> torch.Tensor:
    """Masked mean cross-entropy. ``group``: the data ranks the batch's rows
    are spread over; the loss is then this rank's rows' part of the global
    batch's (the ranks' parts sum to it)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    denom = torch.clamp(all_reduce(mask.float().sum(), group), min=1.0)
    return -(ll * mask.float()).sum() / denom


def _loss(forward, cfg, params, tokens, mask, group=None) -> torch.Tensor:
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    positions = torch.arange(inputs.shape[1], device=inputs.device)[None, :].expand(
        inputs.shape)
    logits, _ = forward(params, cfg, inputs, positions)
    return cross_entropy_loss(logits, targets, mask[:, 1:], group)


def _device_of(params) -> torch.device:
    return _leaves(params)[0].device


def _batch(params, tokens, mask) -> tuple[torch.Tensor, torch.Tensor]:
    dev = _device_of(params)
    return (torch.as_tensor(np.asarray(tokens) if not isinstance(tokens, torch.Tensor)
                            else tokens, device=dev).long(),
            torch.as_tensor(np.asarray(mask) if not isinstance(mask, torch.Tensor)
                            else mask, device=dev).float())


class _OneDevice:
    """The step's sync on one device: the whole batch, nothing to sum."""
    data_group = None

    def local_batch(self, tokens, mask):
        return tokens, mask

    def sync_grads(self, params, grads) -> None:
        pass

    def global_norm(self, params, grads) -> torch.Tensor:
        return global_norm(grads)


ONE_DEVICE = _OneDevice()


def loss_and_grads(forward, cfg, params, tokens, mask,
                   sync=ONE_DEVICE) -> tuple[torch.Tensor, Any]:
    """(masked next-token loss, grads as a tree like ``params``) of the
    no-cache forward on ``tokens`` [B, T]: JAX's ``value_and_grad`` of the
    step's loss. Integer (int8) leaves raise JAX's ``TypeError``. With a
    :class:`ShardedForward` as ``sync``, the loss is the global batch's and
    the grads are this rank's slices of the whole batch's."""
    for t in _leaves(params):
        if not (t.is_floating_point() or t.is_complex()):
            raise TypeError(
                f"grad requires real- or complex-valued inputs (input dtype that is a "
                f"sub-dtype of np.inexact), but got {str(t.dtype).replace('torch.', '')}. "
                f"int8-quantized weights cannot be trained")
    tokens, mask = sync.local_batch(*_batch(params, tokens, mask))
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    with torch.enable_grad():
        loss = _loss(forward, cfg, _unflatten(params, leaves), tokens, mask, sync.data_group)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (MLA's router bias only picks experts)
    # has a zero gradient, as in JAX
    grads = _unflatten(params, [torch.zeros_like(t) if g is None else g
                                for t, g in zip(leaves, grads)])
    sync.sync_grads(params, grads)
    return all_reduce(loss.detach(), sync.data_group), grads


def global_norm(tree) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the sum over leaves (sorted key
    order) of each leaf's sum of squares in its own dtype."""
    return torch.sqrt(sum(torch.sum(g * g) for g in _leaves(tree)))


def clip_by_global_norm_(grads, max_norm: float, g_norm: torch.Tensor | None = None):
    """optax ``clip_by_global_norm`` in place: every leaf ``(g / g_norm) ·
    max_norm`` (in its dtype) when ``g_norm >= max_norm``, else unchanged."""
    g_norm = global_norm(grads) if g_norm is None else g_norm
    if not bool(g_norm < max_norm):
        for g in _leaves(grads):
            g.div_(g_norm.to(g.dtype)).mul_(max_norm)
    return grads


def _chunks(t: torch.Tensor) -> list:
    """Elementwise work one layer (first-dim slice) of a stack at a time,
    so the optimizer's temporaries stay one layer's size."""
    return list(t) if t.dim() >= 3 else [t]


@dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    weight_decay))`` with optax's defaults, as plain functions on tensors.
    ``learning_rate`` is a float or a schedule ``count → lr``."""
    learning_rate: float | Callable = 1e-5
    weight_decay: float = 0.01
    grad_clip: float | None = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> AdamWState:
        dev = _device_of(params)
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          _like(params, torch.zeros_like), _like(params, torch.zeros_like))

    def step_(self, grads, state: AdamWState, params,
              g_norm: torch.Tensor | None = None) -> AdamWState:
        """Update ``params`` in place from ``grads`` (clipped in place first;
        ``g_norm``: their global norm, if the caller has it); returns the
        new state (its moments updated in place)."""
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip, g_norm)
        count = state.count + 1
        cf = count.float()
        # 1 - decay**count in float32, cast to each moment's dtype
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32, device=cf.device) ** cf
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32, device=cf.device) ** cf
        if callable(self.learning_rate):
            step_size = -self.learning_rate(state.count)
        else:
            step_size = -self.learning_rate
        with torch.no_grad():
            for g_all, m_all, v_all, p_all in zip(_leaves(grads), _leaves(state.mu),
                                                  _leaves(state.nu), _leaves(params)):
                for g, m, v, p in zip(*map(_chunks, (g_all, m_all, v_all, p_all))):
                    m.mul_(self.b1).add_(g * (1 - self.b1))
                    v.mul_(self.b2).add_((g * g).mul_(1 - self.b2))
                    u = m / bc1.to(m.dtype)
                    den = (v / bc2.to(v.dtype)).sqrt_().add_(self.eps)
                    u.div_(den).add_(p * self.weight_decay)
                    if isinstance(step_size, torch.Tensor):
                        u.mul_(step_size.to(u.dtype))
                    else:
                        u.mul_(step_size)
                    p.add_(u)
        return AdamWState(count, state.mu, state.nu)


def make_train_step(forward, cfg, optimizer: AdamW, sync=ONE_DEVICE):
    """The train step: (state, tokens [B,T], loss_mask [B,T]) → (state,
    metrics). ``tokens`` are right-shifted internally; ``grad_norm`` is the
    norm before clipping. Params and moments are updated in place. With a
    :class:`ShardedForward` as ``sync`` the step takes this rank's rows of
    the global batch and syncs the gradients; the loss and the norm are the
    global ones."""

    def train_step(state: TrainState, tokens, mask):
        loss, grads = loss_and_grads(forward, cfg, state.params, tokens, mask, sync)
        gnorm = sync.global_norm(state.params, grads)
        opt_state = optimizer.step_(grads, state.opt_state, state.params, gnorm)
        return TrainState(state.params, opt_state, state.step + 1), {
            "loss": loss, "grad_norm": gnorm,
        }

    return train_step


def _polynomial(init_value: float, end_value: float, transition_steps: int):
    """optax ``linear_schedule`` (``polynomial_schedule`` of power 1)."""
    if transition_steps <= 0:
        return lambda count: torch.tensor(init_value, dtype=torch.float32)

    def schedule(count):
        c = torch.clamp(torch.as_tensor(count, dtype=torch.int32), 0, transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float):
    """optax ``cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps!")

    def schedule(count):
        c = torch.minimum(torch.as_tensor(count, dtype=torch.int32).float(),
                          torch.tensor(float(decay_steps)))
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        decayed = (1 - alpha) * cosine_decay + alpha
        return init_value * decayed

    return schedule


def lr_schedule(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                end_lr_frac: float = 0.1):
    """Linear warmup → cosine decay to ``end_lr_frac·peak`` (optax's
    ``warmup_cosine_decay_schedule`` from 0): ``count → lr`` as a float32
    0-d tensor, on the CPU."""
    warmup_steps = min(warmup_steps, max(total_steps - 1, 1))
    peak, end = float(peak_lr), float(peak_lr * end_lr_frac)
    alpha = 0.0 if peak == 0.0 else end / peak
    warm = _polynomial(0.0, peak, warmup_steps)
    decay = _cosine(peak, max(total_steps, 1) - warmup_steps, alpha)

    def schedule(count):
        c = torch.as_tensor(count, dtype=torch.int32).cpu()
        out = warm(c)
        return torch.where(c < warmup_steps, out, decay(c - warmup_steps)).float()

    return schedule


def make_optimizer(learning_rate: float = 1e-5, total_steps: int | None = None,
                   warmup_steps: int = 0, grad_clip: float | None = 1.0) -> AdamW:
    """The trainer's AdamW: with ``total_steps``, warmup-cosine LR decay."""
    lr = (lr_schedule(learning_rate, total_steps, warmup_steps)
          if total_steps else learning_rate)
    return AdamW(lr, weight_decay=0.01, grad_clip=grad_clip)


def init_train_state(model_name: str, mesh, *, seed: int = 0,
                     learning_rate: float = 1e-5, rules=None,
                     total_steps: int | None = None, warmup_steps: int = 0,
                     grad_clip: float | None = 1.0, device="cuda"):
    """Random params of ``model_name`` from ``seed`` on ``device`` (the
    engine's packed layout, ``engine/weights.init_params``), wrapped in a
    TrainState with AdamW (+ global-norm clipping and, when
    ``total_steps`` is given, warmup-cosine LR decay). ``rules`` are JAX's
    sharding rules, read only with a mesh; there the family's ``forward``
    is a :class:`ShardedForward`, the steps' ``sync``."""
    from ..device import resolve_device
    from ..engine.weights import init_params
    from ..models.registry import get_model

    fam = get_model(model_name)
    if mesh is None:
        params = init_params(fam, device=resolve_device(device), seed=seed)
    else:
        import dataclasses

        from ..parallel.sharding import TRAIN_RULES

        sharded = ShardedForward(fam, mesh, rules or TRAIN_RULES)
        params = sharded.init(resolve_device(device), seed)
        fam = dataclasses.replace(fam, forward=sharded, config=sharded.cfg)
    optimizer = make_optimizer(learning_rate, total_steps, warmup_steps, grad_clip)
    state = TrainState(params, optimizer.init(params),
                       torch.zeros((), dtype=torch.int32))
    return state, optimizer, fam


def make_eval_step(forward, cfg, sync=ONE_DEVICE):
    """Held-out loss: (params, tokens, mask) → masked CE, without grad (with
    a :class:`ShardedForward` as ``sync``: the global batch's)."""

    @torch.no_grad()
    def eval_step(params, tokens, mask):
        tokens, mask = sync.local_batch(*_batch(params, tokens, mask))
        return all_reduce(_loss(forward, cfg, params, tokens, mask, sync.data_group),
                          sync.data_group)

    return eval_step


def train_loop(model_name: str, mesh, train_batches, *,
               eval_batches=None, total_steps: int | None = None,
               learning_rate: float = 1e-5, warmup_steps: int = 0,
               eval_every: int = 0, checkpoint_dir: str | None = None,
               checkpoint_every: int = 0, log_every: int = 10,
               seed: int = 0, log=print, device="cuda"):
    """The SFT loop: schedule, periodic held-out eval, safetensors checkpoints.

    ``train_batches`` yields ``(tokens [B, T], loss_mask [B, T])`` numpy
    arrays (see train/data.batches); ``eval_batches`` a list of the same.
    Returns (final TrainState, history list of metric dicts).
    """
    state, optimizer, fam = init_train_state(
        model_name, mesh, seed=seed, learning_rate=learning_rate,
        total_steps=total_steps, warmup_steps=warmup_steps, device=device)
    sync = ONE_DEVICE if mesh is None else fam.forward
    step_fn = make_train_step(fam.forward, fam.config, optimizer, sync)
    eval_fn = make_eval_step(fam.forward, fam.config, sync)

    history: list[dict] = []
    for i, (tokens, mask) in enumerate(train_batches):
        if total_steps is not None and i >= total_steps:
            break
        state, metrics = step_fn(state, tokens, mask)
        rec = {"step": i + 1, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        if eval_batches and eval_every and (i + 1) % eval_every == 0:
            losses = [float(eval_fn(state.params, t, m)) for t, m in eval_batches]
            rec["eval_loss"] = sum(losses) / len(losses)
        history.append(rec)
        if log_every and (i + 1) % log_every == 0:
            log(rec)
        if checkpoint_dir and checkpoint_every \
                and (i + 1) % checkpoint_every == 0:
            from .checkpoint import save_params

            # under a mesh each rank writes its own slices, rank<r>/
            path = checkpoint_dir
            if mesh is not None:
                path = os.path.join(checkpoint_dir, f"rank{sync.par.rank}")
            save_params(path, state.params, step=i + 1)
    return state, history


class ShardedForward:
    """A family's no-cache forward on this rank's ``rules`` slices of the
    params (see the module docstring), and the train step's ``sync``: this
    rank's rows of the batch, the data group, the gradients' sums and the
    global norm. ``tp`` must divide the kv heads here (the serving
    engine's one-kv-head-a-rank layout would need its gradients summed over
    the ranks sharing a head; MLA's single latent row is computed on every
    rank from replicated weights); ``pp`` trains through
    ``parallel/pipeline.make_pp_forward``."""

    # leaves replicated over tp that see only this rank's heads: their
    # gradients are partial sums over tp
    TP_PARTIAL = ("q_norm", "k_norm")

    def __init__(self, fam, mesh, rules):
        from ..parallel.collectives import Parallel
        from ..parallel.mesh import axes_group, mesh_shape
        from ..parallel.sharding import local_config

        sizes, cfg = mesh_shape(mesh), fam.config
        if sizes["pp"] > 1:
            raise ValueError("a pp axis trains through parallel/pipeline.make_pp_forward")
        if (sizes["tp"] > 1 and not getattr(cfg, "latent_cache", False)
                and cfg.n_kv_heads % sizes["tp"]):
            raise ValueError(f"sharded training needs tp ({sizes['tp']}) to divide the "
                             f"{cfg.n_kv_heads} kv heads")
        self.fam, self.mesh, self.rules = fam, mesh, rules
        self.par = par = Parallel(mesh)
        self.cfg = local_config(cfg, par.tp)
        if fam.logical_axes is None:
            raise ValueError(f"model family {fam.name!r} was registered without logical "
                             f"axes to shard by")
        self.axes = fam.logical_axes(cfg)
        self.data_group = axes_group(mesh, ("dp", "fsdp"))
        self.dp_group = axes_group(mesh, ("dp",))
        self.fsdp_group = axes_group(mesh, ("fsdp",))
        self.world_group = axes_group(mesh, tuple(mesh.mesh_dim_names))
        self.n_data = par.sizes["dp"] * par.sizes["fsdp"]
        self.data_rank = par.coords["dp"] * par.sizes["fsdp"] + par.coords["fsdp"]
        if self.n_data > 1:   # capacity dispatch over the whole batch
            par.data = (self.data_group, self.data_rank, self.n_data)

    def shard(self, params: dict) -> dict:
        """This rank's slices of a whole (packed or unpacked) param tree,
        on the device of each leaf, one matrix at a time."""
        return self._local().place(params)

    def _local(self):
        from ..parallel.sharding import LocalDraw

        return LocalDraw(self.fam.config, self.axes, self.rules, self.par.sizes,
                         self.par.coords)

    def init(self, device, seed: int = 0) -> dict:
        """This rank's slices of the random draw from ``seed``, each matrix
        cut as it is drawn (``parallel/sharding.LocalDraw``: a rank never
        holds the whole model); a ``custom_init`` family's draw is made
        whole and sliced."""
        from ..engine.weights import init_params, random_params

        cfg = self.fam.config
        if getattr(cfg, "custom_init", False):
            return self.shard(init_params(self.fam, device=device, seed=seed))
        return random_params(cfg, device=device, seed=seed, local=self._local())

    def _specs(self, params, axes=None):
        """(leaf, its spec) pairs in ``_leaves`` order."""
        axes = self.axes if axes is None else axes
        out = []
        for k in sorted(params):
            if isinstance(params[k], dict):
                out += self._specs(params[k], axes[k])
            elif params[k] is not None:
                out.append((k, self.rules.spec(*axes[k])))
        return out

    def _fsdp_dim(self, spec) -> int | None:
        for d, entry in enumerate(spec):
            if entry == "fsdp" or (isinstance(entry, tuple) and "fsdp" in entry):
                return d
        return None

    def __call__(self, params, cfg, tokens, positions, **kw):
        """The forward on whole-over-fsdp leaves (gathered; under autograd
        their gradients reduce-scattered back)."""
        from ..parallel.collectives import fsdp_gather

        if self.fsdp_group is not None:
            leaves = [t if self._fsdp_dim(spec) is None
                      else fsdp_gather(t, self._fsdp_dim(spec), self.fsdp_group)
                      for t, (_, spec) in zip(_leaves(params), self._specs(params))]
            params = _unflatten(params, leaves)
        return self.fam.forward(params, cfg, tokens, positions, par=self.par, **kw)

    def local_batch(self, tokens, mask):
        """This rank's rows of the global batch (over dp × fsdp)."""
        n = tokens.shape[0] // self.n_data
        rows = slice(self.data_rank * n, (self.data_rank + 1) * n)
        return tokens[rows], mask[rows]

    def sync_grads(self, params, grads) -> None:
        """Each gradient summed over the data ranks (an FSDP leaf's over
        fsdp already, in its reduce-scatter: over dp here), and the
        tp-partial leaves' over tp."""
        for g, (name, spec) in zip(_leaves(grads), self._specs(params)):
            group = (self.data_group if self.fsdp_group is None or self._fsdp_dim(spec) is None
                     else self.dp_group)
            g.copy_(all_reduce(g, group))
            if name in self.TP_PARTIAL:
                g.copy_(all_reduce(g, self.par.tp_group))

    def global_norm(self, params, grads) -> torch.Tensor:
        """The norm of the whole gradient tree: each leaf's sum of squares
        over the ranks holding distinct slices of it (every rank's, weighted
        by one over the ranks holding the same slice)."""
        total = None
        for g, (_, spec) in zip(_leaves(grads), self._specs(params)):
            shards = 1
            for entry in spec:
                for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
                    shards *= self.par.sizes.get(ax, 1)
            sq = torch.sum(g.float() * g.float()) * (shards / self.par.world)
            total = sq if total is None else total + sq
        return torch.sqrt(all_reduce(total, self.world_group))
