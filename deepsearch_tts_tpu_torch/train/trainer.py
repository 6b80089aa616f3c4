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

``mesh`` (JAX's sharding over a device mesh) is ROADMAP A13: anything but
``None`` raises ``NotImplementedError``. ``device`` is explicit and the card
is the default; the tests ask for the CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch


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
                       mask: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    denom = torch.clamp(mask.float().sum(), min=1.0)
    return -(ll * mask.float()).sum() / denom


def _loss(forward, cfg, params, tokens, mask) -> torch.Tensor:
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    positions = torch.arange(inputs.shape[1], device=inputs.device)[None, :].expand(
        inputs.shape)
    logits, _ = forward(params, cfg, inputs, positions)
    return cross_entropy_loss(logits, targets, mask[:, 1:])


def _device_of(params) -> torch.device:
    return _leaves(params)[0].device


def _batch(params, tokens, mask) -> tuple[torch.Tensor, torch.Tensor]:
    dev = _device_of(params)
    return (torch.as_tensor(np.asarray(tokens) if not isinstance(tokens, torch.Tensor)
                            else tokens, device=dev).long(),
            torch.as_tensor(np.asarray(mask) if not isinstance(mask, torch.Tensor)
                            else mask, device=dev).float())


def loss_and_grads(forward, cfg, params, tokens, mask) -> tuple[torch.Tensor, Any]:
    """(masked next-token loss, grads as a tree like ``params``) of the
    no-cache forward on ``tokens`` [B, T]: JAX's ``value_and_grad`` of the
    step's loss. Integer (int8) leaves raise JAX's ``TypeError``."""
    for t in _leaves(params):
        if not (t.is_floating_point() or t.is_complex()):
            raise TypeError(
                f"grad requires real- or complex-valued inputs (input dtype that is a "
                f"sub-dtype of np.inexact), but got {str(t.dtype).replace('torch.', '')}. "
                f"int8-quantized weights cannot be trained")
    tokens, mask = _batch(params, tokens, mask)
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    with torch.enable_grad():
        loss = _loss(forward, cfg, _unflatten(params, leaves), tokens, mask)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (MLA's router bias only picks experts)
    # has a zero gradient, as in JAX
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


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


def make_train_step(forward, cfg, optimizer: AdamW):
    """The train step: (state, tokens [B,T], loss_mask [B,T]) → (state,
    metrics). ``tokens`` are right-shifted internally; ``grad_norm`` is the
    norm before clipping. Params and moments are updated in place."""

    def train_step(state: TrainState, tokens, mask):
        loss, grads = loss_and_grads(forward, cfg, state.params, tokens, mask)
        gnorm = global_norm(grads)
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
    sharding rules, read only with a mesh."""
    from ..device import resolve_device
    from ..engine.weights import init_params
    from ..models.registry import get_model

    if mesh is not None:
        raise NotImplementedError(
            "mesh (sharded training) is not ported yet: see ROADMAP.md A13 (parallel); "
            "pass mesh=None to train on one device")
    fam = get_model(model_name)
    params = init_params(fam, device=resolve_device(device), seed=seed)
    optimizer = make_optimizer(learning_rate, total_steps, warmup_steps, grad_clip)
    state = TrainState(params, optimizer.init(params),
                       torch.zeros((), dtype=torch.int32))
    return state, optimizer, fam


def make_eval_step(forward, cfg):
    """Held-out loss: (params, tokens, mask) → masked CE, without grad."""

    @torch.no_grad()
    def eval_step(params, tokens, mask):
        tokens, mask = _batch(params, tokens, mask)
        return _loss(forward, cfg, params, tokens, mask)

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
    step_fn = make_train_step(fam.forward, fam.config, optimizer)
    eval_fn = make_eval_step(fam.forward, fam.config)

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

            save_params(checkpoint_dir, state.params, step=i + 1)
    return state, history
