"""Pipeline parallelism: GPipe microbatch scheduling over a ``pp`` mesh axis
(port of ``parallel/pipeline.py``).

Each pipeline stage (a rank along ``pp``) owns a contiguous slice of the
layer stack, and activations flow stage to stage
(:func:`..parallel.collectives.shift`, a ring send / receive) while M
microbatches stream through. As in JAX every rank runs the same schedule of
M + S - 1 steps: the (S-1)/(M+S-1) bubble is masked compute, and the hand-off
runs every step. Under autograd the same function trains: the hand-off's
backward sends the gradients the other way round the ring, the input enters
stage 0 with its gradient shared by every rank, and the last stage's output
is replicated with a mean-of-copies backward, so every rank may compute the
same loss from it (``collectives.replicate``). A layer leaf's gradient is
then its stage's rows (zero elsewhere): sum it over ``pp`` for the whole
stack; every other leaf's gradient is the same on every rank.
"""
from __future__ import annotations

import torch

from .collectives import enter, group_size, replicate, shift


def pipeline_apply(layer_params: dict, x: torch.Tensor, block_fn, *, mesh, axis: str = "pp",
                   n_microbatches: int | None = None) -> torch.Tensor:
    """Run ``block_fn(lp, l, h)`` (layer ``l`` of the stacked ``lp``) over
    the layer stack with its layers split over ``axis`` of ``mesh``: this
    rank runs the layers of its stage. ``layer_params`` holds the whole
    stack (every leaf [L, ...]; the stage's rows are views taken here).
    x [B, T, E] is every rank's input; returns [B, T, E] on every rank.
    ``n_microbatches`` defaults to the pipeline depth; B must divide by it."""
    group = mesh.get_group(axis)
    S = group_size(group)
    s = mesh.get_local_rank(axis)
    L = next(iter(layer_params.values())).shape[0]
    if L % S:
        raise ValueError(f"{L} layers not divisible by {S} pipeline stages")
    per = L // S
    layer_params = {k: v.narrow(0, s * per, per) for k, v in layer_params.items()}
    M = n_microbatches or S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    xs = enter(x, group).reshape((M, B // M) + tuple(x.shape[1:]))
    is_first, is_last = s == 0, s == S - 1

    def run_stage(h):
        for l in range(per):
            h = block_fn(layer_params, l, h)
        return h

    buf = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(M)]
    for t in range(M + S - 1):
        mb = t - s                              # this stage's microbatch
        active = 0 <= mb < M
        i = min(max(mb, 0), M - 1)
        # stage 0 reads fresh microbatches, the others the hand-off; both
        # stay in the graph (JAX's where), so every rank's backward runs
        # every step's hand-off
        h_in = torch.where(torch.tensor(is_first), xs[i], buf)
        h_out = torch.where(torch.tensor(active), run_stage(h_in), buf)
        # the last stage banks its finished microbatch (a where on every
        # rank, as in JAX: every rank's output stays in the graph)
        outs[i] = torch.where(torch.tensor(active and is_last), h_out, outs[i])
        buf = shift(h_out, group)
    out = torch.stack(outs)
    out = torch.where(torch.tensor(is_last), out, torch.zeros_like(out))
    return replicate(out, group).reshape((B,) + tuple(x.shape[1:]))


def make_pp_forward(cfg, *, mesh, axis: str = "pp", n_microbatches: int | None = None):
    """The dense family's (``models/qwen3.py``) training forward with the
    layer stack pipelined over ``axis``: embedding, final norm and head run
    on every rank alike; the L decoder layers stream microbatches through
    the stages. ``forward(params, cfg, tokens, positions)`` → (logits, None)
    as the no-cache forward returns them; ``params["layers"]`` is the whole
    stack (each stage takes its rows)."""
    from ..models.common import matmul_f32, rms_norm, rope_angles
    from ..models.qwen3 import block

    def forward(params, cfg_, tokens, positions):
        x = params["embed"][tokens.long()]
        # one [1, T, half] table: training positions are the same per row,
        # and microbatches split the batch dim only
        cos, sin = rope_angles(positions[:1].clamp(min=0), cfg_.head_dim, cfg_.rope_theta)

        def block_fn(lp, l, h):
            return block(cfg_, lp, l, h, cos, sin)

        x = pipeline_apply(params["layers"], x, block_fn, mesh=mesh, axis=axis,
                           n_microbatches=n_microbatches)
        x = rms_norm(x, params["final_norm"], cfg_.rms_eps)
        head = params.get("lm_head")
        if head is None:
            head = params["embed"].t()
        logits = matmul_f32(x.reshape(-1, x.shape[-1]), head)
        return logits.reshape(*x.shape[:-1], -1), None

    return forward
