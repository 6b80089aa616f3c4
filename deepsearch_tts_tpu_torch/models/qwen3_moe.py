"""Qwen3-MoE decoder family (port of ``models/qwen3_moe.py``).

The attention stack is the dense family's (GQA + per-head QK-RMSNorm +
RoPE); every layer's MLP is a top-k-of-NE SwiGLU mixture of experts with
renormalised router probabilities (``ops/moe.py``). The param tree is the
JAX one: ``layers`` holds the dense family's attention stacks, ``router``
[L,E,NE] and the expert stacks ``w_gate``/``w_up`` [L,NE,E,F] (or packed
``w_gateup`` [L,NE,E,2F]) and ``w_down`` [L,NE,F,E].

:func:`forward` has the dense forward's modes and serving branches through
the same attention half (:class:`.qwen3.ServingAttention`). The fused T=1
decode layer is B3 (``fused_qkv_stacked``), attention, B7
(``fused_out_router_stacked``: x2, hn and the router logits), the expert
FFN on hn with those logits, then ``x2 + moe_out`` — on when
``fused_decode``, T == 1, not fresh, ``moe_impl == "ragged"`` and the
weights are packed. The expert FFN runs through the grouped expert kernel
on every path. A speculative verify window (T > 1 slot decode) runs
unfused, as JAX's ``use_fused`` requires T == 1.

int8 (``quantize="int8"``; ``ops/quant.py``): every ``QUANT_KEYS`` leaf is
``{q, scales}`` — ``wqkv``, ``wo`` and the ``lm_head`` go through
``maybe_int8_dot`` / ``int8_matmul`` (the dense family's ``_dot`` /
``_lm_head``), the routed experts through ``_expert_ffn_blocked`` (the int8
grouped expert kernel, with JAX's capacity rule); the router, the norms and
the embedding stay in the model dtype. The fused layer does not run on int8
leaves (JAX's ``use_fused`` requires a plain ``wqkv``); ``plain_int8``
sends every int8 product, the experts included, to its plain version: a
reference on the card. Two differences from JAX,
both with ``impl="pallas"``, where the port takes the dense family's
kernels and the JAX MoE family keeps XLA attention: fresh prefill runs
flash attention (B2), and a verify window attends through
``slot_window_attention`` (B9). The decode-step prefill lane is the dense
family's (``lane_*``, JAX ``qwen3_moe.py:161-183``): its rows take B3,
attention, B7 and the experts with the decode rows, B+Tp rows in all.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from ..ops import attention as attn_ops
from ..ops.fused_layer import fused_out_router_stacked, shapes_ok
from ..ops.moe import _split_gateup, moe_capacity, moe_ragged
from ..ops.quant import is_quantized
from .common import matmul_f32, rms_norm, rope_angles
from .qwen3 import (
    ServingAttention,
    _at,
    _embed,
    _fused_decode_on,
    _lm_head,
    _qkv_roped,
    _row_dot,
    _seq_attention,
    append_lane,
    lane_logits_rows,
)


@dataclass(frozen=True)
class Qwen3MoeConfig:
    vocab_size: int = 151936
    hidden: int = 4096
    n_layers: int = 94
    n_heads: int = 64
    n_kv_heads: int = 4
    head_dim: int = 128
    n_experts: int = 128
    top_k: int = 8
    moe_intermediate: int = 1536
    norm_topk_prob: bool = True
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    moe_impl: str = "ragged"
    capacity_factor: float = 1.25
    dtype: str = "bfloat16"
    # int8 weights, the routed experts included (``_expert_ffn_blocked``);
    # the JAX family's forward takes no KV scales, so it has no int8 KV
    int8_weights: ClassVar[bool] = True
    int8_kv: ClassVar[bool] = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def mlp_shapes(self) -> dict[str, tuple[int, ...]]:
        """Per-layer router and expert weights in the packed layout the
        engine serves (gate|up packed as in ``pack_matmul_params``)."""
        E, NE, Fi = self.hidden, self.n_experts, self.moe_intermediate
        return {"router": (E, NE), "w_gateup": (NE, E, 2 * Fi), "w_down": (NE, Fi, E)}

    def fused_decode_widths(self) -> tuple[int, int, int] | None:
        """(E, H·D, N) of the fused T=1 decode layer's products, N being the
        expert count of B7's router product; None for the capacity
        dispatch, which JAX does not fuse."""
        if self.moe_impl != "ragged":
            return None
        return self.hidden, self.n_heads * self.head_dim, self.n_experts

    def fused_decode_fits(self, device: torch.device) -> bool:
        """Whether the fused decode layer can run on ``device`` (the ragged
        dispatch only): its plain versions on the CPU, the CUDA kernels
        where they take the widths."""
        widths = self.fused_decode_widths()
        return widths is not None and (device.type == "cpu"
                                       or shapes_ok(*widths, self.head_dim))


QWEN3_MOE_CONFIGS = {
    # Qwen3-235B-A22B: 94 layers, 64 q heads / 4 kv heads, 128 experts top-8
    "qwen3-235b-a22b": Qwen3MoeConfig(),
    # Qwen3-30B-A3B: 48 layers, 32/4 heads, 128 experts top-8, hidden 2048
    "qwen3-30b-a3b": Qwen3MoeConfig(hidden=2048, n_layers=48, n_heads=32,
                                    n_kv_heads=4, moe_intermediate=768),
    "qwen3-moe-test": Qwen3MoeConfig(vocab_size=512, hidden=64, n_layers=2,
                                     n_heads=4, n_kv_heads=2, head_dim=16,
                                     n_experts=8, top_k=2, moe_intermediate=96),
}


def logical_axes(cfg: Qwen3MoeConfig) -> dict:
    """Tree of logical-axis tuples mirroring the unpacked params (JAX
    ``qwen3_moe.py:102``)."""
    lax_ = {
        "ln1": ("layer", "embed"), "ln2": ("layer", "embed"),
        "q_norm": ("layer", None), "k_norm": ("layer", None),
        "wq": ("layer", "embed", "heads"),
        "wk": ("layer", "embed", "kv_heads"),
        "wv": ("layer", "embed", "kv_heads"),
        "wo": ("layer", "heads", "embed"),
        "router": ("layer", "embed", None),
        "w_gate": ("layer", "expert", "embed", "expert_mlp"),
        "w_up": ("layer", "expert", "embed", "expert_mlp"),
        "w_down": ("layer", "expert", "expert_mlp", "embed"),
    }
    tree = {"embed": ("vocab", "embed"), "layers": lax_, "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("embed", "vocab")
    return tree


def _moe_block(cfg: Qwen3MoeConfig, lp: dict, l: int, h: torch.Tensor,
               router_logits: torch.Tensor | None = None,
               plain: bool = False, par=None) -> torch.Tensor:
    """Layer ``l``'s expert MLP on h [B,T,E] (``router_logits`` [B·T,NE]
    when B7 computed them; ``plain``: the expert FFN's plain versions).
    Expert leaves may be int8 ``{q, scales}``. Under ``par`` the stacks
    hold this rank's experts (over ``ep``) at its MLP columns (over
    ``tp``): the ragged dispatch runs the grouped expert kernels over the
    rows routed to them, the capacity dispatch its slice of the global
    dispatch, and the partial outputs are summed over ``tp`` and ``ep``."""
    B, T, E = h.shape
    x = h.reshape(B * T, E)
    if "w_gateup" in lp:   # packed gate|up (engine packing)
        w_gate, w_up = _at(lp["w_gateup"], l), None
    else:
        w_gate, w_up = _at(lp["w_gate"], l), _at(lp["w_up"], l)
    w_down = _at(lp["w_down"], l)
    experts = None
    if par is not None:
        # the router runs alike on every rank; its logits and the tokens
        # enter this rank's experts (their gradients summed over tp and ep)
        experts = par.experts(cfg.n_experts)
        if router_logits is None:
            router_logits = matmul_f32(x, lp["router"][l])
        router_logits, x = par.enter_experts(router_logits), par.enter_experts(x)
    if cfg.moe_impl == "ragged":
        router = lp["router"][l] if router_logits is None else None
        out = moe_ragged(x, router, w_gate, w_up, w_down, cfg.top_k,
                         cfg.norm_topk_prob, router_logits=router_logits, plain=plain,
                         experts=experts)
    else:
        w_gate, w_up = _split_gateup(w_gate, w_up)
        out = moe_capacity(x, lp["router"][l], w_gate, w_up, w_down,
                           cfg.top_k, cfg.norm_topk_prob,
                           capacity_factor=cfg.capacity_factor, experts=experts,
                           router_logits=router_logits,
                           data=None if par is None else par.data)
    if par is not None:
        out = par.reduce_experts(out)
    return out.reshape(B, T, E)


def forward(
    params: dict,
    cfg: Qwen3MoeConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    *,
    k_pages: torch.Tensor | None = None,
    v_pages: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,
    seq_lens: torch.Tensor | None = None,
    logits_indices: torch.Tensor | None = None,
    impl: str = "xla",
    slot_decode: bool = False,
    slot_ctx: int | None = None,
    fresh_prefill: bool = False,
    fused_decode: bool = False,
    plain_experts: bool = False,
    plain_int8: bool = False,
    lane_tokens: torch.Tensor | None = None,
    lane_positions: torch.Tensor | None = None,
    lane_table: torch.Tensor | None = None,
    lane_logit_row=None,
    par=None,
    seq_parallel: str | None = None,
):
    """Same contract as :func:`.qwen3.forward` (serving and no-cache modes,
    the prefill lane included, and sharded under ``par``: attention as the
    dense family's, the experts over ``ep`` × ``tp``, :func:`_moe_block`). ``plain_experts`` runs the ragged expert
    FFN through its plain versions instead of the grouped expert kernel, on
    any device: the no-cache forward is then plain torch throughout, a
    reference for the kernels on the card. ``plain_int8`` does the same for
    int8 weights: every int8 product and the int8 expert FFN."""
    lp = params["layers"]
    plain = plain_experts or plain_int8
    H, D = cfg.n_heads, cfg.head_dim
    eps = cfg.rms_eps
    serving = k_pages is not None
    B_dec = tokens.shape[0]
    if lane_tokens is not None:
        assert serving and not fresh_prefill, "lane rides the decode step only"
        tokens, positions, page_table = append_lane(
            tokens, positions, page_table, slot_decode, lane_tokens, lane_positions,
            lane_table)
    x = _embed(params, tokens, par)
    cos, sin = rope_angles(positions.clamp(min=0), D, cfg.rope_theta)
    B, T, E = x.shape

    if serving:
        use_fused = (_fused_decode_on(fused_decode, T, fresh_prefill, lp)
                     and cfg.fused_decode_widths() is not None
                     and not is_quantized(lp["wqkv"]))
        attend = ServingAttention(
            cfg, lp, positions, cos, sin, k_pages=k_pages, v_pages=v_pages,
            page_table=page_table, seq_lens=seq_lens, impl=impl,
            slot_decode=slot_decode, slot_ctx=slot_ctx, fresh_prefill=fresh_prefill,
            fused=use_fused, plain=plain_int8, lane=B - B_dec,
            seq_attention=_seq_attention(par, seq_parallel, impl))
        if use_fused:
            xf = x.reshape(B, E)
        for l in range(cfg.n_layers):
            if use_fused:
                o = attend(l, xf)
                x2, hn, rl = fused_out_router_stacked(
                    o.reshape(B, H * D).to(x.dtype), xf, lp["wo"], lp["ln2"],
                    lp["router"], l, eps=eps)
                xf = x2 + _moe_block(cfg, lp, l, hn[:, None], router_logits=rl,
                                     plain=plain)[:, 0]
            else:
                o = attend(l, x)
                x = x + _row_dot(o.reshape(B, T, H * D), lp["wo"], l, plain_int8,
                                 par).to(x.dtype)
                x = x + _moe_block(cfg, lp, l, rms_norm(x, lp["ln2"][l], eps), plain=plain,
                                   par=par)
        if use_fused:
            x = xf.reshape(B, 1, E)
    else:
        for l in range(cfg.n_layers):
            q, k, v = _qkv_roped(cfg, lp, l, x, cos, sin, plain_int8, par)
            o = attn_ops.causal_attention(q, k, v.to(x.dtype), impl=impl)
            x = x + _row_dot(o.reshape(B, T, H * D), lp["wo"], l, plain_int8, par).to(x.dtype)
            x = x + _moe_block(cfg, lp, l, rms_norm(x, lp["ln2"][l], eps), plain=plain,
                               par=par)

    x = rms_norm(x, params["final_norm"], eps)
    if lane_tokens is not None:
        x = lane_logits_rows(x, B_dec, lane_logit_row)
    if logits_indices is not None:
        x = x[torch.arange(B, device=x.device), logits_indices.long()][:, None]
    logits = _lm_head(params, x, plain_int8, par, cfg.vocab_size)
    if not serving:
        return logits, None
    return logits, (k_pages, v_pages)
