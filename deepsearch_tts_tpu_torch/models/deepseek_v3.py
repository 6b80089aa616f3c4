"""DeepSeek-V3 / Kimi-K2 family: Multi-head Latent Attention (MLA), shared
and grouped-sigmoid-routed experts (port of ``models/deepseek_v3.py``).

Kimi-K2 is the reference system's auxiliary verifier model, so this family
is the verifier side of asymmetric verification.

MLA in absorbed form, as in JAX: the per-head no-rope key matrix is folded
into the query (``q_lat[h] = q_nope[h] @ W_kb[h]``) and the value matrix is
applied after attention, so attention is MQA over one cache row per token,
``[latent (kv_lora_rank) | k_rope (qk_rope_head_dim)]``, with the softmax
scale ``(qk_nope + qk_rope)^-1/2``. The row is the key and, in its first
``kv_lora_rank`` columns, the value. The cache is latent only: the engine
writes and reads ``k_pages`` (``[L, N, ps, 1, D]``) and hands a one-page
dummy ``v_pages`` through untouched.

Two differences from JAX. The cache row is ``kv_lora_rank +
qk_rope_head_dim`` wide (576 on deepseek-v3 and kimi-k2); JAX pads it to
the TPU's 128-lane tile (640), a Mosaic artifact whose zero columns change
no score or output. And the serving attention computes only the value
columns it keeps (``v`` = the row's first ``kv_lora_rank`` columns) where
JAX computes all and slices.

The param tree is JAX's two-stack one: ``dense_layers`` (the first
``first_k_dense`` layers: attention + ``d_gate``/``d_up``/``d_down``) and
``moe_layers`` (attention + ``router``, float32 ``router_bias``, expert
stacks ``w_gate``/``w_up`` [L,NE,E,F] and ``w_down`` [L,NE,F,E], shared
experts ``s_gate``/``s_up``/``s_down``). The routed experts run through the
grouped expert kernel (``ops/moe.py``, unpacked gate and up). With
``fused_decode`` at T=1 (not fresh prefill) the dense-layer MLPs and the
shared experts each run as one call of B8 (``ops/fused_layer.
fused_mlp_stacked``); attention stays plain torch, as it stays XLA in JAX,
except the kernels ``impl`` selects: K3 for a T=1 slot decode
(``"pallas"``) and a T=1 paged decode (``"pallas"``, ``"pallas2"``,
``"clamp"``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from ..engine.kvcache import kv_slots, write_rows_slots
from ..ops import attention as attn_ops
from ..ops.fused_layer import fused_mlp_stacked, mlp_shapes_ok
from ..ops.moe import dispatch_ragged
from ..ops.paged_attention import latent_prefill
from ..ops.slot_attention import slot_attention
from .common import (
    apply_rope,
    dot_bf16,
    matmul_f32,
    rms_norm,
    rope_angles,
    row_dot_bf16,
    swiglu,
)
from .qwen3 import _embed, _lm_head, _seq_attention


@dataclass(frozen=True)
class DeepSeekV3Config:
    vocab_size: int = 129280
    hidden: int = 7168
    n_layers: int = 61
    n_heads: int = 128
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    dense_intermediate: int = 18432
    first_k_dense: int = 3
    n_routed_experts: int = 256
    n_shared_experts: int = 1
    moe_intermediate: int = 2048
    top_k: int = 8
    n_group: int = 8
    topk_group: int = 4
    routed_scaling_factor: float = 2.5
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # the engine keeps one latent row per token in k_pages and a one-page
    # dummy v pool (engine/kvcache.py init_latent_pages)
    latent_cache: bool = True
    # no int8 weights: the JAX reference cannot serve them (its attention
    # reshapes the quantized w_kb / w_vb leaves as arrays, deepseek_v3.py:283;
    # engine/weights.py INT8_MLA_REFUSED); its forward takes no KV scales
    int8_weights: ClassVar[bool] = False
    int8_kv: ClassVar[bool] = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_kv_heads(self) -> int:   # cache heads
        return 1

    @property
    def raw_row_dim(self) -> int:  # latent + rope
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def head_dim(self) -> int:
        """The cache row width: ``raw_row_dim``, unpadded (JAX pads it to a
        multiple of 128 for its TPU tiling)."""
        return self.raw_row_dim

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def fused_decode_fits(self, device: torch.device) -> bool:
        """Whether B8 takes the dense and the shared-expert MLP widths
        (JAX's gate, ``engine.py:299-305``, on any device)."""
        return (mlp_shapes_ok(self.hidden, self.dense_intermediate)
                and mlp_shapes_ok(self.hidden, self.moe_intermediate * self.n_shared_experts))


DEEPSEEK_V3_CONFIGS = {
    "deepseek-v3": DeepSeekV3Config(),
    # Kimi-K2: 1T total / 32B active — 64 heads, 384 experts, 1 group
    "kimi-k2": DeepSeekV3Config(n_heads=64, n_routed_experts=384, n_group=1,
                                topk_group=1, first_k_dense=1,
                                rope_theta=50_000.0),
    "deepseek-v3-test": DeepSeekV3Config(
        vocab_size=512, hidden=64, n_layers=3, n_heads=4, q_lora_rank=32,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, dense_intermediate=128, first_k_dense=1,
        n_routed_experts=8, n_shared_experts=1, moe_intermediate=48,
        top_k=2, n_group=2, topk_group=1, tie_embeddings=True),
}


def route_v3(x, router_w, bias, cfg: DeepSeekV3Config):
    """Sigmoid scores; selection by the bias-corrected scores, limited to the
    ``topk_group`` groups with the largest top-2 sums; weights from the
    unbiased scores, renormalised and times ``routed_scaling_factor``.
    x [T,E] → (weights [T,k] float32, expert ids [T,k] int64)."""
    T = x.shape[0]
    scores = torch.sigmoid(matmul_f32(x, router_w))          # [T, NE]
    sel = scores + bias.float()[None, :]
    if cfg.n_group > 1:
        G = cfg.n_group
        per = cfg.n_routed_experts // G
        grp_score = sel.reshape(T, G, per).topk(min(2, per), dim=-1).values.sum(-1)
        top_groups = grp_score.topk(cfg.topk_group, dim=-1).indices
        gmask = torch.zeros((T, G), dtype=torch.bool, device=x.device)
        gmask.scatter_(1, top_groups, True)
        # each group's flag over its experts (a broadcast: a CUDA graph
        # captures no host-side size computation)
        sel = sel.masked_fill(~gmask[:, :, None].expand(T, G, per).reshape(T, G * per),
                              float("-inf"))
    top_e = sel.topk(cfg.top_k, dim=-1).indices
    w = torch.gather(scores, 1, top_e)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    return w * cfg.routed_scaling_factor, top_e


def logical_axes(cfg: DeepSeekV3Config) -> dict:
    """Tree of logical-axis tuples mirroring the params (JAX
    ``deepseek_v3.py:181``)."""
    attn = {
        "ln1": ("layer", "embed"), "ln2": ("layer", "embed"),
        "w_qa": ("layer", "embed", None), "q_a_norm": ("layer", None),
        "w_qb": ("layer", None, "heads"),
        "w_kva": ("layer", "embed", None), "kv_a_norm": ("layer", None),
        "w_kb": ("layer", None, "heads"), "w_vb": ("layer", None, "heads"),
        "wo": ("layer", "heads", "embed"),
    }
    dense = dict(attn, **{
        "d_gate": ("layer", "embed", "mlp"), "d_up": ("layer", "embed", "mlp"),
        "d_down": ("layer", "mlp", "embed"),
    })
    moe = dict(attn, **{
        "router": ("layer", "embed", None), "router_bias": ("layer", None),
        "w_gate": ("layer", "expert", "embed", "expert_mlp"),
        "w_up": ("layer", "expert", "embed", "expert_mlp"),
        "w_down": ("layer", "expert", "expert_mlp", "embed"),
        "s_gate": ("layer", "embed", "mlp"), "s_up": ("layer", "embed", "mlp"),
        "s_down": ("layer", "mlp", "embed"),
    })
    tree = {"embed": ("vocab", "embed"), "dense_layers": dense,
            "moe_layers": moe, "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("embed", "vocab")
    return tree


def _moe_v3_routed(cfg, lp: dict, l: int, x, plain: bool = False, par=None):
    """Layer ``l``'s routed experts on x [T,E] (``plain``: the expert FFN's
    plain versions); under ``par`` this rank's experts at its MLP columns,
    summed over ``tp`` and ``ep``."""
    w, top_e = route_v3(x, lp["router"][l], lp["router_bias"][l], cfg)
    experts = None
    if par is not None:   # as qwen3_moe._moe_block
        experts = par.experts(cfg.n_routed_experts)
        w, x = par.enter_experts(w), par.enter_experts(x)
    out = dispatch_ragged(x, w, top_e, cfg.n_routed_experts, lp["w_gate"][l],
                          lp["w_up"][l], lp["w_down"][l], plain, experts)
    return out if par is None else par.reduce_experts(out)


def _moe_v3(cfg, lp: dict, l: int, h2, plain: bool = False, par=None):
    """Routed + shared experts on h2 [B,T,E]."""
    B, T, E = h2.shape
    x = h2.reshape(B * T, E)
    routed = _moe_v3_routed(cfg, lp, l, x, plain, par)
    shared = swiglu(x, lp["s_gate"][l], lp["s_up"][l], lp["s_down"][l], par)
    return (routed.to(h2.dtype) + shared.to(h2.dtype)).reshape(B, T, E)


def _dense_mlp(lp: dict, l: int, h2, par=None):
    return swiglu(h2, lp["d_gate"][l], lp["d_up"][l], lp["d_down"][l], par).to(h2.dtype)


def _mla_qk(cfg, lp: dict, l: int, h, cos, sin, par=None):
    """Queries in absorbed (latent) space and this chunk's cache rows:
    q_eff [B,T,H,KL+QR], rows [B,T,1,KL+QR]. Under ``par``: this rank's
    heads; the latent rows, alike on every rank, enter its heads'
    attention through ``par.enter``."""
    B, T, _ = h.shape
    H, KL = cfg.n_heads, cfg.kv_lora_rank
    QN, QR = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    eps = cfg.rms_eps
    qa = rms_norm(dot_bf16(h, lp["w_qa"][l]), lp["q_a_norm"][l], eps)
    if par is not None:
        qa = par.enter(qa)
    q = dot_bf16(qa, lp["w_qb"][l]).reshape(B, T, H, QN + QR)
    q_rope = apply_rope(q[..., QN:], cos, sin)
    # absorb W_kb: q_lat[b,t,h,l] = sum_n q_nope[b,t,h,n] * W_kb[l,h,n]
    w_kb = lp["w_kb"][l].reshape(KL, H, QN)
    q_lat = torch.einsum("bthn,lhn->bthl", q[..., :QN].float(), w_kb.float()).to(h.dtype)
    q_eff = torch.cat([q_lat, q_rope.to(h.dtype)], dim=-1)
    kva = dot_bf16(h, lp["w_kva"][l])
    latent = rms_norm(kva[..., :KL], lp["kv_a_norm"][l], eps)
    k_rope = apply_rope(kva[..., None, KL:], cos, sin)                 # [B,T,1,QR]
    rows = torch.cat([latent[..., None, :], k_rope.to(h.dtype)], dim=-1)
    if par is not None:
        rows = par.enter(rows)
    return q_eff, rows


def _mla_out(cfg, lp: dict, l: int, attn_lat, dtype, par=None):
    """Attention over latent rows [B,T,H,KL] → per-head value up-projection
    → wo (row-parallel under ``par``)."""
    B, T, H, KL = attn_lat.shape
    w_vb = lp["w_vb"][l].reshape(KL, H, cfg.v_head_dim)
    out = torch.einsum("bthl,lhv->bthv", attn_lat.float(), w_vb.float()).to(dtype)
    return row_dot_bf16(out.reshape(B, T, -1), lp["wo"][l], par).to(dtype)


class LatentAttention:
    """The serving branches of MLA attention over the latent pool (JAX
    ``deepseek_v3.py:358-413``), built once per serving forward with the
    layer-invariant index math. ``__call__(layer, q_eff, rows)`` writes the
    rows of global layer ``layer`` in place (padding → the spare row) and
    attends with v = the rows' first ``kv_lora_rank`` columns:

    * fresh prefill: causal attention over the chunk itself;
    * slot decode at T=1 with ``impl="pallas"``: B1's shared variant
      (:func:`.slot_attention.slot_attention` with ``v_pool=None``; K3 on
      the card); a slot decode otherwise (T>1: the speculative window, or
      ``"xla"``): the masked gather over the row's first ``slot_ctx`` keys;
    * re-prefill (T>1 over a cached prefix): the prefix, read before the
      write, and the chunk's own rows, as k and v;
    * paged T=1: :func:`.attention.paged_attention` (the gather, or B6 → K3
      on the card under ``"pallas"`` / ``"pallas2"`` / ``"clamp"``).
    With ``impl="pallas"`` the three prefill branches (fresh, re-prefill,
    a slot window at T>1) write the rows first and attend over the pool
    through :func:`.paged_attention.latent_prefill` (K3's prefill mode on
    the card; the sequence-parallel fresh prefill stays as it is): the
    same keys as JAX's functions for every real query, 0 for a padding
    query. Returns [B,T,H,kv_lora_rank]."""

    def __init__(self, cfg, positions, *, k_pages, page_table, seq_lens, impl: str,
                 slot_decode: bool, slot_ctx: int | None, fresh_prefill: bool,
                 seq_attention=None):
        B, T = positions.shape
        self.seq_attention = seq_attention
        L, N, ps = k_pages.shape[:3]
        self.cfg, self.N, self.ps = cfg, N, ps
        self.kpf = k_pages.view((L * N,) + tuple(k_pages.shape[2:]))
        if slot_decode:
            page_table = torch.arange(B, device=positions.device)[:, None]
            slot_ctx = min(slot_ctx or ps, ps)
        self.page_table = page_table.long()
        self.positions, self.seq_lens, self.impl = positions, seq_lens, impl
        self.slot_decode, self.slot_ctx, self.fresh = slot_decode, slot_ctx, fresh_prefill
        self.pos_c = positions.clamp(min=0)
        self.scale = cfg.qk_head_dim ** -0.5
        self.slots0 = kv_slots(positions, self.page_table, ps, L * N * ps)
        self.layer_step = (positions >= 0).long() * (N * ps)
        kernel_decode = T == 1 and impl in (("pallas",) if slot_decode
                                            else ("pallas", "pallas2", "clamp"))
        self.prefill_kernel = impl == "pallas" and (fresh_prefill or T > 1)
        self.decode_mask = self.slot_limit = None
        if slot_decode and kernel_decode:
            self.slot_limit = torch.minimum(seq_lens.long(), self.pos_c[:, 0].long() + 1)
        elif (not fresh_prefill and (T == 1 or slot_decode) and not kernel_decode
              and not self.prefill_kernel):
            S = slot_ctx if slot_decode else self.page_table.shape[1] * ps
            self.decode_mask = attn_ops.context_mask(seq_lens, self.pos_c, S)

    def __call__(self, layer: int, q_eff, rows):
        B, T = self.positions.shape
        KL, D = self.cfg.kv_lora_rank, self.cfg.head_dim
        kpf, N, ps, scale = self.kpf, self.N, self.ps, self.scale
        slots_l = self.slots0 + layer * self.layer_step
        if self.prefill_kernel and self.seq_attention is None:
            # the chunk's rows first, then its queries over the pool
            write_rows_slots(kpf, rows, slots_l)
            rows_of = (dict(row_offset=layer * N, max_keys=self.slot_ctx) if self.slot_decode
                       else dict(page_table=self.page_table + layer * N))
            return latent_prefill(q_eff, kpf, self.seq_lens, self.positions, scale=scale,
                                  v_width=KL, **rows_of)
        if self.fresh:
            write_rows_slots(kpf, rows, slots_l)
            if self.seq_attention is not None:
                return self.seq_attention(q_eff, rows, rows[..., :KL], scale=scale)
            return attn_ops.causal_attention(q_eff, rows, rows[..., :KL], scale=scale)
        if self.slot_decode:
            write_rows_slots(kpf, rows, slots_l)
            if self.slot_limit is not None:
                return slot_attention(q_eff[:, 0], kpf, None, self.slot_limit, layer,
                                      n_rows=N, slot_ctx=self.slot_ctx, scale=scale,
                                      v_width=KL)[:, None]
            ctx = kpf[layer * N:(layer + 1) * N, :self.slot_ctx]
            return attn_ops.masked_context_attention(
                q_eff, ctx, ctx[..., :KL], self.seq_lens, self.pos_c, scale=scale,
                mask=self.decode_mask)
        table_l = self.page_table + layer * N
        if T > 1:
            # re-prefill: the cached prefix, read before this chunk's write
            old = attn_ops.gather_kv_rows(kpf, table_l).reshape(
                B, table_l.shape[1] * ps, 1, D)
            write_rows_slots(kpf, rows, slots_l)
            return attn_ops.prefix_chunk_attention(
                q_eff, old, old[..., :KL], rows, rows[..., :KL], self.positions[:, 0],
                self.positions, scale=scale)
        write_rows_slots(kpf, rows, slots_l)
        return attn_ops.paged_attention(q_eff, kpf, kpf, table_l, self.seq_lens, self.pos_c,
                                        scale=scale, mask=self.decode_mask, impl=self.impl,
                                        v_width=KL)


def forward(
    params: dict,
    cfg: DeepSeekV3Config,
    tokens: torch.Tensor,            # [B, T] int
    positions: torch.Tensor,         # [B, T] int absolute; <0 = padding
    *,
    k_pages: torch.Tensor | None = None,    # [L, N, ps, 1, D] latent rows
    v_pages: torch.Tensor | None = None,    # unused (the one-page dummy)
    page_table: torch.Tensor | None = None,
    seq_lens: torch.Tensor | None = None,
    logits_indices: torch.Tensor | None = None,
    impl: str = "xla",
    slot_decode: bool = False,
    slot_ctx: int | None = None,
    fresh_prefill: bool = False,
    fused_decode: bool = False,
    plain_experts: bool = False,
    par=None,
    seq_parallel: str | None = None,
):
    """Same contract as :func:`.qwen3.forward`, except that the cache is
    latent only: rows go into ``k_pages`` and ``v_pages`` is handed back
    untouched. Layer ``l`` of ``dense_layers`` is global layer ``l``, layer
    ``l`` of ``moe_layers`` global layer ``first_k_dense + l`` (its cache
    rows). ``plain_experts``: the routed experts through the grouped expert
    kernel's plain versions on any device (a reference on the card).

    Sharded under ``par`` as :func:`.qwen3.forward`: local q heads
    (``w_qb`` / ``w_kb`` / ``w_vb`` column slices), ``wo`` and the MLPs'
    down products row-parallel, the single latent row computed on every
    rank (its weights replicated: JAX replicates the latent pool over tp),
    the routed experts over ``ep`` × ``tp``."""
    serving = k_pages is not None
    x = _embed(params, tokens, par)
    B, T, E = x.shape
    eps, KL, LD = cfg.rms_eps, cfg.kv_lora_rank, cfg.first_k_dense
    cos, sin = rope_angles(positions.clamp(min=0), cfg.qk_rope_head_dim, cfg.rope_theta)
    dstack, mstack = params["dense_layers"], params["moe_layers"]
    use_fused = fused_decode and serving and T == 1 and not fresh_prefill
    attend = None
    if serving:
        attend = LatentAttention(cfg, positions, k_pages=k_pages, page_table=page_table,
                                 seq_lens=seq_lens, impl=impl, slot_decode=slot_decode,
                                 slot_ctx=slot_ctx, fresh_prefill=fresh_prefill,
                                 seq_attention=_seq_attention(par, seq_parallel, impl))

    def attention(lp: dict, l: int, layer: int, x):
        q_eff, rows = _mla_qk(cfg, lp, l, rms_norm(x, lp["ln1"][l], eps), cos, sin, par)
        if attend is not None:
            o = attend(layer, q_eff, rows)
        else:
            o = attn_ops.causal_attention(q_eff, rows, rows[..., :KL],
                                          scale=cfg.qk_head_dim ** -0.5)
        return x + _mla_out(cfg, lp, l, o, x.dtype, par)

    for l in range(LD):
        x = attention(dstack, l, l, x)
        if use_fused:
            # ln2 + MLP + residual as one B8 call; the dense layers lead, so
            # the global layer is the stack index
            x = fused_mlp_stacked(x[:, 0], dstack["ln2"], dstack["d_gate"], dstack["d_up"],
                                  dstack["d_down"], l, eps=eps)[:, None]
        else:
            x = x + _dense_mlp(dstack, l, rms_norm(x, dstack["ln2"][l], eps), par)
    for l in range(cfg.n_layers - LD):
        x = attention(mstack, l, LD + l, x)
        h2 = rms_norm(x, mstack["ln2"][l], eps)
        if use_fused:
            h2f = h2.reshape(B * T, E)
            routed = _moe_v3_routed(cfg, mstack, l, h2f, plain_experts)
            shared = fused_mlp_stacked(h2f, mstack["ln2"], mstack["s_gate"], mstack["s_up"],
                                       mstack["s_down"], l, eps=eps, residual=False,
                                       norm=False)
            x = x + (routed.to(x.dtype) + shared).reshape(B, T, E)
        else:
            x = x + _moe_v3(cfg, mstack, l, h2, plain_experts, par)

    x = rms_norm(x, params["final_norm"], eps)
    if logits_indices is not None:
        x = x[torch.arange(B, device=x.device), logits_indices.long()][:, None]
    logits = _lm_head(params, x, par=par, vocab=cfg.vocab_size)
    if not serving:
        return logits, None
    return logits, (k_pages, v_pages)
