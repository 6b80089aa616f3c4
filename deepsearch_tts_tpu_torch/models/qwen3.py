"""Qwen3 dense decoder family (port of ``models/qwen3.py``).

Parameters stay *stacked* across layers (leading ``L`` dim) exactly as in the
JAX package: the same dict tree (``embed``, ``final_norm``, optional
``lm_head``, and ``layers`` holding ``ln1``, ``wq``/``wk``/``wv`` or packed
``wqkv``, ...), so :func:`engine.weights.params_from_jax` is a leaf-by-leaf
copy and the fused decode kernels take layer ``l``'s weights as a pointer
offset into the stack.

:func:`forward` carries the JAX function's no-cache mode and the serving
branches the engine runs: fresh prefill, non-fresh re-prefill over a cached
prefix, T=1 paged decode and contiguous-slot decode (T=1, or a speculative
verify window of T tokens a row) — decode through the fused layer functions
(``ops/fused_layer.py``, a window flattened into B·T rows) when
``fused_decode`` is set and the weights are packed. ``impl`` selects the
attention kernels where JAX selects its Pallas ones: flash attention for
fresh prefill and the no-cache forward, the paged kernels for T=1 paged
decode, ``slot_attention`` for T=1 slot decode and
``slot_window_attention`` for a slot verify window. The layer loop is a
Python loop (the JAX ``lax.scan``); the KV pools are updated in place.

int8 (``ops/quant.py``): a matrix leaf may be ``{q, scales}`` (int8 stack +
float32 per-column scales); every product then goes through
``maybe_int8_dot`` / ``int8_matmul`` (``plain_int8``: their plain versions,
on any device), and the fused T=1 layer takes B10 (``*_i8``) when ``wqkv``
is quantized. int8 KV: given ``k_scales`` / ``v_scales`` pools, each
layer's k/v rows are quantized and written with their scales; fresh
prefill attends over the chunk's unquantized k/v, and re-prefill and decode
read the dequantized pages through ``paged_attention``'s gather.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.nn.functional as F
from torch import nn

from ..engine.kvcache import kv_slots, quantize_kv_rows, write_kv_slots, write_scales_slots
from ..ops import attention as attn_ops
from ..ops.fused_layer import (
    fused_out_mlp_stacked,
    fused_out_mlp_stacked_i8,
    fused_qkv_stacked,
    fused_qkv_stacked_i8,
    shapes_ok,
)
from ..ops.quant import int8_matmul, is_quantized, maybe_int8_dot
from ..ops.slot_attention import slot_attention, slot_window_attention
from .common import apply_rope, matmul_f32, rms_norm, rope_angles


@dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden: int = 4096
    n_layers: int = 36
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate: int = 12288
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # int8 serving (ROADMAP A10): int8 weights through B10 / B12, and int8
    # KV pools with their scales (``forward``'s ``k_scales`` / ``v_scales``)
    int8_weights: ClassVar[bool] = True
    int8_kv: ClassVar[bool] = True

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def mlp_shapes(self) -> dict[str, tuple[int, ...]]:
        """Per-layer MLP weights in the packed layout the engine serves."""
        return {"w_gateup": (self.hidden, 2 * self.intermediate),
                "w_down": (self.intermediate, self.hidden)}

    def fused_decode_widths(self) -> tuple[int, int, int] | None:
        """(E, H·D, N) of the fused T=1 decode layer's products, N being
        B4's MLP width F; None where the family runs no fused decode."""
        return self.hidden, self.n_heads * self.head_dim, self.intermediate

    def fused_decode_fits(self, device: torch.device) -> bool:
        """Whether the fused decode layer can run on ``device``: its plain
        versions on the CPU, the CUDA kernels where they take the widths."""
        return device.type == "cpu" or shapes_ok(*self.fused_decode_widths(), self.head_dim)


# Published size points of the family (head_dim is 128 across the board).
QWEN3_CONFIGS = {
    "qwen3-0.6b": Qwen3Config(hidden=1024, n_layers=28, n_heads=16, n_kv_heads=8,
                              intermediate=3072, tie_embeddings=True),
    "qwen3-1.7b": Qwen3Config(hidden=2048, n_layers=28, n_heads=16, n_kv_heads=8,
                              intermediate=6144, tie_embeddings=True),
    "qwen3-4b": Qwen3Config(hidden=2560, n_layers=36, n_heads=32, n_kv_heads=8,
                            intermediate=9728, tie_embeddings=True),
    "qwen3-8b": Qwen3Config(hidden=4096, n_layers=36, n_heads=32, n_kv_heads=8,
                            intermediate=12288),
    "qwen3-14b": Qwen3Config(hidden=5120, n_layers=40, n_heads=40, n_kv_heads=8,
                             intermediate=17408),
    "qwen3-32b": Qwen3Config(hidden=5120, n_layers=64, n_heads=64, n_kv_heads=8,
                             intermediate=25600),
    # tiny config for tests
    "qwen3-test": Qwen3Config(vocab_size=512, hidden=128, n_layers=2, n_heads=4,
                              n_kv_heads=2, head_dim=32, intermediate=256,
                              tie_embeddings=True),
}


def _at(w, l: int):
    """Layer ``l`` of a stacked weight leaf, plain or int8 ``{q, scales}``."""
    if is_quantized(w):
        return {"q": w["q"][l], "scales": w["scales"][l]}
    return w[l]


def _dot(h: torch.Tensor, w, l: int, plain: bool = False) -> torch.Tensor:
    """``maybe_int8_dot`` of h with layer ``l`` of a stacked weight."""
    return maybe_int8_dot(h, _at(w, l), plain=plain)


def _qkv(cfg: Qwen3Config, lp: dict, l: int, h: torch.Tensor, plain: bool = False):
    B, T, _ = h.shape
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "wqkv" in lp:  # packed single-chip layout (engine pack_weights)
        qkv = _dot(h, lp["wqkv"], l, plain)
        q = qkv[..., : H * D].reshape(B, T, H, D)
        k = qkv[..., H * D: (H + K) * D].reshape(B, T, K, D)
        v = qkv[..., (H + K) * D:].reshape(B, T, K, D)
    else:
        q = _dot(h, lp["wq"], l, plain).reshape(B, T, H, D)
        k = _dot(h, lp["wk"], l, plain).reshape(B, T, K, D)
        v = _dot(h, lp["wv"], l, plain).reshape(B, T, K, D)
    return q, k, v


def _mlp(cfg: Qwen3Config, lp: dict, l: int, h: torch.Tensor,
         plain: bool = False) -> torch.Tensor:
    if "w_gateup" in lp:
        Fi = cfg.intermediate
        gu = _dot(h, lp["w_gateup"], l, plain)
        g, u = gu[..., :Fi], gu[..., Fi:]
    else:
        g = _dot(h, lp["w_gate"], l, plain)
        u = _dot(h, lp["w_up"], l, plain)
    return _dot(F.silu(g.float()).to(u.dtype) * u, lp["w_down"], l, plain)


def _lm_head(params: dict, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Final projection with float32 logits (``preferred_element_type=f32``).
    An int8 head rounds its product to x's dtype first, then widens
    (``qwen3.py:530-533``): bf16-rounded logits on a bf16 model."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].t()
    x2 = x.reshape(-1, x.shape[-1])
    if is_quantized(head):
        logits = int8_matmul(x2, head["q"], head["scales"], plain=plain).float()
    else:
        logits = matmul_f32(x2, head)
    return logits.reshape(*x.shape[:-1], -1)


class ServingAttention:
    """The attention half of a serving decoder layer, shared by the dense and
    the MoE family (the JAX families each carry their own copy).

    Built once per serving forward: the layer-invariant index math — each
    token's pool row in layer 0 (padding → the spare row past the pool), the
    offset one layer adds to it, and the decode attention mask or slot limit.
    ``attend(l, x)`` then runs layer ``l``: q/k/v (the fused B3 or B10
    kernel on ``x`` [B·T,E] when ``fused``, else the plain chain on ``x``
    [B,T,E]), the in-place KV write (quantized, with its scales, when the
    scales pools are given) and one of five branches — fresh causal
    prefill, slot decode (B1 at T=1, B9 over a speculative verify window,
    or the masked gather), re-prefill over a cached prefix, and T=1 paged
    decode (B6 or the gather). Returns o [B,T,H,D].

    int8 KV follows JAX's routing (``qwen3.py:297-400``): fresh prefill
    attends over the chunk's unquantized k/v; re-prefill does not take
    ``prefix_chunk_attention`` but reads the pages after the write, like
    T=1 decode, through ``paged_attention``'s gather."""

    def __init__(self, cfg, lp: dict, positions, cos, sin, *, k_pages, v_pages,
                 page_table, seq_lens, impl: str, slot_decode: bool,
                 slot_ctx: int | None, fresh_prefill: bool, fused: bool,
                 k_scales=None, v_scales=None, plain: bool = False):
        B, T = positions.shape
        L, N, ps = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
        self.cfg, self.lp, self.cos, self.sin, self.plain = cfg, lp, cos, sin, plain
        self.kpf = k_pages.view((L * N,) + tuple(k_pages.shape[2:]))
        self.vpf = v_pages.view((L * N,) + tuple(v_pages.shape[2:]))
        self.kv_int8 = k_scales is not None
        if self.kv_int8:
            if slot_decode:
                raise ValueError("int8 KV runs on the paged cache, not slot decode")
            self.ksf = k_scales.view((L * N,) + tuple(k_scales.shape[2:]))
            self.vsf = v_scales.view((L * N,) + tuple(v_scales.shape[2:]))
        if slot_decode:
            page_table = torch.arange(B, device=positions.device)[:, None]
            slot_ctx = min(slot_ctx or ps, ps)
        self.page_table = page_table.long()
        self.positions, self.seq_lens, self.impl = positions, seq_lens, impl
        self.slot_decode, self.slot_ctx, self.fresh = slot_decode, slot_ctx, fresh_prefill
        self.N, self.ps, self.fused = N, ps, fused
        self.pos_c = positions.clamp(min=0)
        self.slots0 = kv_slots(positions, self.page_table, ps, L * N * ps)
        self.layer_step = (positions >= 0).long() * (N * ps)
        kernel_decode = T == 1 and impl in (("pallas",) if slot_decode
                                            else ("pallas", "pallas2", "clamp"))
        # a T > 1 slot decode is a speculative verify window: B9 with
        # impl="pallas", else the masked gather with per-query positions
        self.window_kernel = slot_decode and T > 1 and impl == "pallas"
        self.decode_mask = self.slot_limit = None
        if (not fresh_prefill and (T == 1 or slot_decode) and not kernel_decode
                and not self.window_kernel):
            S = slot_ctx if slot_decode else self.page_table.shape[1] * ps
            self.decode_mask = attn_ops.context_mask(seq_lens, self.pos_c, S)
        elif slot_decode and kernel_decode:
            self.slot_limit = torch.minimum(seq_lens.long(), self.pos_c[:, 0].long() + 1)
        if fused:
            self.cosf, self.sinf = cos.reshape(B * T, -1), sin.reshape(B * T, -1)

    def _write(self, k, v, slots_l) -> None:
        """This layer's rows into the pools (int8 KV: quantized, with their
        scales)."""
        if self.kv_int8:
            (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
            write_kv_slots(self.kpf, self.vpf, kq, vq, slots_l)
            write_scales_slots(self.ksf, ks, slots_l)
            write_scales_slots(self.vsf, vs, slots_l)
        else:
            write_kv_slots(self.kpf, self.vpf, k, v, slots_l)

    def __call__(self, l: int, x: torch.Tensor) -> torch.Tensor:
        cfg, lp = self.cfg, self.lp
        H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        B, T = self.positions.shape
        if self.fused:
            kw = dict(n_heads=H, n_kv=K, head_dim=D, eps=cfg.rms_eps)
            w = lp["wqkv"]
            if is_quantized(w):
                qf, kf, vf = fused_qkv_stacked_i8(
                    x, lp["ln1"], w["q"], w["scales"], lp["q_norm"], lp["k_norm"],
                    self.cosf, self.sinf, l, **kw)
            else:
                qf, kf, vf = fused_qkv_stacked(x, lp["ln1"], w, lp["q_norm"], lp["k_norm"],
                                               self.cosf, self.sinf, l, **kw)
            q, k, v = qf.reshape(B, T, H, D), kf.reshape(B, T, K, D), vf.reshape(B, T, K, D)
        else:
            q, k, v = _qkv_roped(cfg, lp, l, x, self.cos, self.sin, self.plain)
            v = v.to(x.dtype)
        kpf, vpf, N = self.kpf, self.vpf, self.N
        table_l = self.page_table + l * N
        slots_l = self.slots0 + l * self.layer_step
        if self.fresh:
            # positions start at 0: causal attention over the chunk itself;
            # padded tail rows are garbage that is never read
            self._write(k, v, slots_l)
            return attn_ops.causal_attention(q, k, v, impl=self.impl)
        if self.slot_decode:
            write_kv_slots(kpf, vpf, k, v, slots_l)
            if self.slot_limit is not None:
                return slot_attention(q[:, 0], kpf, vpf, self.slot_limit, l, n_rows=N,
                                      slot_ctx=self.slot_ctx)[:, None]
            if self.window_kernel:
                return slot_window_attention(q, kpf, vpf, self.seq_lens, self.positions[:, 0],
                                             l, n_rows=N, slot_ctx=self.slot_ctx)
            rows = slice(l * N, (l + 1) * N)
            return attn_ops.masked_context_attention(
                q, kpf[rows, :self.slot_ctx], vpf[rows, :self.slot_ctx], self.seq_lens,
                self.pos_c, mask=self.decode_mask)
        if self.kv_int8:
            # re-prefill and decode: the pages after the write, dequantized
            self._write(k, v, slots_l)
            return attn_ops.paged_attention(
                q, kpf, vpf, table_l, self.seq_lens, self.pos_c, mask=self.decode_mask,
                k_scales=self.ksf, v_scales=self.vsf)
        if T > 1:
            # re-prefill over a cached prefix: read the prefix BEFORE this
            # chunk's in-place write, take the chunk's K/V directly
            P, ps = table_l.shape[1], self.ps
            k_old = attn_ops.gather_kv_rows(kpf, table_l).reshape(B, P * ps, K, D)
            v_old = attn_ops.gather_kv_rows(vpf, table_l).reshape(B, P * ps, K, D)
            write_kv_slots(kpf, vpf, k, v, slots_l)
            return attn_ops.prefix_chunk_attention(
                q, k_old, v_old, k, v, self.positions[:, 0], self.positions)
        write_kv_slots(kpf, vpf, k, v, slots_l)
        return attn_ops.paged_attention(q, kpf, vpf, table_l, self.seq_lens, self.pos_c,
                                        mask=self.decode_mask, impl=self.impl)


def _qkv_roped(cfg, lp: dict, l: int, x: torch.Tensor, cos, sin, plain: bool = False):
    """Layer ``l``'s plain q/k/v: rmsnorm, projection, per-head q/k norm and
    RoPE; q and k in x's dtype, v as the projection leaves it."""
    eps = cfg.rms_eps
    h = rms_norm(x, lp["ln1"][l], eps)
    q, k, v = _qkv(cfg, lp, l, h, plain)
    q = apply_rope(rms_norm(q, lp["q_norm"][l], eps), cos, sin).to(x.dtype)
    k = apply_rope(rms_norm(k, lp["k_norm"][l], eps), cos, sin).to(x.dtype)
    return q, k, v


def _fused_decode_on(fused_decode, T, fresh_prefill, lp, slot_decode: bool = False) -> bool:
    """Whether a serving forward takes the fused layer functions: at T=1,
    and for a slot decode's verify window of up to 8 tokens, flattened into
    B·T rows (JAX ``qwen3.py:275-280``)."""
    return (fused_decode and (T == 1 or (slot_decode and T <= 8)) and not fresh_prefill
            and "wqkv" in lp and "w_gateup" in lp)


def forward(
    params: dict,
    cfg: Qwen3Config,
    tokens: torch.Tensor,            # [B, T] int
    positions: torch.Tensor,         # [B, T] int absolute; <0 = padding
    *,
    k_pages: torch.Tensor | None = None,    # [L, N, ps, K, D] serving mode
    v_pages: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,  # [B, P] int
    seq_lens: torch.Tensor | None = None,    # [B]
    logits_indices: torch.Tensor | None = None,  # [B] position in T to project
    impl: str = "xla",               # attention: "xla" | "pallas" | "pallas2" | "clamp"
    slot_decode: bool = False,       # contiguous-slot decode: batch row == pool row
    slot_ctx: int | None = None,     # context bucket the slot decode reads
    fresh_prefill: bool = False,     # no cached prefix: attend over the chunk
    fused_decode: bool = False,      # T=1 packed-weight fused layer functions
    k_scales: torch.Tensor | None = None,   # int8 KV: [L, N, ps, K] f32 scales
    v_scales: torch.Tensor | None = None,
    plain_int8: bool = False,        # int8 products through their plain versions
):
    """Run the decoder.

    Serving mode (pages given): writes the chunk's KV into the paged cache
    IN PLACE and attends over the cached sequence; returns
    ``(logits [B,(T|1),V] f32, (k_pages, v_pages))`` with the same pool
    tensors, and ``(k_pages, v_pages, k_scales, v_scales)`` with int8 KV
    (int8 pools and their scales pools). With ``slot_decode`` the pools are
    ``[L, B, max_seq_len, K, D]``, row b's table is the identity and
    attention reads the first ``slot_ctx`` positions of its row. Training
    mode (pages None): full causal attention, returns ``(logits [B,T,V],
    None)``. ``plain_int8`` keeps every int8 product off the kernels (the
    unfused chain with the plain int8 product): a reference on the card.
    """
    lp = params["layers"]
    H, D = cfg.n_heads, cfg.head_dim
    eps = cfg.rms_eps
    x = params["embed"][tokens.long()]
    cos, sin = rope_angles(positions.clamp(min=0), D, cfg.rope_theta)
    B, T, E = x.shape
    serving = k_pages is not None

    def layer_tail(l: int, o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x + o@wo, then the MLP block, unfused."""
        x = x + _dot(o.reshape(B, T, H * D), lp["wo"], l, plain_int8).to(x.dtype)
        return x + _mlp(cfg, lp, l, rms_norm(x, lp["ln2"][l], eps), plain_int8).to(x.dtype)

    if serving:
        use_fused = (_fused_decode_on(fused_decode, T, fresh_prefill, lp, slot_decode)
                     and not plain_int8)
        attend = ServingAttention(
            cfg, lp, positions, cos, sin, k_pages=k_pages, v_pages=v_pages,
            page_table=page_table, seq_lens=seq_lens, impl=impl,
            slot_decode=slot_decode, slot_ctx=slot_ctx, fresh_prefill=fresh_prefill,
            fused=use_fused, k_scales=k_scales, v_scales=v_scales, plain=plain_int8)
        if use_fused:
            xf = x.reshape(B * T, E)
        for l in range(cfg.n_layers):
            if not use_fused:
                x = layer_tail(l, attend(l, x), x)
                continue
            a = attend(l, xf).reshape(B * T, H * D).to(x.dtype)
            if is_quantized(lp["wqkv"]):
                wo, gu, wd = lp["wo"], lp["w_gateup"], lp["w_down"]
                xf = fused_out_mlp_stacked_i8(
                    a, xf, wo["q"], wo["scales"], lp["ln2"], gu["q"], gu["scales"],
                    wd["q"], wd["scales"], l, eps=eps)
            else:
                xf = fused_out_mlp_stacked(a, xf, lp["wo"], lp["ln2"], lp["w_gateup"],
                                           lp["w_down"], l, eps=eps)
        if use_fused:
            x = xf.reshape(B, T, E)
    else:
        for l in range(cfg.n_layers):
            q, k, v = _qkv_roped(cfg, lp, l, x, cos, sin, plain_int8)
            x = layer_tail(l, attn_ops.causal_attention(q, k, v, impl=impl), x)

    x = rms_norm(x, params["final_norm"], eps)
    if logits_indices is not None:
        x = x[torch.arange(B, device=x.device), logits_indices.long()][:, None]
    logits = _lm_head(params, x, plain_int8)
    if not serving:
        return logits, None
    if k_scales is not None:
        return logits, (k_pages, v_pages, k_scales, v_scales)
    return logits, (k_pages, v_pages)


class Qwen3(nn.Module):
    """Qwen3 over a stacked param tree held as (non-trainable) buffers.

    ``params`` is the JAX-layout dict; :meth:`params` hands the same tree
    back to :func:`forward`, so the module and the functional form share
    one code path."""

    def __init__(self, cfg: Qwen3Config, params: dict):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.Module()
        for name, t in params["layers"].items():
            self.layers.register_buffer(name, t, persistent=True)
        for name in ("embed", "final_norm", "lm_head"):
            if name in params:
                self.register_buffer(name, params[name], persistent=True)

    def params(self) -> dict:
        out = {name: buf for name, buf in self.named_buffers(recurse=False)}
        out["layers"] = dict(self.layers.named_buffers(recurse=False))
        return out

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor, **serving):
        return forward(self.params(), self.cfg, tokens, positions, **serving)
