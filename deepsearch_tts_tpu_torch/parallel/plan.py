"""Deployment memory planner: does a model fit a mesh of H100s, and which
mesh to use (port of ``parallel/plan.py``, the port's own copy).

Per device, where the bytes go: parameters (sharded per the rules tables
in ``parallel/sharding.py``), the KV pool (the port's layouts,
:func:`kv_pool_device_bytes`), and the serving activation high-water
(prefill causal scores). Computed analytically — no tracing, no device —
from the config dataclasses and logical-axis tables the real code paths
use. Pure Python: this module imports neither torch nor the models'
kernels (the configs come from ``models/*.py``, which import torch).

Exactness contract: :func:`param_table` mirrors each family's param tree
leaf for leaf (JAX's ``init_params``, the port's unpacked tree);
``tests/test_torch_parallel_plan.py`` holds the table and the counts to
the JAX planner's, and the pool bytes to the port's engine allocations.

Sharding model: a leaf dim whose logical axis maps to mesh axes divides the
leaf across ``prod(axis sizes)`` devices when divisible; a non-divisible dim
is reported as a *violation* and counted replicated. The KV pools follow
the port's sharded engine: local kv heads (``sharding.kv_heads_local``:
where tp exceeds the kv heads each rank keeps one head, JAX keeps all).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

from .sharding import SERVING_RULES, ShardingRules

GiB = 1024 ** 3
# ops/attention.py's query-block bound on float32 score elements
SCORES_BUDGET = 1 << 28

#: One H100 80GB HBM3 as ``torch.cuda.mem_get_info`` reports it (81,079
#: MiB), and the memory a serving rank cannot use: its CUDA context (545.2
#: MiB: the total less the free memory once CUDA has initialised) and the
#: caching allocator's reserved-but-unallocated bytes at a qwen3-8b tp=2
#: serving peak (0.46 and 0.78 GiB on the two ranks; the larger kept), as
#: ``chip_smoke.py``'s env and parallel phases read them on that card.
H100_HBM_GIB = 81079 / 1024
H100_RESERVED_GIB = 545.1875 / 1024 + 0.78

_DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1,
                "int32": 4}

# leaves the engine int8-quantizes (ops/quant.py QUANT_KEYS); everything
# else (norms, embed, router) stays at model dtype
_QUANT_LEAVES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                 "wqkv", "w_gateup", "d_gate", "d_up", "d_down",
                 "s_gate", "s_up", "s_down", "w_qb", "w_kb", "w_vb",
                 "lm_head"}


@dataclass(frozen=True)
class ParamLeaf:
    name: str                      # dotted path, e.g. "layers.wq"
    shape: tuple[int, ...]
    axes: tuple[Any, ...]          # logical axis names (None = replicated)
    f32: bool = False              # stored f32 regardless of model dtype


def _attn_leaves(prefix: str, nl: int, cfg) -> list[ParamLeaf]:
    """MLA attention block (deepseek_v3.init_params attn_block)."""
    E, H = cfg.hidden, cfg.n_heads
    QL, KL = cfg.q_lora_rank, cfg.kv_lora_rank
    QN, QR, VD = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    L = ("layer",)
    return [
        ParamLeaf(f"{prefix}.ln1", (nl, E), L + ("embed",)),
        ParamLeaf(f"{prefix}.ln2", (nl, E), L + ("embed",)),
        ParamLeaf(f"{prefix}.w_qa", (nl, E, QL), L + ("embed", None)),
        ParamLeaf(f"{prefix}.q_a_norm", (nl, QL), L + (None,)),
        ParamLeaf(f"{prefix}.w_qb", (nl, QL, H * (QN + QR)), L + (None, "heads")),
        ParamLeaf(f"{prefix}.w_kva", (nl, E, KL + QR), L + ("embed", None)),
        ParamLeaf(f"{prefix}.kv_a_norm", (nl, KL), L + (None,)),
        ParamLeaf(f"{prefix}.w_kb", (nl, KL, H * QN), L + (None, "heads")),
        ParamLeaf(f"{prefix}.w_vb", (nl, KL, H * VD), L + (None, "heads")),
        ParamLeaf(f"{prefix}.wo", (nl, H * VD, E), L + ("heads", "embed")),
    ]


def param_table(cfg) -> list[ParamLeaf]:
    """Analytic leaf table mirroring the family's ``init_params``.

    Dispatches on config class name. Accepts a config instance or a
    registered model name.
    """
    if isinstance(cfg, str):
        cfg = _resolve(cfg)[1]
    kind = type(cfg).__name__
    E = cfg.hidden
    leaves = [ParamLeaf("embed", (cfg.vocab_size, E), ("vocab", "embed")),
              ParamLeaf("final_norm", (E,), ("embed",))]
    if not cfg.tie_embeddings:
        leaves.append(ParamLeaf("lm_head", (E, cfg.vocab_size),
                                ("embed", "vocab")))

    if kind == "DeepSeekV3Config":
        LD = cfg.first_k_dense
        LM = cfg.n_layers - LD
        NE, F, FD = cfg.n_routed_experts, cfg.moe_intermediate, cfg.dense_intermediate
        FS = F * cfg.n_shared_experts
        L = ("layer",)
        leaves += _attn_leaves("dense_layers", LD, cfg)
        leaves += [
            ParamLeaf("dense_layers.d_gate", (LD, E, FD), L + ("embed", "mlp")),
            ParamLeaf("dense_layers.d_up", (LD, E, FD), L + ("embed", "mlp")),
            ParamLeaf("dense_layers.d_down", (LD, FD, E), L + ("mlp", "embed")),
        ]
        leaves += _attn_leaves("moe_layers", LM, cfg)
        leaves += [
            ParamLeaf("moe_layers.router", (LM, E, NE), L + ("embed", None)),
            ParamLeaf("moe_layers.router_bias", (LM, NE), L + (None,), f32=True),
            ParamLeaf("moe_layers.w_gate", (LM, NE, E, F),
                      L + ("expert", "embed", "expert_mlp")),
            ParamLeaf("moe_layers.w_up", (LM, NE, E, F),
                      L + ("expert", "embed", "expert_mlp")),
            ParamLeaf("moe_layers.w_down", (LM, NE, F, E),
                      L + ("expert", "expert_mlp", "embed")),
            ParamLeaf("moe_layers.s_gate", (LM, E, FS), L + ("embed", "mlp")),
            ParamLeaf("moe_layers.s_up", (LM, E, FS), L + ("embed", "mlp")),
            ParamLeaf("moe_layers.s_down", (LM, FS, E), L + ("mlp", "embed")),
        ]
        return leaves

    # qwen3 dense / qwen3-moe share the attention stack
    H, K, D, nl = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    L = ("layer",)
    leaves += [
        ParamLeaf("layers.ln1", (nl, E), L + ("embed",)),
        ParamLeaf("layers.ln2", (nl, E), L + ("embed",)),
        ParamLeaf("layers.q_norm", (nl, D), L + (None,)),
        ParamLeaf("layers.k_norm", (nl, D), L + (None,)),
        ParamLeaf("layers.wq", (nl, E, H * D), L + ("embed", "heads")),
        ParamLeaf("layers.wk", (nl, E, K * D), L + ("embed", "kv_heads")),
        ParamLeaf("layers.wv", (nl, E, K * D), L + ("embed", "kv_heads")),
        ParamLeaf("layers.wo", (nl, H * D, E), L + ("heads", "embed")),
    ]
    if kind == "Qwen3MoeConfig":
        NE, F = cfg.n_experts, cfg.moe_intermediate
        leaves += [
            ParamLeaf("layers.router", (nl, E, NE), L + ("embed", None)),
            ParamLeaf("layers.w_gate", (nl, NE, E, F),
                      L + ("expert", "embed", "expert_mlp")),
            ParamLeaf("layers.w_up", (nl, NE, E, F),
                      L + ("expert", "embed", "expert_mlp")),
            ParamLeaf("layers.w_down", (nl, NE, F, E),
                      L + ("expert", "expert_mlp", "embed")),
        ]
    elif kind == "Qwen3Config":
        F = cfg.intermediate
        leaves += [
            ParamLeaf("layers.w_gate", (nl, E, F), L + ("embed", "mlp")),
            ParamLeaf("layers.w_up", (nl, E, F), L + ("embed", "mlp")),
            ParamLeaf("layers.w_down", (nl, F, E), L + ("mlp", "embed")),
        ]
    else:
        raise ValueError(f"no param table for config class {kind}")
    return leaves


def count_params(cfg) -> int:
    return sum(math.prod(l.shape) for l in param_table(cfg))


def active_params(cfg) -> int:
    """Params touched per token (the A22B in 235B-A22B): expert stacks count
    top_k (+shared) of n_experts; everything else counts fully."""
    if isinstance(cfg, str):
        cfg = _resolve(cfg)[1]
    total = 0
    for l in param_table(cfg):
        n = math.prod(l.shape)
        if "expert" in l.axes:
            e_dim = l.shape[l.axes.index("expert")]
            k = getattr(cfg, "top_k", e_dim)
            n = n * k // e_dim
        total += n
    return total


def _axis_size(ax, mesh_shape: dict[str, int]) -> int:
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        return math.prod(_axis_size(a, mesh_shape) for a in ax)
    return int(mesh_shape.get(ax, 1))


def _leaf_device_bytes(leaf: ParamLeaf, mesh_shape, rules: ShardingRules,
                       weight_dtype: str, model_dtype: str,
                       violations: list[str]) -> float:
    n = math.prod(leaf.shape)
    shard = 1
    for dim, lax_ in zip(leaf.shape, leaf.axes):
        size = _axis_size(rules.axis(lax_), mesh_shape)
        if size == 1:
            continue
        if dim % size:
            violations.append(
                f"{leaf.name}: dim {dim} ({lax_}) not divisible by "
                f"mesh factor {size} — counted replicated")
            continue
        shard *= size
    key = leaf.name.rsplit(".", 1)[-1]
    if leaf.f32:
        bpe, scale_bytes = 4.0, 0.0
    elif weight_dtype == "int8" and key in _QUANT_LEAVES:
        # int8 payload + f32 per-output-channel scales ([..., 1, N]); scales
        # share the sharded (expert/output) dims so dividing the sum by the
        # same shard factor is exact
        bpe = 1.0
        scale_bytes = n // leaf.shape[-2] * 4.0 if len(leaf.shape) >= 2 else 0.0
    else:
        bpe = float(_DTYPE_BYTES[model_dtype])
        scale_bytes = 0.0
    return (n * bpe + scale_bytes) / shard


def param_device_bytes(cfg, mesh_shape: dict[str, int],
                       rules: ShardingRules = SERVING_RULES,
                       weight_dtype: str | None = None
                       ) -> tuple[float, list[str]]:
    """Per-device parameter bytes under the rules table + mesh shape."""
    weight_dtype = weight_dtype or cfg.dtype
    violations: list[str] = []
    total = sum(_leaf_device_bytes(l, mesh_shape, rules, weight_dtype,
                                   cfg.dtype, violations)
                for l in param_table(cfg))
    return total, violations


def kv_pool_device_bytes(cfg, mesh_shape: dict[str, int], *,
                         max_slots: int, max_seq_len: int,
                         page_size: int = 64, cache_mode: str = "slot",
                         rules: ShardingRules = SERVING_RULES,
                         headroom_pages: int = 1,
                         kv_budget_tokens: int | None = None,
                         kv_quantize: str | None = None
                         ) -> tuple[float, list[str]]:
    """KV pool bytes per device, mirroring the port's pools
    (``engine/kvcache.py``, ``Engine.__init__``).

    slot mode: page_size=max_seq_len, n_pages=max_slots (one row per slot).
    paged mode: n_pages sized for max_slots full sequences + the null page
    (JAX's worst case), or with ``kv_budget_tokens`` a shared page pool of
    that many tokens. Each pool's storage holds one spare row (the padding
    sink). bf16 k and v pools ``[L, N, ps, K, D]`` at the local kv heads;
    int8 KV (``kv_quantize``): int8 pools (no int32 packing) plus float32
    scales pools ``[L, N, ps, K]``; MLA (``latent_cache``): the latent pool
    at its own row width (576: no padding to 640) and a one-page dummy v
    pool. Where tp does not divide the kv heads each rank keeps one
    (``sharding.kv_heads_local``; MLA's single latent head on every rank):
    no violation, unlike JAX's whole-cache replication."""
    from .sharding import kv_heads_local

    K, D, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    if cache_mode == "slot":
        ps, n_pages = max_seq_len, max_slots
    elif kv_budget_tokens is not None:
        ps = page_size
        n_pages = -(-kv_budget_tokens // page_size) + headroom_pages
    else:
        ps = page_size
        n_pages = max_slots * -(-max_seq_len // page_size) + headroom_pages
    violations: list[str] = []
    tp = _axis_size(rules.axis("kv_heads"), mesh_shape)
    try:
        k_local = kv_heads_local(K, tp)[0]
    except ValueError as e:
        violations.append(f"kv pool: {e} — cache replicated over tp")
        k_local = K
    rows = L * n_pages * ps + 1
    if getattr(cfg, "latent_cache", False):
        bpe = _DTYPE_BYTES[cfg.dtype]
        return rows * D * bpe + L * ps * D * bpe, violations   # latent + dummy v
    if kv_quantize:
        per_row = k_local * (D + 4)          # int8 row + its float32 scale
    else:
        per_row = k_local * D * _DTYPE_BYTES[cfg.dtype]
    return 2 * rows * per_row, violations


def activation_device_bytes(cfg, mesh_shape: dict[str, int], *,
                            max_slots: int, prefill_lane: int = 0,
                            prefill_token_budget: int = 8192,
                            max_bucket: int = 2048) -> float:
    """Serving activation high-water estimate (decode step ∪ prefill group).

    Decode: rows × a handful of hidden/mlp-wide f32-ish intermediates plus
    the f32 logits [rows, vocab] (the port all-gathers them whole on every
    rank). Prefill: the fresh-causal score tensor [G, H_local, T, T] f32
    with G×T capped by the engine's ``PREFILL_TOKEN_BUDGET``, computed in
    query blocks of at most ``ops/attention.SCORES_BUDGET`` elements, plus
    the group's hidden/mlp activations and logits. Deliberately ~20%
    conservative; the planner's fit check adds reserved_gib on top.
    """
    tp = _axis_size("tp", mesh_shape)
    H = cfg.n_heads // tp if cfg.n_heads % tp == 0 else cfg.n_heads
    E = cfg.hidden
    F = getattr(cfg, "intermediate", None) or getattr(
        cfg, "dense_intermediate", None) or getattr(cfg, "moe_intermediate")
    if hasattr(cfg, "n_experts") or hasattr(cfg, "n_routed_experts"):
        # ragged path materializes top_k-sorted rows [T*top_k, E] and
        # the expert ffn intermediates at the same width
        F = max(F, getattr(cfg, "moe_intermediate") * getattr(cfg, "top_k", 1))
    F = F // tp if F % tp == 0 else F
    vocab = cfg.vocab_size
    rows = max_slots + prefill_lane

    def act(nrows: int, T: int = 1) -> float:
        width = max(E, F, H * getattr(cfg, "head_dim", 128))
        # qkv/gate/up/down + residual + norm temps, bf16, ~6 live buffers
        core = nrows * T * width * 2 * 6
        logits = nrows * vocab * 4          # f32 logits (last position only)
        return core + logits

    decode = act(rows)
    T = min(max_bucket, prefill_token_budget)
    g = max(1, prefill_token_budget // max(T, 1))
    scores = min(g * H * T * T, SCORES_BUDGET) * 4   # one query block's f32 scores
    prefill = scores + act(g, T)
    return float(max(decode, prefill))


@dataclass
class DeploymentPlan:
    model: str
    mesh: dict[str, int]
    weight_dtype: str
    hbm_gib: float
    reserved_gib: float
    params_total: int
    params_active: int
    per_device: dict[str, float] = field(default_factory=dict)  # GiB
    violations: list[str] = field(default_factory=list)
    kv_capacity_tokens: int = 0        # tokens the *leftover* HBM could cache
    fits: bool = False

    def summary(self) -> str:
        pd = self.per_device
        mesh = {k: v for k, v in self.mesh.items() if v > 1} or {"single": 1}
        flag = "FITS" if self.fits else "DOES NOT FIT"
        s = (f"{self.model} [{self.weight_dtype}] on "
             f"{math.prod(self.mesh.values())}x{self.hbm_gib:.0f}GiB {mesh}: "
             f"{flag} — params {pd['params']:.2f} + kv {pd['kv']:.2f} + "
             f"acts {pd['activations']:.2f} + reserved {self.reserved_gib:.1f}"
             f" = {pd['total']:.2f} GiB/device"
             f" (headroom {pd['headroom']:.2f}, "
             f"kv capacity ~{self.kv_capacity_tokens//1000}k tok/device)")
        if self.violations:
            s += f"; {len(self.violations)} sharding violations"
        if not self.fits and self.kv_capacity_tokens > 0:
            s += (f" — would fit with the KV pool shrunk to "
                  f"~{self.kv_capacity_tokens//1000}k cached tokens/device")
        return s


def _spare_row_bytes(cfg, mesh_shape, rules) -> float:
    """The fixed part of a one-token pool: the spare rows (and MLA's dummy
    v pool at one position a layer)."""
    from .sharding import kv_heads_local

    D = cfg.head_dim
    bpe = _DTYPE_BYTES[cfg.dtype]
    if getattr(cfg, "latent_cache", False):
        return D * bpe + cfg.n_layers * D * bpe
    try:
        k_local = kv_heads_local(cfg.n_kv_heads,
                                 _axis_size(rules.axis("kv_heads"), mesh_shape))[0]
    except ValueError:
        k_local = cfg.n_kv_heads
    return 2 * k_local * D * bpe


def _resolve(model):
    """model name or config instance → (name, cfg)."""
    if not isinstance(model, str):
        return type(model).__name__, model
    from ..models.deepseek_v3 import DEEPSEEK_V3_CONFIGS
    from ..models.qwen3 import QWEN3_CONFIGS
    from ..models.qwen3_moe import QWEN3_MOE_CONFIGS
    for table in (QWEN3_CONFIGS, QWEN3_MOE_CONFIGS, DEEPSEEK_V3_CONFIGS):
        if model in table:
            return model, table[model]
    raise KeyError(f"unknown model {model!r}")


def plan(model, mesh_shape: dict[str, int] | None = None, *,
         weight_dtype: str | None = None, max_slots: int = 64,
         max_seq_len: int = 8192, page_size: int = 64,
         cache_mode: str = "slot", prefill_lane: int = 0,
         hbm_gib: float = H100_HBM_GIB, reserved_gib: float = H100_RESERVED_GIB,
         kv_budget_tokens: int | None = None,
         rules: ShardingRules = SERVING_RULES) -> DeploymentPlan:
    """Memory plan for serving ``model`` on a mesh of ``mesh_shape``."""
    name, cfg = _resolve(model)
    mesh_shape = dict(mesh_shape or {})
    weight_dtype = weight_dtype or cfg.dtype

    pbytes, viol = param_device_bytes(cfg, mesh_shape, rules, weight_dtype)
    kvbytes, kviol = kv_pool_device_bytes(
        cfg, mesh_shape, max_slots=max_slots, max_seq_len=max_seq_len,
        page_size=page_size, cache_mode=cache_mode, rules=rules,
        kv_budget_tokens=kv_budget_tokens)
    abytes = activation_device_bytes(
        cfg, mesh_shape, max_slots=max_slots, prefill_lane=prefill_lane)

    total = pbytes + kvbytes + abytes + reserved_gib * GiB
    headroom = hbm_gib * GiB - total
    # bytes per cached token per device (for capacity reporting)
    per_tok, _ = kv_pool_device_bytes(cfg, mesh_shape, max_slots=1, max_seq_len=1,
                                      cache_mode="slot", rules=rules)
    per_tok -= _spare_row_bytes(cfg, mesh_shape, rules)
    # tokens the device's KV budget could hold: the allocated pool plus any
    # leftover headroom; when the plan doesn't fit this is what the pool
    # would need to SHRINK to (slots x seq re-sizing guidance)
    budget = kvbytes + headroom

    p = DeploymentPlan(
        model=name, mesh=mesh_shape, weight_dtype=weight_dtype,
        hbm_gib=hbm_gib, reserved_gib=reserved_gib,
        params_total=count_params(cfg), params_active=active_params(cfg),
        violations=viol + kviol,
        per_device={
            "params": pbytes / GiB, "kv": kvbytes / GiB,
            "activations": abytes / GiB, "total": total / GiB,
            "headroom": headroom / GiB,
        },
        kv_capacity_tokens=max(0, int(budget / per_tok)),
        fits=headroom >= 0,
    )
    return p


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def recommend(model, n_devices: int, *, weight_dtype: str | None = None,
              max_slots: int = 64, max_seq_len: int = 8192,
              cache_mode: str = "slot", hbm_gib: float = H100_HBM_GIB,
              top: int = 3, **kw) -> list[DeploymentPlan]:
    """Enumerate serving mesh geometries {dp, ep, tp} for ``n_devices`` and
    return the fitting plans, best first.

    Constraints honored: tp must divide n_heads (attention TP); tp beyond
    the kv-head count replicates the cache (allowed, flagged); ep must
    divide the expert count (1 for dense). Ranking: fitting plans with zero
    sharding violations first, then highest per-device KV token capacity
    (bigger batches/contexts per chip), then smallest tp (fewer collectives
    per matmul).
    """
    name, cfg = _resolve(model)
    n_exp = getattr(cfg, "n_experts", None) or getattr(
        cfg, "n_routed_experts", None) or 1
    out = []
    for tp in _divisors(n_devices):
        if cfg.n_heads % tp:
            continue
        for ep in _divisors(n_devices // tp):
            if n_exp % ep:
                continue
            dp = n_devices // tp // ep
            # dp shards batch: slots must split evenly
            if max_slots % dp:
                continue
            p = plan(model, {"dp": dp, "ep": ep, "tp": tp},
                     weight_dtype=weight_dtype,
                     max_slots=max_slots // dp, max_seq_len=max_seq_len,
                     cache_mode=cache_mode, hbm_gib=hbm_gib, **kw)
            p.mesh = {"dp": dp, "ep": ep, "tp": tp}
            out.append(p)
    # fitting plans first (fewest violations, most KV capacity, least tp);
    # among non-fitting plans, closest to fitting first so the summary shows
    # what to shrink
    out.sort(key=lambda p: (
        (0, len(p.violations) > 0, -p.kv_capacity_tokens, p.mesh["tp"])
        if p.fits else (1, p.per_device["total"])))
    return out[:top] if top else out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model", nargs="?", default="qwen3-235b-a22b")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--dtype", default=None, choices=[None, "bfloat16", "int8"])
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--hbm-gib", type=float, default=H100_HBM_GIB)
    ap.add_argument("--cache", default="slot", choices=["slot", "paged"])
    ap.add_argument("--kv-budget", type=int, default=None,
                    help="per-device KV token budget (paged shared pool)")
    args = ap.parse_args(argv)

    name, cfg = _resolve(args.model)
    print(f"{name}: {count_params(cfg)/1e9:.1f}B total / "
          f"{active_params(cfg)/1e9:.1f}B active params")
    for n in args.devices:
        plans = recommend(name, n, weight_dtype=args.dtype,
                          max_slots=args.slots, max_seq_len=args.seq,
                          cache_mode=args.cache, hbm_gib=args.hbm_gib,
                          kv_budget_tokens=args.kv_budget)
        print(f"\n== {n} x H100 ==")
        if not plans:
            print("  no valid geometry")
        for p in plans:
            print("  " + p.summary())
            for v in p.violations[:3]:
                print(f"    ! {v}")


if __name__ == "__main__":
    main()
