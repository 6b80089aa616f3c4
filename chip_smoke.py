#!/usr/bin/env python3
"""Drive the torch port's serving path once on one CUDA card.

    python3 chip_smoke.py                 # everything (needs one CUDA card)
    python3 chip_smoke.py --profile       # adds profiled full-batch bursts
    python3 chip_smoke.py --kernels-only  # build + kernel checks, then stop

Phases, each raising on failure (non-zero exit, no final line):

1. environment: card name and power limit (nvidia-smi), torch/CUDA/Triton;
2. build: the CUDA C++ libraries from ``deepsearch_tts_tpu_torch/ops/csrc``
   (one nvcc per source, started together, timed) and the Triton kernels'
   JIT;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the serving path's shapes (qwen3-8b widths), with the tolerance
   stated below, timed with CUDA events after warm-up: B3, B4, B5, then
   the attention kernels B1 (slot; also B = 1 over one full 4096-token row,
   the case K1's context split is for, and B = 64, where one split fills
   the card, both beside SDPA), B6 (the three paged
   entries) and B2 (flash prefill: T = 1, 127, 128, 512, 3030 at B = 1
   and 2, 3072, and G = 2), K1 and K2 held to a bound scaled by each
   query position's output (``ATTN_RMS_FRAC``), which a plain attention
   missing one split or tile of the B = 1 row must fail; then B11, the one-layer forms (``fused_mlp``, ``fused_qkv``,
   ``fused_out_mlp`` with packed and unpacked gate/up) at qwen3-8b widths,
   B = 1 and 16, and B11's own path: its counters set to 0, each entry
   driven once on a 16-row decode layer, the counts read (no serving path
   runs B11); then, at qwen3-30b-a3b widths, B7, both entries of the
   grouped expert kernels, one expert empty: the decode kernel at 16
   tokens x top-8 and one token below the wrappers' crossover
   (``moe.PREFILL_ROWS_PER_EXPERT``), the prefill kernel at the crossover,
   3072 and 3072 skewed (one expert over 256 rows), each timed shape beside
   ``torch._grouped_mm`` where this PyTorch has it; and B3 / B1 / B2 at its
   query group G = 8;
4. serve: ``deepsearch_tts_tpu_torch.cli.serve.build_engine`` builds
   qwen3-8b (full width, bf16, random weights from a seed) on the card; an
   ``OpenAIServer`` on an ephemeral localhost port answers chat and
   completion requests over HTTP; the kernel launch counters, reset just
   before, must show that decode and sampling went through the kernels;
5. reference: the same weights' paged prefill + fused decode logits against
   the plain no-cache forward on a short input;
6. slot serve: ``Engine(cache_mode="slot")`` on the same weights, whose
   ``attn_impl`` resolves to ``"pallas"`` on the card, over HTTP: decode
   must run B1 once per layer and step, and a multi-turn follow-up must
   re-enter its parked row;
7. Pallas paged serve: ``Engine(attn_impl="pallas",
   enable_prefix_cache=False)``: fresh prefill through B2 (a ~3000-token
   prompt, timed beside phase 4's), decode through ``pallas_paged_attention``;
   then short runs with ``attn_impl="pallas2"`` and ``"clamp"``;
8. reference: slot prefill + B1 decode, and B2 fresh prefill + B6 decode,
   against the plain no-cache forward;
9. release: the qwen3-8b engines and weights are dropped; less than 1 GiB
   may stay allocated on the card;
10. MoE serve: phase 4 for qwen3-30b-a3b (full width, 61 GB of random bf16
    weights): decode through B3, B7 and the grouped expert kernel, whose
    counters must equal 48 x the decode steps (B3, B7) and 48 x (decode
    steps + prefill forwards) (each expert entry, either kernel; the long
    prompt's prefill takes the prefill kernel, the decode steps the decode
    one, and the kernel line counts each); peak memory logged;
11. MoE reference: phase 5 on the qwen3-30b-a3b weights, the no-cache
    forward running the expert FFN's plain versions (``plain_experts``), so
    that the check covers the grouped expert kernel too;
12. MoE slot: phase 6 on the same weights after the paged pools are freed:
    B1 decode at G = 8, B3, B7, the grouped expert kernel and a parked-row
    re-entry;
13. int8 kernels (run with phase 3): B10 (``fused_qkv_stacked_i8``,
    ``fused_out_mlp_stacked_i8``) at qwen3-32b and qwen3-8b widths, B = 1,
    16 and 64 on every layer of a four-layer stack, a plain output with one
    ring stage of K or one column tile left out failing each check at B = 1
    and 16; B10's bare int8 product at the qwen3-32b ``lm_head`` shape
    beside ``torch._weight_int8pack_mm`` and at the layer shapes and a
    ragged one from 1 to 64 rows; and B12 (``quantize_int8``): round to
    nearest bit-equal to its plain version on a [5120, 51200] matrix,
    stochastic rounding held to its properties;
14. int8 serve, after the qwen3-30b-a3b weights are released: qwen3-32b
    (full width, random weights from seed 0 drawn and quantized one matrix
    at a time, 33.6 GB) with ``quantize="int8"`` and ``kv_quantize="int8"``,
    the CLI's paged cache and prefix cache, over HTTP as phase 4: B12 once
    per quantized matrix at build, B10 once per layer and decode step;
15. int8 reference: its serving logits against the no-cache forward on the
    same int8 params with the plain int8 products;
16. speculative kernels (run with phase 3): B9 (``slot_window_attention``,
    K1 in its T-row mode) against its plain version on phase 3's slot pool,
    W = 4 and 8 (qwen3-8b widths) and W = 4, 8 and 16 (G = 8; 16 splits
    into two launches); B3 / B4 / B10 at 64 rows, a verify step's
    16 x (3 + 1);
17. speculative serve, after phase 6: ``Engine(cache_mode="slot",
    speculative="ngram", spec_k=3)`` on the qwen3-8b weights over HTTP,
    phase 6's requests, then a greedy full batch whose tokens per verify
    step must exceed 1; B9, B3 and B4 once per layer and verify step, B1
    never; a B=1 greedy run of 128 tokens beside phase 6's on the plain
    slot engine; one greedy stream teacher-forced through the no-cache
    forward;
18. speculative reference: one 4-token window after a slot prefill, through
    the fused layers and B9, against the no-cache forward on prompt +
    window;
19. MoE speculative, after phase 12 on the same weights: 8 greedy requests
    x 32 tokens, B9 once per layer and verify step, the grouped expert
    kernel on every forward (windows unfused, as in JAX), and phase 18 with
    ``plain_experts``;
20. MLA kernels (run with phase 3): B8 (``fused_mlp_stacked``) at
    deepseek-v3 widths, E = 7168 with the dense F = 18432 (norm and
    residual) and the shared-expert F = 2048 (neither), B = 1 and 16, both
    layers of a two-layer stack; K3 (``latent_attention``) at D = 576 with
    deepseek-v3's 128 and kimi-k2's 64 query heads over one cache head,
    B = 16 and 4096-token rows with ragged limits and inactive rows, through
    B1's entry (``slot_attention`` with ``v_pool=None``, the slot identity
    table) and through the three B6 entries over a shuffled table of
    64-token pages, and at B = 1 over one full 4096-key row and B = 64,
    each beside SDPA, under the rms-scaled bound (a plain attention missing
    a split of the B = 1 row must fail it); the grouped expert kernels at
    E = 7168, F = 2048, 256 experts, top-8, gate and up unpacked: the decode
    kernel at 16 tokens, the prefill kernel at 3072 (also packed, beside
    ``torch._grouped_mm``);
21. MLA serve, after the qwen3-32b int8 engine is released (less than
    1 GiB may stay allocated): deepseek-v3 at its published widths cut to
    5 of its 61 layers (3 dense + 2 MoE, 26.6 B parameters, 53.2 GB of
    random bf16 weights drawn one matrix at a time), registered from this
    script under its own name, served as phase 4 through ``build_engine``:
    B8 on the three dense MLPs and the two shared experts of every decode
    step, the grouped expert kernel on the routed experts; its serving
    logits held to the no-cache forward with ``plain_experts``;
22. MLA slot serve: phase 6 on the same weights, K3 through B1's entry
    once per layer and decode step, K1 (B1 at D = 128) never;
23. MLA paged ``attn_impl="pallas"``: a short run whose decode takes K3
    through ``pallas_paged_attention``; then slot and paged prefill + K3
    decode against the no-cache forward; the weights are released and
    less than 1 GiB may stay allocated.

Every kernel entry of the JSON line before the last carries its bound
(``bound_ms``: the larger of its bytes over 3.35 TB/s and its operations
over the peak rate of their type, from the timed call's inputs) and, where
one PyTorch call computes the same function, that call's time
(``library_ms``, timed here only). The last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# qwen3-8b widths (deepsearch_tts_tpu_torch/models/qwen3.py QWEN3_CONFIGS)
E, H, KV, D, FF, V = 4096, 32, 8, 128, 12288, 151936
V_ODD = 50257            # a vocab width that is not a multiple of 128
V_MLA = 129280           # deepseek-v3's vocab width
SLOTS = 16               # the serve phase's max_slots: its decode batch
# bf16 outputs of kernel and plain version differ by float32 summation order
# and the resulting bf16 rounding of intermediates: the JAX suite's own bound
# for the stacked fused kernels (tests/test_fused_layer.py:181,190)
BF16_RTOL, BF16_ATOL = 2e-2, 1e-2
# B5 is float32 end to end; only the order of the lse sum differs
F32_RTOL, F32_ATOL = 1e-5, 1e-5
# attention kernels against their plain versions: bf16 outputs, float32
# scores in another summation order, and p rounded to bf16 where the plain
# version keeps float32 (B2); the JAX suite's own bound for these kernels
# (tests/test_kernels.py:131,166)
ATTN_RTOL, ATTN_ATOL = 5e-2, 2e-2
# K1 and K2 (the split-context decode and the wgmma prefill) are held
# tighter: the absolute part of the bound is at most this share of the
# reference's root mean square over each query position's heads and
# columns. Over a long row of randn keys the outputs are ~0.026 (a softmax
# average of ~1500 effective keys), so ATTN_ATOL alone would pass a result
# missing a whole 256-key split; a sound kernel uses ~0.16 of this bound
# (its error is the bf16 rounding of the output), one that drops a 64-key
# tile or weighs a split wrong ~9-17 times it (phase_attention_kernels
# asserts the latter on the B = 1 row)
ATTN_RMS_FRAC = 5e-2
CTX = 4096              # max_seq_len of the serve phases: the slot row width
# per-row limits / sequence lengths of the B1 and B6 checks: single keys,
# page and tile edges, the full row, and inactive rows (0, clamped to 1)
LIMITS = [1, 17, 500, 4095, 0, 4096, 2048, 64, 65, 1000, 3000, 129, 256, 4000, 7, 0]
SEQS = [1, 17, 500, 4095, 64, 65, 4096, 2048, 129, 1000, 3000, 256, 7, 4000, 333, 2]
# qwen3-30b-a3b widths (models/qwen3_moe.py QWEN3_MOE_CONFIGS): hidden, q /
# kv heads (G = 8), experts, top-k, expert width
MOE_MODEL = "qwen3-30b-a3b"
M_E, M_H, M_KV, M_NE, M_TOPK, M_F = 2048, 32, 4, 128, 8, 768
LIBS = ("fused_layer", "attention", "quant")
LONG_TEXT = "The search returned a page about the rivers of Europe. " * 55
# qwen3-32b widths (models/qwen3.py QWEN3_CONFIGS): the int8 slice's model
I8_MODEL = "qwen3-32b"
Q_E, Q_H, Q_KV, Q_F = 5120, 64, 8, 25600
# the least time of a call: bytes over the HBM rate, operations over the
# peak rate of their type (H100 SXM5 80 GB data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12     # tensor cores, bf16 (B10 widens int8 to bf16)
F32_FLOP_S = 67e12       # float32 outside the tensor cores
# B12's stochastic rounding is unbiased: the mean of (q - x/s) over the
# [5120, 51200] check matrix has a standard deviation below 0.5/sqrt(2.6e8)
# = 3.1e-5; a bound 30 times that fails a biased rounding (round to
# nearest of a uniform fraction is off by its mean, up to 0.5)
STOCH_MEAN_BOUND = 1e-3
# the speculative engine of phases 17-19, and its verify window
SPEC_KW = dict(speculative="ngram", spec_k=3)
WIN = SPEC_KW["spec_k"] + 1
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)
# the five matrix shapes a qwen3-32b int8 build quantizes (B12)
B12_SHAPES = {"wqkv": (Q_E, (Q_H + 2 * Q_KV) * 128), "wo": (Q_H * 128, Q_E),
              "w_gateup": (Q_E, 2 * Q_F), "w_down": (Q_F, Q_E), "lm_head": (Q_E, V)}
# deepseek-v3 widths (models/deepseek_v3.py DEEPSEEK_V3_CONFIGS), the MLA
# slice's model: served at its published widths with 5 of its 61 layers,
# under a name this script registers (3 dense + 2 MoE layers)
MLA_MODEL, MLA_LAYERS = "deepseek-v3-5-layers", 5
X_E, X_FD, X_FS, X_NE, X_TOPK = 7168, 18432, 2048, 256, 8
X_D, X_V = 576, 512      # latent row (kv_lora_rank 512 + rope 64), value columns
X_SCALE = 192 ** -0.5    # MLA's softmax scale, (qk_nope 128 + qk_rope 64)^-1/2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, calls: int = 1, iters: int = 50) -> tuple[float, float]:
    """(device ms, eager ms) per call of a kernel, where ``fn`` makes
    ``calls`` calls. Device time: ``fn`` captured once in a CUDA graph,
    replayed ``iters`` times between two CUDA events (no host launch cost).
    Eager time: ``iters`` back-to-back runs of ``fn`` between two events,
    host launch cost included where the host is the bottleneck."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    out = []
    for run in (graph.replay, fn):
        run()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            run()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / (iters * calls))
    graph.reset()   # its private memory pool goes back at once
    return out[0], out[1]


def _free() -> None:
    """Give the memory of dropped tensors and CUDA graphs back to the card
    (graph pools can sit in reference cycles until a collection)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def time_eager_ms(fn, iters: int) -> float:
    """ms per call of ``fn`` run eagerly between two CUDA events (for a
    function that reads values back to the host, which no graph captures)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def phase_env() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    import triton

    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {triton.__version__} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi.splitlines()[0]


def phase_build() -> None:
    from deepsearch_tts_tpu_torch.ops import _build

    def build(name):
        t = time.time()
        _build.load_library(name)
        return time.time() - t

    t0 = time.time()
    with ThreadPoolExecutor(len(LIBS)) as ex:
        secs = dict(zip(LIBS, ex.map(build, LIBS)))
    log(f"[build] nvcc " + ", ".join(f"{n}.cu {t:.2f} s" for n, t in secs.items())
        + f" (started together; {time.time() - t0:.2f} s in all)")
    for name in LIBS:
        for line in _build.build_log.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
                log(f"[build] {name}: {line.strip()}")
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    from deepsearch_tts_tpu_torch.ops import moe

    occ = pa.attention_occupancy()
    log("[build] attention blocks an SM (runtime occupancy): " +
        ", ".join(f"{k} {v}" for k, v in occ.items()))
    occ = moe.grouped_occupancy()
    log("[build] grouped expert blocks an SM (runtime occupancy): " +
        ", ".join(f"{k} {v}" for k, v in occ.items()))


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(nbytes: float, flop: float, rate: float = BF16_FLOP_S) -> dict:
    """``bound_ms`` / ``bound_by`` of a call that must move ``nbytes`` (each
    input read once, each output written once) and do ``flop`` operations
    at ``rate``."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, flop / rate * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def phase_kernels(gen) -> dict:
    """Each wrapper vs its plain version; returns per-kernel results."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

    dev = torch.device("cuda")
    bf = torch.bfloat16
    # a four-layer stack: every layer is checked (the layer offsets), and the
    # timed loop walks the layers, so each call reads its weights cold as in
    # serving (4 x 386 MB of weights, far beyond the 50 MB L2)
    L = 4

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    ln1, ln2 = rnd(L, E, scale=0.1) + 1, rnd(L, E, scale=0.1) + 1
    qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
    wqkv = rnd(L, E, (H + 2 * KV) * D, scale=E ** -0.5)
    wo = rnd(L, H * D, E, scale=(H * D) ** -0.5)
    gateup = rnd(L, E, 2 * FF, scale=E ** -0.5)
    wd = rnd(L, FF, E, scale=FF ** -0.5)
    res = {"fused_qkv_stacked": {"err": 0.0}, "fused_out_mlp_stacked": {"err": 0.0},
           "sampling_prep": {"err": 0.0}}
    for B in (1, 8, SLOTS, SLOTS * WIN):   # 64: a verify step's rows
        x = rnd(B, E)
        a = rnd(B, H * D)
        pos = torch.randint(0, 4000, (B,), generator=gen, device=dev)
        cos, sin = rope_angles(pos, D, 1_000_000.0)
        kw = dict(n_heads=H, n_kv=KV, head_dim=D, eps=1e-6)
        args3 = (x, ln1, wqkv, qn, kn, cos, sin)
        args4 = (a, x, wo, ln2, gateup, wd)
        e3 = e4 = 0.0
        for layer in range(L):
            got = fl.fused_qkv_stacked(*args3, layer, **kw)
            ref = fl.fused_qkv_stacked_plain(*args3, layer, **kw)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.float(), r.float(), rtol=BF16_RTOL,
                                           atol=BF16_ATOL)
                e3 = max(e3, _err(g, r))
            got4 = fl.fused_out_mlp_stacked(*args4, layer, eps=1e-6)
            ref4 = fl.fused_out_mlp_stacked_plain(*args4, layer, eps=1e-6)
            torch.cuda.synchronize()
            torch.testing.assert_close(got4.float(), ref4.float(), rtol=BF16_RTOL,
                                       atol=BF16_ATOL)
            e4 = max(e4, _err(got4, ref4))

        def layers(f, args, **k):
            return lambda: [f(*args, layer, **k) for layer in range(L)]

        t3 = time_ms(layers(fl.fused_qkv_stacked, args3, **kw), calls=L)
        p3 = time_ms(layers(fl.fused_qkv_stacked_plain, args3, **kw), calls=L)
        t4 = time_ms(layers(fl.fused_out_mlp_stacked, args4, eps=1e-6), calls=L)
        p4 = time_ms(layers(fl.fused_out_mlp_stacked_plain, args4, eps=1e-6), calls=L)
        C, W4 = (H + 2 * KV) * D, H * D * E + 3 * E * FF
        b3 = bound(2 * (E * C + B * E + E + 2 * D + B * C) + 4 * B * D, 2 * B * E * C)
        b4 = bound(2 * (W4 + B * H * D + 2 * B * E + E), 2 * B * W4)
        for name, e, t, p, bd in (("B3 fused_qkv_stacked", e3, t3, p3, b3),
                                  ("B4 fused_out_mlp_stacked", e4, t4, p4, b4)):
            log(f"[kernel] {name:25s} B={B:3d} max_abs_err={e:.3e} | device "
                f"kernel {t[0]:.4f} ms plain {p[0]:.4f} ms | eager kernel "
                f"{t[1]:.4f} ms plain {p[1]:.4f} ms | bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']})")
            name = name.split()[1]
            res[name]["err"] = max(res[name]["err"], e)
            if B == SLOTS:
                res[name].update(ms=t[0], plain_ms=p[0], library_ms=None, **bd)

    # B3 with bf16 cos / sin (read as stored: widening is exact) at B = 1,
    # 16 and 64, and a plain output whose input norm left out one K chunk
    # (1024 columns of the sum of squares) failing B3's bound; inputs from
    # a generator of their own, so later phases see their old ones
    aux = torch.Generator(device=dev).manual_seed(3)
    for B in (1, SLOTS, 64):
        x = (torch.randn((B, E), generator=aux, device=dev)).to(bf)
        pos = torch.randint(0, 4000, (B,), generator=aux, device=dev)
        cos, sin = (c.to(bf) for c in rope_angles(pos, D, 1_000_000.0))
        kw = dict(n_heads=H, n_kv=KV, head_dim=D, eps=1e-6)
        args3 = (x, ln1, wqkv, qn, kn, cos, sin)
        e3 = 0.0
        for layer in range(L):
            got = fl.fused_qkv_stacked(*args3, layer, **kw)
            ref = fl.fused_qkv_stacked_plain(*args3, layer, **kw)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.float(), r.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
                e3 = max(e3, _err(g, r))
        res["fused_qkv_stacked"]["err"] = max(res["fused_qkv_stacked"]["err"], e3)
        fault = _qkv_norm_fault(x, ln1[0], wqkv[0], qn[0], kn[0], cos, sin, drop=1, **kw)
        ref0 = torch.cat(fl.fused_qkv_stacked_plain(*args3, 0, **kw), 1)
        use = _bound_use(torch.cat(fault, 1)[:, None], ref0[:, None], BF16_RTOL, BF16_ATOL,
                         math.inf)
        assert use > 1.0, ("B3: a norm without one K chunk passed the bound", B, use)
        log(f"[kernel] B3 fused_qkv_stacked B={B:3d} bf16 cos/sin: max_abs_err={e3:.3e}; plain "
            f"output with K chunk 1 of the input norm left out: {use:.1f} times the bound")

    # B5 over the three vocab widths at B = 1, 16, 64 (a verify step's
    # rows) and 65 (a ragged split), timed at each B; the same inputs twice
    # give the same bits (the lse merged in one fixed order), and an lse
    # that leaves out one chunk's partial fails the F32 bound. Shapes that
    # earlier versions of this script did not check draw their inputs from
    # a generator of their own, so every later phase sees the same inputs
    aux = torch.Generator(device=dev).manual_seed(1)
    for Vw in (V, V_MLA, V_ODD):
        eos = Vw - 1
        for B in (1, SLOTS, 64, 65):
            g = gen if Vw in (V, V_ODD) and B in (1, SLOTS, 64) else aux
            logits = torch.randn((B, Vw), generator=g, device=dev) * 3
            seen = torch.rand((B, Vw), generator=g, device=dev) < 0.1
            pen = torch.tensor([1.0, 1.05, 1.3], device=dev).repeat(B)[:B].contiguous()
            temp = torch.tensor([0.7, 1.0, 0.3, 1.5], device=dev).repeat(B)[:B].contiguous()
            sup = (torch.arange(B, device=dev) % 2 == 0)
            args5 = (logits, seen, pen, temp, sup, eos)
            s_k, l_k = sp.sampling_prep(*args5)
            s_r, l_r = sp.sampling_prep_plain(*args5)
            s_2, l_2 = sp.sampling_prep(*args5)
            torch.cuda.synchronize()
            torch.testing.assert_close(s_k, s_r, rtol=F32_RTOL, atol=F32_ATOL)
            torch.testing.assert_close(l_k, l_r, rtol=F32_RTOL, atol=F32_ATOL)
            assert torch.equal(s_k, s_2) and torch.equal(l_k, l_2), (
                "sampling_prep: two calls on the same inputs differ", Vw, B)
            e5 = max(_err(s_k, s_r), _err(l_k, l_r))
            S, chunk = sp.prep_splits(B, Vw, torch.cuda.get_device_properties(0)
                                      .multi_processor_count)
            drop = S // 2   # the lse without chunk `drop`'s partial
            keep = torch.ones(Vw, dtype=torch.bool, device=dev)
            keep[drop * chunk:(drop + 1) * chunk] = False
            fault = torch.logsumexp(s_r[:, keep], dim=-1, keepdim=True)
            use = _bound_use(fault[:, :, None], l_r[:, :, None], F32_RTOL, F32_ATOL, math.inf)
            assert S == 1 or use > 1.0, ("B5 lse fault passed the bound", Vw, B, use)
            t5 = time_ms(lambda: sp.sampling_prep(*args5))
            p5 = time_ms(lambda: sp.sampling_prep_plain(*args5))
            # logits f32 + seen + 3 row values read, scaled f32 + lse
            # written; ~8 float32 operations an element
            bd5 = bound(B * Vw * 9 + B * 16, 8 * B * Vw, rate=F32_FLOP_S)
            log(f"[kernel] B5 sampling_prep V={Vw:6d} B={B:3d} S={S:3d} chunk={chunk:6d} "
                f"max_abs_err={e5:.3e} (lse without chunk {drop}: "
                f"{'one chunk, no fault' if S == 1 else f'bound use {use:.1f}'}) | device "
                f"kernel {t5[0]:.4f} ms plain {p5[0]:.4f} ms | eager kernel {t5[1]:.4f} ms "
                f"plain {p5[1]:.4f} ms | bound "
                f"{bd5['bound_ms']:.4f} ms ({bd5['bound_by']}) | "
                f"{(B * Vw * 9 + B * 16) / t5[0] / 1e6:.1f} GB/s")
            res["sampling_prep"]["err"] = max(res["sampling_prep"]["err"], e5)
            if B == SLOTS and Vw == V:
                res["sampling_prep"].update(ms=t5[0], plain_ms=p5[0], library_ms=None,
                                            shape=f"B={B} V={Vw}", **bd5)
    return res


def phase_one_layer_kernels(gen) -> tuple[dict, dict]:
    """B11, the one-layer forms (``fused_mlp``, ``fused_qkv``,
    ``fused_out_mlp`` with packed and unpacked gate/up), against their plain
    versions at qwen3-8b widths, B = 1 and 16, timed at 16 with their bounds;
    then B11's own path (no serving path calls it: the JAX package's tests
    are its callers): the counters set to 0, each entry driven once on a
    16-row decode layer, the counts read. Returns (per-kernel results, the
    path's launches)."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    dev = torch.device("cuda")
    res: dict = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    ln = rnd(E, scale=0.1) + 1
    qn, kn = rnd(D, scale=0.1) + 1, rnd(D, scale=0.1) + 1
    C = (H + 2 * KV) * D
    wqkv, wo = rnd(E, C, scale=E ** -0.5), rnd(H * D, E, scale=(H * D) ** -0.5)
    wg, wu = rnd(E, FF, scale=E ** -0.5), rnd(E, FF, scale=E ** -0.5)
    wd = rnd(FF, E, scale=FF ** -0.5)
    gateup = torch.cat([wg, wu], dim=1)   # the packed [E, 2F] layout
    kw = dict(n_heads=H, n_kv=KV, head_dim=D, eps=1e-6)
    w_mlp, w_out = 3 * E * FF, H * D * E + 3 * E * FF
    for B in (1, SLOTS):
        x, a = rnd(B, E), rnd(B, H * D)
        cos, sin = (c.to(torch.bfloat16) for c in rope_angles(
            torch.randint(0, 4000, (B,), generator=gen, device=dev), D, 1_000_000.0))
        timed = B == SLOTS

        def check(name, label, kernel, plain, nbytes, flop):
            _check_kernel(res, name, f"B={B} {label}", kernel, plain, rtol=BF16_RTOL,
                          atol=BF16_ATOL, timed=timed, nbytes=nbytes, flop=flop)

        check("fused_mlp", "E=4096 F=12288", lambda: fl.fused_mlp(x, ln, wg, wu, wd),
              lambda: fl.fused_mlp_plain(x, ln, wg, wu, wd),
              2 * (w_mlp + 2 * B * E + E), 2 * B * w_mlp)
        check("fused_qkv", "E=4096 H=32 KV=8",
              lambda: fl.fused_qkv(x, ln, wqkv, qn, kn, cos, sin, **kw),
              lambda: fl.fused_qkv_plain(x, ln, wqkv, qn, kn, cos, sin, **kw),
              2 * (E * C + B * E + E + 2 * D + B * C + B * D), 2 * B * E * C)
        # float32 cos / sin too (not timed: the row keeps bf16's time)
        _check_kernel(res, "fused_qkv", f"B={B} cos/sin float32",
                      lambda: fl.fused_qkv(x, ln, wqkv, qn, kn, cos.float(), sin.float(), **kw),
                      lambda: fl.fused_qkv_plain(x, ln, wqkv, qn, kn, cos.float(), sin.float(),
                                                 **kw), rtol=BF16_RTOL, atol=BF16_ATOL)
        nb_out = 2 * (w_out + B * H * D + 2 * B * E + E)
        # packed first: the unpacked call's time is the one the row keeps
        check("fused_out_mlp", "packed gate|up",
              lambda: fl.fused_out_mlp(a, x, wo, ln, gateup, gateup, wd, packed_gateup=True),
              lambda: fl.fused_out_mlp_plain(a, x, wo, ln, gateup, gateup, wd,
                                             packed_gateup=True), nb_out, 2 * B * w_out)
        check("fused_out_mlp", "unpacked gate, up",
              lambda: fl.fused_out_mlp(a, x, wo, ln, wg, wu, wd),
              lambda: fl.fused_out_mlp_plain(a, x, wo, ln, wg, wu, wd), nb_out, 2 * B * w_out)

    # fused_qkv at a verify step's 64 rows, cos / sin in both dtypes (inputs
    # from a generator of their own), timed for the record
    aux = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn((64, E), generator=aux, device=dev)).to(torch.bfloat16)
    pos = torch.randint(0, 4000, (64,), generator=aux, device=dev)
    for cdt in (torch.bfloat16, torch.float32):
        cos, sin = (c.to(cdt) for c in rope_angles(pos, D, 1_000_000.0))
        sub: dict = {}
        _check_kernel(sub, "fused_qkv", f"B=64 cos/sin {str(cdt).split('.')[-1]}",
                      lambda: fl.fused_qkv(x, ln, wqkv, qn, kn, cos, sin, **kw),
                      lambda: fl.fused_qkv_plain(x, ln, wqkv, qn, kn, cos, sin, **kw),
                      rtol=BF16_RTOL, atol=BF16_ATOL, timed=True,
                      nbytes=2 * (E * C + 64 * E + E + 2 * D + 64 * C + 64 * D)
                      + (2 if cdt == torch.bfloat16 else 4) * 64 * D, flop=2 * 64 * E * C)
        res["fused_qkv"]["err"] = max(res["fused_qkv"]["err"], sub["fused_qkv"]["err"])

    # B11's path: its three entry points on one 16-row decode layer
    fns = (fl.fused_qkv, fl.fused_out_mlp, fl.fused_mlp)
    for f in fns:
        f.launches = 0
    x = rnd(SLOTS, E)
    cos, sin = rope_angles(torch.arange(SLOTS, device=dev), D, 1_000_000.0)
    q = fl.fused_qkv(x, ln, wqkv, qn, kn, cos, sin, **kw)[0].contiguous()
    x2 = fl.fused_out_mlp(q, x, wo, ln, wg, wu, wd)
    x3 = fl.fused_out_mlp(q, x2, wo, ln, gateup, gateup, wd, packed_gateup=True)
    out = fl.fused_mlp(x3, ln, wg, wu, wd)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in fns}
    assert bool(torch.isfinite(out.float()).all()) and out.shape == (SLOTS, E)
    assert all(n > 0 for n in launches.values()), launches
    log(f"[b11-path] one decode layer through the one-layer forms: launches {launches}")
    return res, launches


def _x2_ulp(a, x, wo_q, wo_s):
    """One bf16 ulp of each element of x2 = x + a @ wo (int8, scaled).
    B10-out (like B4) rounds x2 to bf16 and then adds the MLP to it; a
    kernel whose float32 sums run in another order can round x2 one ulp the
    other way, and where the MLP cancels x2 that ulp (0.0156 for |x2| in
    [2, 4)) is the whole difference of two outputs near 0, beyond the
    relative bound. Over a 64-row check (327,680 outputs a layer at
    qwen3-32b) such an element turns up."""
    import torch

    x2 = (x.float() + (a.float() @ wo_q.float()) * wo_s.float()).abs()
    return torch.exp2(torch.floor(torch.log2(x2.clamp(min=1e-30))) - 7)


def _qkv_norm_fault(x, ln, w, qn, kn, cos, sin, *, drop: int, n_heads, n_kv, head_dim, eps):
    """B3's plain output with an input norm whose sum of squares leaves out
    K chunk ``drop`` (columns 1024·drop .. +1024, the chunks of 128 of the
    norm's threads): what a kernel that lost that chunk of the norm would
    give. The q / k heads are normalised again per head, so the fault shows
    on the v heads."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import matmul_f32
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    xf = x.float()
    keep = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
    keep[1024 * drop:1024 * (drop + 1)] = False
    inv = torch.rsqrt(xf[:, keep].square().sum(-1, keepdim=True) / x.shape[1] + eps)
    xn = ((xf * inv) * ln.float()).to(x.dtype)
    return fl._qkv_epilogue(matmul_f32(xn, w), x, qn, kn, cos, sin, n_heads=n_heads,
                            n_kv=n_kv, head_dim=head_dim, eps=eps)


def _bound_use(got, ref, rtol: float, atol: float, rms_frac: float) -> float:
    """The largest share of its bound that an element's error takes: the
    bound is ``min(atol, rms_frac · rms) + rtol · |ref|``, rms taken over
    the reference's last two dimensions (a query position's heads and
    columns); above 1 the check fails."""
    import torch

    r = ref.float()
    rms = r.pow(2).mean(dim=(-2, -1), keepdim=True).sqrt()
    tol = torch.clamp(rms_frac * rms, max=atol) + rtol * r.abs()
    return float(((got.float() - r).abs() / tol.clamp(min=1e-30)).max())


def _check_kernel(res: dict, name: str, label: str, kernel, plain, *, rtol: float,
                  atol: float, timed: bool = False, nbytes: int = 0, flop: int = 0,
                  plain_graph: bool = True, library=None, exact: bool = False,
                  rate: float = BF16_FLOP_S, slack=None, rms_frac=None) -> None:
    """``kernel()`` against ``plain()`` (tensors or tuples of them) at the
    stated tolerance (``exact``: bit for bit; ``slack``: an absolute
    allowance per element added to it; ``rms_frac``: the absolute part is
    at most that share of the reference's root mean square over its last
    two dimensions, see ``_rms_bound``); the largest error is kept in
    ``res[name]``. ``timed`` also records device ms of both
    (``plain_graph=False``: the plain version syncs with the host, so its
    time is the eager one), the bound from ``nbytes`` (every input read and
    every output written once) and ``flop``, and the time of ``library``,
    one PyTorch call computing the same function, where there is one."""
    import torch

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    e, use = 0.0, None
    for g, r in zip(got, ref):
        if rms_frac is not None:
            u = _bound_use(g, r, rtol, atol, rms_frac)
            assert u <= 1.0, (name, label, f"{u:.2f} times the bound (rms share "
                              f"{rms_frac}), largest error {_err(g, r)}")
            use = max(use or 0.0, u)
        elif exact:
            assert g.dtype == r.dtype and torch.equal(g, r), (
                name, label, f"{int((g != r).sum())} of {g.numel()} elements differ")
        elif slack is not None:
            d = (g.float() - r.float()).abs()
            bad = d > atol + rtol * r.float().abs() + slack
            assert not bool(bad.any()), (name, label, f"{int(bad.sum())} of {g.numel()} "
                                         f"elements beyond the bound, largest {float(d.max())}")
        else:
            torch.testing.assert_close(g.float(), r.float(), rtol=rtol, atol=atol)
        e = max(e, _err(g, r))
    r = res.setdefault(name, {"err": 0.0})
    r["err"] = max(r["err"], e)
    msg = f"[kernel] {name:26s} {label:34s} max_abs_err={e:.3e}"
    if use is not None:
        msg += f" (bound use {use:.3f})"
    if timed:
        t = time_ms(kernel, iters=20)
        p = time_ms(plain, iters=5) if plain_graph else (time_eager_ms(plain, 5),) * 2
        r.update(ms=t[0], plain_ms=p[0], shape=label, **bound(nbytes, flop, rate),
                 library_ms=None if library is None else time_ms(library, iters=20)[0])
        msg += (f" | device kernel {t[0]:.4f} ms plain {p[0]:.4f} ms"
                f"{'' if plain_graph else ' (eager: it syncs)'} | eager "
                f"kernel {t[1]:.4f} ms plain {p[1]:.4f} ms | bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        if r["library_ms"] is not None:
            msg += f" | library {r['library_ms']:.4f} ms"
        if nbytes:
            msg += f" | {nbytes / t[0] / 1e6:.1f} GB/s"
        if flop:
            msg += f" | {flop / t[0] / 1e9:.1f} TFLOP/s"
    log(msg)


def _bound_rejects_split_faults(ref, q, k, v, *, scale=None, tag: str = "K1") -> None:
    """The rms-scaled attention bound is tight enough to see a fault of the
    context split: over one full row (q [1,H,D], k [1,KV,S,D], v
    [1,KV,S,Dv], ``ref`` B1's plain output) a plain attention with p
    rounded to bf16 passes the bound, and the same with one 256-key split
    dropped, with the last 64-key tile dropped, or with one split weighed
    twice, each fails it."""
    import torch

    H, D = q.shape[1], q.shape[2]
    S = k.shape[2]
    kk = k[0].float().repeat_interleave(H // k.shape[1], 0)    # [H,S,D]
    vv = v[0].float().repeat_interleave(H // k.shape[1], 0)
    s = torch.einsum("hd,hsd->hs", q[0].float() * (scale or D ** -0.5), kk)
    chunk = S // 16

    def attend(lo=0, hi=0, bias=-torch.inf):
        b = torch.zeros(S, device=q.device)
        b[lo:hi] = bias
        p = torch.softmax(s + b, -1).to(torch.bfloat16).float()
        return torch.einsum("hs,hsd->hd", p, vv).to(torch.bfloat16)[None]

    uses, flat = {}, {}
    for fault, kw in (("sound", dict()), ("one split dropped", dict(lo=chunk, hi=2 * chunk)),
                      ("last 64-key tile dropped", dict(lo=S - 64, hi=S)),
                      ("one split weighed twice",
                       dict(lo=chunk, hi=2 * chunk, bias=math.log(2.0)))):
        out = attend(**kw)
        uses[fault] = _bound_use(out, ref, ATTN_RTOL, ATTN_ATOL, ATTN_RMS_FRAC)
        flat[fault] = _bound_use(out, ref, ATTN_RTOL, ATTN_ATOL, math.inf)
    log(f"[kernel] {tag} bound over one full row, bound use: " +
        ", ".join(f"{t} {u:.3f}" for t, u in uses.items()) +
        " (ATTN_ATOL alone: " + ", ".join(f"{u:.3f}" for u in flat.values()) + ")")
    assert uses.pop("sound") <= 1.0 and min(uses.values()) > 1.0, uses


def phase_attention_kernels(gen) -> dict:
    """B1, the three B6 entries and B2 against their plain versions at
    qwen3-8b attention widths (H=32, K=8, D=128, bf16); returns per-kernel
    results (error, and device ms of kernel and plain at the shape noted)."""
    import torch

    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev = torch.device("cuda")
    res: dict = {}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def check(*a, **k):
        _check_kernel(res, *a, rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, **k)

    # B1: a two-layer slot pool of SLOTS rows x CTX tokens
    L = 2
    kp, vp = rnd(L * SLOTS, CTX, KV, D), rnd(L * SLOTS, CTX, KV, D)
    q = rnd(SLOTS, H, D)
    lim = torch.tensor(LIMITS, device=dev)
    kw = dict(n_rows=SLOTS, slot_ctx=CTX)
    keys = sum(max(x, 1) for x in LIMITS)
    io = keys * KV * D * 2 * 2 + 2 * SLOTS * H * D * 2 + SLOTS * 8
    # the yardstick: SDPA over layer 1's contiguous rows, keys masked past
    # each row's limit (inactive rows keep one key, as B1 clamps them)
    k1, v1 = (t[SLOTS:].transpose(1, 2).contiguous() for t in (kp, vp))
    mask = (torch.arange(CTX, device=dev)[None] < lim.clamp(min=1)[:, None])[:, None, None]
    q4 = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for layer in range(L):
        for v, tag in ((vp, ""), (None, " v=k")):
            check("slot_attention", f"B={SLOTS} layer={layer} ctx={CTX}{tag}",
                  lambda: sa.slot_attention(q, kp, v, lim, layer, **kw),
                  lambda: sa.slot_attention_plain(q, kp, v, lim, layer, **kw),
                  timed=layer == 1 and v is not None, nbytes=io, flop=4 * H * D * keys,
                  library=lambda: sdpa(q4, k1, v1, attn_mask=mask, enable_gqa=True))
    _check_windows(check, rnd, kp, vp, H, KV, (4, 8), timed_w=WIN,
                   library_kv=(k1, v1))
    del k1, v1
    # B1 at B = 1 over one full 4096-token row: the case the context split
    # is for (16 splits of 256 keys), beside SDPA over the same row
    row: dict = {}
    qb, lb = rnd(1, H, D), torch.tensor([CTX], device=dev)
    kb1, vb1 = (t[1:2].transpose(1, 2) for t in (kp, vp))
    kw1 = dict(n_rows=1, slot_ctx=CTX)
    _check_kernel(row, "slot_attention", f"B=1 layer=1 ctx={CTX} (one full row)",
                  lambda: sa.slot_attention(qb, kp[:2], vp[:2], lb, 1, **kw1),
                  lambda: sa.slot_attention_plain(qb, kp[:2], vp[:2], lb, 1, **kw1),
                  rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                  nbytes=CTX * KV * D * 4 + 4 * H * D + 8, flop=4 * H * D * CTX,
                  library=lambda: sdpa(qb[:, :, None], kb1, vb1, enable_gqa=True))
    res["slot_attention_b1"] = row["slot_attention"]
    _bound_rejects_split_faults(sa.slot_attention_plain(qb, kp[:2], vp[:2], lb, 1, **kw1),
                                qb, kb1, vb1)
    del kb1, vb1
    # B1 at B = 64: B·KV = 512 blocks fill the card, so one split and no
    # merge (LIMITS' rows four times over), beside SDPA over the same rows
    n64, wide = 4 * SLOTS, {}
    k64, v64, q64 = rnd(n64, CTX, KV, D), rnd(n64, CTX, KV, D), rnd(n64, H, D)
    lim64 = torch.tensor(LIMITS * 4, device=dev)
    mask64 = (torch.arange(CTX, device=dev)[None] < lim64.clamp(min=1)[:, None])[:, None, None]
    kt64, vt64 = (t.transpose(1, 2) for t in (k64, v64))
    kw64 = dict(n_rows=n64, slot_ctx=CTX)
    _check_kernel(wide, "slot_attention", f"B={n64} layer=0 ctx={CTX} (one split)",
                  lambda: sa.slot_attention(q64, k64, v64, lim64, 0, **kw64),
                  lambda: sa.slot_attention_plain(q64, k64, v64, lim64, 0, **kw64),
                  rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                  nbytes=4 * keys * KV * D * 4 + 2 * n64 * H * D * 2 + n64 * 8,
                  flop=4 * H * D * 4 * keys,
                  library=lambda: sdpa(q64[:, :, None], kt64, vt64, attn_mask=mask64,
                                       enable_gqa=True))
    res["slot_attention_b64"] = wide["slot_attention"]
    del k64, v64, kt64, vt64

    # B6: ps=64, P=64 pages per row, page 0 the (zeroed) null page
    ps, P = 64, CTX // 64
    NP = 1 + SLOTS * P
    kpg, vpg = rnd(NP, ps, KV, D), rnd(NP, ps, KV, D)
    kpg[0], vpg[0] = 0, 0
    seq = torch.tensor(SEQS, device=dev)
    perm = torch.randperm(NP - 1, generator=gen, device=dev)[: SLOTS * P].view(SLOTS, P)
    used = (seq + ps - 1) // ps
    table = torch.where(torch.arange(P, device=dev)[None] < used[:, None], perm + 1, 0)
    read = int(seq.sum()) * KV * D * 2 * 2 + 2 * SLOTS * H * D * 2 + SLOTS * (P + 2) * 8
    flop6 = 4 * H * D * int(seq.sum())
    q1 = rnd(SLOTS, 1, H, D)
    qpos1 = (seq - 1)[:, None]
    check("pallas_paged_attention", f"B={SLOTS} T=1 ps={ps} P={P}",
          lambda: pa.pallas_paged_attention(q1, kpg, vpg, table, seq, qpos1),
          lambda: pa.pallas_paged_attention_plain(q1, kpg, vpg, table, seq, qpos1),
          timed=True, nbytes=read, flop=flop6)
    # chunks: T=4 (16 query rows a block) and T=16 (64, the most K1 holds)
    for T in (4, 16):
        seqT = seq.clamp(min=T)
        qposT = seqT[:, None] - T + torch.arange(T, device=dev)[None]
        qT = rnd(SLOTS, T, H, D)
        check("pallas_paged_attention", f"B={SLOTS} T={T} ps={ps} P={P}",
              lambda: pa.pallas_paged_attention(qT, kpg, vpg, table, seqT, qposT),
              lambda: pa.pallas_paged_attention_plain(qT, kpg, vpg, table, seqT, qposT))
    for name in ("pallas_paged_decode", "pallas_paged_decode_clamp"):
        fk, fp = getattr(pa, name), getattr(pa, name + "_plain")
        check(name, f"B={SLOTS} T=1 ps={ps} P={P}",
              lambda: fk(q1, kpg, vpg, table, seq), lambda: fp(q1, kpg, vpg, table, seq),
              timed=True, nbytes=read, flop=flop6)
    del kp, vp, kpg, vpg

    # B2: causal prefill: one query, a ragged 127 (one partial tile), lengths
    # that are not a multiple of the tile (3030), and the timed 3072
    # (and B = 2 at 3030: a ragged tail in a batch row that has a next one)
    for B, T in ((1, 1), (1, 127), (1, 128), (4, 512), (1, 3030), (2, 3030), (1, 3072)):
        qf, kf, vf = rnd(B, T, H, D), rnd(B, T, KV, D), rnd(B, T, KV, D)
        qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))
        check("flash_attention", f"B={B} T={T}",
              lambda: fa.flash_attention(qf, kf, vf),
              lambda: fa.flash_attention_plain(qf, kf, vf),
              timed=T == 3072, flop=4 * B * H * D * T * (T + 1) // 2,
              nbytes=2 * B * T * D * (2 * H + 2 * KV),
              library=lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    # G = 2: 16 kv heads, a block's 128 rows hold 64 positions
    qf, kf, vf = rnd(1, 1000, H, D), rnd(1, 1000, 16, D), rnd(1, 1000, 16, D)
    check("flash_attention", "G=2 B=1 T=1000", lambda: fa.flash_attention(qf, kf, vf),
          lambda: fa.flash_attention_plain(qf, kf, vf))
    return res


def _check_windows(check, rnd, kp, vp, h, kv, widths, timed_w=None, library_kv=None):
    """B9 on a two-layer slot pool of SLOTS rows x CTX tokens: windows of
    each width in ``widths``, bases from LIMITS (limit 0: an inactive row,
    base -1; 4096: a window that ends at the last slot position), seq_lens
    covering each window; both layers, with v and with v = k. The layer-1
    call at width ``timed_w`` is timed, beside SDPA over layer 1's rows
    (``library_kv``) with each query's key mask."""
    import torch

    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev = kp.device
    kw = dict(n_rows=SLOTS, slot_ctx=CTX)
    for W in widths:
        base = torch.tensor([min(x, CTX - W + 1) - 1 for x in LIMITS], device=dev)
        seq = torch.where(base >= 0, base + W, 0)
        # query t of row b sees keys < min(max(seq, 1), max(base, 0) + 1 + t)
        lim = torch.minimum(seq.clamp(min=1)[:, None],
                            base.clamp(min=0)[:, None] + torch.arange(1, W + 1, device=dev))
        assert int((base < 0).sum()) >= 1 and int(lim[:, -1].max()) == CTX
        qw = rnd(SLOTS, W, h, D)
        # the context is read once per row, to its widest limit
        io = int(lim[:, -1].sum()) * kv * D * 2 * 2 + 2 * SLOTS * W * h * D * 2 + 2 * SLOTS * 8
        library = None
        if library_kv is not None and W == timed_w:
            mask = (torch.arange(CTX, device=dev)[None, None] < lim[:, :, None])[:, None]
            qt = qw.transpose(1, 2)
            library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, *library_kv, attn_mask=mask, enable_gqa=True)
        for layer in range(2):
            for v, tag in ((vp, ""), (None, " v=k")):
                check("slot_window_attention",
                      f"G={h // kv} B={SLOTS} W={W} layer={layer} ctx={CTX}{tag}",
                      lambda: sa.slot_window_attention(qw, kp, v, seq, base, layer, **kw),
                      lambda: sa.slot_window_attention_plain(qw, kp, v, seq, base, layer, **kw),
                      timed=W == timed_w and layer == 1 and v is not None, nbytes=io,
                      flop=4 * h * D * int(lim.sum()), library=library)


def _b7_faults(a, x, wo, ln, router) -> None:
    """B7's bound (BF16_RTOL / BF16_ATOL on x2, hn and the logits) sees a
    fault of its schedule: against the sound plain output of layer 0, a
    plain output with one ring stage (32 k rows) of one split wo tile left
    out, one with one router partial left out (a phase-2 warp's share of
    K: k-step pairs 1, 5, 9, ... of one block's 8 expert columns), and one
    with hn normalised by a sum of squares missing one tile each take more
    than the whole bound."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import matmul_f32
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    grid = pa._sm_count(a.device)
    E = x.shape[1]
    tiles, nk = fl.b7_tiles(E, a.shape[1])
    runs = fl.i8_partition(tiles, nk, grid)
    # a tile that more than one block streams, and a ring stage of it
    t = next(t for t in range(tiles) if sum(any(s[0] == t for s in r) for r in runs) > 1)
    ref = fl.fused_out_router_stacked_plain(a, x, wo, ln, router, 0)
    w = wo[:1].clone()
    w[0, 5 * fl._KT:6 * fl._KT, t * fl._TILE:(t + 1) * fl._TILE] = 0
    r = router[:1].clone()
    warp1 = (torch.arange(E, device=a.device) // 32) % 4 == 1   # warp 1's k rows
    r[0, warp1, fl.B7_BAND:2 * fl.B7_BAND] = 0                   # of expert columns 8 .. 15
    x2 = ref[0]
    ss = x2.float().square()
    ss[:, t * fl._TILE:(t + 1) * fl._TILE] = 0
    hn = ((x2.float() * torch.rsqrt(ss.sum(-1, keepdim=True) / E + 1e-6))
          * ln[0].float()).to(x2.dtype)
    faults = {f"stage 5 of wo tile {t} dropped": fl.fused_out_router_stacked_plain(
                  a, x, w, ln, router, 0),
              "router partial (warp 1 of expert columns 8 .. 15) dropped":
                  fl.fused_out_router_stacked_plain(a, x, wo, ln, r, 0),
              f"sum of squares of tile {t} dropped": (x2, hn, matmul_f32(hn, router[0]))}
    uses = {n: max(_bound_use(g, w_, BF16_RTOL, BF16_ATOL, math.inf) for g, w_ in zip(f, ref))
            for n, f in faults.items()}
    log("[kernel] fused_out_router_stacked B=16 faults, bound use: " +
        ", ".join(f"{n} {u:.2f}" for n, u in uses.items()))
    assert min(uses.values()) > 1.0, uses


def phase_moe_kernels(gen) -> dict:
    """B7 and both entries of the grouped expert kernels (decode and
    prefill) against their plain versions at qwen3-30b-a3b widths, and B3,
    K1 (B1) and K2 (B2) at its query group G = H/K = 8; returns per-kernel
    results (the B3, B1 and B2 errors at G = 8 under ``"g8"``)."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev, bf = torch.device("cuda"), torch.bfloat16
    res: dict = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def check(*a, **k):
        _check_kernel(res, *a, rtol=BF16_RTOL, atol=BF16_ATOL, **k)

    # B7: the 2-layer check stack of the contract, then an 8-layer stack
    # (138 MB, beyond the 50 MB L2) for the timing, walked layer by layer;
    # B = 1, 16, 64 (a verify step's rows) and 80 (two row groups, the last
    # ragged; all but B = 16 from a generator of their own, so that later
    # phases see the inputs they saw before); the same inputs twice give the
    # same bits
    aux = torch.Generator(device=dev).manual_seed(1)
    for L, timed in ((2, False), (8, True)):
        wo = rnd(L, M_H * D, M_E, scale=(M_H * D) ** -0.5)
        ln = rnd(L, M_E, scale=0.1) + 1
        router = rnd(L, M_E, M_NE, scale=M_E ** -0.5)
        for B in (1, SLOTS, 64, 80):
            g = gen if B == SLOTS else aux
            a = (torch.randn((B, M_H * D), generator=g, device=dev)).to(bf)
            x = (torch.randn((B, M_E), generator=g, device=dev)).to(bf)
            for layer in range(L):
                args = (a, x, wo, ln, router, layer)
                check("fused_out_router_stacked", f"B={B} layer={layer} L={L}",
                      lambda: fl.fused_out_router_stacked(*args),
                      lambda: fl.fused_out_router_stacked_plain(*args))
                once, twice = fl.fused_out_router_stacked(*args), fl.fused_out_router_stacked(*args)
                assert all(torch.equal(u, v) for u, v in zip(once, twice)), (
                    "fused_out_router_stacked: two calls on the same inputs differ", B, layer)
            if timed and B == SLOTS:
                _b7_faults(a, x, wo, ln, router)
            if timed and B <= 64:
                def walk(f):
                    return lambda: [f(a, x, wo, ln, router, layer) for layer in range(L)]

                t = time_ms(walk(fl.fused_out_router_stacked), calls=L)
                p = time_ms(walk(fl.fused_out_router_stacked_plain), calls=L)
                w7 = M_H * D * M_E + M_E * M_NE
                nb = 2 * (w7 + B * M_H * D + 3 * B * M_E + M_E) + 4 * B * M_NE
                bd = bound(nb, 2 * B * w7)
                if B == SLOTS:
                    res["fused_out_router_stacked"].update(
                        ms=t[0], plain_ms=p[0], shape=f"B={B} (8 layers walked)",
                        library_ms=None, **bd)
                log(f"[kernel] B7 fused_out_router_stacked B={B} | device kernel "
                    f"{t[0]:.4f} ms plain {p[0]:.4f} ms | eager "
                    f"kernel {t[1]:.4f} ms plain {p[1]:.4f} ms | bound {bd['bound_ms']:.4f} "
                    f"ms ({bd['bound_by']}) | {nb / t[0] / 1e6:.1f} GB/s")
        del wo, ln, router
    # B7 at widths beyond the served configs' that the fused layer's gate
    # (shapes_ok) takes: E not a multiple of 1024 with 512 experts (phase 2's
    # items outnumber the grid: blocks take several), E above one phase-2 K
    # chunk (two chunks), and a wo smaller than the grid (blocks with empty
    # shares, a tile spanning more blocks than one batch of slots); layer 1
    # of a 2-layer stack, from the generator of the new shapes
    for E7, HD7, NE7 in ((2560, 4096, 512), (5120, 1024, 128), (256, 256, 128)):
        wo = (torch.randn((2, HD7, E7), generator=aux, device=dev) * HD7 ** -0.5).to(bf)
        ln = (torch.randn((2, E7), generator=aux, device=dev) * 0.1 + 1).to(bf)
        router = (torch.randn((2, E7, NE7), generator=aux, device=dev) * E7 ** -0.5).to(bf)
        for B in (1, SLOTS, 64, 80):
            a = torch.randn((B, HD7), generator=aux, device=dev).to(bf)
            x = torch.randn((B, E7), generator=aux, device=dev).to(bf)
            args = (a, x, wo, ln, router, 1)
            check("fused_out_router_stacked", f"B={B} E={E7} H*D={HD7} NE={NE7} layer=1 L=2",
                  lambda: fl.fused_out_router_stacked(*args),
                  lambda: fl.fused_out_router_stacked_plain(*args))
            once, twice = fl.fused_out_router_stacked(*args), fl.fused_out_router_stacked(*args)
            assert all(torch.equal(u, v) for u, v in zip(once, twice)), (
                "fused_out_router_stacked: two calls on the same inputs differ", B, E7, NE7)
        del wo, ln, router

    # grouped expert FFN over the rows of one layer of a 2-layer expert stack
    # (layer 1: the layer offset); expert 7 gets no rows. The decode kernel
    # at 16 tokens and one token below the prefill kernel's crossover (which
    # the wrapper takes from static sizes), the prefill kernel at the
    # crossover, at 3072 (timed) and at 3072 skewed (expert 3 over 256
    # rows); the timed shapes beside torch._grouped_mm where this PyTorch
    # has it
    grouped_mm = getattr(torch, "_grouped_mm", None)
    log(f"[kernel] grouped expert yardstick: torch._grouped_mm "
        f"{'present' if grouped_mm else 'absent'} in torch {torch.__version__}")
    wgu = rnd(2, M_NE, M_E, 2 * M_F, scale=M_E ** -0.5)[1]
    wd = rnd(2, M_NE, M_F, M_E, scale=M_F ** -0.5)[1]
    cross = moe.PREFILL_ROWS_PER_EXPERT * M_NE // M_TOPK   # tokens at the crossover
    for T, tag in ((SLOTS, "decode"), (cross - 1, "below"), (cross, "above"),
                   (3072, "prefill"), (3072, "skewed")):
        logits = torch.randn((T, M_NE), generator=gen, device=dev) * 2
        logits[:, 7] = -1e30
        if tag == "skewed":
            logits[:, 3] += 4.0
        _, top_e = moe.route_topk(logits, M_TOPK)
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        offsets = moe.group_offsets(flat_e, M_NE)
        xs = rnd(T, M_E)[order // M_TOPK]
        sizes = offsets[1:] - offsets[:-1]
        assert int(sizes[7]) == 0, "expert 7 must be empty"
        rows = T * M_TOPK
        prefill = moe.grouped_prefill(rows, M_NE, M_E, M_F)
        assert prefill == (tag in ("above", "prefill", "skewed")), (tag, rows)
        if tag != "decode":   # ragged experts: rows not a multiple of 128
            assert bool((sizes % 128 != 0).any())
        if tag == "skewed":
            assert int(sizes[3]) > 256, int(sizes[3])
        touched = int((sizes > 0).sum())
        label = (f"T={T} x top-{M_TOPK} ({touched} experts, largest {int(sizes.max())} rows)"
                 f"{' skewed' if tag == 'skewed' else ''}")
        sfx = "_prefill" if prefill else ""
        timed = tag in ("decode", "prefill")
        h = moe.grouped_gateup_plain(xs, wgu, None, offsets)
        # the yardstick: torch._grouped_mm, the same ragged products in one
        # call (gate|up without the SwiGLU), where this PyTorch has it
        ends = offsets[1:]
        check("grouped_gateup" + sfx, label, lambda: moe.grouped_gateup(xs, wgu, None, offsets),
              lambda: moe.grouped_gateup_plain(xs, wgu, None, offsets), timed=timed,
              nbytes=2 * (touched * M_E * 2 * M_F + rows * (M_E + M_F)) + 4 * (M_NE + 1),
              flop=2 * rows * M_E * 2 * M_F, plain_graph=False,
              library=timed and grouped_mm and (lambda: grouped_mm(xs, wgu, offs=ends)) or None)
        check("grouped_down" + sfx, label, lambda: moe.grouped_down(h, wd, offsets),
              lambda: moe.grouped_down_plain(h, wd, offsets), timed=timed,
              nbytes=2 * (touched * M_F * M_E + rows * (M_F + M_E)) + 4 * (M_NE + 1),
              flop=2 * rows * M_F * M_E, plain_graph=False,
              library=timed and grouped_mm and (lambda: grouped_mm(h, wd, offs=ends)) or None)
        if timed:   # gate and up unpacked, as MLA's experts are
            wg, wu = wgu[..., :M_F].contiguous(), wgu[..., M_F:].contiguous()
            check("grouped_gateup" + sfx, label + " unpacked",
                  lambda: moe.grouped_gateup(xs, wg, wu, offsets),
                  lambda: moe.grouped_gateup_plain(xs, wg, wu, offsets))
            del wg, wu
    del wgu, wd

    # B3 at G = 8: E = 2048, 32 q and 4 kv heads ((H + 2K)·D = 5120 columns,
    # another split-K choice, per-head norm and rope over 4 kv heads), every
    # layer of a 4-layer stack, at B = 1 and the decode batch
    scratch: dict = {}
    L = 4
    ln = rnd(L, M_E, scale=0.1) + 1
    qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
    wqkv = rnd(L, M_E, (M_H + 2 * M_KV) * D, scale=M_E ** -0.5)
    kw3 = dict(n_heads=M_H, n_kv=M_KV, head_dim=D, eps=1e-6)
    for B in (1, SLOTS):
        x = rnd(B, M_E)
        cos, sin = rope_angles(torch.randint(0, 4000, (B,), generator=gen, device=dev),
                               D, 1_000_000.0)
        for layer in range(L):
            args3 = (x, ln, wqkv, qn, kn, cos, sin, layer)
            _check_kernel(scratch, "fused_qkv_stacked", f"G=8 B={B} layer={layer} L={L}",
                          lambda: fl.fused_qkv_stacked(*args3, **kw3),
                          lambda: fl.fused_qkv_stacked_plain(*args3, **kw3),
                          rtol=BF16_RTOL, atol=BF16_ATOL)
    del ln, qn, kn, wqkv

    # K1 (B1) and K2 (B2) at G = 8
    L = 2
    kp, vp = rnd(L * SLOTS, CTX, M_KV, D), rnd(L * SLOTS, CTX, M_KV, D)
    q = rnd(SLOTS, M_H, D)
    lim = torch.tensor(LIMITS, device=dev)
    kw = dict(n_rows=SLOTS, slot_ctx=CTX)
    for layer in range(L):
        keys = sum(max(x, 1) for x in LIMITS)
        _check_kernel(scratch, "slot_attention", f"G=8 B={SLOTS} layer={layer} ctx={CTX}",
                      lambda: sa.slot_attention(q, kp, vp, lim, layer, **kw),
                      lambda: sa.slot_attention_plain(q, kp, vp, lim, layer, **kw),
                      rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC,
                      timed=layer == 1,
                      nbytes=keys * M_KV * D * 4 + 4 * SLOTS * M_H * D + 8 * SLOTS,
                      flop=4 * M_H * D * keys)
    # B9 at G = 8: W = 16 holds 128 query rows a block, two K1 launches
    _check_windows(lambda *a, **k: _check_kernel(
        scratch, *a, rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, **k),
        rnd, kp, vp, M_H, M_KV, (4, 8, 16))
    del kp, vp
    for B, T in ((4, 512), (1, 3030), (2, 3030), (1, 3072)):
        qf, kf, vf = rnd(B, T, M_H, D), rnd(B, T, M_KV, D), rnd(B, T, M_KV, D)
        _check_kernel(scratch, "flash_attention", f"G=8 B={B} T={T}",
                      lambda: fa.flash_attention(qf, kf, vf),
                      lambda: fa.flash_attention_plain(qf, kf, vf),
                      rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC,
                      timed=T == 3072,
                      flop=4 * B * M_H * D * T * (T + 1) // 2,
                      nbytes=2 * B * T * D * (2 * M_H + 2 * M_KV))
    res["g8"] = scratch
    return res


def _int8pack(x, w_t, scales):
    """One PyTorch call that computes B10's bare product, the yardstick of
    ``int8_product``: ``torch._weight_int8pack_mm`` with the [N, K] int8
    weight and the scales rounded to x's dtype (its only difference), or
    None where this PyTorch has no CUDA kernel for it."""
    import torch

    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None
    try:
        fn(x, w_t, scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"[kernel] torch._weight_int8pack_mm: no CUDA kernel here ({str(e)[:120]})")
        return None
    return lambda: fn(x, w_t, scales)


def _i8_fault_uses(tag: str, ref, faults: dict) -> None:
    """B10's bound sees a scheduling fault: each faulted plain output (one
    ring stage of a product's K left out, or one column tile left out)
    against the sound plain output ``ref`` takes more than its whole bound
    (BF16_RTOL / BF16_ATOL)."""
    uses = {name: _bound_use(got, ref, BF16_RTOL, BF16_ATOL, math.inf)
            for name, got in faults.items()}
    log(f"[kernel] {tag} faults, bound use: " +
        ", ".join(f"{n} {u:.2f}" for n, u in uses.items()))
    assert min(uses.values()) > 1.0, (tag, uses)


def phase_int8_kernels(gen) -> dict:
    """B10's two entries and its bare int8 product, and B12, against their
    plain versions (B10 at qwen3-32b and qwen3-8b widths, B = 1, 16 and 64,
    every layer of a four-layer stack; the product at qwen3-32b's lm_head
    shape (a half-filled last 256-column tile), at each qwen3-32b layer shape
    and at qwen3-8b's down projection and a ragged [5120, 51328] at 1, 16,
    32, 48 and 64 rows; B12 at the five qwen3-32b shapes, stochastic at
    [5120, 51200], and on its element-load, fp16, float32 and unaligned-q
    paths); a plain
    output with one ring stage of K or one column tile left out must fail
    each B10 check at B = 1 and 16. Returns per-kernel results, timed at
    qwen3-32b widths and the decode batch, ``int8_product`` beside
    ``torch._weight_int8pack_mm``."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import quant

    dev, bf = torch.device("cuda"), torch.bfloat16
    res: dict = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def i8(L, K, N):
        """An int8 stack whose dequantized values have std ~K^-1/2, and its
        [L,1,N] column scales (q uniform in [-127, 127]: std ~73)."""
        q = torch.randint(-127, 128, (L, K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (0.5 + torch.rand((L, 1, N), generator=gen, device=dev)) / (73 * K ** 0.5)
        return q, s

    def check(*a, **k):
        _check_kernel(res, *a, rtol=BF16_RTOL, atol=BF16_ATOL, **k)

    def drop(w, stage=None, tile=None):
        """w [K,N] with one ring stage of rows (its tile width's k rows) or
        one column tile zeroed: what a schedule that skipped it would sum."""
        w = w.clone()
        tw = fl.i8_tile_cols(w.shape[1])
        if stage is not None:
            rows = 8192 // tw
            w[stage * rows:(stage + 1) * rows] = 0
        if tile is not None:
            w[:, tile * tw:(tile + 1) * tw] = 0
        return w

    # a four-layer stack walked layer by layer, each call reading its
    # weights cold (487 MB of int8 a layer at qwen3-32b, beyond the 50 MB L2)
    L = 4
    for model, (e, h, kv, f) in ((I8_MODEL, (Q_E, Q_H, Q_KV, Q_F)),
                                 ("qwen3-8b", (E, H, KV, FF))):
        C = (h + 2 * kv) * D
        ln1, ln2 = rnd(L, e, scale=0.1) + 1, rnd(L, e, scale=0.1) + 1
        qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
        wq, ws = i8(L, e, C)
        woq, wos = i8(L, h * D, e)
        guq, gus = i8(L, e, 2 * f)
        wdq, wds = i8(L, f, e)
        kw = dict(n_heads=h, n_kv=kv, head_dim=D, eps=1e-6)
        for B in (1, SLOTS, SLOTS * WIN):
            x, a = rnd(B, e), rnd(B, h * D)
            cos, sin = rope_angles(torch.randint(0, 4000, (B,), generator=gen, device=dev),
                                   D, 1_000_000.0)
            args_q = (x, ln1, wq, ws, qn, kn, cos, sin)
            args_o = (a, x, woq, wos, ln2, guq, gus, wdq, wds)
            for layer in range(L):
                label = f"{model} B={B} layer={layer}"
                check("fused_qkv_stacked_i8", label,
                      lambda: fl.fused_qkv_stacked_i8(*args_q, layer, **kw),
                      lambda: fl.fused_qkv_stacked_i8_plain(*args_q, layer, **kw))
                # the new 64-row check also allows one bf16 ulp of x2 (see
                # _x2_ulp); the 1- and 16-row checks keep the plain bound
                check("fused_out_mlp_stacked_i8", label,
                      lambda: fl.fused_out_mlp_stacked_i8(*args_o, layer, eps=1e-6),
                      lambda: fl.fused_out_mlp_stacked_i8_plain(*args_o, layer, eps=1e-6),
                      slack=(_x2_ulp(a, x, woq[layer], wos[layer]) if B == SLOTS * WIN
                             else None))
            if model == I8_MODEL and B in (1, SLOTS):
                # faults of the schedule: a product of layer 0 with one ring
                # stage left out (64 rows of wqkv's 5120, of wd's 25600),
                # and one column tile of it left out
                ref = torch.cat(fl.fused_qkv_stacked_i8_plain(*args_q, 0, **kw), 1)
                faults = {}
                for name, kw_drop in (("stage 17 of wqkv dropped", {"stage": 17}),
                                      ("tile 5 of wqkv dropped", {"tile": 5})):
                    wf = drop(wq[0], **kw_drop)[None]
                    faults[name] = torch.cat(fl.fused_qkv_stacked_i8_plain(
                        x, ln1, wf, ws, qn, kn, cos, sin, 0, **kw), 1)
                _i8_fault_uses(f"fused_qkv_stacked_i8 B={B}", ref, faults)
                ref = fl.fused_out_mlp_stacked_i8_plain(*args_o, 0, eps=1e-6)
                faults = {}
                for name, kw_drop in (("stage 201 of wd dropped", {"stage": 201}),
                                      ("tile 7 of wd dropped", {"tile": 7})):
                    wf = drop(wdq[0], **kw_drop)[None]
                    faults[name] = fl.fused_out_mlp_stacked_i8_plain(
                        a, x, woq, wos, ln2, guq, gus, wf, wds, 0, eps=1e-6)
                _i8_fault_uses(f"fused_out_mlp_stacked_i8 B={B}", ref, faults)
                del ref, faults, wf

            def walk(f, args, **k):
                return lambda: [f(*args, layer, **k) for layer in range(L)]

            wo_ = h * D * e + 3 * e * f
            for name, fk, fp, args, k, nbytes, flop in (
                    ("fused_qkv_stacked_i8", fl.fused_qkv_stacked_i8,
                     fl.fused_qkv_stacked_i8_plain, args_q, kw,
                     e * C + 4 * C + 2 * (B * e + e + 2 * D + B * C) + 4 * B * D,
                     2 * B * e * C),
                    ("fused_out_mlp_stacked_i8", fl.fused_out_mlp_stacked_i8,
                     fl.fused_out_mlp_stacked_i8_plain, args_o, {"eps": 1e-6},
                     wo_ + 4 * (2 * e + 2 * f) + 2 * (B * h * D + 2 * B * e + e),
                     2 * B * wo_)):
                t = time_ms(walk(fk, args, **k), calls=L)
                p = time_ms(walk(fp, args, **k), calls=L)
                bd = bound(nbytes, flop)
                if model == I8_MODEL and B == SLOTS:   # the int8 serve phase's shape
                    res[name].update(ms=t[0], plain_ms=p[0], library_ms=None, **bd,
                                     shape=f"{model} B={B} ({L} layers walked)")
                log(f"[kernel] {name:26s} {model} B={B} | device kernel {t[0]:.4f} ms "
                    f"plain {p[0]:.4f} ms | eager kernel {t[1]:.4f} ms plain {p[1]:.4f} "
                    f"ms | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) | "
                    f"{nbytes / t[0] / 1e6:.1f} GB/s")
            if model == I8_MODEL and B == SLOTS:
                # for information: torch._weight_int8pack_mm on B10-out's three
                # products, layer by layer (three calls and no epilogues: not
                # one call computing the function, so no library_ms)
                pk = [(w[l].t().contiguous(), s[l, 0].to(bf)) for l in range(L)
                      for w, s in ((woq, wos), (guq, gus), (wdq, wds))]
                xs = (a, rnd(B, e), rnd(B, f))
                if _int8pack(a, *pk[0]) is not None:
                    lib3 = time_ms(lambda: [torch._weight_int8pack_mm(xs[i % 3], *pk[i])
                                            for i in range(3 * L)], calls=L)[0]
                    log(f"[kernel] fused_out_mlp_stacked_i8 {model} B={B}: three "
                        f"torch._weight_int8pack_mm calls a layer {lib3:.4f} ms")
                del pk
        del wq, ws, woq, wos, guq, gus, wdq, wds

    # the bare int8 product at the lm_head shape (778 MB of int8; 593.5
    # 256-column tiles: the last half full), beside one library call
    V32 = V
    hq, hs = i8(1, Q_E, V32)
    hq, hs = hq[0], hs[0]
    lib = None
    for B in (1, SLOTS):
        x = rnd(B, Q_E)
        if B == SLOTS:
            lib = _int8pack(x, hq.t().contiguous(), hs[0].to(bf))
        check("int8_product", f"lm_head B={B} [{Q_E}, {V32}]",
              lambda: fl.int8_product(x, hq, hs), lambda: fl.int8_product_plain(x, hq, hs),
              timed=B == SLOTS, nbytes=Q_E * V32 + 4 * V32 + 2 * B * (Q_E + V32),
              flop=2 * B * Q_E * V32, library=lib)
        ref = fl.int8_product_plain(x, hq, hs)
        _i8_fault_uses(f"int8_product lm_head B={B}", ref, {
            "stage 77 dropped": fl.int8_product_plain(x, drop(hq, stage=77), hs),
            "tile 300 dropped": fl.int8_product_plain(x, drop(hq, tile=300), hs)})
    if lib is None:
        log("[kernel] int8_product: torch._weight_int8pack_mm has no CUDA kernel here")
    del hq, hs, lib

    # the bare product as int8_matmul runs it in a prefill of up to 64 rows,
    # on each qwen3-32b layer shape (B = 16 beside torch._weight_int8pack_mm,
    # for information), qwen3-8b's down projection and [5120, 51328] (200.5
    # 256-column tiles: a half-filled last one): 17-32 rows take the
    # kernel's MT=2 instance, 33-64 its MT=4 one (48: a partly filled last
    # m-tile)
    for wname, (K8, N8) in (("wqkv", (Q_E, (Q_H + 2 * Q_KV) * D)), ("wo", (Q_H * D, Q_E)),
                            ("w_gateup", (Q_E, 2 * Q_F)), ("w_down", (Q_F, Q_E)),
                            ("qwen3-8b w_down", (FF, E)), ("ragged", (Q_E, 51328))):
        wq8, ws8 = i8(1, K8, N8)
        wq8, ws8 = wq8[0], ws8[0]
        for B in (1, 16, 32, 48, 64):
            x = rnd(B, K8)
            check("int8_product", f"{wname} B={B} [{K8}, {N8}]",
                  lambda: fl.int8_product(x, wq8, ws8),
                  lambda: fl.int8_product_plain(x, wq8, ws8))
            if B == SLOTS and not wname.startswith(("qwen3-8b", "ragged")):
                t = time_ms(lambda: fl.int8_product(x, wq8, ws8), iters=20)[0]
                lb = _int8pack(x, wq8.t().contiguous(), ws8[0].to(bf))
                tl = time_ms(lb, iters=20)[0] if lb is not None else None
                log(f"[kernel] int8_product {wname} B={B} [{K8}, {N8}] | device kernel "
                    f"{t:.4f} ms | bound {K8 * N8 / HBM_BYTES_S * 1e3:.4f} ms (bytes) | "
                    f"torch._weight_int8pack_mm "
                    f"{'none' if tl is None else f'{tl:.4f} ms'}")
        del wq8, ws8

    # B12 at the five qwen3-32b shapes a build quantizes: round to nearest
    # bit-equal, timed, each with its bound (the row keeps w_gateup's); a
    # plain version whose amax left out one cluster block's rows (its
    # partial amax dropped in the merge) must differ from the kernel's
    # scales. The matrices draw from a generator of their own, except
    # w_gateup, which draws from gen as before
    aux = torch.Generator(device=dev).manual_seed(5)
    res["b12_shapes"] = {}
    for wname, (K12, N12) in B12_SHAPES.items():
        w = (torch.randn((K12, N12), generator=gen if wname == "w_gateup" else aux, device=dev)
             * K12 ** -0.5).to(bf)
        sub: dict = {}
        _check_kernel(sub, "quantize_int8", f"{wname} [{K12}, {N12}] bf16, round to nearest",
                      lambda: quant.quantize_int8(w), lambda: quant.quantize_int8_plain(w),
                      rtol=BF16_RTOL, atol=BF16_ATOL, timed=True, exact=True,
                      nbytes=3 * K12 * N12 + 4 * N12,
                      flop=6 * K12 * N12, rate=F32_FLOP_S)
        plan = quant.quant_plan(K12, N12)
        q_k, s_k = quant.quantize_int8(w)
        xa = w.float().abs()
        r0, r1 = plan.rows, min(K12, 2 * plan.rows)   # cluster block 1's rows
        amax = torch.maximum(xa[:r0].amax(0, keepdim=True), xa[r1:].amax(0, keepdim=True)
                             if r1 < K12 else torch.zeros_like(xa[:1]))
        s_f = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
        q_f, _ = quant.quantize_int8_plain(w, scale=s_f)
        torch.cuda.synchronize()
        bad_s, bad_q = int((s_f != s_k).sum()), int((q_f != q_k).sum())
        assert plan.cs == 1 or (bad_s > 0 and bad_q > 0), (wname, "a dropped amax passed", plan)
        sub["quantize_int8"].update(plan=plan._asdict())
        res["b12_shapes"][wname] = sub["quantize_int8"]
        log(f"[kernel] quantize_int8 {wname}: plan {plan._asdict()}; block 1's amax "
            f"dropped: {bad_s} of {N12} scales and {bad_q} of q differ")
        if wname == "w_gateup":
            res["quantize_int8"] = dict(sub["quantize_int8"])
            w_gu = w
        del w, xa, q_k, s_k, q_f, s_f, amax
    w, (K12, N12) = w_gu, B12_SHAPES["w_gateup"]
    del w_gu
    res["quantize_int8"]["err"] = max(v["err"] for v in res["b12_shapes"].values())
    # stochastic rounding: the round-to-nearest scales, q in {floor(x/s),
    # floor(x/s) + 1} (clipped), unbiased, one stream per seed, and the
    # plain version's Philox stream to the bit
    q_rn, s_rn = quant.quantize_int8(w)
    q1, s1 = quant.quantize_int8(w, seed=1, stochastic=True)
    q1b, _ = quant.quantize_int8(w, seed=1, stochastic=True)
    q2, _ = quant.quantize_int8(w, seed=2, stochastic=True)
    torch.cuda.synchronize()
    assert torch.equal(s1, s_rn), "stochastic scales differ from round-to-nearest's"
    assert torch.equal(q1, quant.quantize_int8_plain(w, seed=1, stochastic=True)[0]), (
        "stochastic q differs from the plain Philox model's")
    y = w.float() / s1
    lo = torch.floor(y).clamp(-127, 127)
    d = q1.float() - lo
    assert bool(((d == 0) | (d == 1)).all()), "stochastic q outside {floor, floor + 1}"
    mean_err = float((q1.float() - y).mean())
    mean_up = float(d.mean() - (y - torch.floor(y)).mean())
    assert abs(mean_err) < STOCH_MEAN_BOUND and abs(mean_up) < STOCH_MEAN_BOUND, (
        mean_err, mean_up)
    assert torch.equal(q1, q1b), "the same seed gave another q"
    changed = float((q1 != q2).float().mean())
    assert changed > 0.1, f"another seed changed only {changed:.4f} of q"
    log(f"[kernel] quantize_int8 stochastic [{K12}, {N12}]: scales equal round to "
        f"nearest's; q equal to the plain Philox model's and in {{floor, floor + 1}}; "
        f"mean(q - x/s) {mean_err:.2e}, "
        f"mean(q - floor) - mean(frac) {mean_up:.2e} (bound {STOCH_MEAN_BOUND}); "
        f"seed 1 twice equal; seed 2 differs on {changed:.3f} of q; "
        f"{float((q1 != q_rn).float().mean()):.3f} of q differ from round to nearest")
    del w, y, lo, d, q_rn, q1, q1b, q2
    # B12's other paths, bit for bit: rows whose stride is no multiple of 16
    # bytes (the threads' element loads instead of TMA; a cluster of 4 at
    # [3000, 1030], stochastic too), fp16 and float32 weights, and a q that
    # is not 8-byte aligned (byte stores instead of 8-byte ones)
    edge: dict = {}
    for K12, N12, dt, stoch, offset in ((7, 130, bf, False, 0), (3000, 1030, bf, False, 0),
                                        (3000, 1030, bf, True, 0),
                                        (4096, 6144, torch.float16, False, 0),
                                        (2048, 5120, torch.float32, False, 0),
                                        (1000, 77, torch.float32, False, 0),
                                        (5120, 1024, bf, False, 1)):
        w = (torch.randn((K12, N12), generator=aux, device=dev) * K12 ** -0.5).to(dt)
        buf = torch.empty(K12 * N12 + offset, dtype=torch.int8, device=dev)
        out = (buf[offset:].view(K12, N12), torch.empty((1, N12), device=dev))
        _check_kernel(edge, "quantize_int8", f"[{K12}, {N12}] {str(dt).split('.')[-1]}"
                      f"{', stochastic' if stoch else ''}{', q offset 1 B' if offset else ''}",
                      lambda: quant.quantize_int8(w, seed=3, stochastic=stoch, out=out),
                      lambda: quant.quantize_int8_plain(w, seed=3, stochastic=stoch),
                      rtol=BF16_RTOL, atol=BF16_ATOL, exact=True)
    res["quantize_int8"]["err"] = max(res["quantize_int8"]["err"], edge["quantize_int8"]["err"])
    del w, buf, out
    _free()   # the B12 checks' ~20 GB of temporaries go back before the MLA phase
    return res


def phase_mla_kernels(gen) -> tuple[dict, dict]:
    """B8 and K3 against their plain versions at deepseek-v3 widths (K3 also
    at kimi-k2's 64 heads, and at B = 1 and 64 beside SDPA), and the grouped
    expert kernels at its expert shape; returns the per-kernel results of
    the JSON line (B8 timed at the dense width, K3 at H = 128, B = 16) and
    the other timed shapes."""
    import torch

    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev, bf = torch.device("cuda"), torch.bfloat16
    res: dict = {}
    other: dict = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def check(name, *a, **k):
        _check_kernel(res if k.get("timed") else other, name, *a, **k)

    def attn_check(name, *a, **k):
        check(name, *a, rtol=ATTN_RTOL, atol=ATTN_ATOL, **{"rms_frac": ATTN_RMS_FRAC, **k})

    _free()   # the earlier kernel phases' tensors and graphs
    # B8: two-layer stacks (793 MB a dense layer, 88 MB a shared expert:
    # beyond the 50 MB L2), each layer checked at B = 1 and 16; the timing
    # walks both layers, so each call reads its weights cold as in serving
    L = 2
    for F, norm, tag in ((X_FD, True, "dense"), (X_FS, False, "shared")):
        ln = rnd(L, X_E, scale=0.1) + 1
        wg, wu = rnd(L, X_E, F, scale=X_E ** -0.5), rnd(L, X_E, F, scale=X_E ** -0.5)
        wd = rnd(L, F, X_E, scale=F ** -0.5)
        kw = dict(eps=1e-6, norm=norm, residual=norm)
        for B in (1, SLOTS):
            x = rnd(B, X_E)
            for layer in range(L):
                _check_kernel(other, "fused_mlp_stacked", f"{tag} F={F} B={B} layer={layer}",
                              lambda: fl.fused_mlp_stacked(x, ln, wg, wu, wd, layer, **kw),
                              lambda: fl.fused_mlp_stacked_plain(x, ln, wg, wu, wd, layer, **kw),
                              rtol=BF16_RTOL, atol=BF16_ATOL)

            def walk(f):
                return lambda: [f(x, ln, wg, wu, wd, layer, **kw) for layer in range(L)]

            t = time_ms(walk(fl.fused_mlp_stacked), calls=L)
            p = time_ms(walk(fl.fused_mlp_stacked_plain), calls=L)
            bd = bound(2 * (3 * X_E * F + 2 * B * X_E + norm * X_E), 2 * B * 3 * X_E * F)
            log(f"[kernel] B8 fused_mlp_stacked {tag} F={F} B={B} | device kernel "
                f"{t[0]:.4f} ms plain {p[0]:.4f} ms | eager kernel {t[1]:.4f} ms plain "
                f"{p[1]:.4f} ms | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) | "
                f"{6 * X_E * F / t[0] / 1e6:.1f} GB/s")
            r = dict(ms=t[0], plain_ms=p[0], library_ms=None, **bd,
                     shape=f"{tag} E={X_E} F={F} B={B} ({L} layers walked)")
            if tag == "dense" and B == SLOTS:
                res["fused_mlp_stacked"] = {"err": 0.0, **r}
            other[f"fused_mlp_stacked {tag} B={B}"] = r
        del ln, wg, wu, wd
        _free()
    res["fused_mlp_stacked"]["err"] = other.pop("fused_mlp_stacked")["err"]

    # K3 through B1's entry: a two-layer slot pool of SLOTS rows x CTX
    # tokens of one 576-column cache head, LIMITS as K1's check. The
    # yardstick is SDPA over layer 1's rows with each row's key mask, the
    # H heads of a row as its H query rows over the one cache head: the
    # same function as enable_gqa over [B, H, 1, 576] queries, whose math
    # path expands k and v to every head (over 60 GB at H = 128)
    lim = torch.tensor(LIMITS, device=dev)
    keys = sum(max(x, 1) for x in LIMITS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(n_rows=SLOTS, slot_ctx=CTX, scale=X_SCALE, v_width=X_V)
    pool = rnd(2 * SLOTS, CTX, 1, X_D)
    k1 = pool[SLOTS:].transpose(1, 2)                         # [B, 1, CTX, 576]
    mask = (torch.arange(CTX, device=dev)[None] < lim.clamp(min=1)[:, None])[:, None, None]
    for h, model in ((128, "deepseek-v3"), (64, "kimi-k2")):
        q = rnd(SLOTS, h, X_D)
        q4 = q[:, None]                                       # [B, 1, H, 576]
        io = keys * X_D * 2 + SLOTS * h * (X_D + X_V) * 2 + SLOTS * 8
        for layer in range(2):
            attn_check("slot_attention_latent", f"{model} H={h} B={SLOTS} layer={layer} "
                       f"ctx={CTX}",
                       lambda: sa.slot_attention(q, pool, None, lim, layer, **kw),
                       lambda: sa.slot_attention_plain(q, pool, None, lim, layer, **kw),
                       timed=layer == 1 and h == 128, nbytes=io,
                       flop=2 * h * (X_D + X_V) * keys,
                       library=lambda: sdpa(q4, k1, k1[..., :X_V], attn_mask=mask,
                                            scale=X_SCALE))
        if h == 64:   # the kimi-k2 time, for PERF.md
            other["slot_attention_latent H=64"] = {
                "ms": time_ms(lambda: sa.slot_attention(q, pool, None, lim, 1, **kw),
                              iters=20)[0], **bound(io, 2 * h * (X_D + X_V) * keys)}
    # B = 1 over one full 4096-key row (16 splits of 256 keys), beside SDPA
    # over the same row, and the bound's view of a split fault there
    qb, lb = rnd(1, 128, X_D), torch.tensor([CTX], device=dev)
    kb = pool[1:2].transpose(1, 2)                            # [1, 1, CTX, 576]
    kw1 = dict(kw, n_rows=1)
    row: dict = {}
    _check_kernel(row, "slot_attention_latent",
                  f"deepseek-v3 H=128 B=1 layer=1 ctx={CTX} (one full row)",
                  lambda: sa.slot_attention(qb, pool[:2], None, lb, 1, **kw1),
                  lambda: sa.slot_attention_plain(qb, pool[:2], None, lb, 1, **kw1),
                  rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                  nbytes=CTX * X_D * 2 + 128 * (X_D + X_V) * 2 + 8,
                  flop=2 * 128 * (X_D + X_V) * CTX,
                  library=lambda: sdpa(qb[:, None], kb, kb[..., :X_V], scale=X_SCALE))
    other["slot_attention_latent B=1"] = row.pop("slot_attention_latent")
    _bound_rejects_split_faults(sa.slot_attention_plain(qb, pool[:2], None, lb, 1, **kw1),
                                qb, kb, kb[..., :X_V], scale=X_SCALE, tag="K3")
    del pool, k1, kb
    _free()
    # B = 64 (LIMITS four times over): 128 blocks of 64 heads, three splits
    n64 = 4 * SLOTS
    pool64 = rnd(n64, CTX, 1, X_D)
    q64, lim64 = rnd(n64, 128, X_D), torch.tensor(LIMITS * 4, device=dev)
    k64 = pool64.transpose(1, 2)
    mask64 = (torch.arange(CTX, device=dev)[None] < lim64.clamp(min=1)[:, None])[:, None, None]
    kw64 = dict(kw, n_rows=n64)
    _check_kernel(row, "slot_attention_latent", f"deepseek-v3 H=128 B={n64} layer=0 ctx={CTX}",
                  lambda: sa.slot_attention(q64, pool64, None, lim64, 0, **kw64),
                  lambda: sa.slot_attention_plain(q64, pool64, None, lim64, 0, **kw64),
                  rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                  nbytes=4 * keys * X_D * 2 + n64 * 128 * (X_D + X_V) * 2 + n64 * 8,
                  flop=2 * 128 * (X_D + X_V) * 4 * keys,
                  library=lambda: sdpa(q64[:, None], k64, k64[..., :X_V], attn_mask=mask64,
                                       scale=X_SCALE))
    other["slot_attention_latent B=64"] = row.pop("slot_attention_latent")
    del pool64, q64, k64
    _free()

    # K3 through the three B6 entries: 64-token pages of a shuffled table
    # (page 0 the zeroed null page), SEQS as K1's check; the pool is k and v
    ps, P = 64, CTX // 64
    NP = 1 + SLOTS * P
    pages = rnd(NP, ps, 1, X_D)
    pages[0] = 0
    seq = torch.tensor(SEQS, device=dev)
    perm = torch.randperm(NP - 1, generator=gen, device=dev)[: SLOTS * P].view(SLOTS, P)
    used = (seq + ps - 1) // ps
    table = torch.where(torch.arange(P, device=dev)[None] < used[:, None], perm + 1, 0)
    qpos = (seq - 1)[:, None]
    nkeys = int(seq.sum())
    for h, model in ((128, "deepseek-v3"), (64, "kimi-k2")):
        q1 = rnd(SLOTS, 1, h, X_D)
        io = nkeys * X_D * 2 + SLOTS * h * (X_D + X_V) * 2 + SLOTS * (P + 2) * 8
        flop = 2 * h * (X_D + X_V) * nkeys
        for name in ("pallas_paged_attention", "pallas_paged_decode",
                     "pallas_paged_decode_clamp"):
            extra = (qpos,) if name == "pallas_paged_attention" else ()
            fk, fp = getattr(pa, name), getattr(pa, name + "_plain")
            timed = h == 128 and name == "pallas_paged_attention"
            attn_check("paged_attention_latent", f"{name} {model} H={h} B={SLOTS} ps={ps} "
                       f"P={P}",
                       lambda: fk(q1, pages, pages, table, seq, *extra, scale=X_SCALE,
                                  v_width=X_V),
                       lambda: fp(q1, pages, pages, table, seq, *extra, scale=X_SCALE,
                                  v_width=X_V), timed=timed, nbytes=io, flop=flop)
            if h == 64 and name == "pallas_paged_attention":
                other["paged_attention_latent H=64"] = {
                    "ms": time_ms(lambda: fk(q1, pages, pages, table, seq, *extra,
                                             scale=X_SCALE, v_width=X_V), iters=20)[0],
                    **bound(io, flop)}
    del pages
    _free()
    for name in ("slot_attention_latent", "paged_attention_latent"):
        res[name]["err"] = max(res[name]["err"], other.pop(name)["err"])
    res["slot_attention_latent"]["err"] = max(
        res["slot_attention_latent"]["err"], *(other[f"slot_attention_latent B={n}"]["err"]
                                               for n in (1, n64)))

    # the grouped expert kernels at deepseek-v3's expert shape, gate and up
    # unpacked (MLA's routed experts): the decode kernel over the rows of 16
    # tokens x top-8, the prefill kernel over 3072 tokens x top-8, there
    # also packed, beside torch._grouped_mm over the packed copy
    wg = torch.empty((X_NE, X_E, X_FS), dtype=bf, device=dev)
    wu, wd = torch.empty_like(wg), torch.empty((X_NE, X_FS, X_E), dtype=bf, device=dev)
    wgu = torch.empty((X_NE, X_E, 2 * X_FS), dtype=bf, device=dev)
    for e in range(0, X_NE, 32):   # drawn 32 experts at a time
        wg[e:e + 32], wu[e:e + 32] = (rnd(32, X_E, X_FS, scale=X_E ** -0.5) for _ in "gu")
        wd[e:e + 32] = rnd(32, X_FS, X_E, scale=X_FS ** -0.5)
        wgu[e:e + 32] = torch.cat([wg[e:e + 32], wu[e:e + 32]], dim=-1)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    for T in (SLOTS, 3072):
        logits = torch.randn((T, X_NE), generator=gen, device=dev) * 2
        _, top_e = moe.route_topk(logits, X_TOPK)
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        offsets = moe.group_offsets(flat_e, X_NE)
        xs = rnd(T, X_E)[order // X_TOPK]
        sizes = offsets[1:] - offsets[:-1]
        touched = int((sizes > 0).sum())
        rows = T * X_TOPK
        prefill = moe.grouped_prefill(rows, X_NE, X_E, X_FS)
        assert prefill == (T != SLOTS), (T, prefill)
        sfx = "_prefill" if prefill else ""
        label = (f"deepseek-v3 T={T} x top-{X_TOPK} ({touched} of {X_NE} experts, largest "
                 f"{int(sizes.max())} rows) unpacked")
        h = moe.grouped_gateup_plain(xs, wg, wu, offsets)
        ends = offsets[1:]
        gu_bytes = 2 * (touched * X_E * 2 * X_FS + rows * (X_E + X_FS)) + 4 * (X_NE + 1)
        _check_kernel(other, "grouped_gateup" + sfx, label,
                      lambda: moe.grouped_gateup(xs, wg, wu, offsets),
                      lambda: moe.grouped_gateup_plain(xs, wg, wu, offsets), rtol=BF16_RTOL,
                      atol=BF16_ATOL, timed=True, plain_graph=False, nbytes=gu_bytes,
                      flop=2 * rows * X_E * 2 * X_FS,
                      library=prefill and grouped_mm and (lambda: grouped_mm(xs, wgu, offs=ends))
                      or None)
        _check_kernel(other, "grouped_down" + sfx, label,
                      lambda: moe.grouped_down(h, wd, offsets),
                      lambda: moe.grouped_down_plain(h, wd, offsets), rtol=BF16_RTOL,
                      atol=BF16_ATOL, timed=True, plain_graph=False,
                      nbytes=2 * (touched * X_FS * X_E + rows * (X_FS + X_E)) + 4 * (X_NE + 1),
                      flop=2 * rows * X_FS * X_E,
                      library=prefill and grouped_mm and (lambda: grouped_mm(h, wd, offs=ends))
                      or None)
        if prefill:
            _check_kernel(other, "grouped_gateup_prefill", label[:-len("unpacked")] + "packed",
                          lambda: moe.grouped_gateup(xs, wgu, None, offsets),
                          lambda: moe.grouped_gateup_plain(xs, wgu, None, offsets),
                          rtol=BF16_RTOL, atol=BF16_ATOL)
        for n in ("grouped_gateup", "grouped_down"):
            other[f"{n} deepseek-v3 T={T}"] = other.pop(n + sfx)
    del wg, wu, wd, wgu, h
    return res, other


@contextlib.contextmanager
def _serve_http(engine):
    """An ``OpenAIServer`` for ``engine`` on an ephemeral localhost port,
    run on its own thread; yields the ``/v1`` base URL."""
    import asyncio

    from deepsearch_tts_tpu_torch.engine.server import OpenAIServer

    loop = asyncio.new_event_loop()
    server = OpenAIServer(engine, "127.0.0.1", 0)
    loop.run_until_complete(server.start())
    port = server._server.sockets[0].getsockname()[1]
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{port}/v1"
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=30)
        loop.run_until_complete(server.stop())
        loop.close()


def _release(engine) -> dict:
    """Stop ``engine`` and free its KV pools; returns its params."""
    import torch

    engine.shutdown()
    params = engine.params
    engine.k_pages = engine.v_pages = engine.k_scales = engine.v_scales = None
    engine.seen = None
    gc.collect()
    torch.cuda.empty_cache()
    return params


def _engine(params, model: str = "qwen3-8b", **kw):
    """``model`` on the card over the served weights, ``SLOTS`` rows."""
    from deepsearch_tts_tpu_torch.engine.engine import Engine
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer

    return Engine(model, ByteTokenizer(), params=params, device="cuda",
                  max_slots=SLOTS, max_seq_len=CTX, decode_chunk_len=8, **kw)


def phase_slot_serve(card: str, params: dict, model: str = "qwen3-8b",
                     profile: bool = False, tag: str = "slot", spec: bool = False,
                     b1_tokens: int = 0, b1_plain_ms: float | None = None) -> dict:
    """The slot engine with parking, default ``attn_impl``, over HTTP, on
    the served weights of ``model``; with ``spec`` the speculative engine
    (``SPEC_KW``), whose full-batch burst is greedy and must emit more than
    one token per verify step, and whose greedy stream is teacher-forced
    through the no-cache forward. ``b1_tokens``: one more greedy request of
    that many tokens alone (ms per token logged beside ``b1_plain_ms``)."""
    import torch

    from deepsearch_tts_tpu_torch.engine.weights import pack_matmul_params
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    # the engine packs its params; on the served (packed) tree that is the
    # identity (MLA's two-stack tree is handed back whole), so the same
    # weights are reused instead of drawn again
    packed = pack_matmul_params(params)
    assert packed is params or all(packed["layers"][k] is t
                                   for k, t in params["layers"].items())
    t0 = time.time()
    engine = _engine(params, model=model, cache_mode="slot", **(SPEC_KW if spec else {}))
    engine.warmup(prompt_lens=(64,))
    log(f"[{tag}] engine built and warmed in {time.time() - t0:.1f} s; attn_impl="
        f"{engine.attn_impl}; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    assert engine.attn_impl == "pallas" and engine.layer_fusion, engine.attn_impl
    # a speculative engine runs only verify windows: B9, never B1
    counters = {**_counters(model), "slot_attention": sa.slot_attention}
    idle = ()
    if model == MLA_MODEL:
        # MLA's 576-column latent rows take K3 through B1's entry; K1 idles
        counters["slot_attention_latent"] = sa.slot_attention_latent
        idle = ("slot_attention",)
    if spec:
        counters["slot_window_attention"] = sa.slot_window_attention
        idle = ("slot_attention",)
    out: dict = {}
    try:
        with _serve_http(engine) as base:
            def chat(content, **kw):
                payload = {"messages": [{"role": "user", "content": content}], **kw}
                return _post(f"{base}/chat/completions", payload)

            _zero(counters)
            st0 = dict(engine.stats)
            ttfts = []
            for i in range(5):
                code, body, dt = chat(f"Time to first token, please ({i}).", max_tokens=1)
                assert code == 200 and body["usage"]["completion_tokens"] == 1, body
                ttfts.append(dt)
            out["ttft_s"] = sorted(ttfts)[2]

            results = _burst(chat, 4, 48)
            log(f"[{tag}] 4 concurrent chat: completion tokens "
                f"{[r[1]['usage']['completion_tokens'] for r in results]}")

            # the same greedy request twice, sent together, so that both
            # take the same path: a raw completion whose first byte no
            # parked chat row shares re-enters no parked row (a parked
            # prefix was computed by another prefill group, rounded
            # otherwise), and neither can re-enter the other's row (sent one
            # after the other, the second would)
            pair: list = [None, None]
            hits0 = engine.stats["slot_park_hits"]

            def greedy(i):
                pair[i] = _post(f"{base}/completions", {
                    "prompt": "Greedy: count to five.", "max_tokens": 24,
                    "temperature": 0.0, "repetition_penalty": 1.0})

            ths = [threading.Thread(target=greedy, args=(i,)) for i in range(2)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            texts = [r[1]["choices"][0]["text"] for r in pair]
            assert all(r[0] == 200 for r in pair) and texts[0] == texts[1], texts
            assert engine.stats["slot_park_hits"] == hits0, "the greedy pair re-entered a row"

            r = chat("Budget: think for a while.", max_tokens=40, min_tokens=32)
            assert r[0] == 200 and r[1]["usage"]["completion_tokens"] >= 32, r[1]["usage"]

            hits0 = engine.stats["slot_park_hits"]
            msgs = [{"role": "system",
                     "content": "You are a careful search assistant. " * 8},
                    {"role": "user", "content": "Which river flows through Vienna?"}]
            r = _post(f"{base}/chat/completions", {"messages": msgs, "max_tokens": 16})
            assert r[0] == 200
            msgs += [{"role": "assistant", "content": "The Danube."},
                     {"role": "user", "content": "And through Budapest?"}]
            r = _post(f"{base}/chat/completions", {"messages": msgs, "max_tokens": 16})
            cached = r[1]["usage"]["prompt_tokens_details"]["cached_tokens"]
            hits = engine.stats["slot_park_hits"] - hits0
            assert r[0] == 200 and cached > 0 and hits >= 1, (r[1]["usage"], hits)
            log(f"[{tag}] multi-turn follow-up: prompt_tokens "
                f"{r[1]['usage']['prompt_tokens']} cached_tokens {cached} "
                f"(parked-row re-entries {hits})")

            d0 = dict(engine.stats)
            results = _burst(chat, SLOTS, 64, **(GREEDY if spec else {}))
            d1 = dict(engine.stats)
            dt = d1["decode_time_s"] - d0["decode_time_s"]
            out["burst_decode_tok_s"] = (d1["decode_tokens"] - d0["decode_tokens"]) / dt
            out["burst_step_ms"] = 1e3 * dt / ((d1["decode_steps"] - d0["decode_steps"])
                                               * engine.decode_chunk_len)
            if spec:
                # tokens emitted per row and verify step (JAX's telemetry key
                # over the whole phase, and the greedy burst's own)
                out["burst_spec_tokens_per_step"] = (
                    (d1["decode_tokens"] - d0["decode_tokens"])
                    / (d1["slot_steps"] - d0["slot_steps"]))
                out["spec_tokens_per_step"] = engine.telemetry()["spec_tokens_per_step"]
                log(f"[{tag}] greedy burst: {out['burst_spec_tokens_per_step']:.3f} tokens "
                    f"per row and verify step (phase {out['spec_tokens_per_step']:.3f})")
                assert out["burst_spec_tokens_per_step"] > 1.0, out
            if profile:
                _profile_burst(chat, engine)
            if b1_tokens:
                out["b1_ms_per_token"] = _b1_run(tag, engine, b1_tokens, b1_plain_ms)

            st1 = dict(engine.stats)
            out["launches"] = _check_launches(tag, engine, counters, st0, st1, idle)
            log(f"[{tag}] park hits {st1['slot_park_hits'] - st0['slot_park_hits']}")
            out["decode_tok_s"] = ((st1["decode_tokens"] - st0["decode_tokens"])
                                   / (st1["decode_time_s"] - st0["decode_time_s"]))
        step = "verify step" if spec else "decode step"
        log(f"[{tag}] {card} | TTFT median of 5 {out['ttft_s'] * 1000:.1f} ms | decode "
            f"{out['decode_tok_s']:.1f} tok/s over the whole phase | full batch of "
            f"{SLOTS}: {out['burst_decode_tok_s']:.1f} tok/s decode "
            f"({out['burst_step_ms']:.2f} ms per {step})")
        if spec:
            _teacher_forced(tag, engine)
    finally:
        _release(engine)
    return out


def _b1_run(tag: str, engine, n: int, plain_ms: float | None) -> float:
    """One greedy request of ``n`` tokens alone on ``engine``: decode ms per
    generated token (logged beside ``plain_ms``, the plain engine's)."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest

    s0 = dict(engine.stats)
    r = engine.generate(GenerationRequest(
        prompt_ids=engine.tokenizer.encode("Alone: repeat the search results twice."),
        max_tokens=n, **GREEDY))
    s1 = dict(engine.stats)
    ms = 1e3 * (s1["decode_time_s"] - s0["decode_time_s"]) / max(
        s1["decode_tokens"] - s0["decode_tokens"], 1)
    steps = s1["slot_steps"] - s0["slot_steps"]
    log(f"[{tag}] B=1 greedy: {r.completion_tokens} tokens, {ms:.3f} ms per token "
        f"({steps} row-steps)" + ("" if plain_ms is None else
                                  f" against {plain_ms:.3f} ms on the plain slot engine"))
    return ms


def _teacher_forced(tag: str, engine) -> None:
    """One greedy stream of ``engine`` fed whole through the no-cache
    forward: each generated token must be that forward's argmax at its
    position, for at least 90 % of them."""
    import torch

    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest

    prompt = engine.tokenizer.encode("Teacher forcing: the rivers of Europe, again.")
    r = engine.generate(GenerationRequest(prompt_ids=prompt, max_tokens=48, **GREEDY))
    ids = torch.tensor([prompt + r.token_ids], device=engine.device)
    assert len(r.token_ids) >= 8, r
    with torch.no_grad():
        logits, _ = engine.forward(engine.params, engine.cfg, ids[:, :-1],
                                   torch.arange(ids.shape[1] - 1, device=engine.device)[None])
    pred = logits[0, len(prompt) - 1:].argmax(-1)
    agree = (pred == ids[0, len(prompt):]).float().mean().item()
    log(f"[{tag}] teacher-forced greedy stream of {len(r.token_ids)} tokens: argmax "
        f"agreement with the no-cache forward {agree:.3f} (bound >= 0.9)")
    assert agree >= 0.9, agree


def phase_spec_reference(params: dict, model: str = "qwen3-8b", tag: str = "spec-reference",
                         **plain_kw) -> None:
    """A 16-token slot prefill, then one ``WIN``-token verify window through
    the serving path (fused layers where the family fuses windows, B9 for
    attention) against the no-cache forward on prompt + window: every
    window row's logits. ``plain_kw`` keeps the reference off the kernels
    (``plain_experts``)."""
    import torch

    from deepsearch_tts_tpu_torch.engine.kvcache import init_kv_pages
    from deepsearch_tts_tpu_torch.models.registry import get_model
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    fam = get_model(model)
    cfg, fwd, dev = fam.config, fam.forward, torch.device("cuda")
    T0, T = 16, 16 + WIN
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None]
    one = lambda n: torch.tensor([n], device=dev)   # noqa: E731
    with torch.no_grad():
        ref, _ = fwd(params, cfg, toks, pos, **plain_kw)
        kp, vp = init_kv_pages(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim,
                               dtype=cfg.torch_dtype, device=dev)
        kw = dict(k_pages=kp, v_pages=vp, impl="pallas")
        fwd(params, cfg, toks[:, :T0], pos[:, :T0], page_table=torch.tensor([[0]], device=dev),
            seq_lens=one(T0), logits_indices=one(T0 - 1), **kw)
        n0 = sa.slot_window_attention.launches
        got, _ = fwd(params, cfg, toks[:, T0:], pos[:, T0:], seq_lens=one(T), slot_decode=True,
                     slot_ctx=64, fused_decode=True, **kw)
        launched = sa.slot_window_attention.launches - n0
    got, want = got[0], ref[0, T0:]
    assert got.shape == want.shape == (WIN, cfg.vocab_size) and torch.isfinite(got).all()
    assert launched == cfg.n_layers, launched
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[{tag}] {WIN}-token verify window (B9 x {launched}) logits vs no-cache forward: "
        f"max_abs_err {(got - want).abs().max().item():.4f}, min cosine "
        f"{cos.min().item():.5f} (bound > 0.99), argmax agreement {agree:.2f} (bound >= 0.75)")
    assert cos.min().item() > 0.99, cos
    assert agree >= 0.75, agree


def phase_moe_spec(card: str, params: dict) -> dict:
    """The speculative slot engine on the qwen3-30b-a3b weights: 8 greedy
    requests x 32 tokens; its windows run unfused (B3 and B7 idle, as in
    JAX), attention through B9 and the expert FFN through the grouped
    expert kernel."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    engine = _engine(params, model=MOE_MODEL, cache_mode="slot", **SPEC_KW)
    engine.warmup(prompt_lens=(64,))
    assert engine.attn_impl == "pallas", engine.attn_impl
    counters = {**_counters(MOE_MODEL), "slot_window_attention": sa.slot_window_attention,
                "slot_attention": sa.slot_attention}
    idle = ("slot_attention", fl.fused_qkv_stacked.__name__,
            fl.fused_out_router_stacked.__name__)
    out: dict = {}
    try:
        _zero(counters)
        st0 = dict(engine.stats)
        futs = engine.submit_many([GenerationRequest(
            prompt_ids=engine.tokenizer.encode(f"MoE speculative {i}: the rivers of Europe."),
            max_tokens=32, **GREEDY) for i in range(8)])
        res = [f.result(timeout=600) for f in futs]
        st1 = dict(engine.stats)
        assert all(len(r.token_ids) >= 1 for r in res)
        out["launches"] = _check_launches("moe-spec", engine, counters, st0, st1, idle)
        dt = st1["decode_time_s"] - st0["decode_time_s"]
        out["spec_tokens_per_step"] = engine.telemetry()["spec_tokens_per_step"]
        out["step_ms"] = 1e3 * dt / ((st1["decode_steps"] - st0["decode_steps"])
                                     * engine.decode_chunk_len)
        out["decode_tok_s"] = (st1["decode_tokens"] - st0["decode_tokens"]) / dt
        log(f"[moe-spec] {card} | 8 greedy requests: completion tokens "
            f"{[r.completion_tokens for r in res]}, {out['spec_tokens_per_step']:.3f} tokens "
            f"per row and verify step, {out['step_ms']:.2f} ms per verify step, "
            f"{out['decode_tok_s']:.1f} tok/s decode")
    finally:
        _release(engine)
    return out


def phase_pallas_serve(card: str, params: dict, xla_long_s: float) -> dict:
    """The paged engine with ``attn_impl="pallas"`` and no prefix cache
    (fresh prefill through B2, decode through ``pallas_paged_attention``),
    then short runs with the other two B6 entries."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    engine = _engine(params, attn_impl="pallas", enable_prefix_cache=False,
                     page_size=64, n_pages=1024)
    engine.warmup(prompt_lens=(64,))
    cfg, out = engine.cfg, {}
    try:
        with _serve_http(engine) as base:
            def chat(content, **kw):
                payload = {"messages": [{"role": "user", "content": content}], **kw}
                return _post(f"{base}/chat/completions", payload)

            fa.flash_attention.launches = pa.pallas_paged_attention.launches = 0
            st0 = dict(engine.stats)
            r = chat(LONG_TEXT, max_tokens=8)
            u = r[1]["usage"]
            assert r[0] == 200 and u["prompt_tokens"] > 2900 and u["completion_tokens"] >= 1, u
            out["long_prompt_s"] = r[2]
            log(f"[pallas] {card} | long prompt: {u['prompt_tokens']} prompt tokens "
                f"answered in {r[2] * 1000:.1f} ms (B2 prefill) against "
                f"{xla_long_s * 1000:.1f} ms on the XLA engine of phase 4")
            d0 = dict(engine.stats)
            _burst(chat, SLOTS, 64)
            d1 = dict(engine.stats)
            dt = d1["decode_time_s"] - d0["decode_time_s"]
            out["burst_decode_tok_s"] = (d1["decode_tokens"] - d0["decode_tokens"]) / dt
            out["burst_step_ms"] = 1e3 * dt / ((d1["decode_steps"] - d0["decode_steps"])
                                               * engine.decode_chunk_len)
            steps = (d1["decode_steps"] - st0["decode_steps"]) * engine.decode_chunk_len
            prefills = d1["prefill_dispatches"] - st0["prefill_dispatches"]
            launches = {"flash_attention": fa.flash_attention.launches,
                        "pallas_paged_attention": pa.pallas_paged_attention.launches}
            log(f"[pallas] decode steps {steps}, fresh prefill dispatches {prefills}, "
                f"launches {launches} | full batch of {SLOTS}: "
                f"{out['burst_decode_tok_s']:.1f} tok/s decode "
                f"({out['burst_step_ms']:.2f} ms per decode step)")
            assert launches["flash_attention"] == cfg.n_layers * prefills > 0, launches
            assert launches["pallas_paged_attention"] == cfg.n_layers * steps > 0, launches
            out["launches"] = launches
    finally:
        _release(engine)

    for impl, name in (("pallas2", "pallas_paged_decode"),
                       ("clamp", "pallas_paged_decode_clamp")):
        engine = _engine(params, attn_impl=impl, page_size=64, n_pages=256)
        try:
            fn = getattr(pa, name)
            fn.launches = 0
            st0 = dict(engine.stats)
            futs = engine.submit_many([
                GenerationRequest(prompt_ids=list(range(40 + 9 * i, 90 + 13 * i)),
                                  max_tokens=24) for i in range(4)])
            res = [f.result(timeout=600) for f in futs]
            steps = (engine.stats["decode_steps"] - st0["decode_steps"]) \
                * engine.decode_chunk_len
            assert all(len(r.token_ids) >= 1 for r in res)
            assert fn.launches == cfg.n_layers * steps > 0, (name, fn.launches, steps)
            out["launches"][name] = fn.launches
            log(f"[pallas] attn_impl={impl}: {steps} decode steps, {name} launches "
                f"{fn.launches}")
        finally:
            _release(engine)
    return out


def phase_mla_pallas(card: str, params: dict) -> dict:
    """The MLA model's paged engine with ``attn_impl="pallas"``: 16
    concurrent requests whose decode takes K3 through
    ``pallas_paged_attention`` (the pool as k and v) once per layer and
    step, K1 never; B8 and the grouped expert kernel as in phase 21."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    engine = _engine(params, model=MLA_MODEL, attn_impl="pallas", page_size=64, n_pages=256)
    engine.warmup(prompt_lens=(64,))
    counters = {**_counters(MLA_MODEL), "paged_attention_latent": pa.paged_attention_latent,
                "pallas_paged_attention": pa.pallas_paged_attention}
    out: dict = {}
    try:
        _zero(counters)
        st0 = dict(engine.stats)
        futs = engine.submit_many([GenerationRequest(
            prompt_ids=engine.tokenizer.encode(f"MLA paged {i}: " + "the rivers of Europe. "
                                               * (1 + i % 5)), max_tokens=32)
            for i in range(SLOTS)])
        res = [f.result(timeout=600) for f in futs]
        st1 = dict(engine.stats)
        assert all(len(r.token_ids) >= 1 for r in res)
        out["launches"] = _check_launches("mla-pallas", engine, counters, st0, st1,
                                          idle=("pallas_paged_attention",))
        dt = st1["decode_time_s"] - st0["decode_time_s"]
        out["step_ms"] = 1e3 * dt / ((st1["decode_steps"] - st0["decode_steps"])
                                     * engine.decode_chunk_len)
        out["decode_tok_s"] = (st1["decode_tokens"] - st0["decode_tokens"]) / dt
        log(f"[mla-pallas] {card} | {SLOTS} requests: {out['decode_tok_s']:.1f} tok/s "
            f"decode, {out['step_ms']:.2f} ms per decode step")
    finally:
        _release(engine)
    return out


def phase_attention_reference(params: dict, model: str = "qwen3-8b", tag: str = "reference",
                              **plain_kw) -> None:
    """Slot prefill + B1 decode, and fresh prefill (B2 where the family runs
    it) + B6 decode, against the plain no-cache forward on the served
    weights (24 tokens); on the MLA model both decodes take K3. ``plain_kw``
    keeps the reference off the kernels (``plain_experts``)."""
    import torch

    from deepsearch_tts_tpu_torch.engine.kvcache import init_kv_pages
    from deepsearch_tts_tpu_torch.models.registry import get_model

    fam, dev = get_model(model), params["embed"].device
    cfg, forward = fam.config, fam.forward
    T0, T = 16, 24
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None]
    one = lambda n: torch.tensor([n], device=dev)   # noqa: E731
    latent = getattr(cfg, "latent_cache", False)
    with torch.no_grad():
        free, _ = forward(params, cfg, toks, pos, **plain_kw)
        for label, prefill_kw, decode_kw in (
                ("slot prefill + B1 decode", {},
                 dict(slot_decode=True, slot_ctx=64, page_table=None)),
                ("fresh prefill + B6 decode", dict(fresh_prefill=True), {})):
            kp, vp = init_kv_pages(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim,
                                   dtype=cfg.torch_dtype, device=dev)
            kw = dict(k_pages=kp, v_pages=vp, page_table=torch.tensor([[0]], device=dev),
                      impl="pallas")
            replay = _RouteReplay(cfg) if latent else None
            with replay.record() if replay else contextlib.nullcontext():
                got = [forward(params, cfg, toks[:, :T0], pos[:, :T0], seq_lens=one(T0),
                               logits_indices=one(T0 - 1), **kw, **prefill_kw)[0][:, 0]]
                for t in range(T0, T):
                    got.append(forward(params, cfg, toks[:, t:t + 1], pos[:, t:t + 1],
                                       seq_lens=one(t + 1), fused_decode=True,
                                       **{**kw, **decode_kw})[0][:, 0])
            ref = free
            if replay:
                with replay.replay():
                    ref, _ = forward(params, cfg, toks, pos, **plain_kw)
                log(f"[{tag}] {label}: routing replayed, the reference's own expert set "
                    f"differs on {replay.differ} of {replay.rows} rows")
            _hold_to_reference(tag, label, torch.cat(got), ref[0, T0 - 1:],
                               free[0, T0 - 1:] if replay else None)


def _post(url: str, payload: dict, timeout: float = 600.0) -> tuple[int, dict, float]:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


def _burst(chat, n: int, max_tokens: int, **sampler) -> list:
    """n concurrent chat requests (temperature 0.7 unless ``sampler`` says
    otherwise); returns their (status, body, seconds)."""
    results = [None] * n
    sampler = {"temperature": 0.7, **sampler}

    def worker(i):
        results[i] = chat(f"Burst {i}: write a long story.", max_tokens=max_tokens, **sampler)

    ths = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=600)
    for r in results:
        assert r is not None and r[0] == 200, r
    return results


def _profile_burst(chat, engine) -> None:
    """One more full-batch burst under torch.profiler: device time by kernel
    and the share of the window in which no kernel ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _burst(chat, SLOTS, 32)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events)
    log(f"[profile] window {wall_us / 1e3:.1f} ms, kernels busy {busy / 1e3:.1f} ms, "
        f"device idle share {1 - busy / wall_us:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} calls  "
            f"{e.key[:90]}")
    spans = engine.telemetry()["spans"]
    log(f"[profile] engine spans {json.dumps(spans)}")


def _counters(model: str) -> dict:
    """The launch counters of ``model``'s fused decode path: name → wrapper
    (B5, and B3 + B4 for qwen3-8b, B3 + B7 + the grouped expert entries for
    qwen3-30b-a3b, B10's two entries + its int8 product for qwen3-32b, B8 +
    the grouped expert entries for the MLA model)."""
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

    fns = {MOE_MODEL: [fl.fused_qkv_stacked, fl.fused_out_router_stacked,
                       moe.grouped_gateup, moe.grouped_down],
           I8_MODEL: [fl.fused_qkv_stacked_i8, fl.fused_out_mlp_stacked_i8,
                      fl.int8_product],
           MLA_MODEL: [fl.fused_mlp_stacked, moe.grouped_gateup,
                       moe.grouped_down]}.get(model, [fl.fused_qkv_stacked,
                                                      fl.fused_out_mlp_stacked])
    return {f.__name__: f for f in fns + [sp.sampling_prep]}


def _zero(counters: dict) -> None:
    """Set every launch counter of ``counters`` (name → wrapper) to 0."""
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "prefill_launches"):
            f.prefill_launches = 0


def _check_launches(tag: str, engine, counters: dict, st0: dict, st1: dict,
                    idle=()) -> dict:
    """Read the counters after a phase and hold them to the phase's work:
    B3, B4/B7, B10, B8 (MLA: 3 dense MLPs + 2 shared experts), B1, B9 and
    K3 once per layer and decode (or verify) step, each grouped expert entry
    once per MoE layer and forward (decode steps + prefill dispatches), B5
    once per sample, the int8 product at least once per forward (the
    lm_head; and the layer products of prefills of up to 64 rows); the
    counters named in ``idle`` not at all."""
    L = engine.cfg.n_layers
    L_moe = L - getattr(engine.cfg, "first_k_dense", 0)   # MLA leads with dense layers
    steps = (st1["decode_steps"] - st0["decode_steps"]) * engine.decode_chunk_len
    prefills = st1["prefill_dispatches"] - st0["prefill_dispatches"]
    launches = {n: f.launches for n, f in counters.items()}
    log(f"[{tag}] decode steps {steps}, prefill dispatches {prefills}, sample calls "
        f"{steps + prefills}, launches {launches}")
    # the grouped expert entries count either kernel; of those, the prefill
    # kernel's apart (a long prompt's forward takes it)
    prefill = {n + "_prefill": counters[n].prefill_launches for n in launches
               if n.startswith("grouped_")}
    for name, n in prefill.items():
        assert 0 <= n <= launches[name[:-len("_prefill")]], (name, n)
    if prefill:
        log(f"[{tag}] of which the grouped expert prefill kernel: {prefill}")
    for name, n in launches.items():
        if name in idle:
            assert n == 0, (name, n)
            continue
        if name == "int8_product":
            assert n >= steps + prefills > 0, (name, n, steps + prefills)
            continue
        want = (steps + prefills if name == "sampling_prep"
                else L_moe * (steps + prefills) if name.startswith("grouped_")
                else L * steps)
        assert n == want > 0, (name, n, want)
    return {**launches, **prefill}


def phase_serve(card: str, model: str = "qwen3-8b", profile: bool = False,
                tag: str = "serve", **quant_kw) -> tuple[dict, object]:
    """Serve ``model`` over HTTP through the port's own construction:
    ``cli/serve.py``'s ``build_engine``, or with ``quant_kw`` (``quantize``,
    ``kv_quantize``: ``Engine`` arguments only, as in JAX) the same
    ``Engine`` construction with them. With ``quantize`` B12's counter is
    zeroed before the build and must count one launch per quantized
    matrix."""
    import torch

    from deepsearch_tts_tpu_torch.cli.serve import build_engine, build_parser
    from deepsearch_tts_tpu_torch.ops import quant

    args = build_parser().parse_args([
        "--model", model, "--device", "cuda", "--seed", "0",
        "--max_slots", str(SLOTS), "--page_size", "64", "--pages", "1024",
        "--max_seq_len", "4096", "--decode_chunk", "8", "--warmup", "64"])
    torch.cuda.reset_peak_memory_stats()
    quant.quantize_int8.launches = 0
    t0 = time.time()
    if quant_kw:
        engine = _engine(None, model=model, seed=args.seed, page_size=args.page_size,
                         n_pages=args.pages, **quant_kw)
        engine.warmup(prompt_lens=(args.warmup,))
    else:
        engine = build_engine(args)
    torch.cuda.synchronize()
    out: dict = {"build_s": time.time() - t0,
                 "allocated_gib": torch.cuda.memory_allocated() / 2**30}
    log(f"[{tag}] engine built (random {model} weights, warmup) in "
        f"{out['build_s']:.1f} s; layer_fusion={engine.layer_fusion}; "
        f"memory allocated {out['allocated_gib']:.2f} GiB")
    if not engine.layer_fusion:
        raise AssertionError(f"the {model} engine must run the fused decode layers")
    if quant_kw.get("quantize"):
        # every QUANT_KEYS matrix of the packed tree: wqkv, wo, w_gateup and
        # w_down of each layer, and the untied lm_head
        want = 4 * engine.cfg.n_layers + (not engine.cfg.tie_embeddings)
        out["quantize_launches"] = quant.quantize_int8.launches
        log(f"[{tag}] B12 quantize_int8 launches at build {quant.quantize_int8.launches} "
            f"(matrices {want}); KV pools {engine.k_pages.dtype}, scales "
            f"{None if engine.k_scales is None else engine.k_scales.dtype}")
        assert quant.quantize_int8.launches == want, (quant.quantize_int8.launches, want)

    counters = _counters(model)
    try:
        with _serve_http(engine) as base:
            # counters are zeroed right before the main path runs
            _zero(counters)
            st0 = dict(engine.stats)

            def chat(content, **kw):
                payload = {"messages": [{"role": "user", "content": content}], **kw}
                return _post(f"{base}/chat/completions", payload)

            # (a) time to first token: single one-token requests, nothing else
            # running (client-side request latency: HTTP + prefill + first sample)
            ttfts = []
            for i in range(5):
                code, body, dt = chat(f"Time to first token, please ({i}).", max_tokens=1)
                assert code == 200 and body["usage"]["completion_tokens"] == 1, body
                ttfts.append(dt)
            out["ttft_s"] = sorted(ttfts)[2]
            out["ttft_max_s"] = max(ttfts)

            # (b) four concurrent chat completions, default sampler
            results = [None] * 4

            def worker(i):
                results[i] = chat(f"Request {i}: name three rivers of Europe.",
                                  max_tokens=48)

            ths = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            for r in results:
                assert r is not None and r[0] == 200, r
                u = r[1]["usage"]
                assert 1 <= u["completion_tokens"] <= 48 and u["prompt_tokens"] > 0, u
            log(f"[{tag}] 4 concurrent chat: completion tokens "
                f"{[r[1]['usage']['completion_tokens'] for r in results]}")

            # (c) one greedy request twice: identical text (prompt under one
            # page, so both runs take the same path)
            greedy = dict(max_tokens=24, temperature=0.0, repetition_penalty=1.0)
            r1 = chat("Greedy: count to five.", **greedy)
            r2 = chat("Greedy: count to five.", **greedy)
            assert r1[0] == 200 and r2[0] == 200
            t1 = r1[1]["choices"][0]["message"]["content"]
            t2 = r2[1]["choices"][0]["message"]["content"]
            assert t1 == t2, (t1, t2)
            assert r1[1]["usage"]["completion_tokens"] == r2[1]["usage"]["completion_tokens"]

            # (d) min_tokens budget forcing
            r = chat("Budget: think for a while.", max_tokens=40, min_tokens=32)
            assert r[0] == 200 and r[1]["usage"]["completion_tokens"] >= 32, r[1]["usage"]

            # (e) multi-turn follow-up must reuse the cached conversation prefix
            msgs = [{"role": "system", "content": "You are a careful search assistant. " * 8},
                    {"role": "user", "content": "Which river flows through Vienna?"}]
            r = _post(f"{base}/chat/completions", {"messages": msgs, "max_tokens": 16})
            assert r[0] == 200
            msgs += [{"role": "assistant", "content": "The Danube."},
                     {"role": "user", "content": "And through Budapest?"}]
            r = _post(f"{base}/chat/completions", {"messages": msgs, "max_tokens": 16})
            cached = r[1]["usage"]["prompt_tokens_details"]["cached_tokens"]
            assert r[0] == 200 and cached > 0, r[1]["usage"]
            log(f"[{tag}] multi-turn follow-up: prompt_tokens "
                f"{r[1]['usage']['prompt_tokens']} cached_tokens {cached}")

            # (f) /v1/completions
            r = _post(f"{base}/completions", {"prompt": "The capital of France is",
                                              "max_tokens": 16})
            assert r[0] == 200 and r[1]["usage"]["completion_tokens"] >= 1, r[1]
            assert isinstance(r[1]["choices"][0]["text"], str)

            # (g) a long prompt (~3000 tokens): prefill attention in query blocks
            r = chat(LONG_TEXT, max_tokens=8)
            u = r[1]["usage"]
            assert r[0] == 200 and u["prompt_tokens"] > 2900 and u["completion_tokens"] >= 1, u
            out["long_prompt_tokens"], out["long_prompt_s"] = u["prompt_tokens"], r[2]
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            log(f"[{tag}] long prompt: {u['prompt_tokens']} prompt tokens answered "
                f"in {r[2] * 1000:.1f} ms; peak memory allocated {out['peak_gib']:.2f} GiB")

            # (h) a full batch: max_slots concurrent requests for decode tok/s
            d0 = dict(engine.stats)
            tb = time.perf_counter()
            results = _burst(chat, SLOTS, 64)
            wall = time.perf_counter() - tb
            d1 = dict(engine.stats)
            out["burst_decode_tok_s"] = ((d1["decode_tokens"] - d0["decode_tokens"])
                                         / (d1["decode_time_s"] - d0["decode_time_s"]))
            out["burst_step_ms"] = 1e3 * (d1["decode_time_s"] - d0["decode_time_s"]) / (
                (d1["decode_steps"] - d0["decode_steps"]) * engine.decode_chunk_len)
            out["burst_wall_s"] = wall
            out["burst_tokens"] = sum(r[1]["usage"]["completion_tokens"] for r in results)
            if profile:
                _profile_burst(chat, engine)

            st1 = dict(engine.stats)
            out["launches"] = _check_launches(tag, engine, counters, st0, st1)
            out["decode_tok_s"] = ((st1["decode_tokens"] - st0["decode_tokens"])
                                   / (st1["decode_time_s"] - st0["decode_time_s"]))
            log(f"[{tag}] {card} | TTFT median of 5 {out['ttft_s'] * 1000:.1f} ms "
                f"(max {out['ttft_max_s'] * 1000:.1f}) | decode "
                f"{out['decode_tok_s']:.1f} tok/s over the whole phase | full batch "
                f"of {SLOTS}: {out['burst_decode_tok_s']:.1f} tok/s decode "
                f"({out['burst_step_ms']:.2f} ms per decode step), "
                f"{out['burst_tokens']} tokens in {out['burst_wall_s']:.2f} s")
    finally:
        engine.shutdown()
    return out, engine


class _RouteReplay:
    """MLA's expert choices on the serving path, replayed in its reference.

    Group-limited top-k routing is discontinuous: where two experts' (or two
    groups') scores lie within the rounding noise of the two paths — a
    near-tie, common on random weights — the paths pick other experts, and
    the logits part by far more than the numerics under test. ``record()``
    keeps the expert ids of each ``route_v3`` call of the serving forwards;
    ``replay()`` routes the reference's rows to the same experts, with
    weights from the reference's own scores, and counts the rows whose own
    choice would have differed."""

    def __init__(self, cfg):
        from deepsearch_tts_tpu_torch.models import deepseek_v3

        self.mod, self.route = deepseek_v3, deepseek_v3.route_v3
        self.n_moe = cfg.n_layers - cfg.first_k_dense
        self.calls: list = []
        self.differ = self.rows = 0

    @contextlib.contextmanager
    def _patched(self, fn):
        self.mod.route_v3 = fn
        try:
            yield
        finally:
            self.mod.route_v3 = self.route

    def record(self):
        def route(x, router_w, bias, cfg):
            w, ids = self.route(x, router_w, bias, cfg)
            self.calls.append(ids)
            return w, ids

        return self._patched(route)

    def replay(self):
        """The reference runs one ``route_v3`` call per MoE layer over all
        positions; layer j's rows are the serving calls of layer j, in
        order (the prefill's rows, then one row a decode step)."""
        import torch

        from deepsearch_tts_tpu_torch.models.common import matmul_f32

        layers = iter(range(self.n_moe))

        def route(x, router_w, bias, cfg):
            ids = torch.cat(self.calls[next(layers)::self.n_moe])
            _, own = self.route(x, router_w, bias, cfg)
            self.differ += int((own.sort(-1).values != ids.sort(-1).values).any(-1).sum())
            self.rows += ids.shape[0]
            w = torch.gather(torch.sigmoid(matmul_f32(x, router_w)), 1, ids)
            return w / w.sum(-1, keepdim=True).clamp(min=1e-9) * cfg.routed_scaling_factor, ids

        return self._patched(route)


def _hold_to_reference(tag: str, label: str, got, want, free=None) -> None:
    """Serving logits ``got`` against the reference's ``want`` (one row a
    position): min cosine > 0.99 and argmax agreement >= 0.75. ``free``:
    the same reference without the routing replay, logged beside it."""
    import torch

    assert got.shape == want.shape and torch.isfinite(got).all(), (got.shape, want.shape)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    msg = (f"[{tag}] {label} logits vs no-cache forward: max_abs_err "
           f"{(got - want).abs().max().item():.4f}, min cosine {cos.min().item():.5f} "
           f"(bound > 0.99), argmax agreement {agree:.2f} (bound >= 0.75)")
    if free is not None:
        cf = torch.nn.functional.cosine_similarity(got, free, dim=-1)
        msg += (f" | routed on its own (not held): min cosine {cf.min().item():.5f}, "
                f"argmax agreement {(got.argmax(-1) == free.argmax(-1)).float().mean().item():.2f}")
    log(msg)
    assert cos.min().item() > 0.99, cos
    assert agree >= 0.75, agree


def phase_reference(engine, tag: str = "reference", t0: int = 16, **plain_kw) -> None:
    """Paged prefill of ``t0`` tokens + 8 fused decode steps (the serving
    branches) vs the plain no-cache forward, on the served weights, into
    pools like the engine's (int8 with scales under int8 KV). ``plain_kw``
    keeps the reference off the kernels the no-cache forward would
    otherwise run (the MoE family's grouped expert kernel, the int8
    product)."""
    import torch

    from deepsearch_tts_tpu_torch.engine.kvcache import init_kv_pages, init_kv_scales

    cfg, dev = engine.cfg, engine.device
    T0, T = t0, t0 + 8
    assert T <= 64, T                           # one 64-token page
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None]
    replay = _RouteReplay(cfg) if getattr(cfg, "latent_cache", False) else None
    with torch.no_grad():
        kp, vp = init_kv_pages(cfg.n_layers, 2, 64, cfg.n_kv_heads, cfg.head_dim,
                               dtype=engine.k_pages.dtype, device=dev)
        table = torch.tensor([[1]], device=dev)
        kw = dict(k_pages=kp, v_pages=vp, page_table=table)
        if engine.k_scales is not None:
            kw["k_scales"], kw["v_scales"] = init_kv_scales(cfg.n_layers, 2, 64,
                                                            cfg.n_kv_heads, device=dev)
        with replay.record() if replay else contextlib.nullcontext():
            got = [engine.forward(engine.params, cfg, toks[:, :T0], pos[:, :T0],
                                  seq_lens=torch.tensor([T0], device=dev),
                                  logits_indices=torch.tensor([T0 - 1], device=dev),
                                  **kw)[0][:, 0]]
            for t in range(T0, T):
                got.append(engine.forward(
                    engine.params, cfg, toks[:, t:t + 1], pos[:, t:t + 1],
                    seq_lens=torch.tensor([t + 1], device=dev), fused_decode=True,
                    **kw)[0][:, 0])
        free, _ = engine.forward(engine.params, cfg, toks, pos, **plain_kw)
        ref = free
        if replay:
            with replay.replay():
                ref, _ = engine.forward(engine.params, cfg, toks, pos, **plain_kw)
            log(f"[{tag}] routing: the reference's own expert set differs from the "
                f"serving path's on {replay.differ} of {replay.rows} (position, MoE layer) "
                f"rows; it routes all rows as the serving path did")
    got = torch.cat(got)                        # positions T0-1 .. T-1
    assert got.shape == (T - T0 + 1, cfg.vocab_size), got.shape
    # bf16 through 5-64 layers: the two paths round q/k/v at different
    # points (the fused kernels keep q/k in float32 until after norm and
    # rope); under int8 KV the serving path also attends over int8 keys and
    # values (one scale per token and head) where the reference keeps bf16
    _hold_to_reference(tag, "serving-path", got, ref[0, T0 - 1:],
                       free[0, T0 - 1:] if replay else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="add a full-batch burst under torch.profiler to the "
                         "qwen3-8b serve, slot serve and speculative serve "
                         "phases and the qwen3-30b-a3b serve phase (device "
                         "time by kernel, idle share)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build and the kernel checks (prints "
                         "the kernel results, not the final line)")
    opts = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "deepsearch_tts_tpu_torch")):
        raise SystemExit("chip_smoke: deepsearch_tts_tpu_torch/ not found next to "
                         "this script — run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    card = phase_env()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = phase_kernels(gen)
    res.update(phase_attention_kernels(gen))
    k1_b1 = res.pop("slot_attention_b1")
    k1_b64 = res.pop("slot_attention_b64")
    b11_res, b11_launches = phase_one_layer_kernels(gen)
    res.update(b11_res)
    moe_res = phase_moe_kernels(gen)
    g8 = moe_res.pop("g8")
    res.update(moe_res)
    res.update(phase_int8_kernels(gen))
    b12_shapes = res.pop("b12_shapes")
    mla_res, mla_kernels = phase_mla_kernels(gen)
    res.update(mla_res)
    _free()
    if opts.kernels_only:
        print(json.dumps({"kernels": res, "g8": g8, "mla_kernels": mla_kernels,
                          "k1_b1": k1_b1, "k1_b64": k1_b64, "b11_launches": b11_launches,
                          "b12_shapes": b12_shapes, "card": card}))
        return 0
    serve, engine = phase_serve(card, profile=opts.profile)
    phase_reference(engine)
    params = _release(engine)
    slot = phase_slot_serve(card, params, profile=opts.profile, b1_tokens=128)
    spec = phase_slot_serve(card, params, tag="spec", spec=True, b1_tokens=128,
                            b1_plain_ms=slot["b1_ms_per_token"], profile=opts.profile)
    phase_spec_reference(params)
    pallas = phase_pallas_serve(card, params, serve["long_prompt_s"])
    phase_attention_reference(params)

    # the qwen3-30b-a3b phases need the card to themselves: 61 GB of weights
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[release] qwen3-8b engines and weights released: {held:.3f} GiB still allocated")
    assert held < 1.0, held
    moe_serve, engine = phase_serve(card, model=MOE_MODEL, profile=opts.profile, tag="moe")
    phase_reference(engine, plain_experts=True)
    params = _release(engine)
    del engine
    moe_slot = phase_slot_serve(card, params, model=MOE_MODEL, tag="moe-slot")
    moe_spec = phase_moe_spec(card, params)
    phase_spec_reference(params, MOE_MODEL, tag="moe-spec-reference", plain_experts=True)

    # the qwen3-32b int8 phase needs the card to itself too
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[release] qwen3-30b-a3b engines and weights released: {held:.3f} GiB still "
        f"allocated")
    assert held < 1.0, held
    i8_serve, engine = phase_serve(card, model=I8_MODEL, profile=opts.profile, tag="int8",
                                   quantize="int8", kv_quantize="int8")
    # a 48-row prefill: int8_matmul's kernel at its MT=4 instance
    phase_reference(engine, tag="int8-reference", t0=48, plain_int8=True)
    _release(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[release] qwen3-32b int8 engine and weights released: {held:.3f} GiB still "
        f"allocated")
    assert held < 1.0, held

    # MLA: deepseek-v3's published widths, 5 of its 61 layers, registered
    # here under a name of its own (the package's registry gains none)
    from deepsearch_tts_tpu_torch.engine.weights import convert_deepseek_v3
    from deepsearch_tts_tpu_torch.models import deepseek_v3, registry

    mla_cfg = dataclasses.replace(deepseek_v3.DEEPSEEK_V3_CONFIGS["deepseek-v3"],
                                  n_layers=MLA_LAYERS)
    registry.register(MLA_MODEL, mla_cfg, deepseek_v3.forward, convert_deepseek_v3)
    mla_serve, engine = phase_serve(card, model=MLA_MODEL, profile=opts.profile, tag="mla")
    phase_reference(engine, tag="mla-reference", plain_experts=True)
    params = _release(engine)
    del engine
    mla_slot = phase_slot_serve(card, params, model=MLA_MODEL, tag="mla-slot")
    mla_pallas = phase_mla_pallas(card, params)
    phase_attention_reference(params, MLA_MODEL, tag="mla-attention-reference",
                              plain_experts=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[release] MLA engines and weights released: {held:.3f} GiB still allocated")
    assert held < 1.0, held

    b11_path = {"launches": b11_launches}   # B11's own path (no serving path runs it)
    src = "deepsearch_tts_tpu_torch/ops/"
    jsrc = "deepsearch_tts_tpu/ops/"
    attn = src + "csrc/attention.cu"
    fused = src + "csrc/fused_layer.cu"
    ragged = jsrc + "moe.py:81 _expert_ffn_ragged (lax.ragged_dot)"
    # name: (route, source, TPU kernel it replaces, the run whose launches count)
    meta = {
        "fused_qkv_stacked": ("cuda", fused, jsrc + "fused_layer.py:244", serve),
        "fused_out_mlp_stacked": ("cuda", fused, jsrc + "fused_layer.py:356", serve),
        "fused_out_router_stacked": ("cuda", fused, jsrc + "fused_layer.py:818",
                                     moe_serve),
        "grouped_gateup": ("cuda", fused, ragged, moe_serve),
        "grouped_down": ("cuda", fused, ragged, moe_serve),
        "grouped_gateup_prefill": ("cuda", fused, ragged, moe_serve),
        "grouped_down_prefill": ("cuda", fused, ragged, moe_serve),
        "sampling_prep": ("triton", src + "sampling_prep.py",
                          jsrc + "sampling_prep.py:30", serve),
        "slot_attention": ("cuda", attn, jsrc + "slot_attention.py:110", slot),
        "slot_window_attention": ("cuda", attn, jsrc + "slot_attention.py:123 _slot_window_body",
                                  spec),
        "pallas_paged_attention": ("cuda", attn, jsrc + "paged_attention.py:49", pallas),
        "pallas_paged_decode": ("cuda", attn, jsrc + "paged_attention.py:117", pallas),
        "pallas_paged_decode_clamp": ("cuda", attn, jsrc + "paged_attention.py:239",
                                      pallas),
        "flash_attention": ("cuda", attn, jsrc + "flash_attention.py:27", pallas),
        "fused_qkv_stacked_i8": ("cuda", fused, jsrc + "fused_layer.py:568", i8_serve),
        "fused_out_mlp_stacked_i8": ("cuda", fused, jsrc + "fused_layer.py:669", i8_serve),
        "int8_product": ("cuda", fused, jsrc + "quant.py:68 int8_matmul (XLA dot_general)",
                         i8_serve),
        "quantize_int8": ("cuda", src + "csrc/quant.cu", jsrc + "quant.py:24", i8_serve),
        "fused_mlp_stacked": ("cuda", fused, jsrc + "fused_layer.py:468", mla_serve),
        "fused_mlp": ("cuda", fused, jsrc + "fused_layer.py:112", b11_path),
        "fused_qkv": ("cuda", fused, jsrc + "fused_layer.py:150", b11_path),
        "fused_out_mlp": ("cuda", fused, jsrc + "fused_layer.py:975", b11_path),
        "slot_attention_latent": ("cuda", attn, jsrc + "slot_attention.py:116 "
                                  "_slot_attn_kernel_shared (D = 576)", mla_slot),
        "paged_attention_latent": ("cuda", attn, jsrc + "paged_attention.py:49 _paged_kernel "
                                   "(v = k, D = 576)", mla_pallas),
    }
    i8_serve["launches"]["quantize_int8"] = i8_serve["quantize_launches"]
    for n in ("grouped_gateup", "grouped_down"):   # the decode kernel's: all but the prefill's
        moe_serve["launches"][n] -= moe_serve["launches"][n + "_prefill"]
    kernels = [{"name": n, "route": r, "source": s, "replaces": rep,
                "launches": run["launches"][n],
                "max_abs_err": res[n]["err"], "ms": res[n]["ms"],
                "plain_ms": res[n]["plain_ms"], "bound_ms": res[n]["bound_ms"],
                "bound_by": res[n]["bound_by"], "library_ms": res[n]["library_ms"]}
               for n, (r, s, rep, run) in meta.items()]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    assert not idle, f"kernels no run of their path launched: {idle}"
    runs = {"serve": serve, "slot_serve": slot, "spec_serve": spec, "pallas_serve": pallas,
            "moe_serve": moe_serve, "moe_slot": moe_slot, "moe_spec": moe_spec,
            "int8_serve": i8_serve, "mla_serve": mla_serve, "mla_slot": mla_slot,
            "mla_pallas": mla_pallas}
    log(card)   # the card's name and power limit again, beside the result lines
    print(json.dumps({**{name: {k: v for k, v in run.items() if k != "launches"}
                         for name, run in runs.items()},
                      "g8": g8, "mla_kernels": mla_kernels, "k1_b1": k1_b1, "k1_b64": k1_b64,
                      "b12_shapes": b12_shapes, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
