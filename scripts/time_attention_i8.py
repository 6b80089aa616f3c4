#!/usr/bin/env python3
"""K2's int8 mode (the int8-KV engine's prefill attention in
``ops/csrc/attention.cu``: ``widen_kv_pages``, then the bf16 paged mode
over the widened pages) beside a parent commit's, in one process on one
card, and where its time goes.

    python3 scripts/time_attention_i8.py --prepare REV   (in a git checkout:
                                                         REV's sources into
                                                         build/attn_parent/)
    python3 scripts/time_attention_i8.py [--copy DIR]   (needs one CUDA card
                                                         and nvcc)

``--prepare`` writes ``attention.cu`` and ``hopper.cuh`` of commit REV into
``build/attn_parent/`` (``scripts/kernel_copies.py``); the run builds them
there with the port's nvcc flags, so it also runs in a copy without
``.git``. The parent's kernels run through the tree's wrappers over the
parent's library, so the parent needs the tree's C entries (``ENTRIES``).
``--copy DIR`` (repeatable) does the same for another copy of the sources
(``DIR/attention.cu`` with ``DIR/hopper.cuh``), a variant to compare.

Shapes (qwen3-32b's 64 / 8 heads, D = 128; random pages from seed 0
quantized as the engine writes them): ``chip_smoke.I8_PREFILLS`` (the
3044-token prompt over 48 pages of 64, the ragged 16 x 64 group with a
padding row and tail padding, 100 tokens after 3000 cached) and
``chip_smoke.I8_BUCKET`` (the long prompt padded to the engine's 4096
bucket over its 64 pages). At each: the tree's mode
(``flash_attention_paged(k_scales=, v_scales=)``), the parent's and the
copies' are held to the plain version under the smoke's rms-scaled bound,
then timed as CUDA-graph replays between CUDA events in the order parent,
tree, copies, copies reversed, tree, parent; beside them the bound
(operations: 4·H·D a visible pair of a real query; bytes: each row's int8
keys, values and scales up to its largest limit once, q, out, the table
and positions), SDPA over the pre-dequantized context (masked, and causal
where B = 1; the dequantization not timed), the bf16 paged mode over the
same pages unquantized, and the tree's widening launch alone.

A stamped copy of the tree's sources (``STAMP_EDITS``: lines of the
kernels replaced; a change there stops the script with the text it did
not find) runs each shape once more, replayed from a captured graph
(``%globaltimer`` for kernel and item events, ``clock64`` by consumer
thread 0 for each key tile, turned into time at the clock each block's
items show): the widening kernel's first start and last end, the plan
kernel's phases, per item of the persistent grid its start, first K tile
ready, last value product and stores, per tile the consumers' turn wait,
the products' issue (waits for the tiles included), the QK wait, the
softmax and the PV wait, and the merge's first start and last end. From
them, in microseconds from the first kernel's start: each phase's span,
the SMs' busy share over the attention kernel's span, items and tiles a
block, and each per-tile step's mean. Prints the card's name and power
limit first and one JSON line last. B2 and the bf16 paged mode alone:
``scripts/time_k2_paged.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import kernel_copies as kc  # noqa: E402

ROOT = kc.ROOT
PARENT = os.path.join(ROOT, "build", "attn_parent")
OUT = os.path.join(ROOT, "build", "attn_time")
TOOL = "time_attention_i8"
# the C entries the int8 mode's wrappers call, which the parent and the copies must have
ENTRIES = ("dstts_widen_kv_pages", "dstts_flash_attention_paged", "dstts_flash_paged_plan",
           "dstts_flash_paged_merge")

NBLK, MAXIT, MAXT = 160, 96, 512    # blocks, items a block, key tiles a block
TILE_STEPS = ("turn", "issue", "QK wait", "softmax", "PV wait")
DEFS = (
    "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
    "__device__ __forceinline__ long long ctick() {\n  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t));\n  return t;\n}\n"
    f"__device__ unsigned long long g_k[4];   // first / last of the widening, of the merge\n"
    f"__device__ long long g_plan[5];\n"
    f"__device__ long long g_item[6][{NBLK}][{MAXIT}];   // start, K ready, last PV, stores "
    "(globaltimer); start, stores (clock64)\n"
    f"__device__ long long g_tile[6][{NBLK}][{MAXT}];   // clock64 a ring tile\n")
READER = (
    "int trace_read(long long* k, long long* plan, long long* item, long long* tile) {\n"
    "  int e = (int)cudaMemcpyFromSymbol(k, g_k, sizeof(g_k));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(plan, g_plan, sizeof(g_plan));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(item, g_item, sizeof(g_item));\n"
    "  return e ? e : (int)cudaMemcpyFromSymbol(tile, g_tile, sizeof(g_tile));\n}\n"
    "int trace_clear() {\n"
    "  static unsigned long long k[4] = {~0ull, 0ull, ~0ull, 0ull};\n"
    "  static long long z[6 * %d * %d];\n" % (NBLK, MAXT) +
    "  int e = (int)cudaMemcpyToSymbol(g_k, k, sizeof(k));\n"
    "  if (!e) e = (int)cudaMemcpyToSymbol(g_plan, z, sizeof(g_plan));\n"
    "  if (!e) e = (int)cudaMemcpyToSymbol(g_item, z, sizeof(g_item));\n"
    "  return e ? e : (int)cudaMemcpyToSymbol(g_tile, z, sizeof(g_tile));\n}\n")
K1_MARK = "// ------------------------------------------------------------------- K1\n"
ON = f"threadIdx.x == 0 && blockIdx.x < {NBLK}"


def _item(k: int, clk: int | None = None) -> str:
    s = f"if ({ON} && it < {MAXIT}) {{ g_item[{k}][blockIdx.x][it] = gtime();"
    if clk is not None:
        s += f" g_item[{clk}][blockIdx.x][it] = ctick();"
    return s + " }\n"


def _tile(k: int, g: str) -> str:
    return f"        if ({ON} && ({g}) < {MAXT}) g_tile[{k}][blockIdx.x][{g}] = ctick();\n"


def _plan(k: int) -> str:
    return f"  if (threadIdx.x == 0) g_plan[{k}] = gtime();\n"


_ZEROED = "  for (int i = tid; i < nb; i += PLAN_TH) hist[i] = 0;\n  __syncthreads();\n"
_LIMITS = ("    if (u >= 0 && lane == __ffs(peers) - 1) atomicMax(&ulim[u], lm);\n  }\n"
           "  __syncthreads();\n")
_STORES = ("                  odd ? make_uint2(got, wo) : make_uint2(we, got);\n          }\n"
           "        }\n      }\n")
_MERGE_TOP = "  grid_dep_wait();   // the attention kernel's partials\n"
_MERGE_END = ("                                4 * lane) = pair;\n    }\n  }\n}\n")
# the plan's phases, the merge's first start and last end, the readers
COMMON_EDITS = [
    (K1_MARK, DEFS + K1_MARK),
    ("  const int tid = threadIdx.x, lane = tid & 31;\n",
     "  const int tid = threadIdx.x, lane = tid & 31;\n" + _plan(0)),
    (_ZEROED, _ZEROED + _plan(1)),
    (_LIMITS, _LIMITS + _plan(2)),
    ("  __syncthreads();\n  // a warp a unit: its z * KV items",
     "  __syncthreads();\n" + _plan(3) + "  // a warp a unit: its z * KV items"),
    ("                                 z > 1 ? (sb + zi) * KV + kh : -1);\n    }\n  }\n",
     "                                 z > 1 ? (sb + zi) * KV + kh : -1);\n    }\n  }\n"
     "  __syncthreads();\n" + _plan(4)),
    (_MERGE_TOP, _MERGE_TOP + "  if (threadIdx.x == 0) atomicMin(&g_k[2], (unsigned long long)"
     "gtime());\n"),
    (_MERGE_END, "                                4 * lane) = pair;\n    }\n  }\n"
     "  if (threadIdx.x == 0) atomicMax(&g_k[3], (unsigned long long)gtime());\n}\n"),
    ('}  // extern "C"', READER + '}  // extern "C"'),
]


# the bf16 kernel: each anchor searched past its signature
_BF16 = "flash_attention(const __grid_constant__ CUtensorMap tq"


def _consumer_edits() -> list:
    """The item and tile stamps of the bf16 paged mode's consumer loop."""
    return [(old, new, _BF16) for old, new in [
        ("      mbar_arrive(&meta_empty[it & 1]);\n",
         "      mbar_arrive(&meta_empty[it & 1]);\n      " + _item(0, 4)),
        ("      bar_sync(1 + wg, 256);\n      issue_qk(g0);\n",
         "      mbar_wait(&k_full[g0 % FSTAGES], (g0 / FSTAGES) & 1);\n      " + _item(1) +
         "      bar_sync(1 + wg, 256);\n      issue_qk(g0);\n"),
        ("      for (int kt = 0; kt + 1 < nt; ++kt) {\n        bar_sync(1 + wg, 256);\n",
         "      for (int kt = 0; kt + 1 < nt; ++kt) {\n" + _tile(0, "g0 + kt") +
         "        bar_sync(1 + wg, 256);\n" + _tile(1, "g0 + kt")),
        ("        bar_arrive(2 - wg, 256);\n        wgmma_wait<1>();\n        fence_regs(sc);\n",
         "        bar_arrive(2 - wg, 256);\n" + _tile(2, "g0 + kt") +
         "        wgmma_wait<1>();\n        fence_regs(sc);\n" + _tile(3, "g0 + kt")),
        ("        wgmma_wait<0>();\n        fence_regs(o);\n        fence_regs(pk);",
         _tile(4, "g0 + kt") + "        wgmma_wait<0>();\n        fence_regs(o);\n" +
         _tile(5, "g0 + kt") + "        fence_regs(pk);"),
        ("      mbar_arrive(&empty[gl % FSTAGES]);\n      g0 += nt;\n",
         "      mbar_arrive(&empty[gl % FSTAGES]);\n      " + _item(2) + "      g0 += nt;\n"),
        (_STORES, _STORES + "      " + _item(3, 5)),
    ]]


# the widening kernel's first start and last end, and all of the above
STAMP_EDITS = COMMON_EDITS + _consumer_edits() + [
    ("  const int bp = blockIdx.x, b = bp / P, p = bp - b * P;\n",
     "  const int bp = blockIdx.x, b = bp / P, p = bp - b * P;\n"
     "  if (threadIdx.x == 0) atomicMin(&g_k[0], (unsigned long long)gtime());\n"),
    ("  reinterpret_cast<uint4*>(vw)[dst + 1] = hi;\n}\n",
     "  reinterpret_cast<uint4*>(vw)[dst + 1] = hi;\n"
     "  if (threadIdx.x == 0) atomicMax(&g_k[1], (unsigned long long)gtime());\n}\n"),
]


def replay_once(lib, run) -> None:
    """``run`` captured in a CUDA graph (as the engine's prefill programs
    run it, and as the times are taken), the stamps cleared, one replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    torch.cuda.synchronize()
    assert lib.trace_clear() == 0
    graph.replay()
    torch.cuda.synchronize()
    graph.reset()


def timeline(lib, run) -> dict:
    """One stamped replay: where the mode's time goes (module docstring)."""
    import torch

    replay_once(lib, run)
    k = (ctypes.c_longlong * 4)()
    plan = (ctypes.c_longlong * 5)()
    item = (ctypes.c_longlong * (6 * NBLK * MAXIT))()
    tile = (ctypes.c_longlong * (6 * NBLK * MAXT))()
    assert lib.trace_read(k, plan, item, tile) == 0
    kk = np.array(k, dtype=np.int64).view(np.uint64).astype(np.float64)
    plan = np.array(plan, dtype=np.int64)
    it = np.array(item, dtype=np.int64).reshape(6, NBLK, MAXIT)
    tl = np.array(tile, dtype=np.int64).reshape(6, NBLK, MAXT)
    live = (it[0] > 0) & (it[3] > 0)
    if not live.any():
        return {}
    # clock64 ticks a ns, from the items long enough to read it well
    ns = (it[3] - it[0]).astype(float)
    cyc = (it[5] - it[4]).astype(float)
    good = live & (ns > 2000)
    ghz = float(np.median(cyc[good] / ns[good])) if good.any() else 1.755
    has_w = kk[0] < 2.0 ** 63
    t0 = min(x for x in (kk[0] if has_w else None, float(plan[0]) if plan[0] else None,
                         float(it[0][live].min())) if x is not None)
    us = lambda t: round((float(t) - t0) / 1e3, 2)   # noqa: E731
    a0, a1 = it[0][live].min(), it[3][live].max()
    span = (a1 - a0) / 1e3
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"clock_ghz": round(ghz, 3)}
    if has_w:
        res["widen_us"] = [us(kk[0]), us(kk[1])]
    if plan[0]:
        res["plan_us"] = [us(x) for x in plan]
    res["attention_us"] = [us(a0), us(a1)]
    if kk[2] < 2.0 ** 63:
        res["merge_us"] = [us(kk[2]), us(kk[3])]
    res["end_us"] = max(res.get("merge_us", [0, 0])[1], us(a1))
    blocks = live.any(1)
    res["busy_share"] = round(float(((it[3] - it[0])[live]).sum() / 1e3 / (n_sms * span)), 4)
    res["items"] = int(live.sum())
    res["items_a_block_max"] = int(live.sum(1).max())
    res["blocks"] = int(blocks.sum())
    res["item_start_to_first_k_us"] = round(float(((it[1] - it[0])[live]).mean() / 1e3), 3)
    res["item_last_pv_to_stores_us"] = round(float(((it[3] - it[2])[live]).mean() / 1e3), 3)
    nxt = live[:, 1:] & live[:, :-1]
    gap = (it[0][:, 1:] - it[3][:, :-1])[nxt]
    res["item_stores_to_next_start_us"] = round(float(gap.mean() / 1e3), 3) if gap.size else None
    has = (tl[0] > 0) & (tl[5] > 0)
    res["tiles_stamped"] = int(has.sum())
    if has.any():
        steps = {name: round(float(((tl[j + 1] - tl[j])[has]).mean() / ghz / 1e3), 4)
                 for j, name in enumerate(TILE_STEPS)}
        steps["tile"] = round(float(((tl[5] - tl[0])[has]).mean() / ghz / 1e3), 4)
        res["tile_steps_us"] = steps
    return res


def inputs(cs, gen, shape):
    """The shape's q, int8 pools and scales, table, seq_lens, positions and
    the bf16 pools they were quantized from."""
    from deepsearch_tts_tpu_torch.engine.kvcache import quantize_kv_rows

    label, B, T, starts, valid, ps, P = shape[:7]
    q, kb, vb, table, seq, pos = cs._paged_prefill_inputs(gen, B, T, starts, valid, ps, P,
                                                          (cs.Q_H, cs.Q_KV), False)
    (kp, ks), (vp, vs) = quantize_kv_rows(kb), quantize_kv_rows(vb)
    return q, kp, vp, ks, vs, table, seq, pos, kb, vb


def on(libs: dict, name: str, fn):
    """``fn`` with the wrappers launching library ``name``'s kernels."""
    from deepsearch_tts_tpu_torch.ops import _build

    def run():
        _build._libs["attention"] = libs[name]
        try:
            return fn()
        finally:
            _build._libs["attention"] = libs["tree"]
    return run


def k2_int8(cs, libs, gen, copies, result) -> None:
    import torch
    from torch.nn.attention.bias import causal_lower_right

    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops.attention import dequant_context

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in [s[:7] for s in (*cs.I8_PREFILLS, cs.I8_BUCKET)]:
        label, B, T, starts, valid, ps, P = shape
        q, kp, vp, ks, vs, table, seq, pos, kb, vb = inputs(cs, gen, shape)
        h, kv, D, S = cs.Q_H, cs.Q_KV, cs.D, P * ps
        sc = dict(k_scales=ks, v_scales=vs)
        lim = fa.paged_key_limits(seq, pos, S, h // kv)
        ref = fa.flash_attention_paged_plain(q, kp, vp, table, seq, pos, **sc)
        tree = lambda: fa.flash_attention_paged(q, kp, vp, table, seq, pos, **sc)  # noqa: E731
        runs = {"parent": on(libs, "parent", tree), "tree": tree,
                **{n: on(libs, n, tree) for n in copies}}
        row = {"bound_use": {n: round(cs._bound_use(f(), ref, cs.ATTN_RTOL, cs.ATTN_ATOL,
                                                    cs.ATTN_RMS_FRAC), 3)
                             for n, f in runs.items()}}
        assert max(row["bound_use"].values()) <= 1.0, (label, row)
        nbytes = (int(lim.amax(1).sum()) * kv * (D + 4) * 2 + 2 * B * T * h * D * 2
                  + B * (T + P + 1) * 8)
        row.update(cs.bound(nbytes, 4 * h * D * int(lim[pos >= 0].sum())))
        ms = {n: [] for n in runs}
        for n in ("parent", "tree", *copies, *copies[::-1], "tree", "parent"):
            ms[n].append(cs.time_ms(runs[n], iters=20)[0])
        row["ms"] = {n: [round(x, 4) for x in v] for n, v in ms.items()}
        row.update({f"{n}_ms": round(float(np.mean(v)), 4) for n, v in ms.items()})
        row["widen_ms"] = round(cs.time_ms(
            lambda: fa.widen_kv_pages(kp, vp, ks, vs, table, seq), iters=20)[0], 4)
        row["bf16_paged_ms"] = round(cs.time_ms(
            lambda: fa.flash_attention_paged(q, kb, vb, table, seq, pos), iters=20)[0], 4)
        kt, vt = (dequant_context(p_, s_, table, torch.bfloat16).transpose(1, 2)
                  for p_, s_ in ((kp, ks), (vp, vs)))
        qt = q.transpose(1, 2)
        mask = (torch.arange(S, device=q.device)[None, None] < lim[:, :, None])[:, None]
        row["sdpa_masked_ms"] = round(cs.time_ms(
            lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=20)[0], 4)
        if B == 1:
            s0, n = starts[0], valid[0]
            qn = qt[:, :, :n].contiguous()
            if s0 == 0:
                causal = lambda: sdpa(qn, kt[:, :, :n], vt[:, :, :n], is_causal=True,  # noqa: E731
                                      enable_gqa=True)
            else:
                kr, vr = (t[:, :, :s0 + n].repeat_interleave(h // kv, 1) for t in (kt, vt))
                bias = causal_lower_right(n, s0 + n)
                causal = lambda: sdpa(qn, kr, vr, attn_mask=bias)  # noqa: E731
            row["sdpa_causal_ms"] = round(cs.time_ms(causal, iters=20)[0], 4)
        row["timeline"] = timeline(libs["stamped"], on(libs, "stamped", tree))
        result["k2_int8"][label] = row
        print(f"[k2-i8] {label}: {json.dumps(row)}", flush=True)
        del q, kp, vp, kb, vb, ref, kt, vt, qt, mask


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prepare", metavar="REV",
                    help="write REV's attention.cu and hopper.cuh into build/attn_parent/ "
                         "(git show) and stop")
    ap.add_argument("--copy", action="append", default=[], metavar="DIR",
                    help="also time DIR/attention.cu (with DIR/hopper.cuh; the tree's C "
                         "entries) through the tree's wrappers, in the same turns")
    opts = ap.parse_args()
    if opts.prepare:
        kc.prepare(opts.prepare, PARENT, TOOL)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{TOOL}: needs a CUDA card")
    rev = kc.parent_rev(PARENT, TOOL)
    import chip_smoke as cs
    from deepsearch_tts_tpu_torch.ops import _build
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    card = cs.phase_env()
    jobs = {"parent": (PARENT, OUT, "parent", None, TOOL),
            "stamped": (kc.CSRC, OUT, "stamped", STAMP_EDITS, TOOL)}
    for d in opts.copy:
        jobs[d] = (d, OUT, os.path.basename(os.path.normpath(d)), None, TOOL)
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        tree_f = ex.submit(_build.load_library, "attention")
        built = {k: ex.submit(kc.build, *v) for k, v in jobs.items()}
        tree_f.result()
        built = {k: f.result() for k, f in built.items()}
    tree = pa._lib()
    for line in _build.build_log.get("attention", "").splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print(f"[build] tree: {line.strip()}", flush=True)
    for k in ("parent", *opts.copy):
        for ln in built[k][1]:
            print(f"[build] {k}: {ln}", flush=True)
    libs = {"tree": tree, **{k: kc.typed_as(v[0], tree, ENTRIES) for k, v in built.items()}}
    libs["stamped"].trace_read.argtypes = [ctypes.c_void_p] * 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    result: dict = {"card": card, "parent": rev, "k2_int8": {}}
    k2_int8(cs, libs, gen, opts.copy, result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
