#!/usr/bin/env python3
"""K1's int8 mode (the int8-KV engine's decode attention, ``decode_i8`` in
``ops/csrc/attention.cu``) beside a parent commit's int8 mode and bf16 K1,
in one process on one card, and where each block's time goes.

    python3 scripts/time_k1_i8.py --prepare REV   (in a git checkout: REV's
                                                  attention.cu and
                                                  hopper.cuh into
                                                  build/k1_parent/)
    python3 scripts/time_k1_i8.py [--parent-only] [--no-trace]
                                  [--variant NAME]   (needs one CUDA card
                                                     and nvcc)

``--prepare`` writes ``attention.cu`` and ``hopper.cuh`` of commit REV
into ``build/k1_parent/`` (``scripts/kernel_copies.py``); the run builds
them there with the port's nvcc flags, so it also runs in a copy without
``.git``. The parent must have the tree's C entries of K1's int8 mode
(``dstts_decode_i8``, ``dstts_decode_i8_plan``: since ``decode_i8``); its
mode runs through the tree's wrappers over the parent's library.

Shapes (qwen3-32b's 64 / 8 heads, D = 128, int8 pages and their float32
scales made as ``chip_smoke._int8_pools`` makes them): B = 16 over the
B6 rows' ragged lengths (``chip_smoke.SEQS``, 19,613 keys, pages of 64),
K1's own rows (``LIMITS``, two with no key), B = 1 over one 4096-key row,
B = 16 rows of 4096 keys and B = 16 rows of 100 keys (a serving burst's
short rows). At each, every kernel is held to the plain
version (``paged_int8_plain``) under the smoke's rms-scaled bound, then
timed as CUDA-graph replays between CUDA events in the order parent,
tree, tree, parent, with bf16 K1 (``pallas_paged_attention`` over bf16
pages of the same rows) after each; beside them the bound (bytes: each
row's int8 keys, values and scales once, q, out, the table) and SDPA over
the pre-dequantized context. ``--variant NAME`` also builds a copy of the
tree with one choice changed (``VARIANTS``) and times it in the same
turns (parent, tree, copy, copy, tree, parent).

Unless ``--no-trace``, stamped copies of the tree and of the parent
(``TREE_EDITS``, applied to both: a parent whose kernel text differs stops
the script with the text it did not find) run each shape once more,
replayed from a captured graph: the plan kernel's start and end; per
persistent block, its start and, per item, the producer's item fetch, the
consumers' item start (meta and q landed), their first tile ready, their
last product and their stores; per tile (consumer warp 0) the stage wait
and the tile's work. From them, in microseconds: the span, the busy share
of the block slots, the per-item and per-tile means, the last block's
items. Prints the card's name and power limit first and one JSON line
last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import kernel_copies as kc  # noqa: E402

ROOT, CSRC = kc.ROOT, kc.CSRC
PARENT = os.path.join(ROOT, "build", "k1_parent")
OUT = os.path.join(ROOT, "build", "k1_time")
TOOL = "time_k1_i8"
NBLK = 1024        # blocks stamped
GTIME = (
    "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
    "__device__ __forceinline__ long long ctick() {\n  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t));\n  return t;\n}\n"
    "__device__ __forceinline__ int smid() {\n  int s;\n"
    "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s));\n  return s;\n}\n")
K1_MARK = "// ------------------------------------------------------------------- K1\n"
# the C entries of K1's wrappers, typed as the tree's on every other library
K1_ENTRIES = ("dstts_decode_attention", "dstts_decode_i8", "dstts_decode_i8_plan")

# ---- the tree: a persistent block, stamps a (block, item) and a (block, tile)
MAXIT, MAXG = 64, 256
T_DEFS = GTIME + (
    f"__device__ long long g_plan[5];\n__device__ long long g_blk[4][{NBLK}];\n"
    f"__device__ long long g_it[5][{NBLK}][{MAXIT}];\n__device__ int g_nt[{NBLK}][{MAXIT}];\n"
    f"__device__ int g_merged[{NBLK}][{MAXIT}];\n__device__ int g_sm[{NBLK}];\n"
    f"__device__ long long g_tl[2][{NBLK}][{MAXG}];\n")
T_ON = f"(blockIdx.x < {NBLK})"


def _it(k: int, who: str = "tid == 0") -> str:
    return f"      if ({who} && {T_ON} && it < {MAXIT}) g_it[{k}][blockIdx.x][it] = gtime();\n"


T_READER = (
    "int trace_read(long long* plan, long long* blk, long long* it, int* nt, int* merged, "
    "int* sm, long long* tl) {\n"
    "  int e = (int)cudaMemcpyFromSymbol(plan, g_plan, sizeof(g_plan));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(blk, g_blk, sizeof(g_blk));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(it, g_it, sizeof(g_it));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(nt, g_nt, sizeof(g_nt));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(merged, g_merged, sizeof(g_merged));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(sm, g_sm, sizeof(g_sm));\n"
    "  return e ? e : (int)cudaMemcpyFromSymbol(tl, g_tl, sizeof(g_tl));\n}\n"
    "int trace_clear() {\n"
    f"  static long long z[5 * {NBLK} * {MAXIT}];\n  static int zi[{NBLK} * {MAXIT}];\n"
    "  int e = (int)cudaMemcpyToSymbol(g_it, z, sizeof(g_it));\n"
    "  if (!e) e = (int)cudaMemcpyToSymbol(g_blk, z, sizeof(g_blk));\n"
    "  if (!e) e = (int)cudaMemcpyToSymbol(g_tl, z, sizeof(g_tl));\n"
    "  if (!e) e = (int)cudaMemcpyToSymbol(g_merged, zi, sizeof(g_merged));\n"
    "  return e ? e : (int)cudaMemcpyToSymbol(g_nt, zi, sizeof(g_nt));\n}\n")
TREE_EDITS = [
    (K1_MARK, T_DEFS + K1_MARK),
    ("  grid_dep_launch();   // the attention kernel's blocks may take their SMs and set up\n"
     "  const bool in_smem = RW <= IPLAN_SMEM_ROWS;\n",
     "  if (tid == 0) g_plan[0] = gtime();\n"
     "  grid_dep_launch();   // the attention kernel's blocks may take their SMs and set up\n"
     "  const bool in_smem = RW <= IPLAN_SMEM_ROWS;\n"),
    ("                               r.z > 1 ? (r.w + zi) * KV + kh : -1);\n    }\n  }\n}\n",
     "                               r.z > 1 ? (r.w + zi) * KV + kh : -1);\n    }\n  }\n"
     "  __syncthreads();\n  if (tid == 0) g_plan[4] = gtime();\n}\n"),
    ("    const long long per_block = (long long)I8_PIECES * nblocks;\n",
     "    if (lane == 0) g_plan[1] = gtime();\n"
     "    const long long per_block = (long long)I8_PIECES * nblocks;\n"),
    ("    __syncwarp();\n    int n = 0;   // each bucket's first item",
     "    __syncwarp();\n    if (lane == 0) g_plan[2] = gtime();\n"
     "    int n = 0;   // each bucket's first item"),
    ("  __syncthreads();\n  const int nb = s_nb;\n",
     "  __syncthreads();\n  if (tid == 0) g_plan[3] = gtime();\n  const int nb = s_nb;\n"),
    ("  if (warp == ICW) {\n    // ---- producer\n",
     "  if (warp == ICW) {\n    // ---- producer\n"
     f"    if (lane == 0 && {T_ON}) {{ g_blk[0][blockIdx.x] = gtime(); "
     "g_sm[blockIdx.x] = smid(); }\n"),
    ("    grid_dep_wait();   // the plan\n",
     "    grid_dep_wait();   // the plan\n"
     f"    if (lane == 0 && {T_ON}) g_blk[1][blockIdx.x] = gtime();\n"),
    ("      const int nt = (k1 - k0 + IBK - 1) / IBK;\n      long long sl = seq_len[b];\n",
     "      const int nt = (k1 - k0 + IBK - 1) / IBK;\n" + _it(0, "lane == 0") +
     f"      if (lane == 0 && {T_ON} && it < {MAXIT}) g_nt[blockIdx.x][it] = nt;\n"
     "      long long sl = seq_len[b];\n"),
    ("    const int kh = mt[1], qg = mt[2], k0 = mt[3], nt = mt[5], pslot = mt[6], u = mt[7];\n",
     "    const int kh = mt[1], qg = mt[2], k0 = mt[3], nt = mt[5], pslot = mt[6], u = mt[7];\n"
     + _it(1)),
    ("      mbar_wait(&full[s], (gg / ISTAGES) & 1);\n      const unsigned char* kst",
     "      mbar_wait(&full[s], (gg / ISTAGES) & 1);\n"
     f"      if (tid == 0 && {T_ON} && gg < {MAXG}) g_tl[0][blockIdx.x][gg] = ctick();\n"
     + _it(2, "tid == 0 && kt == 0") + "      const unsigned char* kst"),
    ("        for (int j = 0; j < NQ; ++j) mma_bf16(o[mi][j], a, pb[j]);\n      }\n    }\n"
     "    g0 += nt;\n",
     "        for (int j = 0; j < NQ; ++j) mma_bf16(o[mi][j], a, pb[j]);\n      }\n"
     f"      if (tid == 0 && {T_ON} && gg < {MAXG}) {{ fence_regs(o[0][0]); "
     "g_tl[1][blockIdx.x][gg] = ctick(); }\n    }\n    g0 += nt;\n" + _it(3)),
    ("    bar_sync(1, 32 * ICW);   // the merge buffers are free again\n  }\n}\n",
     _it(4) + f"      if (tid == 0 && {T_ON} && it < {MAXIT}) g_merged[blockIdx.x][it] = "
     "pslot >= 0 ? 1 + s_last : 0;\n"
     "    bar_sync(1, 32 * ICW);   // the merge buffers are free again\n  }\n"
     f"  if (tid == 0 && {T_ON}) g_blk[3][blockIdx.x] = gtime();\n}}\n"),
    ('}  // extern "C"', T_READER + '}  // extern "C"'),
]
# copies of the tree with one choice changed, timed beside it (--variant)
VARIANTS = {
    "pieces2": [("constexpr int I8_PIECES = 1;", "constexpr int I8_PIECES = 2;")],
    "ceil": [("    const bool round =\n        (long long)__reduce_add_sync(0xffffffffu, "
              "(unsigned)nlong) * KV > nblocks;", "    const bool round = false;")],
    "batch8": [("constexpr int I8_MERGE_BATCH = 10;", "constexpr int I8_MERGE_BATCH = 8;")],
}


def replay_once(lib, run) -> None:
    """``run`` captured in a CUDA graph (as the engine's decode programs run
    it, and as the times are taken), the stamps cleared, one replay."""
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


def shapes(cs, gen):
    """(label, B, row lengths, ps) of the timed shapes."""
    return [("SEQS", cs.SLOTS, cs.SEQS, 64), ("LIMITS", cs.SLOTS, cs.LIMITS, 64),
            ("B=1 one 4096-key row", 1, [cs.CTX], 64),
            ("B=16 rows of 4096 keys", cs.SLOTS, [cs.CTX] * cs.SLOTS, 64),
            ("B=16 rows of 100 keys", cs.SLOTS, [100] * cs.SLOTS, 64)]


def inputs(cs, gen, B, lens, ps):
    """int8 pools and scales, bf16 pools of the same shape, q, the table
    (pages past a row's keys point at the null page 0), seq_lens, q
    positions."""
    import torch

    P = cs.CTX // ps
    NP = 1 + B * P
    kp, vp, ks, vs = cs._int8_pools(gen, NP, ps, cs.Q_KV)
    kb = torch.randn((NP, ps, cs.Q_KV, cs.D), generator=gen, device="cuda").to(torch.bfloat16)
    vb = torch.randn((NP, ps, cs.Q_KV, cs.D), generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((B, 1, cs.Q_H, cs.D), generator=gen, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(NP - 1, generator=gen, device="cuda")[: B * P].view(B, P)
    seq = torch.tensor(lens, device="cuda")
    used = (seq + ps - 1) // ps
    table = torch.where(torch.arange(P, device="cuda")[None] < used[:, None], perm + 1, 0)
    qpos = (seq - 1).clamp(min=0)[:, None]
    return kp, vp, ks, vs, kb, vb, q, table, seq, qpos


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prepare", metavar="REV",
                    help="write REV's attention.cu and hopper.cuh into build/k1_parent/ "
                         "(git show) and stop")
    ap.add_argument("--parent-only", action="store_true",
                    help="the parent's int8 mode and bf16 K1 only (no tree int8 kernel)")
    ap.add_argument("--no-trace", action="store_true", help="times only, no stamped copies")
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS), default=[],
                    help="also time a copy of the tree with one choice changed (repeatable)")
    opts = ap.parse_args()
    if opts.prepare:
        kc.prepare(opts.prepare, PARENT, TOOL)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{TOOL}: needs a CUDA card")
    rev = kc.parent_rev(PARENT, TOOL)
    card = kc.card()
    print(card, flush=True)
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from deepsearch_tts_tpu_torch.ops import _build
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    jobs = {"parent": (PARENT, OUT, "parent", None, TOOL)}
    if not opts.no_trace:
        jobs["parent_stamped"] = (PARENT, OUT, "parent_stamped", TREE_EDITS, TOOL)
        if not opts.parent_only:
            jobs["tree_stamped"] = (CSRC, OUT, "tree_stamped", TREE_EDITS, TOOL)
    for name in opts.variant:
        jobs[name] = (CSRC, OUT, name, VARIANTS[name], TOOL)
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        tree_f = ex.submit(_build.load_library, "attention")
        built = {k: ex.submit(kc.build, *v) for k, v in jobs.items()}
        tree_f.result()
        built = {k: f.result() for k, f in built.items()}
    for line in _build.build_log.get("attention", "").splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print(f"[build] tree: {line.strip()}", flush=True)
    for k, (_, notes) in built.items():
        if k == "parent" or k in opts.variant:
            for ln in notes:
                print(f"[build] {k}: {ln}", flush=True)
    print("[build] tree blocks an SM: " + json.dumps(pa.attention_occupancy()), flush=True)
    tree_lib = pa._lib()
    libs = {"tree": tree_lib, **{k: kc.typed_as(lib, tree_lib, K1_ENTRIES)
                                 for k, (lib, _) in built.items()}}
    for k in ("parent_stamped", "tree_stamped"):
        if k in libs:
            libs[k].trace_clear.restype = ctypes.c_int

    def on(name: str, fn):
        """``fn`` with the wrappers launching library ``name``'s kernels."""
        def run():
            _build._libs["attention"] = libs[name]
            try:
                return fn()
            finally:
                _build._libs["attention"] = tree_lib
        return run

    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    result: dict = {"card": card, "parent": rev, "shapes": {}}
    from deepsearch_tts_tpu_torch.ops.attention import dequant_context

    for label, B, lens, ps in shapes(cs, gen):
        kp, vp, ks, vs, kb, vb, q, table, seq, qpos = inputs(cs, gen, B, lens, ps)
        P = table.shape[1]
        sc = dict(k_scales=ks, v_scales=vs)
        ref = pa.pallas_paged_attention_plain(q, kp, vp, table, seq, qpos, **sc)
        ref_bf = pa.pallas_paged_attention_plain(q, kb, vb, table, seq, qpos)
        tree = lambda: pa.pallas_paged_attention(q, kp, vp, table, seq, qpos, **sc)  # noqa: E731
        bf = lambda: pa.pallas_paged_attention(q, kb, vb, table, seq, qpos)  # noqa: E731
        keys = int(seq.sum())
        nbytes = keys * cs.Q_KV * (cs.D + 4) * 2 + 2 * B * cs.Q_H * cs.D * 2 + B * (P + 2) * 8
        kd, vd = (dequant_context(p_, s_, table, torch.bfloat16).transpose(1, 2)
                  for p_, s_ in ((kp, ks), (vp, vs)))
        mask = (torch.arange(P * ps, device="cuda")[None] < seq[:, None])[:, None, None]
        qt = q.transpose(1, 2)
        lib_fn = lambda: sdpa(qt, kd, vd, attn_mask=mask, enable_gqa=True)  # noqa: E731
        row = {"keys": keys, **cs.bound(nbytes, 4 * cs.Q_H * cs.D * keys),
               "bf16_bound_ms": keys * cs.Q_KV * cs.D * 2 * 2 / cs.HBM_BYTES_S * 1e3}
        runs = {"parent": on("parent", tree), "bf16": bf}
        if not opts.parent_only:
            runs["tree"] = tree
            for name in opts.variant:
                runs[name] = on(name, tree)
        use = {k: cs._bound_use(f(), ref_bf if k == "bf16" else ref, cs.ATTN_RTOL,
                                cs.ATTN_ATOL, cs.ATTN_RMS_FRAC) for k, f in runs.items()}
        row["bound_use"] = {k: round(v, 3) for k, v in use.items()}
        assert max(use.values()) <= 1.0, (label, use)
        ms = {k: [] for k in runs}
        order = ["parent", "tree", *opts.variant, *opts.variant[::-1], "tree", "parent"]
        for k in order:
            if k not in runs:
                continue
            ms[k].append(cs.time_ms(runs[k], iters=20)[0])
            ms["bf16"].append(cs.time_ms(bf, iters=20)[0])
        row["ms"] = {k: [round(x, 4) for x in v] for k, v in ms.items()}
        row.update({f"{k}_ms": round(float(np.mean(v)), 4) for k, v in ms.items()})
        row["sdpa_ms"] = round(cs.time_ms(lib_fn, iters=20)[0], 4)
        for k in ("parent_stamped", "tree_stamped"):
            if k in libs:
                row[k.replace("stamped", "timeline")] = tree_timeline(libs[k], on(k, tree))
        result["shapes"][label] = row
        print(f"[k1-i8] {label}: {json.dumps(row)}", flush=True)
        del kp, vp, kb, vb, kd, vd, ref, ref_bf
    print(json.dumps(result))
    return 0


def tree_timeline(lib, run) -> dict:
    """One stamped replay of the tree's int8 mode: the plan, and where the
    persistent blocks' time goes (module docstring)."""
    import torch

    replay_once(lib, run)
    plan = (ctypes.c_longlong * 5)()
    blk = (ctypes.c_longlong * (4 * NBLK))()
    it = (ctypes.c_longlong * (5 * NBLK * MAXIT))()
    nt, merged = (ctypes.c_int * (NBLK * MAXIT))(), (ctypes.c_int * (NBLK * MAXIT))()
    sm = (ctypes.c_int * NBLK)()
    tl = (ctypes.c_longlong * (2 * NBLK * MAXG))()
    assert lib.trace_read(plan, blk, it, nt, merged, sm, tl) == 0
    plan = np.array(plan, dtype=np.int64)
    bk = np.array(blk, dtype=np.int64).reshape(4, NBLK)
    its = np.array(it, dtype=np.int64).reshape(5, NBLK, MAXIT)
    nt = np.array(nt).reshape(NBLK, MAXIT)
    merged = np.array(merged).reshape(NBLK, MAXIT)
    sm = np.array(sm)
    tl = np.array(tl, dtype=np.int64).reshape(2, NBLK, MAXG)
    t0 = plan[0]
    ran = bk[0] > 0
    live = its[4] > 0                                   # items that reached their stores
    us = lambda a: np.round(a / 1e3, 3)   # noqa: E731
    end = bk[3][ran].max()
    # clock64 per tile: cycles over the tile's work; converted at the
    # blocks' clock (globaltimer span of a block over its tiles' cycles is
    # not stamped: use the card's reported SM clock)
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    ghz = float(clk[0]) / 1e3 if clk and clk[0].strip().isdigit() else 1.755
    work = (tl[1] - tl[0]).astype(float)
    gap = (tl[0][:, 1:] - tl[1][:, :-1]).astype(float)
    has = (tl[0] > 0) & (tl[1] > 0)
    nxt = has[:, 1:] & has[:, :-1]
    busy = np.zeros(int(sm.max()) + 1)
    np.add.at(busy, np.repeat(sm[:, None], MAXIT, 1)[live], (its[4] - its[1])[live] / 1e3)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    span = (end - t0) / 1e3
    first = live & (np.arange(MAXIT)[None] == 0)
    later = live & ~first
    res = {
        "plan_us": float(us(plan[4] - plan[0])),
        "plan_phases_us": [float(us(x - plan[0])) for x in plan[1:]],
        "first_block_start_us": float(us(bk[0][ran].min() - t0)),
        "plan_visible_us": float(us(np.median(bk[1][ran] - t0))),
        "span_us": float(us(end - t0)),
        "blocks": int(ran.sum()), "items": int(live.sum()), "tiles": int(nt[live].sum()),
        "busy_share": round(float(busy.sum() / (n_sms * 3 * span)), 4),
        "items_a_block_max": int(live.sum(1).max()),
        "first_item_fetch_to_meta_us": float(us(np.mean((its[1] - its[0])[first]))),
        "later_item_fetch_to_meta_us": (float(us(np.mean((its[1] - its[0])[later])))
                                        if later.any() else None),
        "meta_to_first_tile_us": float(us(np.mean((its[2] - its[1])[live & (nt > 0)]))),
        "first_tile_to_last_product_us": float(us(np.mean((its[3] - its[2])[live & (nt > 0)]))),
        "epilogue_us": float(us(np.mean((its[4] - its[3])[live]))),
        "epilogue_split_us": (float(us(np.mean((its[4] - its[3])[live & (merged == 1)])))
                              if (live & (merged == 1)).any() else None),
        "epilogue_merging_us": (float(us(np.mean((its[4] - its[3])[live & (merged == 2)])))
                                if (live & (merged == 2)).any() else None),
        "tile_work_us": round(float(work[has].mean() / ghz / 1e3), 3),
        "tile_wait_us": round(float(gap[nxt].mean() / ghz / 1e3), 3) if nxt.any() else None,
        "clock_ghz": ghz,
        "last_item_start_us": float(us(its[1][live].max() - t0)),
        "last_store_us": float(us(its[4][live].max() - t0)),
        "first_tile_ready_us": float(us(its[2][live & (nt > 0)].min() - t0)),
        "item_stores_us_quantiles": [float(us(x - t0)) for x in np.quantile(
            its[4][live], [0.1, 0.5, 0.9, 0.99])],
    }
    last = int(np.argmax(np.where(ran, bk[3], 0)))
    res["last_block"] = [{"tiles": int(nt[last, i]), "meta_us": float(us(its[1][last, i] - t0)),
                          "first_tile_us": float(us(its[2][last, i] - t0)),
                          "last_product_us": float(us(its[3][last, i] - t0)),
                          "stores_us": float(us(its[4][last, i] - t0)),
                          "merged": int(merged[last, i])}
                         for i in range(MAXIT) if live[last, i]]
    return res


if __name__ == "__main__":
    sys.exit(main())
