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
(``git show``) into ``build/k1_parent/`` (ignored by git); the run builds
them there with the port's nvcc flags, so it also runs in a copy without
``.git``. The parent's int8 mode is the split-context kernel
``decode_attention<MT, true>`` behind ``dstts_decode_attention_i8``,
launched here with the splits :func:`paged_attention.decode_splits`
gives, as its wrapper did.

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

Unless ``--no-trace``, stamped copies run each shape once more:

* the parent (``PARENT_EDITS``): per block, ``%globaltimer`` at its start
  and end and ``clock64`` by thread 0 (warp 0) at its prologue's end (q
  staged, the ring's first stages issued) and, for every key tile, at the
  loop's top, after the copy wait, after the block barrier, after the next
  tile's table reads and copy issue, after its widening, after the
  widening's barrier and after the products; the merge kernel's blocks'
  start and end. Cycles are turned into time by each block's own
  clock / timer ratio.
* the tree (``TREE_EDITS``): the plan kernel's start and end; per
  persistent block, its start and, per item, the producer's item fetch,
  the consumers' item start (meta and q landed), their first tile ready,
  their last product and their stores; per tile (consumer warp 0) the
  stage wait and the tile's work.

From them, in microseconds: the span (first start to last end), the busy
share of the SMs, the critical block (the one that ends last) and its
tiles, the mean of each per-tile step, the prologue and epilogue, the
merge's gap and span. Prints the card's name and power limit first and one
JSON line last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "deepsearch_tts_tpu_torch", "ops", "csrc")
PARENT = os.path.join(ROOT, "build", "k1_parent")
OUT = os.path.join(ROOT, "build", "k1_time")
NBLK, MAXT, NTS = 1024, 64, 7      # blocks, tiles a block, per-tile stamps (parent)
TILE_STAMPS = ("top", "copy landed", "block barrier", "table + copy issued", "widened",
               "widen barrier", "products done")
GTIME = (
    "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
    "__device__ __forceinline__ long long ctick() {\n  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t));\n  return t;\n}\n"
    "__device__ __forceinline__ int smid() {\n  int s;\n"
    "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s));\n  return s;\n}\n")
K1_MARK = "// ------------------------------------------------------------------- K1\n"

# ---- the parent: one block a (row, kv head, split)
P_DEFS = GTIME + (
    f"__device__ long long g_tile[{NTS}][{NBLK}][{MAXT}];\n"
    f"__device__ long long g_blk[6][{NBLK}];   // t0, c0, t1, c1, prologue end, epilogue start\n"
    f"__device__ int g_nt[{NBLK}];\n__device__ int g_sm[{NBLK}];\n"
    f"__device__ long long g_merge[2][{NBLK}];\n")
P_BLK = "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))"
P_ON = f"(I8 && threadIdx.x == 0 && {P_BLK} < {NBLK})"


def _tile(k: int) -> str:
    return f"    if ({P_ON} && kt < {MAXT}) g_tile[{k}][{P_BLK}][kt] = ctick();\n"


P_END = (f"  if ({P_ON}) {{ g_blk[2][{P_BLK}] = gtime(); g_blk[3][{P_BLK}] = ctick(); }}\n")
PARENT_EDITS = [
    (K1_MARK, P_DEFS + K1_MARK),
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
     "  const int G = H / KV, R = T * G;\n",
     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
     "  const long long st_t0 = gtime(), st_c0 = ctick();\n"
     "  const int G = H / KV, R = T * G;\n"),
    ("  const long long prow = ((long long)(b * KV + kh) * splits + z) * R;   // partial rows\n",
     "  const long long prow = ((long long)(b * KV + kh) * splits + z) * R;   // partial rows\n"
     f"  if ({P_ON}) {{ g_blk[0][{P_BLK}] = st_t0; g_blk[1][{P_BLK}] = st_c0; "
     f"g_nt[{P_BLK}] = ntiles; g_sm[{P_BLK}] = smid(); }}\n"),
    ("    }\n    return;\n  }\n\n  // q tile, zero-padded",
     "    }\n" + P_END + "    return;\n  }\n\n  // q tile, zero-padded"),
    ("  __syncthreads();   // the q buffer is the ring's last stage from here on\n",
     "  __syncthreads();   // the q buffer is the ring's last stage from here on\n"
     f"  if ({P_ON}) g_blk[4][{P_BLK}] = ctick();\n"),
    ("  for (int kt = 0; kt < ntiles; ++kt) {\n    cp_async_wait<RS - 2>();\n"
     "    __syncthreads();   // tile kt landed for every thread; tile kt-1's stage is free\n",
     "  for (int kt = 0; kt < ntiles; ++kt) {\n" + _tile(0) + "    cp_async_wait<RS - 2>();\n"
     + _tile(1) + "    __syncthreads();   // tile kt landed for every thread; tile kt-1's "
     "stage is free\n" + _tile(2)),
    ("      if (nt < ntiles) load_tile(nt % RS, nt);\n      cp_async_commit();\n    }\n",
     "      if (nt < ntiles) load_tile(nt % RS, nt);\n      cp_async_commit();\n    }\n"
     + _tile(3)),
    ("      if (MT == 1) __syncwarp();\n      else bar_sync(1 + kpart, MT * 32);\n    }\n",
     _tile(4) + "      if (MT == 1) __syncwarp();\n      else bar_sync(1 + kpart, MT * 32);\n"
     "    }\n" + _tile(5)),
    ("    }\n  }\n  cp_async_wait<0>();\n  __syncthreads();   // every warp is done with the ring: "
     "it holds the merge buffers now\n",
     "    }\n" + _tile(6) + "  }\n  cp_async_wait<0>();\n  __syncthreads();   // every warp is "
     "done with the ring: it holds the merge buffers now\n" +
     f"  if ({P_ON}) g_blk[5][{P_BLK}] = ctick();\n"),
    ("  }\n}\n\n// grid (R, KV, B), D threads: out row r",
     "  }\n" + P_END + "}\n\n// grid (R, KV, B), D threads: out row r"),
    ("  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;\n",
     "  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;\n"
     f"  if (d == 0 && {P_BLK} < {NBLK}) g_merge[0][{P_BLK}] = gtime();\n"),
    ("      __float2bfloat16(acc / fmaxf(L, 1e-30f));\n}\n",
     "      __float2bfloat16(acc / fmaxf(L, 1e-30f));\n"
     f"  if (d == 0 && {P_BLK} < {NBLK}) g_merge[1][{P_BLK}] = gtime();\n}}\n"),
]
P_READER = (
    "int trace_read(long long* tile, long long* blk, int* nt, int* sm, long long* merge) {\n"
    "  int e = (int)cudaMemcpyFromSymbol(tile, g_tile, sizeof(g_tile));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(blk, g_blk, sizeof(g_blk));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(nt, g_nt, sizeof(g_nt));\n"
    "  if (!e) e = (int)cudaMemcpyFromSymbol(sm, g_sm, sizeof(g_sm));\n"
    "  return e ? e : (int)cudaMemcpyFromSymbol(merge, g_merge, sizeof(g_merge));\n}\n"
    "int trace_clear() {\n"
    f"  static long long z[{NTS} * {NBLK} * {MAXT}];\n  static int zi[{NBLK}];\n"
    "  int e = (int)cudaMemcpyToSymbol(g_tile, z, sizeof(g_tile));\n"
    "  if (!e) e = (int)cudaMemcpyToSymbol(g_blk, z, sizeof(g_blk));\n"
    "  if (!e) e = (int)cudaMemcpyToSymbol(g_merge, z, sizeof(g_merge));\n"
    "  return e ? e : (int)cudaMemcpyToSymbol(g_nt, zi, sizeof(g_nt));\n}\n")
PARENT_EDITS.append(('}  // extern "C"', P_READER + '}  // extern "C"'))

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


def prepare(rev: str) -> None:
    os.makedirs(PARENT, exist_ok=True)
    for name in ("attention.cu", "hopper.cuh"):
        src = subprocess.run(["git", "show", f"{rev}:deepsearch_tts_tpu_torch/ops/csrc/{name}"],
                             cwd=ROOT, capture_output=True, text=True, check=True).stdout
        with open(os.path.join(PARENT, name), "w") as f:
            f.write(src)
    with open(os.path.join(PARENT, "REV"), "w") as f:
        f.write(rev + "\n")
    print(f"time_k1_i8: {rev}'s attention.cu and hopper.cuh in {PARENT}")


def build(src_dir: str, tag: str, edits=None) -> tuple:
    """nvcc of ``src_dir``/attention.cu (with ``edits`` applied) into
    build/k1_time/lib<tag>.so; returns (the library, ptxas' lines)."""
    from deepsearch_tts_tpu_torch.ops import _build

    with open(os.path.join(src_dir, "attention.cu")) as f:
        src = f.read()
    for old, new in edits or ():
        if src.count(old) != 1:
            raise SystemExit(f"time_k1_i8 ({tag}): kernel text not found once:\n{old}")
        src = src.replace(old, new, 1)
    src = src.replace('#include "hopper.cuh"',
                      f'#include "{os.path.join(src_dir, "hopper.cuh")}"')
    os.makedirs(OUT, exist_ok=True)
    path, so = os.path.join(OUT, f"{tag}.cu"), os.path.join(OUT, f"lib{tag}.so")
    with open(path, "w") as f:
        f.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"time_k1_i8: nvcc failed on {tag}\n{r.stderr[-4000:]}")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib = ctypes.CDLL(so)
    if src_dir == PARENT:
        lib.dstts_decode_attention_i8.argtypes = [p, ll, p, p, p, p, p, i, ll, p, p, i, i, i,
                                                  p, i, i, i, i, i, f, i, i, i, p, p, p]
        lib.dstts_decode_attention_i8.restype = i
    if hasattr(lib, "trace_clear"):
        lib.trace_clear.restype = i
    notes = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
             if any(w in ln for w in ("registers", "spill", "Compiling entry"))]
    return lib, notes


def parent_i8(lib, q, kp, vp, ks, vs, table, seq, qpos):
    """The parent's int8 mode through its own C entry, with the splits its
    wrapper chose (``decode_splits``)."""
    import torch

    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    B, T, H, D = q.shape
    R, ps, K, _ = kp.shape
    P = table.shape[1]
    splits, chunk = pa.decode_splits(B, K, P * ps, pa._sm_count(q.device))
    out = torch.empty_like(q)
    rows = B * K * splits * T * (H // K)
    o_part = torch.empty((rows, D), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((rows, 2), dtype=torch.float32, device=q.device)

    def run():
        err = lib.dstts_decode_attention_i8(
            q.data_ptr(), q.stride(0), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), table.data_ptr(), P, 0, seq.data_ptr(), qpos.data_ptr(),
            qpos.stride(0), 0, P * ps, out.data_ptr(), B, T, H, K, ps, D ** -0.5, 1, splits,
            chunk, o_part.data_ptr(), ml_part.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    return run, splits, chunk


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


def parent_timeline(lib, run) -> dict:
    """One stamped replay of the parent's int8 mode: where its blocks' time
    goes (module docstring)."""
    import torch

    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    replay_once(lib, run)
    tile = (ctypes.c_longlong * (NTS * NBLK * MAXT))()
    blk = (ctypes.c_longlong * (6 * NBLK))()
    nt, sm = (ctypes.c_int * NBLK)(), (ctypes.c_int * NBLK)()
    merge = (ctypes.c_longlong * (2 * NBLK))()
    assert lib.trace_read(tile, blk, nt, sm, merge) == 0
    tl = np.array(tile, dtype=np.int64).reshape(NTS, NBLK, MAXT)
    bk = np.array(blk, dtype=np.int64).reshape(6, NBLK)
    nt, sm = np.array(nt), np.array(sm)
    mg = np.array(merge, dtype=np.int64).reshape(2, NBLK)
    ran = bk[0] > 0
    work = ran & (nt > 0)
    t0 = bk[0][ran].min()
    end = bk[2][ran].max()
    dur = (bk[2] - bk[0]) / 1e3                          # us
    # cycles a ns from the blocks that ran long enough to read it well
    long_ = work & (dur > 2.0)
    ghz = float(np.median(((bk[3] - bk[1]) / (bk[2] - bk[0]))[long_])) if long_.any() else 1.755
    us = lambda cyc: cyc / ghz / 1e3   # noqa: E731
    steps = {}
    names = ("wait for the copy", "block barrier", "table reads + copy issue", "widening",
             "widen barrier", "products")
    mask = np.zeros((NBLK, MAXT), dtype=bool)
    for b in np.nonzero(work)[0]:
        mask[b, :min(nt[b], MAXT)] = True
    first = mask & (np.arange(MAXT)[None] == 0)
    rest = mask & ~first
    for k, name in enumerate(names):
        d = us(tl[k + 1] - tl[k]).astype(float)
        steps[name] = {"mean_us": round(float(d[mask].mean()), 3),
                       "first_tile_us": round(float(d[first].mean()), 3),
                       "later_tiles_us": round(float(d[rest].mean()), 3) if rest.any() else None}
    per_tile = us(tl[6] - tl[0]).astype(float)
    crit = int(np.argmax(np.where(ran, bk[2], 0)))
    longest = int(np.argmax(np.where(work, bk[2] - bk[0], 0)))
    busy = np.zeros(int(sm.max()) + 1)
    np.add.at(busy, sm[work], dur[work])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    span = (end - t0) / 1e3
    res = {
        "clock_ghz": round(ghz, 3),
        "span_us": round(float(span), 2),
        "blocks": int(ran.sum()), "blocks_with_keys": int(work.sum()),
        "tiles": int(nt[work].sum()),
        "slot_busy_share": round(float(busy.sum() / (n_sms * pa.BLOCKS_PER_SM * span)), 4),
        "block_us_mean": round(float(dur[work].mean()), 2),
        "critical_block": {"tiles": int(nt[crit]),
                           "start_us": round(float((bk[0][crit] - t0) / 1e3), 2),
                           "us": round(float(dur[crit]), 2)},
        "longest_block": {"tiles": int(nt[longest]), "us": round(float(dur[longest]), 2),
                          "start_us": round(float((bk[0][longest] - t0) / 1e3), 2)},
        "prologue_us": round(float(us(bk[4] - bk[1])[work].mean()), 3),
        "tile_us": round(float(per_tile[mask].mean()), 3),
        "steps": steps,
        "epilogue_us": round(float((dur - us(bk[5] - bk[1]))[work].mean()), 3),
        "start_spread_us": round(float((bk[0][work].max() - t0) / 1e3), 2),
    }
    used = mg[0] > 0
    if used.any():
        res["merge"] = {"blocks": int(used.sum()),
                        "gap_us": round(float((mg[0][used].min() - end) / 1e3), 2),
                        "span_us": round(float((mg[1][used].max() - mg[0][used].min()) / 1e3), 2),
                        "end_us": round(float((mg[1][used].max() - t0) / 1e3), 2)}
    return res


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
        prepare(opts.prepare)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_k1_i8: needs a CUDA card")
    if not os.path.exists(os.path.join(PARENT, "attention.cu")):
        raise SystemExit(f"time_k1_i8: no parent sources in {PARENT}: run --prepare REV in a "
                         "git checkout first")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with open(os.path.join(PARENT, "REV")) as f:
        rev = f.read().strip()
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from deepsearch_tts_tpu_torch.ops import _build
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    jobs = {"parent": (PARENT, "parent", None)}
    if not opts.no_trace:
        jobs["parent_stamped"] = (PARENT, "parent_stamped", PARENT_EDITS)
        if not opts.parent_only:
            jobs["tree_stamped"] = (CSRC, "tree_stamped", TREE_EDITS)
    for name in opts.variant:
        jobs[name] = (CSRC, name, VARIANTS[name])
    with ThreadPoolExecutor(len(jobs) + 1) as ex:
        tree_f = ex.submit(_build.load_library, "attention")
        built = {k: ex.submit(build, *v) for k, v in jobs.items()}
        tree_lib = tree_f.result()
        libs = {k: f.result() for k, f in built.items()}
    for line in _build.build_log.get("attention", "").splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print(f"[build] tree: {line.strip()}", flush=True)
    for k, (_, notes) in libs.items():
        if k == "parent" or k in opts.variant:
            for ln in notes:
                print(f"[build] {k}: {ln}", flush=True)
    print("[build] tree blocks an SM: " + json.dumps(pa.attention_occupancy()), flush=True)
    typed = pa._lib()
    for key in [*opts.variant, "tree_stamped"]:   # the wrappers' entries typed as the tree's
        if key not in libs:
            continue
        lib = libs[key][0]
        for name in ("dstts_decode_attention", "dstts_decode_i8", "dstts_decode_i8_plan"):
            fn, ref = getattr(lib, name), getattr(typed, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        lib._dstts_typed = True

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
        par, splits, chunk = parent_i8(libs["parent"][0], q, kp, vp, ks, vs, table, seq, qpos)
        tree = lambda: pa.pallas_paged_attention(q, kp, vp, table, seq, qpos, **sc)  # noqa: E731
        bf = lambda: pa.pallas_paged_attention(q, kb, vb, table, seq, qpos)  # noqa: E731
        keys = int(seq.sum())
        nbytes = keys * cs.Q_KV * (cs.D + 4) * 2 + 2 * B * cs.Q_H * cs.D * 2 + B * (P + 2) * 8
        kd, vd = (dequant_context(p_, s_, table, torch.bfloat16).transpose(1, 2)
                  for p_, s_ in ((kp, ks), (vp, vs)))
        mask = (torch.arange(P * ps, device="cuda")[None] < seq[:, None])[:, None, None]
        qt = q.transpose(1, 2)
        lib_fn = lambda: sdpa(qt, kd, vd, attn_mask=mask, enable_gqa=True)  # noqa: E731
        row = {"keys": keys, "parent_splits": [splits, chunk],
               **cs.bound(nbytes, 4 * cs.Q_H * cs.D * keys),
               "bf16_bound_ms": keys * cs.Q_KV * cs.D * 2 * 2 / cs.HBM_BYTES_S * 1e3}
        use = {"parent": cs._bound_use(par(), ref, cs.ATTN_RTOL, cs.ATTN_ATOL, cs.ATTN_RMS_FRAC),
               "bf16": cs._bound_use(bf(), ref_bf, cs.ATTN_RTOL, cs.ATTN_ATOL, cs.ATTN_RMS_FRAC)}
        runs = {"parent": par, "bf16": bf}
        if not opts.parent_only:
            use["tree"] = cs._bound_use(tree(), ref, cs.ATTN_RTOL, cs.ATTN_ATOL, cs.ATTN_RMS_FRAC)
            runs["tree"] = tree
            for name in opts.variant:   # the wrappers launch the copy
                _build._libs["attention"] = libs[name][0]
                use[name] = cs._bound_use(tree(), ref, cs.ATTN_RTOL, cs.ATTN_ATOL,
                                          cs.ATTN_RMS_FRAC)
                _build._libs["attention"] = tree_lib
                runs[name] = tree
        row["bound_use"] = {k: round(v, 3) for k, v in use.items()}
        assert max(use.values()) <= 1.0, (label, use)
        ms = {k: [] for k in runs}
        order = ["parent", "tree", *opts.variant, *opts.variant[::-1], "tree", "parent"]
        for k in order:
            if k not in runs:
                continue
            if k in opts.variant:
                _build._libs["attention"] = libs[k][0]
            ms[k].append(cs.time_ms(runs[k], iters=20)[0])
            _build._libs["attention"] = tree_lib
            ms["bf16"].append(cs.time_ms(bf, iters=20)[0])
        row["ms"] = {k: [round(x, 4) for x in v] for k, v in ms.items()}
        row.update({f"{k}_ms": round(float(np.mean(v)), 4) for k, v in ms.items()})
        row["sdpa_ms"] = round(cs.time_ms(lib_fn, iters=20)[0], 4)
        if "parent_stamped" in libs:
            stamped, _, _ = parent_i8(libs["parent_stamped"][0], q, kp, vp, ks, vs, table, seq,
                                      qpos)
            row["parent_timeline"] = parent_timeline(libs["parent_stamped"][0], stamped)
        if "tree_stamped" in libs and TREE_EDITS:
            _build._libs["attention"] = libs["tree_stamped"][0]
            row["tree_timeline"] = tree_timeline(libs["tree_stamped"][0], tree)
            _build._libs["attention"] = tree_lib
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
