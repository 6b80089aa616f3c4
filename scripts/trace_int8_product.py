#!/usr/bin/env python3
"""Where a pipeline stage of B10's int8 product spends its time.

    python3 scripts/trace_int8_product.py                  # this tree's kernel
    python3 scripts/trace_int8_product.py --parent DIR     # the split-K kernel
                                                           # of an older checkout
    (needs one CUDA card and nvcc)

Builds a copy of ``ops/csrc/fused_layer.cu`` with ``%globaltimer`` stamps
added to the int8 product into ``build/trace_i8/``, runs the bare product
(``dstts_int8_matmul``) once at each qwen3-32b shape at B = 16 (the four
layer products and the lm_head, random int8 weights from seed 0) and prints,
averaged over the stages of one block: the stage period and its parts.

* this tree (``i8_stream``, the persistent int8 kernel): how long consumer
  warp 0 waits for a stage's data, widens and multiplies it in registers,
  and spends on the rest of its loop (its share of the split-K fix-up and
  the epilogue included); how long the producer waits for a free stage.
* ``--parent DIR`` (``gemm_partial<MT, true>``, the earlier split-K int8
  product): thread 0 of block (0, 0) waiting for the stage's ``cp.async``
  data (and the barrier after it), widening the int8 stage into the bf16
  tile (the next stage's loads issued first), the barrier after the
  widening, and the ``ldmatrix`` + ``mma.sync`` work.

It also counts, in the SASS of the built (unstamped) library
(``cuobjdump -sass``), the conversion and byte-permute instructions of the
product kernel's instances at B = 16: ``I2F``/``I2FP``, ``F2F``/``F2FP``,
``PRMT``, with ``HMMA`` and ``LDSM`` beside them. The stamps cost a little
time themselves.

The copy is made by replacing lines of the kernel's source; a change there
makes this script stop with the line it did not find. Prints one JSON line
last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
NSTAMP, NSTAGE = 6, 2048
STAMP_DEFS = (
    "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
    f"__device__ long long g_stamp[{NSTAMP}][{NSTAGE}];\n"
    "__device__ long long g_blk[8][4][1024];\n")
READER = ("int trace_read(long long* out) {\n"
          "  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));\n}\n"
          "int trace_blocks(long long* out) {\n"
          "  return (int)cudaMemcpyFromSymbol(out, g_blk, sizeof(g_blk));\n}\n"
          "int trace_clear() {\n  static long long z[" + str(NSTAMP) + "][" + str(NSTAGE) +
          "];\n  static long long zb[8][4][1024];\n"
          "  cudaMemcpyToSymbol(g_blk, zb, sizeof(zb));\n"
          "  return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));\n}\n")

# the parent's gemm_partial<MT, true>: thread 0 of block (0, 0, 0)
P_ON = "I8 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0 && kt < 2048"
PARENT_EDITS = [
    ("__device__ __forceinline__ void bf16x8_to_float(",
     STAMP_DEFS + "__device__ __forceinline__ void bf16x8_to_float("),
    ("  for (int kt = 0; kt < nk; ++kt) {\n    cp_async_wait<STAGES - 2>();\n"
     "    __syncthreads();  // stage kt landed for every thread; stage kt-1 is consumed\n",
     "  for (int kt = 0; kt < nk; ++kt) {\n"
     f"    if ({P_ON}) g_stamp[0][kt] = gtime();\n"
     "    cp_async_wait<STAGES - 2>();\n"
     "    __syncthreads();  // stage kt landed for every thread; stage kt-1 is consumed\n"
     f"    if ({P_ON}) g_stamp[1][kt] = gtime();\n"),
    ("        widen16(src + r * TILE + c, ws + r * WROW + c);\n      }\n      __syncthreads();\n",
     "        widen16(src + r * TILE + c, ws + r * WROW + c);\n      }\n"
     f"      if ({P_ON}) g_stamp[2][kt] = gtime();\n"
     "      __syncthreads();\n"
     f"      if ({P_ON}) g_stamp[3][kt] = gtime();\n"),
    ("        for (int nb = 0; nb < 4; ++nb) mma_bf16(acc[m][nb], a, b[nb]);\n      }\n    }\n  }\n"
     "  cp_async_wait<0>();\n",
     "        for (int nb = 0; nb < 4; ++nb) mma_bf16(acc[m][nb], a, b[nb]);\n      }\n    }\n"
     f"    if ({P_ON}) g_stamp[4][kt] = gtime();\n"
     "  }\n  cp_async_wait<0>();\n"),
    ('}  // extern "C"', READER + '}  // extern "C"'),
]

# this tree's i8_stream: consumer warp 0 (lane 0) and the producer of block 0
N_ON = "blockIdx.x == 0 && j < 2048"
NEW_EDITS = [
    ("__device__ __forceinline__ void bf16x8_to_float(",
     STAMP_DEFS + "__device__ __forceinline__ void bf16x8_to_float("),
    ("  if (warp == QCW) {\n",
     # a slot per launch of a chain: wd (K = 25600: 400 or 800 stages a
     # tile) apart from wo (K = 8192: 128 or 256), both I8_RESID
     "  const int tslot = EPI * 2 + (p.nk > 300);\n"
     "  if (tid == 0 && blk < 1024) g_blk[tslot][0][blk] = gtime();\n"
     "  if (warp == QCW) {\n"),
    ("        mbar_wait(&empty[s], phase);\n",
     f"        if ({N_ON}) g_stamp[0][j] = gtime();\n"
     "        mbar_wait(&empty[s], phase);\n"
     f"        if ({N_ON}) g_stamp[1][j] = gtime();\n"),
    ("  int s = 0, phase = 0;   // ring slot and phase of the next stage\n",
     "  int s = 0, phase = 0;   // ring slot and phase of the next stage\n  int j = 0;\n"),
    ("      mbar_wait(&full[s], phase);\n",
     f"      if ({N_ON} && threadIdx.x == 0) g_stamp[2][j] = gtime();\n"
     "      mbar_wait(&full[s], phase);\n"
     f"      if ({N_ON} && threadIdx.x == 0) g_stamp[3][j] = gtime();\n"
     "      if (tid == 0 && j == 0 && blk < 1024) g_blk[tslot][1][blk] = gtime();\n"),
    ("      if (lane == 0) mbar_arrive(&empty[s]);\n",
     "      if (lane == 0) mbar_arrive(&empty[s]);\n"
     f"      if ({N_ON} && threadIdx.x == 0) g_stamp[4][j] = gtime();\n      ++j;\n"
     "      if (tid == 0 && blk < 1024) g_blk[tslot][2][blk] = gtime();\n"),
    ("    left -= len;\n",
     "    if (tid == 0 && blk < 1024) g_blk[tslot][3][blk] = gtime();\n    left -= len;\n"),
    ('}  // extern "C"', READER + '}  // extern "C"'),
]

# qwen3-32b shapes of the bare product at B = 16: (name, K, N)
SHAPES = [("wqkv", 5120, 10240), ("wo", 8192, 5120), ("w_gateup", 5120, 51200),
          ("w_down", 25600, 5120), ("lm_head", 5120, 151936)]


def parent_splits(B: int, N: int, K: int) -> int:
    """The split count the parent's wrapper chose (``_splits`` with int8
    weights: 128-column tiles, 32-row stages, >= 264 blocks, partial sums
    within a quarter of the weight bytes)."""
    base, cap, s = (N // 128) * -(-B // 64), max(1, K // (32 * B)), 1
    while base * s < 264 and 2 * s <= cap and K % (2 * s * 32) == 0:
        s *= 2
    return s


def build(src_path: str, edits, tag: str) -> ctypes.CDLL:
    from deepsearch_tts_tpu_torch.ops import _build

    with open(src_path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"trace_int8_product: kernel line not found:\n{old}")
        src = src.replace(old, new, 1)
    csrc = os.path.dirname(os.path.abspath(src_path))
    src = src.replace('#include "hopper.cuh"', f'#include "{os.path.join(csrc, "hopper.cuh")}"')
    out = os.path.join(ROOT, "build", "trace_i8")
    os.makedirs(out, exist_ok=True)
    path, so = os.path.join(out, f"{tag}.cu"), os.path.join(out, f"lib{tag}.so")
    with open(path, "w") as f:
        f.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"trace_int8_product: nvcc failed\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    lib.trace_read.argtypes = [ctypes.c_void_p]
    return lib


def sass_counts(src_path: str, tag: str, kernel: str) -> dict:
    """Static counts of conversion / permute / tensor instructions in each
    instance of ``kernel`` in an unstamped build of ``src_path``."""
    from deepsearch_tts_tpu_torch.ops import _build

    out = os.path.join(ROOT, "build", "trace_i8")
    so = os.path.join(out, f"lib{tag}_plain.so")
    csrc = os.path.dirname(os.path.abspath(src_path))
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, src_path],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"trace_int8_product: nvcc failed\n{r.stderr[-4000:]}")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    counts: dict = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", block)
        c = {k: 0 for k in ("I2F", "F2F", "PRMT", "HMMA", "LDSM", "total")}
        for op in ops:
            c["total"] += 1
            for k in ("I2F", "F2F", "PRMT", "HMMA", "LDSM"):
                if op.startswith(k):
                    c[k] += 1
        counts[name] = c
    return counts


def trace_chains(lib) -> dict:
    """B10-out and B10-qkv at qwen3-32b, B = 16, one layer, replayed once
    from a CUDA graph through the stamped library: per i8_stream launch,
    when its blocks start (first and last), how long a block waits for its
    first stage, streams, and spends after its last stage (fix-up and
    epilogue), when its last block ends, and the gap to the next launch."""
    import torch

    import chip_smoke as cs
    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import _build
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    _build._libs["fused_layer"] = lib
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev, bf, B = torch.device("cuda"), torch.bfloat16, 16
    E, H, KV, F, D = cs.Q_E, cs.Q_H, cs.Q_KV, cs.Q_F, cs.D

    def i8(K, N):
        q = torch.randint(-127, 128, (1, K, N), generator=gen, device=dev, dtype=torch.int8)
        return q, torch.rand((1, 1, N), generator=gen, device=dev) / 73 / K ** 0.5

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.1 + 1).to(bf)

    C = (H + 2 * KV) * D
    wq, ws = i8(E, C)
    woq, wos = i8(H * D, E)
    guq, gus = i8(E, 2 * F)
    wdq, wds = i8(F, E)
    x, a, ln = rnd(B, E), rnd(B, H * D), rnd(1, E)
    qn, kn = rnd(1, D), rnd(1, D)
    cos, sin = rope_angles(torch.arange(B, device=dev), D, 1e6)
    chains = {
        "B10-out": (lambda: fl.fused_out_mlp_stacked_i8(a, x, woq, wos, ln, guq, gus, wdq, wds,
                                                         0), [("wo", 2), ("gate|up", 4),
                                                              ("wd", 3)]),
        "B10-qkv": (lambda: fl.fused_qkv_stacked_i8(x, ln, wq, ws, qn, kn, cos, sin, 0,
                                                     n_heads=H, n_kv=KV, head_dim=D),
                    [("wqkv", 6)])}
    out = {}
    for name, (fn, launches) in chains.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        assert lib.trace_clear() == 0
        graph.replay()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (8 * 4 * 1024))()
        assert lib.trace_blocks(buf) == 0
        d = np.array(buf, dtype=np.int64).reshape(8, 4, 1024)
        t0 = min(int(d[sl, 0][d[sl, 0] > 0].min()) for _, sl in launches)
        rows, prev_end = [], None
        for kname, sl in launches:
            live = d[sl, 0] > 0
            beg, first, sdone, end = (d[sl, e][live].astype(np.float64) for e in range(4))
            row = {"launch": kname, "blocks": int(live.sum()),
                   "first_start_us": (beg.min() - t0) / 1e3,
                   "last_start_us": (beg.max() - t0) / 1e3,
                   "wait_first_stage_us": float((first - beg).mean()) / 1e3,
                   "stream_us": float((sdone - first).mean()) / 1e3,
                   "after_last_stage_us": float((end - sdone).mean()) / 1e3,
                   "last_end_us": (end.max() - t0) / 1e3}
            if prev_end is not None:
                row["gap_from_previous_us"] = row["first_start_us"] - prev_end
            prev_end = row["last_end_us"]
            rows.append(row)
            print(f"[chain] {name} {kname}: " + ", ".join(
                f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()
                if k != "launch"), flush=True)
        graph.reset()
        out[name] = rows
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of a checkout whose int8 product is gemm_partial")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_int8_product: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    root = os.path.abspath(args.parent) if args.parent else ROOT
    src = os.path.join(root, "deepsearch_tts_tpu_torch", "ops", "csrc", "fused_layer.cu")
    tag = "parent" if args.parent else "tree"
    lib = build(src, PARENT_EDITS if args.parent else NEW_EDITS, tag)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dstts_int8_matmul.argtypes = ([p] * 5 + [i] * 4 + [p]) if args.parent else (
        [p] * 6 + [i] * 5 + [p])
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, B = torch.device("cuda"), 16
    result: dict = {"card": card, "kernel": "gemm_partial<1, true>" if args.parent
                    else "i8_stream", "shapes": {}}
    for name, K, N in SHAPES:
        w = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        s = torch.rand((1, N), generator=gen, device=dev) / 73 / K ** 0.5
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((B, N), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if args.parent:
            splits = parent_splits(B, N, K)
            part = torch.empty((splits, B, N), dtype=torch.float32, device=dev)

            def run():
                assert lib.dstts_int8_matmul(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                                             part.data_ptr(), out.data_ptr(), B, K, N, splits,
                                             stream) == 0
            stages = K // splits // 32
            info = f"splits {splits}, {stages} stages of 32 x 128 a block"
        else:
            from deepsearch_tts_tpu_torch.ops import fused_layer as fl

            grid, ring = fl.i8_plan(B, dev)
            part, tickets = fl.i8_scratch(dev, B, grid)

            def run():
                assert lib.dstts_int8_matmul(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                                             part.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                                             B, K, N, grid, ring, stream) == 0
            tiles, nk = fl.i8_tiles(K, N)
            tw = fl.i8_tile_cols(N)
            stages = -(-tiles * nk // grid)
            info = (f"{grid} blocks, {ring}-stage ring, <= {stages} stages of "
                    f"{8192 // tw} x {tw} a block")
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        assert lib.trace_clear() == 0
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        ref = ((x.float() @ w.float()) * s).to(torch.bfloat16)
        err = float((out.float() - ref.float()).abs().max())
        buf = (ctypes.c_longlong * (NSTAMP * NSTAGE))()
        assert lib.trace_read(buf) == 0
        d = np.array(buf, dtype=np.int64).reshape(NSTAMP, NSTAGE).astype(np.float64) / 1e3
        n = min(stages, NSTAGE)
        lo, hi = min(4, n // 4), max(n - 2, min(4, n // 4) + 1)
        sl, nxt = slice(lo, hi), slice(lo + 1, hi + 1)
        row = {"ms": a.elapsed_time(b), "max_abs_err": err, "info": info}
        if args.parent:
            t = d[:5]
            row.update(period=float(np.diff(t[0][lo:hi + 1]).mean()),
                       wait_data=float((t[1][sl] - t[0][sl]).mean()),
                       widen=float((t[2][sl] - t[1][sl]).mean()),
                       barrier=float((t[3][sl] - t[2][sl]).mean()),
                       mma=float((t[4][sl] - t[3][sl]).mean()))
        else:
            row.update(period=float(np.diff(d[3][lo:hi + 1]).mean()),
                       producer_wait=float((d[1][sl] - d[0][sl]).mean()),
                       wait_data=float((d[3][sl] - d[2][sl]).mean()),
                       widen_mma=float((d[4][sl] - d[3][sl]).mean()),
                       rest=float((d[2][nxt] - d[4][sl]).mean()))
        result["shapes"][f"{name} [{K}, {N}]"] = row
        print(f"{name:9s} [{K}, {N}] B={B}: one traced call {row['ms']:.4f} ms ({info}; "
              f"max abs err {err:.3e}); block 0, stages {lo}..{hi - 1}, microseconds: " +
              ", ".join(f"{k} {v:.3f}" for k, v in row.items()
                        if k not in ("ms", "max_abs_err", "info")), flush=True)
        del w, x, out
    if not args.parent:
        result["chains"] = trace_chains(lib)
    kern = "gemm_partial" if args.parent else "i8_stream"
    counts = sass_counts(src, tag, kern)
    for fn, c in counts.items():
        if args.parent and "Lb1EE" not in fn:
            continue   # the bf16 instances
        print(f"SASS {fn}: " + ", ".join(f"{k} {v}" for k, v in c.items()), flush=True)
    result["sass"] = {k: v for k, v in counts.items() if not args.parent or "Lb1EE" in k}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
