#!/usr/bin/env python3
"""Where the time of one B7 launch goes (``fused_out_router_stacked``:
``i8_stream<128, MT, I8_ROUTER>`` in ``ops/csrc/fused_layer.cu``).

    python3 scripts/trace_b7.py        (needs one CUDA card and nvcc)

Builds a copy of ``fused_layer.cu`` with ``%globaltimer`` stamps added to
B7's instances of the kernel into ``build/trace_b7/``, runs one call at
qwen3-30b-a3b widths (E = 2048, H·D = 4096, 128 experts; random bf16
weights from seed 0, layer 0 of an 8-layer stack, read cold) at B = 1, 16
and 64 (after every layer twice, so that layer 0's weights are out of
L2), and prints for each run, in microseconds from the first block's
start, across its blocks (min / median / max): the block's start, its
first ring stage's
arrival, its last stage's end (its segment sums stored after), the ends of
the first grid barrier, of its (row, tile) units of x2 and of the second
barrier, and in phase 2: its loads issued (the first x2 batch, ln2 and
the sums of squares), ln2 and the sums of squares in shared memory, 1/rms
of its rows, its hn tile written, the router columns there, the logits'
products summed, and its end (for a block with several phase-2 items,
those of its last). The stamps cost a little time themselves.

The copy is made by replacing lines of the kernel's source; a change there
makes this script stop with the line it did not find. Prints one JSON line
last.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
NST = 14     # stamps a block
NBLK = 1024
ON = "i8_b7(EPI) && blk < 1024"
STAMP_DEFS = (
    "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
    f"__device__ long long g_b7[{NST}][{NBLK}];\n")
READER = ("int trace_read(long long* out) {\n"
          "  return (int)cudaMemcpyFromSymbol(out, g_b7, sizeof(g_b7));\n}\n"
          f"int trace_clear() {{\n  static long long z[{NST}][{NBLK}];\n"
          "  return (int)cudaMemcpyToSymbol(g_b7, z, sizeof(z));\n}\n")
STAMPS = ["start", "first stage", "last stage", "stream done", "barrier 1 done",
          "x2 done", "barrier 2 done", "1/rms done", "hn done", "end", "phase 2 loads issued",
          "ln2 and sums of squares in", "hn tile written", "logits summed"]
EDITS = [
    ("__device__ __forceinline__ void bf16x8_to_float(",
     STAMP_DEFS + "__device__ __forceinline__ void bf16x8_to_float("),
    ("  const int G = gridDim.x, blk = blockIdx.x;\n",
     "  const int G = gridDim.x, blk = blockIdx.x;\n"
     f"  if ({ON} && tid == 0 && g_b7[0][blk] == 0) g_b7[0][blk] = gtime();\n"),
    ("      mbar_wait(&full[s], phase);\n",
     "      mbar_wait(&full[s], phase);\n"
     f"      if ({ON} && tid == 0 && g_b7[1][blk] == 0) g_b7[1][blk] = gtime();\n"),
    ("      if (lane == 0) mbar_arrive(&empty[s]);\n",
     "      if (lane == 0) mbar_arrive(&empty[s]);\n"
     f"      if ({ON} && tid == 0) g_b7[2][blk] = gtime();\n"),
    ("  if constexpr (i8_b7(EPI)) {\n    // B7: every block's segment sums",
     f"  if ({ON} && tid == 0 && g_b7[3][blk] == 0) g_b7[3][blk] = gtime();\n"
     "  if constexpr (i8_b7(EPI)) {\n    // B7: every block's segment sums"),
    ("  grid_wait(p.count, end, 128);\n  for (int u = blk * 4 + warp;",
     "  grid_wait(p.count, end, 128);\n"
     "  if (threadIdx.x == 0 && blk < 1024) g_b7[4][blk] = gtime();\n"
     "  for (int u = blk * 4 + warp;"),
    ("    b7_x2(p, G, blk, base + G);\n",
     "    b7_x2(p, G, blk, base + G);\n"
     f"    if ({ON} && tid == 0) g_b7[5][blk] = gtime();\n"),
    ("  grid_wait(p.count, end, NTH);\n",
     "  grid_wait(p.count, end, NTH);\n"
     "  if (threadIdx.x == 0) g_b7[6][blk] = gtime();\n"),
    ("    if (tid < nr) inv[tid] = rsqrtf(tsum / (float)E + p.eps);\n    bar_sync(1, NTH);\n",
     "    if (tid < nr) inv[tid] = rsqrtf(tsum / (float)E + p.eps);\n    bar_sync(1, NTH);\n"
     "    if (threadIdx.x == 0) g_b7[7][blk] = gtime();\n"),
    ("      mbar_wait(rbar, ph);   // the router columns\n",
     "      mbar_wait(rbar, ph);   // the router columns\n"
     "      if (threadIdx.x == 0) g_b7[8][blk] = gtime();\n"),
    ("                                       blk, base + 2 * G);\n",
     "                                       blk, base + 2 * G);\n"
     f"    if ({ON} && tid == 0) g_b7[9][blk] = gtime();\n"),
    ("#pragma unroll\n      for (int j = 0; j < B7_SQT * RROWS / NTH; ++j) {\n"
     "        const int i = i0 + tid + j * NTH;\n"
     "        if (i < tiles * RROWS && (i & 15) < nr) sqs[i - i0] = sv[j];",
     "      if (threadIdx.x == 0) g_b7[10][blk] = gtime();\n"
     "#pragma unroll\n      for (int j = 0; j < B7_SQT * RROWS / NTH; ++j) {\n"
     "        const int i = i0 + tid + j * NTH;\n"
     "        if (i < tiles * RROWS && (i & 15) < nr) sqs[i - i0] = sv[j];"),
    ("      bar_sync(1, NTH);\n      if (tid < nr) {\n",
     "      bar_sync(1, NTH);\n      if (threadIdx.x == 0) g_b7[11][blk] = gtime();\n"
     "      if (tid < nr) {\n"),
    ("      mbar_wait(rbar, ph);   // the router columns\n",
     "      if (threadIdx.x == 0) g_b7[12][blk] = gtime();\n"
     "      mbar_wait(rbar, ph);   // the router columns\n"),
    ("#pragma unroll\n    for (int h = 0; h < 2; ++h)\n#pragma unroll\n      for (int e = 0; e < 2; ++e)\n",
     "    if (threadIdx.x == 0) g_b7[13][blk] = gtime();\n"
     "#pragma unroll\n    for (int h = 0; h < 2; ++h)\n#pragma unroll\n      for (int e = 0; e < 2; ++e)\n"),
    ('}  // extern "C"', READER + '}  // extern "C"'),
]


def build() -> ctypes.CDLL:
    from deepsearch_tts_tpu_torch.ops import _build

    csrc = os.path.join(ROOT, "deepsearch_tts_tpu_torch", "ops", "csrc")
    with open(os.path.join(csrc, "fused_layer.cu")) as f:
        src = f.read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"trace_b7: kernel line not found once:\n{old}")
        src = src.replace(old, new, 1)
    src = src.replace('#include "hopper.cuh"', f'#include "{os.path.join(csrc, "hopper.cuh")}"')
    out = os.path.join(ROOT, "build", "trace_b7")
    os.makedirs(out, exist_ok=True)
    path, so = os.path.join(out, "fused_layer_b7.cu"), os.path.join(out, "libfused_layer_b7.so")
    with open(path, "w") as f:
        f.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"trace_b7: nvcc failed\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    lib.trace_read.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_b7: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    import chip_smoke as cs
    from deepsearch_tts_tpu_torch.ops import _build
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    lib = build()
    _build._libs["fused_layer"] = lib   # the wrappers launch the stamped copy
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, bf = torch.device("cuda"), torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    L, HD, E, NE = 8, cs.M_H * cs.D, cs.M_E, cs.M_NE
    wo, ln = rnd(L, HD, E, scale=HD ** -0.5), rnd(L, E, scale=0.1) + 1
    router = rnd(L, E, NE, scale=E ** -0.5)
    result: dict = {"card": card, "runs": []}
    for B in (1, cs.SLOTS, 64):
        a, x = rnd(B, HD), rnd(B, E)
        # every layer twice, layer 0 first, so that its weights are out of
        # L2 (7 x 17 MB read since), then layer 0 alone, traced
        for _ in range(2):
            for layer in range(L):
                fl.fused_out_router_stacked(a, x, wo, ln, router, layer)
        torch.cuda.synchronize()
        assert lib.trace_clear() == 0
        fl.fused_out_router_stacked(a, x, wo, ln, router, 0)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (NST * NBLK))()
        assert lib.trace_read(buf) == 0
        d = np.array(buf, dtype=np.int64).reshape(NST, NBLK)
        live = d[0] > 0
        t0 = d[0][live].min()
        row = {"B": B, "blocks": int(live.sum())}
        for k, name in enumerate(STAMPS):
            v = d[k][live & (d[k] > 0)]
            if v.size:
                us = (v - t0) / 1e3
                row[name] = [round(float(us.min()), 2), round(float(np.median(us)), 2),
                             round(float(us.max()), 2), int(v.size)]
        result["runs"].append(row)
        print(f"[b7-trace] {json.dumps(row)}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
