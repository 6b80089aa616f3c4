#!/usr/bin/env python3
"""Where a ring stage of the grouped expert prefill kernel spends its time.

    python3 scripts/trace_grouped_prefill.py     # needs one CUDA card and nvcc

Builds a copy of ``ops/csrc/fused_layer.cu`` with ``%globaltimer`` stamps
added to ``grouped_expert_tc`` (block 0 of the gate|up entry, its first 512
ring stages) into ``build/trace/``, runs it once at qwen3-30b-a3b widths
(3072 tokens x top-8 over 128 experts, random routing from seed 0) and
prints, averaged over stages 40..339: the stage period, how long the
producer waits for a free stage, how long each consumer warpgroup waits for
its data, issues its wgmma products (the issue blocks while the tensor
cores are busy) and waits for them, and the rest of its loop (the
epilogue's share included). The stamps cost a little time themselves.

The copy is made by replacing lines of the kernel's source; a change there
makes this script stop with the line it did not find.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "deepsearch_tts_tpu_torch", "ops", "csrc")

STAMPS = ["producer_wait_start", "producer_wait_done", "wg0_wait_start", "wg0_full",
          "wg1_wait_start", "wg1_full", "wg0_issued", "wg0_mma_done", "wg1_issued",
          "wg1_mma_done"]
ON = "SWIGLU && blockIdx.x == 0 && it < 512"
EDITS = [
    ("__device__ __forceinline__ float swiglu_fast(float g, float u) {",
     "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
     f"__device__ long long g_stamp[{len(STAMPS)}][512];\n"
     "__device__ __forceinline__ float swiglu_fast(float g, float u) {"),
    ("          if (it >= XSTAGES) mbar_wait(&empty[s], (it / XSTAGES - 1) & 1);",
     f"          if ({ON}) g_stamp[0][it] = gtime();\n"
     "          if (it >= XSTAGES) mbar_wait(&empty[s], (it / XSTAGES - 1) & 1);\n"
     f"          if ({ON}) g_stamp[1][it] = gtime();"),
    ("        mbar_wait(&full[s], (it / XSTAGES) & 1);\n        const unsigned char* a",
     f"        if ({ON} && (tid & 127) == 0) g_stamp[2 + 2 * wg][it] = gtime();\n"
     "        mbar_wait(&full[s], (it / XSTAGES) & 1);\n"
     f"        if ({ON} && (tid & 127) == 0) g_stamp[3 + 2 * wg][it] = gtime();\n"
     "        const unsigned char* a"),
    ("        wgmma_commit();\n        wgmma_wait<0>();",
     f"        wgmma_commit();\n        if ({ON} && (tid & 127) == 0) "
     "g_stamp[6 + 2 * wg][it] = gtime();\n        wgmma_wait<0>();\n"
     f"        if ({ON} && (tid & 127) == 0) g_stamp[7 + 2 * wg][it] = gtime();"),
    ('}  // extern "C"',
     "int trace_read(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));\n}\n"
     '}  // extern "C"'),
]


def build() -> ctypes.CDLL:
    from deepsearch_tts_tpu_torch.ops import _build

    with open(os.path.join(CSRC, "fused_layer.cu")) as f:
        src = f.read()
    for old, new in EDITS:
        if old not in src:
            raise SystemExit(f"trace_grouped_prefill: kernel line not found:\n{old}")
        src = src.replace(old, new, 1)
    src = src.replace('#include "hopper.cuh"',
                      f'#include "{os.path.join(CSRC, "hopper.cuh")}"')
    out = os.path.join(ROOT, "build", "trace")
    os.makedirs(out, exist_ok=True)
    path, so = os.path.join(out, "fused_layer_trace.cu"), os.path.join(out, "libtrace.so")
    with open(path, "w") as f:
        f.write(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"trace_grouped_prefill: nvcc failed\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dstts_grouped_gateup_tc.argtypes = [p] * 4 + [i] * 6 + [p, p]
    lib.trace_read.argtypes = [p]
    return lib


def main() -> int:
    import torch

    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops.paged_attention import _sm_count

    if not torch.cuda.is_available():
        raise SystemExit("trace_grouped_prefill: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, bf = torch.device("cuda"), torch.bfloat16
    NE, E, F, T = 128, 2048, 768, 3072
    wgu = (torch.randn((NE, E, 2 * F), generator=gen, device=dev) * E ** -0.5).to(bf)
    _, top_e = moe.route_topk(torch.randn((T, NE), generator=gen, device=dev) * 2, 8)
    flat_e = top_e.reshape(-1)
    offsets = moe.group_offsets(flat_e, NE)
    S = T * 8
    xs = torch.randn((S, E), generator=gen, device=dev).to(bf)
    h = torch.empty((S, F), dtype=bf, device=dev)

    def run():
        err = lib.dstts_grouped_gateup_tc(
            xs.data_ptr(), offsets.data_ptr(), wgu.data_ptr(), wgu.data_ptr() + F * 2, 2 * F,
            NE, E, F, S, _sm_count(dev), h.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    buf = (ctypes.c_longlong * (len(STAMPS) * 512))()
    assert lib.trace_read(buf) == 0
    d = np.array(buf, dtype=np.int64).reshape(len(STAMPS), 512).astype(np.float64) / 1e3
    st = dict(zip(STAMPS, d))
    sl, nxt = slice(40, 340), slice(41, 341)

    def mean(a, b, later=sl):   # microseconds from stamp a to stamp b
        return (st[b][later] - st[a][sl]).mean()

    print(f"one traced call: {a.elapsed_time(b):.4f} ms; block 0, stages 40..339, microseconds")
    print(f"stage period {np.diff(st['wg0_full'][40:341]).mean():.3f}; producer waits for a "
          f"free stage {mean('producer_wait_start', 'producer_wait_done'):.3f}")
    for wg in ("wg0", "wg1"):
        print(f"{wg}: waits for data {mean(wg + '_wait_start', wg + '_full'):.3f}, issues its "
              f"products {mean(wg + '_full', wg + '_issued'):.3f}, waits for them "
              f"{mean(wg + '_issued', wg + '_mma_done'):.3f}, rest of the loop "
              f"{mean(wg + '_mma_done', wg + '_wait_start', nxt):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
