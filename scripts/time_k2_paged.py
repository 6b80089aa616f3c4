#!/usr/bin/env python3
"""K2's paged mode (``flash_attention<true>`` and its plan kernel in
``ops/csrc/attention.cu``) and dense K2 beside a parent commit's kernels,
in one process on one card, and where each block's time goes.

    python3 scripts/time_k2_paged.py --prepare REV   (in a git checkout: the
                                                     parent's sources into
                                                     build/k2_parent/)
    python3 scripts/time_k2_paged.py [--no-trace] [--variant NAME]
                                                    (needs one CUDA card and nvcc)

``--prepare`` writes ``attention.cu`` and ``hopper.cuh`` of commit REV
(``git show``) into ``build/k2_parent/`` (ignored by git); the timing run
builds them there with the port's nvcc flags, so it also runs in a copy
without ``.git``. The parent's C entries are those of K2 before the
persistent grid: ``dstts_flash_attention(q, k, v, out, B, T, S, H, KV,
scale, stream)`` and ``dstts_flash_attention_paged(q, k, v, table, P,
seq_len, qpos, out, B, T, H, KV, R, ps, scale, stream)``.

For every ``PAGED_PREFILLS`` shape of ``chip_smoke.py`` (random bf16 pages
from seed 0, as the smoke makes them) and for dense K2 at B=1 T=3072
(qwen3-8b's 32 / 8 heads): the tree's kernel is held to its plain version
under the smoke's rms-scaled bound (the parent's on the real queries: it
kept JAX's tail-padding rule), then both are timed as CUDA-graph replays
between CUDA events in the order parent, tree, tree, parent, beside the
shape's bound (operations of the real queries' visible pairs, bytes of q,
out and each row's keys up to its largest limit). ``--variant NAME`` also
times a copy of the tree with one choice changed (``VARIANTS``: pieces of
``W / SMs`` tiles, ``pieces1``; the plan kernel on 256 threads,
``plan256``; no programmatic dependent launch, ``nopdl``) in the same
turns: parent, tree, copy, copy, tree, parent.

Unless ``--no-trace``, copies of both sources with ``%globaltimer`` stamps
(a copy made by replacing lines of the kernel; a change there stops the
script with the line it did not find) run each shape once more and give,
per block (the tree: per item of its persistent blocks), its start, its
first K tile ready, its last value product done and its stores issued, with
its SM (``%smid``). From them, in microseconds: the span (first start to
last store), the SMs' busy share of it (the sum of the blocks' or items'
start-to-store times an SM over the span: 1 - the idle share), the mean
wait from a start to its first K tile, the mean time from the last value
product to the stores issued, the mean time from one item's stores to the
block's next item, and items a block; for the tree, also the plan kernel's
phases (thread 0 after each of its block-wide barriers). The stamps cost a little
time themselves. Prints the card's name and power limit first and one JSON
line last.
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
PARENT = os.path.join(ROOT, "build", "k2_parent")
OUT = os.path.join(ROOT, "build", "k2_time")
NBLK, MAXIT, NST = 1024, 64, 4
STAMPS = ("start", "first K ready", "last PV done", "stores issued")
PLAN_STAMPS = ("start", "zeroed", "unit limits", "pieces and buckets", "items written")
STAMP_DEFS = (
    "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
    "__device__ __forceinline__ int smid() {\n  int s;\n"
    "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s));\n  return s;\n}\n"
    f"__device__ long long g_k2[{NST}][{NBLK}][{MAXIT}];\n__device__ int g_sm[{NBLK}];\n"
    f"__device__ long long g_plan[{len(PLAN_STAMPS)}];\n")
READER = ("int trace_plan(long long* out) {\n"
          "  return (int)cudaMemcpyFromSymbol(out, g_plan, sizeof(g_plan));\n}\n"
          "int trace_read(long long* out, int* sm) {\n"
          "  int e = (int)cudaMemcpyFromSymbol(out, g_k2, sizeof(g_k2));\n"
          "  return e ? e : (int)cudaMemcpyFromSymbol(sm, g_sm, sizeof(g_sm));\n}\n"
          f"int trace_clear() {{\n  static long long z[{NST}][{NBLK}][{MAXIT}];\n"
          "  return (int)cudaMemcpyToSymbol(g_k2, z, sizeof(z));\n}\n")


def _at(k: int, it: str, blk: str = "blockIdx.x") -> str:
    return (f"if (threadIdx.x == 0 && {blk} < {NBLK} && ({it}) < {MAXIT}) "
            f"g_k2[{k}][{blk}][{it}] = gtime();\n")


# copies of the tree with one choice changed, timed beside it (--variant)
VARIANTS = {
    "pieces1": [("constexpr int PIECES_PER_SM = 2;", "constexpr int PIECES_PER_SM = 1;")],
    "plan256": [("constexpr int PLAN_TH = 1024;", "constexpr int PLAN_TH = 256;")],
    "nopdl": [("constexpr int PDL = 1;", "constexpr int PDL = 0;")],
}


_ZEROED = "  for (int i = tid; i < nb; i += PLAN_TH) hist[i] = 0;\n  __syncthreads();\n"
_LIMITS = ("    if (u >= 0 && lane == __ffs(peers) - 1) atomicMax(&ulim[u], lm);\n  }\n"
           "  __syncthreads();\n")


def _plan_at(k: int) -> str:
    return f"  if (threadIdx.x == 0) g_plan[{k}] = gtime();\n"


# the tree: a persistent block, stamps a (block, item); the plan kernel's
# phases (thread 0, after each block-wide barrier)
TREE_EDITS = [
    ("  const int tid = threadIdx.x, lane = tid & 31;\n",
     "  const int tid = threadIdx.x, lane = tid & 31;\n" + _plan_at(0)),
    (_ZEROED, _ZEROED + _plan_at(1)),
    (_LIMITS, _LIMITS + _plan_at(2)),
    ("  __syncthreads();\n  // a warp a unit: its z * KV items",
     "  __syncthreads();\n" + _plan_at(3) + "  // a warp a unit: its z * KV items"),
    ("                                 z > 1 ? (sb + zi) * KV + kh : -1);\n    }\n  }\n",
     "                                 z > 1 ? (sb + zi) * KV + kh : -1);\n    }\n  }\n"
     "  __syncthreads();\n" + _plan_at(4)),
    ("// ------------------------------------------------------------------- K1\n",
     STAMP_DEFS + "// ------------------------------------------------------------------- K1\n"),
    ("      mbar_arrive(&meta_empty[it & 1]);\n",
     "      mbar_arrive(&meta_empty[it & 1]);\n      " + _at(0, "it") +
     f"      if (threadIdx.x == 0 && blockIdx.x < {NBLK}) g_sm[blockIdx.x] = smid();\n"),
    ("      bar_sync(1 + wg, 256);\n      issue_qk(g0);\n",
     "      mbar_wait(&k_full[g0 % FSTAGES], (g0 / FSTAGES) & 1);\n      " + _at(1, "it") +
     "      bar_sync(1 + wg, 256);\n      issue_qk(g0);\n"),
    ("      mbar_arrive(&empty[gl % FSTAGES]);\n      g0 += nt;\n",
     "      mbar_arrive(&empty[gl % FSTAGES]);\n      " + _at(2, "it") + "      g0 += nt;\n"),
    ("                  odd ? make_uint2(got, wo) : make_uint2(we, got);\n          }\n"
     "        }\n      }\n",
     "                  odd ? make_uint2(got, wo) : make_uint2(we, got);\n          }\n"
     "        }\n      }\n      " + _at(3, "it")),
    ('}  // extern "C"', READER + '}  // extern "C"'),
]
# the parent: one block a (kv head, row, query block), one stamp set a block
PBLK = "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))"
PARENT_EDITS = [
    ("// ------------------------------------------------------------------- K1\n",
     STAMP_DEFS + "// ------------------------------------------------------------------- K1\n"),
    ("  const int m = gridDim.z - 1 - blockIdx.z;        // the longest query tiles start first\n",
     "  const int m = gridDim.z - 1 - blockIdx.z;        // the longest query tiles start first\n"
     "  " + _at(0, "0", PBLK) +
     f"  if (threadIdx.x == 0 && {PBLK} < {NBLK}) g_sm[{PBLK}] = smid();\n"),
    ("    mbar_wait(q_full, 0);\n    bar_sync(1 + wg, 256);\n    issue_qk(0);\n",
     "    mbar_wait(q_full, 0);\n    mbar_wait(&k_full[0], 0);\n    " + _at(1, "0", PBLK) +
     "    bar_sync(1 + wg, 256);\n    issue_qk(0);\n"),
    ("    mbar_arrive(&empty[(ntiles - 1) % FSTAGES]);\n",
     "    mbar_arrive(&empty[(ntiles - 1) % FSTAGES]);\n    " + _at(2, "0", PBLK)),
    ("            o[4 * i + 2 * half] * inv, o[4 * i + 2 * half + 1] * inv);\n    }\n",
     "            o[4 * i + 2 * half] * inv, o[4 * i + 2 * half + 1] * inv);\n    }\n    " +
     _at(3, "0", PBLK)),
    ('}  // extern "C"', READER + '}  // extern "C"'),
]


def prepare(rev: str) -> None:
    os.makedirs(PARENT, exist_ok=True)
    for name in ("attention.cu", "hopper.cuh"):
        src = subprocess.run(["git", "show", f"{rev}:deepsearch_tts_tpu_torch/ops/csrc/{name}"],
                             cwd=ROOT, capture_output=True, text=True, check=True).stdout
        with open(os.path.join(PARENT, name), "w") as f:
            f.write(src)
    with open(os.path.join(PARENT, "REV"), "w") as f:
        f.write(rev + "\n")
    print(f"time_k2_paged: {rev}'s attention.cu and hopper.cuh in {PARENT}")


def build(src_dir: str, tag: str, edits=None) -> ctypes.CDLL:
    """nvcc of ``src_dir``/attention.cu (with ``edits`` applied) into
    build/k2_time/lib<tag>.so."""
    from deepsearch_tts_tpu_torch.ops import _build

    with open(os.path.join(src_dir, "attention.cu")) as f:
        src = f.read()
    for old, new in edits or ():
        if src.count(old) != 1:
            raise SystemExit(f"time_k2_paged ({tag}): kernel line not found once:\n{old}")
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
        raise SystemExit(f"time_k2_paged: nvcc failed on {tag}\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    if src_dir == PARENT:
        lib.dstts_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
        lib.dstts_flash_attention_paged.argtypes = [p, p, p, p, i, p, p, p, i, i, i, i, ll, i,
                                                    f, p]
    if any("trace_read" in new for _, new in edits or ()):
        lib.trace_read.argtypes = [p, p]
        lib.trace_plan.argtypes = [p]
    return lib


def parent_paged(lib, q, kp, vp, table, seq, pos):
    import torch

    out = torch.empty_like(q)
    B, T, H, D = q.shape
    R, ps, K, _ = kp.shape
    table, pos = table.long().contiguous(), pos.long().contiguous()

    def run():
        err = lib.dstts_flash_attention_paged(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(), table.shape[1],
            seq.data_ptr(), pos.data_ptr(), out.data_ptr(), B, T, H, K, R, ps, D ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    return run


def parent_dense(lib, q, k, v):
    import torch

    out = torch.empty_like(q)
    B, T, H, D = q.shape

    def run():
        err = lib.dstts_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        B, T, k.shape[1], H, k.shape[2], D ** -0.5,
                                        torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    return run


def stamps(lib, run) -> dict:
    """One stamped run: span, busy share, first-K wait, tail, items a block."""
    import torch

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count

    torch.cuda.synchronize()
    assert lib.trace_clear() == 0
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (NST * NBLK * MAXIT))()
    sm = (ctypes.c_int * NBLK)()
    assert lib.trace_read(buf, sm) == 0
    d = np.array(buf, dtype=np.int64).reshape(NST, NBLK, MAXIT)
    sms = np.array(sm)
    live = (d[0] > 0) & (d[3] > 0)          # items that ran to their stores
    if not live.any():
        return {}
    t0, t1 = d[0][live].min(), d[3][live].max()
    span = (t1 - t0) / 1e3
    busy = np.zeros(sms.max() + 1)
    np.add.at(busy, np.repeat(sms[:, None], MAXIT, 1)[live], (d[3] - d[0])[live] / 1e3)
    n_sm = int((busy > 0).sum())
    nxt = live[:, 1:] & live[:, :-1]          # an item and the block's next one
    gap = (d[0][:, 1:] - d[3][:, :-1])[nxt]
    return {"span_us": round(float(span), 2),
            "busy_share": round(float(busy.sum() / (n_sms * span)), 4),
            "sms_used": n_sm,
            "first_k_wait_us": round(float(((d[1] - d[0])[live]).mean() / 1e3), 2),
            "last_pv_to_stores_us": round(float(((d[3] - d[2])[live]).mean() / 1e3), 2),
            "stores_to_next_start_us": round(float(gap.mean() / 1e3), 2) if gap.size else None,
            "items": int(live.sum()),
            "items_a_block": round(float(live.sum() / max(1, (live.any(1)).sum())), 2),
            **plan_phases(lib)}


def plan_phases(lib) -> dict:
    """The plan kernel's phases of the last stamped call, in microseconds
    from its start (a copy without the plan's stamps: nothing)."""
    if not hasattr(lib, "trace_plan"):
        return {}
    buf = (ctypes.c_longlong * len(PLAN_STAMPS))()
    assert lib.trace_plan(buf) == 0
    t = np.array(buf, dtype=np.int64)
    if t[0] == 0:
        return {}
    return {"plan_us": {name: round(float(v - t[0]) / 1e3, 2)
                        for name, v in zip(PLAN_STAMPS[1:], t[1:])}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prepare", metavar="REV",
                    help="write REV's attention.cu and hopper.cuh into build/k2_parent/ "
                         "(git show) and stop")
    ap.add_argument("--no-trace", action="store_true", help="times only, no stamped copies")
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="also time a copy of the tree with one choice changed")
    opts = ap.parse_args()
    if opts.prepare:
        prepare(opts.prepare)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_k2_paged: needs a CUDA card")
    if not os.path.exists(os.path.join(PARENT, "attention.cu")):
        raise SystemExit(f"time_k2_paged: no parent sources in {PARENT}: run --prepare REV "
                         "in a git checkout first")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with open(os.path.join(PARENT, "REV")) as f:
        rev = f.read().strip()
    import chip_smoke as cs
    from deepsearch_tts_tpu_torch.ops import _build
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa

    parent = build(PARENT, "parent")
    real_lib = _build.load_library("attention")
    if opts.variant:
        pieces_lib = build(CSRC, opts.variant, VARIANTS[opts.variant])
    tree_src = CSRC
    traced = {}
    if not opts.no_trace:
        traced = {"tree": build(tree_src, "tree_stamped", TREE_EDITS),
                  "parent": build(PARENT, "parent_stamped", PARENT_EDITS)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    D = cs.D
    result: dict = {"card": card, "parent": rev, "shapes": {}}

    def timed(runs: dict) -> dict:
        order = ["parent", "tree", "copy", "copy", "tree", "parent"]
        ms = {k: [] for k in runs}
        for k in order:
            if k not in runs:
                continue
            if k == "copy":   # the wrapper launches the copy
                _build._libs["attention"] = pieces_lib
            ms[k].append(cs.time_ms(runs[k], iters=20)[0])
            _build._libs["attention"] = real_lib
        return {k: [round(x, 4) for x in v] for k, v in ms.items()}

    for label, B, T, starts, valid, ps, P, (h, kv), slot in cs.PAGED_PREFILLS:
        q, kp, vp, table, seq, pos = cs._paged_prefill_inputs(gen, B, T, starts, valid, ps, P,
                                                              (h, kv), slot)
        S = P * ps
        lim = fa.paged_key_limits(seq, pos, S, h // kv)
        real = pos >= 0
        ref = fa.flash_attention_paged_plain(q, kp, vp, table, seq, pos)
        tree = lambda: fa.flash_attention_paged(q, kp, vp, table, seq, pos)  # noqa: E731
        par = parent_paged(parent, q, kp, vp, table, seq, pos)
        use = cs._bound_use(tree(), ref, cs.ATTN_RTOL, cs.ATTN_ATOL, cs.ATTN_RMS_FRAC)
        ref_real = torch.where(real[..., None, None], ref, 0)
        use_p = cs._bound_use(torch.where(real[..., None, None], par(), 0), ref_real,
                              cs.ATTN_RTOL, cs.ATTN_ATOL, cs.ATTN_RMS_FRAC)
        assert use <= 1.0 and use_p <= 1.0, (label, use, use_p)
        nbytes = (int(lim.amax(1).sum()) * kv * D * 2 * 2 + 2 * B * T * h * D * 2
                  + B * (T + P + 1) * 8)
        runs = {"parent": par, "tree": tree}
        if opts.variant:
            _build._libs["attention"] = pieces_lib
            use_c = cs._bound_use(tree(), ref, cs.ATTN_RTOL, cs.ATTN_ATOL, cs.ATTN_RMS_FRAC)
            _build._libs["attention"] = real_lib
            assert use_c <= 1.0, (label, "copy", use_c)
            runs["copy"] = tree
        row = {"bound_use": round(use, 3), "parent_bound_use_real": round(use_p, 3),
               **cs.bound(nbytes, 4 * h * D * int(lim[real].sum())), "ms": timed(runs)}
        row["tree_ms"] = round(float(np.mean(row["ms"]["tree"])), 4)
        row["parent_ms"] = round(float(np.mean(row["ms"]["parent"])), 4)
        if traced:   # the wrappers launch the stamped copy for one run
            _build._libs["attention"] = traced["tree"]
            row["tree_trace"] = stamps(traced["tree"], tree)
            _build._libs["attention"] = real_lib
            row["parent_trace"] = stamps(traced["parent"], parent_paged(
                traced["parent"], q, kp, vp, table, seq, pos))
        result["shapes"][label] = row
        print(f"[k2-paged] {label}: {json.dumps(row)}", flush=True)
        del q, kp, vp, ref

    B, T, H, KV = 1, 3072, cs.H, cs.KV
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, KV, D), generator=gen, device="cuda").to(torch.bfloat16)
    ref = fa.flash_attention_plain(q, k, v)
    tree = lambda: fa.flash_attention(q, k, v)  # noqa: E731
    par = parent_dense(parent, q, k, v)
    uses = [cs._bound_use(f(), ref, cs.ATTN_RTOL, cs.ATTN_ATOL, cs.ATTN_RMS_FRAC)
            for f in (tree, par)]
    assert max(uses) <= 1.0, uses
    row = {"bound_use": round(uses[0], 3),
           **cs.bound(2 * B * T * D * (2 * H + 2 * KV), 4 * B * H * D * T * (T + 1) // 2),
           "ms": timed({"parent": par, "tree": tree})}
    row["tree_ms"] = round(float(np.mean(row["ms"]["tree"])), 4)
    row["parent_ms"] = round(float(np.mean(row["ms"]["parent"])), 4)
    if traced:
        _build._libs["attention"] = traced["tree"]
        row["tree_trace"] = stamps(traced["tree"], tree)
        _build._libs["attention"] = real_lib
        row["parent_trace"] = stamps(traced["parent"], parent_dense(traced["parent"], q, k, v))
    result["dense B=1 T=3072"] = row
    print(f"[k2-dense] B=1 T=3072: {json.dumps(row)}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
