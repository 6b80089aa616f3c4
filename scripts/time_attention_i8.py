#!/usr/bin/env python3
"""K1's and K2's int8 modes (``ops/csrc/attention.cu``) held to their plain
versions and timed at qwen3-32b's widths, and K1's and K2's bf16 paged
modes beside a parent commit's kernels, in one process on one card.

    python3 scripts/time_attention_i8.py --prepare REV   (in a git checkout:
                                                         REV's sources into
                                                         build/attn_parent/)
    python3 scripts/time_attention_i8.py [--no-parent]  (needs one CUDA card
                                                         and nvcc)

``--prepare`` writes ``attention.cu`` and ``hopper.cuh`` of commit REV
(``git show``) into ``build/attn_parent/`` (ignored by git); the timing run
builds them there with the port's nvcc flags, so it also runs in a copy
without ``.git``. The parent must have this tree's bf16 C entries
(``dstts_decode_attention``, ``dstts_flash_attention_paged`` and the plan
and merge entries, as since the persistent paged grid).

The run prints the card's name and power limit, ptxas' registers and
spills of the attention kernels and the runtime's blocks an SM; then the
int8 modes at the smoke's shapes (``chip_smoke._check_int8_decode``: B = 16
decode rows over 64 pages of 64 int8 keys, the B6 rows' ragged lengths and
K1's own; ``chip_smoke.I8_PREFILLS``: the 3044-token prompt, the ragged
16 x 64 group, 100 tokens after 3000 cached), each held to its plain
version under the smoke's rms-scaled bound and timed beside it, its bound
and SDPA over the pre-dequantized context; the int8 paged mode again at
those prefill shapes and at the 4096 bucket's (:data:`BUCKET`), beside its
first launch (``widen_kv_pages``) alone and the bf16 paged mode over the
same pages unquantized; then (unless ``--no-parent``)
the bf16 modes, K1 through ``pallas_paged_attention`` at qwen3-8b's
and qwen3-32b's heads over the B6 rows, dense K2 at B = 1, T = 3072
(qwen3-8b's heads) and K2's paged mode at every
``chip_smoke.PAGED_PREFILLS`` shape, each held to its plain version, then
timed as the tree's kernel and the parent's (the same wrappers over the
parent's library) in the order parent, tree, tree, parent. One JSON line
last. ``scripts/time_k1_i8.py`` times K1's int8 mode against a parent's
and takes its timeline.
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
PARENT = os.path.join(ROOT, "build", "attn_parent")
# the C entries the bf16 wrappers call, which the parent must have
BF16_ENTRIES = ("dstts_decode_attention", "dstts_flash_attention", "dstts_flash_attention_paged",
                "dstts_flash_paged_plan", "dstts_flash_paged_merge")


def prepare(rev: str) -> None:
    os.makedirs(PARENT, exist_ok=True)
    for name in ("attention.cu", "hopper.cuh"):
        src = subprocess.run(["git", "show", f"{rev}:deepsearch_tts_tpu_torch/ops/csrc/{name}"],
                             cwd=ROOT, capture_output=True, text=True, check=True).stdout
        with open(os.path.join(PARENT, name), "w") as f:
            f.write(src)
    with open(os.path.join(PARENT, "REV"), "w") as f:
        f.write(rev + "\n")
    print(f"time_attention_i8: {rev}'s attention.cu and hopper.cuh in {PARENT}")


def build_parent(tree_lib) -> ctypes.CDLL:
    """nvcc of the parent's attention.cu with the port's flags; its bf16
    entries typed as the tree's (the wrappers then run on it)."""
    from deepsearch_tts_tpu_torch.ops import _build

    so = os.path.join(PARENT, "libattention_parent.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(PARENT, "attention.cu")], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"time_attention_i8: nvcc failed on the parent\n{r.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    for name in BF16_ENTRIES:
        fn, ref = getattr(lib, name), getattr(tree_lib, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    lib._dstts_typed = True
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prepare", metavar="REV",
                    help="write REV's attention.cu and hopper.cuh into build/attn_parent/ "
                         "(git show) and stop")
    ap.add_argument("--no-parent", action="store_true",
                    help="the int8 modes only, no parent build or bf16 timing")
    opts = ap.parse_args()
    if opts.prepare:
        prepare(opts.prepare)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_attention_i8: needs a CUDA card")
    if not opts.no_parent and not os.path.exists(os.path.join(PARENT, "attention.cu")):
        raise SystemExit(f"time_attention_i8: no parent sources in {PARENT}: run --prepare REV "
                         "in a git checkout first, or pass --no-parent")
    import chip_smoke as cs
    from deepsearch_tts_tpu_torch.ops import _build
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    card = cs.phase_env()
    tree = pa._lib()
    for line in _build.build_log.get("attention", "").splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
            print(f"[build] attention: {line.strip()}", flush=True)
    print("[build] attention blocks an SM: " + json.dumps(pa.attention_occupancy()), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res: dict = {}
    cs._check_int8_decode(res, gen)
    cs._check_paged_prefills(res, gen, cs.I8_PREFILLS, "flash_attention_paged_i8")
    result = {"card": card, "k1_i8": res["decode_attention_i8_shapes"],
              "k2_paged_i8": res["flash_attention_paged_i8_shapes"]}
    result["widen"] = time_widen(cs, gen)
    if opts.no_parent:
        print(json.dumps(result))
        return 0

    with open(os.path.join(PARENT, "REV")) as f:
        result["parent"] = f.read().strip()
    parent = build_parent(tree)
    libs = {"parent": parent, "tree": tree}

    def timed(fn, ref) -> dict:
        """Each library's output under the bound, then its ms in the order
        parent, tree, tree, parent."""
        row = {}
        for name, lib in libs.items():
            _build._libs["attention"] = lib
            row[f"{name}_bound_use"] = round(cs._bound_use(fn(), ref, cs.ATTN_RTOL, cs.ATTN_ATOL,
                                                           cs.ATTN_RMS_FRAC), 3)
            assert row[f"{name}_bound_use"] <= 1.0, (name, row)
        ms = {"parent": [], "tree": []}
        for name in ("parent", "tree", "tree", "parent"):
            _build._libs["attention"] = libs[name]
            ms[name].append(cs.time_ms(fn, iters=20)[0])
        _build._libs["attention"] = tree
        row.update({f"{k}_ms": round(float(np.mean(v)), 4) for k, v in ms.items()}, ms=ms)
        return row

    bf16 = {}
    ps, P = 64, cs.CTX // 64
    NP = 1 + cs.SLOTS * P
    seq = torch.tensor(cs.SEQS, device="cuda")
    perm = torch.randperm(NP - 1, generator=gen, device="cuda")[: cs.SLOTS * P].view(cs.SLOTS, P)
    used = (seq + ps - 1) // ps
    table = torch.where(torch.arange(P, device="cuda")[None] < used[:, None], perm + 1, 0)
    qpos = (seq - 1)[:, None]
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    kp, vp = rnd(NP, ps, cs.KV, cs.D), rnd(NP, ps, cs.KV, cs.D)
    for h in (cs.H, cs.Q_H):
        q = rnd(cs.SLOTS, 1, h, cs.D)
        ref = pa.pallas_paged_attention_plain(q, kp, vp, table, seq, qpos)
        row = timed(lambda: pa.pallas_paged_attention(q, kp, vp, table, seq, qpos), ref)
        label = f"K1 B={cs.SLOTS} T=1 H={h} KV={cs.KV} ps={ps} P={P} (SEQS)"
        bf16[label] = row
        print(f"[bf16] {label}: {json.dumps(row)}", flush=True)
    del kp, vp
    q, k, v = rnd(1, 3072, cs.H, cs.D), rnd(1, 3072, cs.KV, cs.D), rnd(1, 3072, cs.KV, cs.D)
    row = timed(lambda: fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v))
    bf16["K2 B=1 T=3072"] = row
    print(f"[bf16] K2 B=1 T=3072 H={cs.H} KV={cs.KV}: {json.dumps(row)}", flush=True)
    del q, k, v
    for label, B, T, starts, valid, ps, P, heads, slot in cs.PAGED_PREFILLS:
        q, kp, vp, table, seq, pos = cs._paged_prefill_inputs(gen, B, T, starts, valid, ps, P,
                                                              heads, slot)
        ref = fa.flash_attention_paged_plain(q, kp, vp, table, seq, pos)
        row = timed(lambda: fa.flash_attention_paged(q, kp, vp, table, seq, pos), ref)
        bf16[f"K2 paged {label}"] = row
        print(f"[bf16] K2 paged {label}: {json.dumps(row)}", flush=True)
        del q, kp, vp, ref
    result["bf16"] = bf16
    print(json.dumps(result))
    return 0


# the engine's one-row prefill program at the 4096 bucket: the long prompt's
# 3044 tokens padded to 4096 over the bucket's 64 pages
BUCKET = ("B=1 T=4096 bucket: 3044 tokens from 0 over 64 pages", 1, 4096, (0,), (3044,), 64, 64)


def time_widen(cs, gen) -> dict:
    """K2's int8 paged mode at ``I8_PREFILLS`` and :data:`BUCKET`
    (qwen3-32b's heads), held to its plain version: the mode's ms, its
    first launch (``widen_kv_pages``) alone, the bf16 paged mode over the
    same pages unquantized (what the widening adds), and the bf16 scratch
    the widening fills, in MB."""
    from deepsearch_tts_tpu_torch.engine.kvcache import quantize_kv_rows
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa

    out = {}
    for label, B, T, starts, valid, ps, P in [s[:7] for s in cs.I8_PREFILLS] + [BUCKET]:
        q, kp, vp, table, seq, pos = cs._paged_prefill_inputs(gen, B, T, starts, valid, ps, P,
                                                              (cs.Q_H, cs.Q_KV), False)
        row = {"bf16_ms": round(cs.time_ms(
            lambda: fa.flash_attention_paged(q, kp, vp, table, seq, pos), iters=20)[0], 4)}
        (kp, ks), (vp, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
        args = (q, kp, vp, table, seq, pos)
        ref = fa.flash_attention_paged_plain(*args, k_scales=ks, v_scales=vs)
        fn = lambda: fa.flash_attention_paged(*args, k_scales=ks, v_scales=vs)  # noqa: E731
        row["bound_use"] = round(cs._bound_use(fn(), ref, cs.ATTN_RTOL, cs.ATTN_ATOL,
                                               cs.ATTN_RMS_FRAC), 3)
        assert row["bound_use"] <= 1.0, (label, row)
        row["int8_ms"] = round(cs.time_ms(fn, iters=20)[0], 4)
        row["widen_launch_ms"] = round(cs.time_ms(
            lambda: fa.widen_kv_pages(kp, vp, ks, vs, table, seq), iters=20)[0], 4)
        row["scratch_mb"] = round(2 * B * P * ps * cs.Q_KV * cs.D * 2 / 1e6, 1)
        out[label] = row
        print(f"[widen] K2 int8 {label}: {json.dumps(row)}", flush=True)
        del q, kp, vp, ref
    return out


if __name__ == "__main__":
    sys.exit(main())
