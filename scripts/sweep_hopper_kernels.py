#!/usr/bin/env python3
"""Sweeps that set static choices of the port's Hopper kernels.

    python3 scripts/sweep_hopper_kernels.py             # needs one CUDA card
    python3 scripts/sweep_hopper_kernels.py --int8-only  # section 3 alone

1. The grouped expert FFN's crossover (``ops/moe.PREFILL_ROWS_PER_EXPERT``):
   the decode kernel (``grouped_expert``) and the prefill kernel
   (``grouped_expert_tc``), each forced by setting that constant (to no
   row, or to more rows than any call has) around the wrappers, timed at
   qwen3-30b-a3b (128 experts, E = 2048, F = 768) and deepseek-v3 (256
   experts, E = 7168, F = 2048) widths over T tokens x top-8 with random
   routing, from 16 tokens to 3072.
2. K3's least chunk (``ops/paged_attention.LATENT_MIN_CHUNK_TILES``): K3
   through B1's entry (``slot_attention`` with ``v_pool=None``) at
   deepseek-v3's 128 heads, B = 1 (one full 4096-key row), 16 and 64
   (``chip_smoke.LIMITS`` rows), at least 2, 4, 8 and 16 key tiles a split.
3. B10's int8 product (``ops/fused_layer.I8_STAGES`` and the tile width
   of ``csrc`` ``i8_tile_cols``): B10-qkv and B10-out walked over a
   four-layer qwen3-32b int8 stack and the bare product at the lm_head
   shape, B = 1 and 16, at 4, 6 and 8 ring stages; and the bare product at
   every qwen3-32b shape with the tile width forced to 128 and to 256
   columns (two copies of ``fused_layer.cu`` whose ``i8_tile_cols`` returns
   that width, built into ``build/sweep_i8/``).

Times are CUDA-graph replays between CUDA events (``chip_smoke.time_ms``);
the card's name and power limit are printed first. Prints one JSON line
last.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sweep_int8(cs, out: dict) -> None:
    """Section 3: B10's static choices at qwen3-32b widths."""
    import ctypes
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import _build
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    E, H, KV, F, D, L = cs.Q_E, cs.Q_H, cs.Q_KV, cs.Q_F, cs.D, 4

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def i8(L, K, N):
        q = torch.randint(-127, 128, (L, K, N), generator=gen, device=dev, dtype=torch.int8)
        return q, torch.rand((L, 1, N), generator=gen, device=dev) / 73 / K ** 0.5

    C = (H + 2 * KV) * D
    ln1, ln2 = rnd(L, E, scale=0.1) + 1, rnd(L, E, scale=0.1) + 1
    qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
    wq, ws = i8(L, E, C)
    woq, wos = i8(L, H * D, E)
    guq, gus = i8(L, E, 2 * F)
    wdq, wds = i8(L, F, E)
    hq, hs = i8(1, E, cs.V)
    kw = dict(n_heads=H, n_kv=KV, head_dim=D, eps=1e-6)
    kept = dict(fl.I8_STAGES)
    out["int8"] = {}
    for B in (1, 16):
        x, a, xl = rnd(B, E), rnd(B, H * D), rnd(B, E)
        cos, sin = rope_angles(torch.arange(B, device=dev), D, 1e6)
        aq, ao = (x, ln1, wq, ws, qn, kn, cos, sin), (a, x, woq, wos, ln2, guq, gus, wdq, wds)
        mt = fl.i8_m_tiles(B)
        for st in (4, 6, 8):
            fl.I8_STAGES[mt] = st
            tq = cs.time_ms(lambda: [fl.fused_qkv_stacked_i8(*aq, l, **kw)
                                     for l in range(L)], calls=L)[0]
            to = cs.time_ms(lambda: [fl.fused_out_mlp_stacked_i8(*ao, l, eps=1e-6)
                                     for l in range(L)], calls=L)[0]
            tl = cs.time_ms(lambda: fl.int8_product(xl, hq[0], hs[0]), iters=20)[0]
            cs.log(f"[int8] B={B:2d} ring stages {st}: B10-qkv {tq:.4f} "
                   f"B10-out {to:.4f} lm_head {tl:.4f} ms")
            out["int8"][f"B={B} stages {st}"] = (tq, to, tl)
        fl.I8_STAGES.update(kept)
    # the tile width, forced in two copies of the source
    csrc = os.path.join(ROOT, "deepsearch_tts_tpu_torch", "ops", "csrc")
    with open(os.path.join(csrc, "fused_layer.cu")) as f:
        src = f.read()
    choice = "int i8_tile_cols(int N, bool swiglu) { return !swiglu && N <= 51200 ? 128 : 256; }"
    if choice not in src:
        raise SystemExit(f"sweep_hopper_kernels: line not found in fused_layer.cu:\n{choice}")
    os.makedirs(os.path.join(ROOT, "build", "sweep_i8"), exist_ok=True)
    tick = torch.zeros(4096, dtype=torch.int32, device=dev)
    shapes = [("wqkv", E, C), ("wo", H * D, E), ("w_gateup", E, 2 * F), ("w_down", F, E),
              ("lm_head", E, cs.V)]
    mats = {n: i8(1, K, N) for n, K, N in shapes if n != "lm_head"}
    mats["lm_head"] = (hq, hs)
    for tw in (128, 256):
        cu = os.path.join(ROOT, "build", "sweep_i8", f"fused_layer_tw{tw}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(choice, "int i8_tile_cols(int N, bool swiglu) { return swiglu "
                                f"? 256 : {tw}; }}"))
        so = os.path.join(ROOT, "build", "sweep_i8", f"libfused_layer_tw{tw}.so")
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"sweep_hopper_kernels: nvcc failed\n{r.stderr[-3000:]}")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dstts_int8_matmul.argtypes = [p] * 6 + [i] * 5 + [p]
        for B in (1, 16):
            row = {}
            for name, K, N in shapes:
                w, s = mats[name]
                x = rnd(B, K)
                y = torch.empty((B, N), dtype=bf, device=dev)
                grid, st = fl.i8_plan(B, dev)
                part = torch.empty((grid, B, 256), dtype=torch.float32, device=dev)

                def run():
                    assert lib.dstts_int8_matmul(
                        x.data_ptr(), w.data_ptr(), s.data_ptr(), part.data_ptr(),
                        tick.data_ptr(), y.data_ptr(), B, K, N, grid, st,
                        torch.cuda.current_stream().cuda_stream) == 0
                row[name] = cs.time_ms(run, iters=20)[0]
            cs.log(f"[int8] tile width {tw} B={B:2d}: " +
                   ", ".join(f"{n} {t:.4f} ms" for n, t in row.items()))
            out["int8"][f"tile width {tw} B={B}"] = row


def main() -> int:
    import argparse
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--int8-only", action="store_true", help="run section 3 alone")
    args = ap.parse_args()

    import chip_smoke as cs
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    if not torch.cuda.is_available():
        raise SystemExit("sweep_hopper_kernels: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cs.log(card)
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    out: dict = {"card": card, "grouped": {}, "latent": {}}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    if args.int8_only:
        sweep_int8(cs, out)
        print(json.dumps(out))
        return 0
    # 1. the grouped expert kernels on either side of the crossover
    kept_rows = moe.PREFILL_ROWS_PER_EXPERT
    for model, (NE, E, F, tokens) in (
            ("qwen3-30b-a3b", (128, 2048, 768, (16, 64, 128, 256, 384, 512, 768, 1024, 3072))),
            ("deepseek-v3", (256, 7168, 2048, (16, 128, 256, 512, 768, 1024, 2048, 3072)))):
        wgu = torch.empty((NE, E, 2 * F), dtype=bf, device=dev)
        wd = torch.empty((NE, F, E), dtype=bf, device=dev)
        for e in range(0, NE, 32):
            wgu[e:e + 32] = rnd(min(32, NE - e), E, 2 * F, scale=E ** -0.5)
            wd[e:e + 32] = rnd(min(32, NE - e), F, E, scale=F ** -0.5)
        for T in tokens:
            logits = torch.randn((T, NE), generator=gen, device=dev) * 2
            _, top_e = moe.route_topk(logits, 8)
            flat_e = top_e.reshape(-1)
            offsets = moe.group_offsets(flat_e, NE)
            xs = rnd(T, E)[torch.argsort(flat_e, stable=True) // 8]
            h = moe.grouped_gateup_plain(xs, wgu, None, offsets)
            chosen = "prefill" if moe.grouped_prefill(8 * T, NE, E, F) else "decode"
            row = {}
            for kind, rows in (("decode", 1 << 30), ("prefill", 0)):
                moe.PREFILL_ROWS_PER_EXPERT = rows
                g = cs.time_ms(lambda: moe.grouped_gateup(xs, wgu, None, offsets), iters=20)[0]
                d = cs.time_ms(lambda: moe.grouped_down(h, wd, offsets), iters=20)[0]
                row[kind] = (g, d)
            moe.PREFILL_ROWS_PER_EXPERT = kept_rows
            cs.log(f"[grouped] {model} T={T:5d} rows/expert {8 * T / NE:7.2f} | decode "
                   f"{row['decode'][0]:.4f} / {row['decode'][1]:.4f} ms | prefill "
                   f"{row['prefill'][0]:.4f} / {row['prefill'][1]:.4f} ms | wrapper takes "
                   f"{chosen}")
            out["grouped"][f"{model} T={T}"] = row
        del wgu, wd
        cs._free()

    # 2. K3's least chunk
    ctx, kw = cs.CTX, dict(slot_ctx=cs.CTX, scale=cs.X_SCALE, v_width=cs.X_V)
    kept = pa.LATENT_MIN_CHUNK_TILES
    for B in (1, 16, 64):
        lims = [ctx] if B == 1 else cs.LIMITS * (B // 16)
        pool = rnd(B, ctx, 1, cs.X_D)
        q, lim = rnd(B, 128, cs.X_D), torch.tensor(lims, device=dev)
        row = {}
        for tiles in (2, 4, 8, 16):
            pa.LATENT_MIN_CHUNK_TILES = tiles
            splits = pa.latent_splits(B, 2, ctx, pa._sm_count(torch.device("cuda")))
            row[tiles] = (cs.time_ms(lambda: sa.slot_attention(q, pool, None, lim, 0, n_rows=B,
                                                               **kw), iters=20)[0], splits)
        pa.LATENT_MIN_CHUNK_TILES = kept
        cs.log(f"[latent] H=128 B={B:3d} keys {sum(max(x, 1) for x in lims):6d} | " +
               " | ".join(f"min {t} tiles: {ms:.4f} ms (splits {sp[0]} x {sp[1]} keys)"
                          for t, (ms, sp) in row.items()))
        out["latent"][f"B={B}"] = {t: ms for t, (ms, _) in row.items()}
        del pool, q
        cs._free()
    # 3. B10's int8 product
    sweep_int8(cs, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
