#!/usr/bin/env python3
"""Sweeps that set two static choices of the port's Hopper kernels.

    python3 scripts/sweep_hopper_kernels.py     # needs one CUDA card

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


def main() -> int:
    import torch

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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
