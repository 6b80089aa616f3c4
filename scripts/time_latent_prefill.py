#!/usr/bin/env python3
"""K3's prefill mode (``latent_prefill``, ``ops/csrc/attention.cu``) held
to its plain version, and what MLA's plain prefill attention costs a layer.

    python3 scripts/time_latent_prefill.py      (needs one CUDA card and nvcc)

Builds ``attention.cu`` (prints ptxas' registers and spills of K3 and of
the plan kernel, and the runtime's blocks an SM), then holds the prefill
mode to ``latent_prefill_plain`` at every ``LATENT_PREFILLS`` shape of
``chip_smoke.py`` at 128 and 64 heads under the smoke's rms-scaled bound
(untimed: ``chip_smoke.py`` times them). Then it times, at deepseek-v3's
128 heads, the attention MLA's prefills ran before the kernel took them:
the re-prefill's gather of the prefix before the chunk's write and
``prefix_chunk_attention`` (``models/deepseek_v3.py`` with ``impl="xla"``),
and the fresh prefill's ``causal_attention``, one layer, as CUDA-graph
replays between CUDA events, at the 4096 bucket (4096 tokens from 0 over 64
pages of 64) and the 3044-token prompt (48 pages): the share of a 5-layer
prefill program that attention was. Prints the card's name and power limit
first and one JSON line last.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_latent_prefill: no CUDA card")
    import chip_smoke as cs
    from deepsearch_tts_tpu_torch.ops import _build
    from deepsearch_tts_tpu_torch.ops import attention as attn_ops
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    card = cs.phase_env()
    _build.load_library("attention")
    for line in _build.build_log.get("attention", "").splitlines():
        if any(w in line for w in ("latent", "registers", "spill")):
            cs.log(f"[build] {line.strip()}")
    cs.log("[build] attention blocks an SM (runtime occupancy): "
           + ", ".join(f"{k} {v}" for k, v in pa.attention_occupancy().items()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    out: dict = {"card": card, "errors": {}}
    for label, B, T, starts, valid, ps, P, slot in cs.LATENT_PREFILLS:
        for H in (128, 64):
            q, pool, table, seq, pos = cs._latent_prefill_inputs(gen, B, T, starts, valid, ps,
                                                                 P, H, slot)
            kw = dict(page_table=table, row_offset=B if slot else 0, scale=cs.X_SCALE)
            one: dict = {}
            cs._check_kernel(one, "latent_prefill", f"{label} H={H}",
                             lambda: pa.latent_prefill(q, pool, seq, pos, **kw),
                             lambda: pa.latent_prefill_plain(q, pool, seq, pos, **kw),
                             rtol=cs.ATTN_RTOL, atol=cs.ATTN_ATOL, rms_frac=cs.ATTN_RMS_FRAC)
            out["errors"][f"{label} H={H}"] = one["latent_prefill"]["err"]
            del q, pool, table
        cs._free()
    # the parent's plain prefill attention, one layer at 128 heads
    H, KL = 128, cs.X_V
    out["plain_layer_ms"] = {}
    for label, T, P in (("4096 bucket", 4096, 64), ("3044-token prompt", 3044, 48)):
        q, pool, table, seq, pos = cs._latent_prefill_inputs(gen, 1, T, (0,), (T,), 64, P, H,
                                                             False)
        rows = pool[table[0]].reshape(1, P * 64, 1, cs.X_D)[:, :T]

        def reprefill():
            old = attn_ops.gather_kv_rows(pool, table).reshape(1, P * 64, 1, cs.X_D)
            return attn_ops.prefix_chunk_attention(q, old, old[..., :KL], rows, rows[..., :KL],
                                                   pos[:, 0], pos, scale=cs.X_SCALE)

        def fresh():
            return attn_ops.causal_attention(q, rows, rows[..., :KL], scale=cs.X_SCALE)

        r = {name: cs.time_ms(fn, iters=3)[0] for name, fn in (("reprefill", reprefill),
                                                               ("fresh", fresh))}
        out["plain_layer_ms"][label] = r
        cs.log(f"[plain] {label}, 128 heads, one layer: re-prefill (gather + "
               f"prefix_chunk_attention) {r['reprefill']:.3f} ms, fresh (causal_attention) "
               f"{r['fresh']:.3f} ms; 5 layers {5 * r['reprefill']:.1f} / {5 * r['fresh']:.1f} ms")
        del q, pool, table, rows
        cs._free()
    cs.log(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
