#!/usr/bin/env python3
"""Time the two routes of ``ops/quant.int8_matmul`` past 64 rows, to place
its crossover (``quant.INT8_PRODUCT_ROWS``).

    python3 scripts/time_int8_rows.py     (needs one CUDA card and nvcc)

At each qwen3-32b int8 product shape (the lm_head [5120, 151936] and the
four layer products) and 64 to 512 rows: B10's bare product
(``fused_layer.int8_product``, one launch a 64-row group, each streaming
the whole weight) against the widened route (``int8_product_plain``: the
weight widened to bf16 and one float32-accumulated ``torch.mm``). Random
int8 weights and scales from seed 0; each shape is cycled through enough
copies to exceed the 50 MB L2, as weights are read in serving. Each time is
a CUDA graph of the calls replayed between CUDA events
(``chip_smoke.time_ms``). Prints the card's name and power limit first,
one line a shape and row count, and one JSON line last: the times, and for
each shape the fewest rows at which the widened route is faster.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# qwen3-32b's int8 products: [K, N]
SHAPES = {"lm_head": (5120, 151936), "w_gateup": (5120, 51200), "wqkv": (5120, 10240),
          "wo": (8192, 5120), "w_down": (25600, 5120)}
ROWS = (64, 65, 80, 96, 128, 192, 256, 320, 384, 512)


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_int8_rows: torch.cuda.is_available() is False: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    out: dict = {"times": {}, "crossover": {}}
    for name, (K, N) in SHAPES.items():
        copies = max(1, -(-200 * 2**20 // (K * N)))   # > 200 MB of int8 in all
        ws = [(torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8),
               torch.rand((1, N), generator=gen, device=dev) / 1000) for _ in range(copies)]
        out["times"][name] = {}
        for B in ROWS:
            x = torch.randn((B, K), generator=gen, device=dev).to(bf)
            got, ref = fl.int8_product(x, *ws[0]), fl.int8_product_plain(x, *ws[0])
            torch.testing.assert_close(got.float(), ref.float(), rtol=cs.BF16_RTOL,
                                       atol=cs.BF16_ATOL)
            kernel = cs.time_ms(lambda: [fl.int8_product(x, q, s) for q, s in ws],
                                calls=copies, iters=10)[0]
            widened = cs.time_ms(lambda: [fl.int8_product_plain(x, q, s) for q, s in ws],
                                 calls=copies, iters=10)[0]
            bd = cs.bound(K * N + 4 * N + 2 * B * (K + N), 2 * B * K * N)
            out["times"][name][B] = {"kernel_ms": kernel, "widened_ms": widened, **bd}
            print(f"[int8_matmul] {name:8s} [{K}, {N}] B={B:3d} ({len(fl.i8_row_groups(B))} "
                  f"launches) | kernel {kernel:.4f} ms | widened + torch.mm {widened:.4f} ms | "
                  f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})", flush=True)
        faster = [B for B in ROWS if out["times"][name][B]["widened_ms"]
                  < out["times"][name][B]["kernel_ms"]]
        out["crossover"][name] = faster[0] if faster else None
        del ws
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
