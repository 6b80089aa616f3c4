#!/usr/bin/env python3
"""Time B7 (``fused_out_router_stacked``) and B5 (``sampling_prep``) of a
checkout of the port at B = 1, 16 and 64, for comparing two trees on one
card.

    python3 scripts/time_b7_b5.py                 # this checkout's kernels
    python3 scripts/time_b7_b5.py --tree DIR      # the kernels of the checkout at DIR
    (needs one CUDA card and nvcc)

``--tree DIR`` imports the package of the checkout at DIR, which builds its
kernels into DIR's own ``build/`` directory: give it a copy made for the
comparison (``git archive`` of the other commit unpacked under this
checkout's ``build/``), never a checkout that something else builds in.

B7 at qwen3-30b-a3b widths (E = 2048, H·D = 4096, 128 experts) walks an
8-layer stack of random bf16 weights from seed 0 (138 MB, beyond the
50 MB L2), as ``chip_smoke.py`` does; B5 at V = 151936 (Qwen3). Each time
is a CUDA graph of the calls replayed between CUDA events
(``chip_smoke.time_ms``), beside the kernel's bound (``chip_smoke.bound``)
and its plain version's time. Prints the card's name and power limit
first and one JSON line last.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE, help="root of the checkout whose kernels to time")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_b7_b5: torch.cuda.is_available() is False: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    # the timing helpers of this checkout's chip_smoke.py, whatever --tree is
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

    assert os.path.dirname(os.path.dirname(os.path.dirname(fl.__file__))) == tree, fl.__file__
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    out: dict = {"tree": tree, "b7": {}, "b5": {}}
    L, HD, E, NE = 8, cs.M_H * cs.D, cs.M_E, cs.M_NE
    wo, ln = rnd(L, HD, E, scale=HD ** -0.5), rnd(L, E, scale=0.1) + 1
    router = rnd(L, E, NE, scale=E ** -0.5)
    w7 = HD * E + E * NE
    for B in (1, cs.SLOTS, 64):
        a, x = rnd(B, HD), rnd(B, E)

        def walk(f):
            return lambda: [f(a, x, wo, ln, router, layer) for layer in range(L)]

        r = {"ms": cs.time_ms(walk(fl.fused_out_router_stacked), calls=L)[0],
             "plain_ms": cs.time_ms(walk(fl.fused_out_router_stacked_plain), calls=L)[0],
             **cs.bound(2 * (w7 + B * HD + 3 * B * E + E) + 4 * B * NE, 2 * B * w7)}
        out["b7"][B] = r
        print(f"[b7] B={B:3d} {json.dumps(r)}", flush=True)
    del wo, ln, router
    V = cs.V
    for B in (1, cs.SLOTS, 64):
        logits = torch.randn((B, V), generator=gen, device=dev) * 3
        seen = torch.rand((B, V), generator=gen, device=dev) < 0.1
        pen = torch.full((B,), 1.1, device=dev)
        temp = torch.full((B,), 0.7, device=dev)
        sup = torch.arange(B, device=dev) % 2 == 0
        args = (logits, seen, pen, temp, sup, V - 1)
        r = {"ms": cs.time_ms(lambda: sp.sampling_prep(*args))[0],
             "plain_ms": cs.time_ms(lambda: sp.sampling_prep_plain(*args))[0],
             **cs.bound(B * V * 9 + B * 16, 8 * B * V, rate=cs.F32_FLOP_S)}
        out["b5"][B] = r
        print(f"[b5] B={B:3d} {json.dumps(r)}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
