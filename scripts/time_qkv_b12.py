#!/usr/bin/env python3
"""Time B3 / B11 ``fused_qkv`` and B12 (``quantize_int8``) of a checkout of
the port, for comparing two trees on one card.

    python3 scripts/time_qkv_b12.py                 # this checkout's kernels
    python3 scripts/time_qkv_b12.py --tree DIR      # the kernels of the checkout at DIR
    python3 scripts/time_qkv_b12.py --check         # also hold each kernel to its plain version
    python3 scripts/time_qkv_b12.py --plans         # also B12 at one to four blocks an SM
    (needs one CUDA card and nvcc)

``--tree DIR`` imports the package of the checkout at DIR, which builds its
kernels into DIR's own ``build/`` directory: give it a copy made for the
comparison (``git archive`` of the other commit unpacked under this
checkout's ``build/``), never a checkout that something else builds in.

B3 (``fused_qkv_stacked``) at qwen3-8b (E = 4096, C = 6144) and
qwen3-30b-a3b (E = 2048, C = 5120) widths walks a 4-layer stack of random
bf16 weights from seed 0 (each layer read cold, as ``chip_smoke.py``
does), float32 cos / sin as the engines pass them; B11 ``fused_qkv`` at
qwen3-8b widths on one layer, with float32 and with bf16 cos / sin; each at
B = 1, 16 and 64. B12 rounds to nearest at the five qwen3-32b shapes.
Each time is a CUDA graph of the calls replayed between CUDA events
(``chip_smoke.time_ms``), beside the kernel's bound (``chip_smoke.bound``).
``--check`` holds B3 / B11 to their plain versions at B3's bound (rtol 2e-2,
atol 1e-2) and B12 to its plain version bit for bit (stochastic mode too,
at [5120, 51200]). ``--plans`` also times B12 with ``ops/quant.QUANT_PER_SM``
(the most blocks an SM its plan aims at) set to 1, 2, 3 and 4 around the
calls. Prints the card's name and power limit first and one JSON line last.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the five matrix shapes a qwen3-32b int8 build quantizes
B12_SHAPES = {"wqkv": (5120, 10240), "wo": (8192, 5120), "w_gateup": (5120, 51200),
              "w_down": (25600, 5120), "lm_head": (5120, 151936)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE, help="root of the checkout whose kernels to time")
    ap.add_argument("--check", action="store_true", help="hold each kernel to its plain version")
    ap.add_argument("--plans", action="store_true",
                    help="also time B12 with its plan aimed at one to four blocks an SM")
    ap.add_argument("--part", choices=("qkv", "b12"), default=None,
                    help="time only B3 / B11 or only B12 (a kernel fault ends the process's "
                         "CUDA context, so run the parts as separate processes to keep both)")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_qkv_b12: torch.cuda.is_available() is False: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    # the timing helpers of this checkout's chip_smoke.py, whatever --tree is
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import quant

    assert os.path.dirname(os.path.dirname(os.path.dirname(fl.__file__))) == tree, fl.__file__
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def close(got, ref, what):
        for g, r in zip(got, ref):
            torch.testing.assert_close(g.float(), r.float(), rtol=cs.BF16_RTOL,
                                       atol=cs.BF16_ATOL, msg=lambda m: f"{what}: {m}")
        return max(cs._err(g, r) for g, r in zip(got, ref))

    out: dict = {"tree": tree, "b3": {}, "b11": {}, "b12": {}}

    def qkv_part():
        L, D = 4, cs.D
        for model, (E, H, KV) in (("qwen3-8b", (cs.E, cs.H, cs.KV)),
                                  ("qwen3-30b-a3b", (cs.M_E, cs.M_H, cs.M_KV))):
            C = (H + 2 * KV) * D
            ln, w = rnd(L, E, scale=0.1) + 1, rnd(L, E, C, scale=E ** -0.5)
            qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
            kw = dict(n_heads=H, n_kv=KV, head_dim=D, eps=1e-6)
            for B in (1, cs.SLOTS, 64):
                x = rnd(B, E)
                cos, sin = rope_angles(torch.randint(0, 4000, (B,), generator=gen, device=dev), D,
                                       1_000_000.0)
                args = (x, ln, w, qn, kn, cos, sin)
                r = {"ms": cs.time_ms(lambda: [fl.fused_qkv_stacked(*args, layer, **kw)
                                               for layer in range(L)], calls=L)[0],
                     **cs.bound(2 * (E * C + B * E + E + 2 * D + B * C) + 4 * B * D,
                                2 * B * E * C)}
                if opts.check:
                    r["err"] = max(close(fl.fused_qkv_stacked(*args, layer, **kw),
                                         fl.fused_qkv_stacked_plain(*args, layer, **kw),
                                         f"B3 {model} B={B} layer={layer}")
                                   for layer in range(L))
                out["b3"][f"{model} B={B}"] = r
                print(f"[b3] {model} B={B:3d} {json.dumps(r)}", flush=True)
                if model != "qwen3-8b":
                    continue
                for cdt in (torch.float32, bf):
                    c1, s1 = cos.to(cdt), sin.to(cdt)
                    a1 = (x, ln[0], w[0], qn[0], kn[0], c1, s1)
                    r = {"ms": cs.time_ms(lambda: fl.fused_qkv(*a1, **kw))[0],
                         **cs.bound(2 * (E * C + B * E + E + 2 * D + B * C)
                                    + (2 if cdt == bf else 4) * B * D, 2 * B * E * C)}
                    if opts.check:
                        r["err"] = close(fl.fused_qkv(*a1, **kw), fl.fused_qkv_plain(*a1, **kw),
                                         f"B11 fused_qkv B={B} cos/sin {cdt}")
                    key = f"B={B} cos/sin {str(cdt).split('.')[-1]}"
                    out["b11"][key] = r
                    print(f"[b11] fused_qkv {key} {json.dumps(r)}", flush=True)
            del ln, w, qn, kn
        torch.cuda.empty_cache()


    def b12_part():
        default = getattr(quant, "QUANT_PER_SM", None)   # None: a tree without the plan
        per_sm = [None] + ([1, 2, 3, 4] if opts.plans and default is not None else [])
        for name, (K, N) in B12_SHAPES.items():
            w = rnd(K, N, scale=K ** -0.5)
            ref = quant.quantize_int8_plain(w) if opts.check else None
            for n in per_sm:
                if n is not None:
                    quant.QUANT_PER_SM = n
                try:
                    r = {"ms": cs.time_ms(lambda: quant.quantize_int8(w), iters=20)[0],
                         **cs.bound(3 * K * N + 4 * N, 6 * K * N, rate=cs.F32_FLOP_S)}
                    if hasattr(quant, "quant_plan"):
                        r["plan"] = quant.quant_plan(K, N)._asdict()
                    if opts.check:
                        q, s = quant.quantize_int8(w)
                        torch.cuda.synchronize()
                        assert torch.equal(q, ref[0]) and torch.equal(s, ref[1]), (name, n)
                        r["bit_equal"] = True
                finally:
                    if n is not None:
                        quant.QUANT_PER_SM = default
                key = f"{name} [{K}, {N}]" + ("" if n is None else f" per_sm={n}")
                out["b12"][key] = r
                print(f"[b12] {key} {json.dumps(r)}", flush=True)
            if opts.check and name == "w_gateup":
                # stochastic: bit-equal to the plain Philox model, and its properties
                q1, s1 = quant.quantize_int8(w, seed=1, stochastic=True)
                p1, ps = quant.quantize_int8_plain(w, seed=1, stochastic=True)
                torch.cuda.synchronize()
                assert torch.equal(s1, ref[1]) and torch.equal(ps, ref[1])
                assert torch.equal(q1, p1), int((q1 != p1).sum())
                y = w.float() / s1
                mean_err = float((q1.float() - y).mean())
                assert abs(mean_err) < cs.STOCH_MEAN_BOUND, mean_err
                print(f"[b12] stochastic {name}: bit-equal to the plain Philox model, "
                      f"mean(q - x/s) {mean_err:.2e}", flush=True)
            del w, ref
            torch.cuda.empty_cache()

    failed = []
    parts = {"qkv": (qkv_part,), "b12": (b12_part,), None: (b12_part, qkv_part)}[opts.part]
    for part in parts:   # a failing part does not hide the other's numbers
        try:
            part()
        except Exception:
            traceback.print_exc()
            failed.append(part.__name__)
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
