#!/usr/bin/env python3
"""Check and time the two forms of B4's products and of the int8 grouped
expert kernel at prefill, each beside the other form in one call.

    python3 scripts/time_b4_experts.py [--part b4|experts|all] [--check-only]
    (needs one CUDA card and nvcc)

* ``b4``: the bare bf16 product over qwen3-8b's gate|up ([4096, 24576],
  201 MB) at 16, 64, 80, 128 and 256 rows on ``gemm_tc`` (the wgmma form)
  and on ``gemm_partial`` (the mma.sync form, a block a 64-row group),
  each held to the float32 product; then B4 (``fused_out_mlp_stacked``)
  at 1, 16, 64, 80, 128 and 256 rows (``--rows``) and B3
  (``fused_qkv_stacked``) at those up to 80 in both forms (``fused_layer.TC_MIN_ROWS`` set for each),
  held to their plain versions, on a four-layer stack walked layer by
  layer (weights cold in L2).
* ``experts``: ``grouped_gateup_i8`` / ``grouped_down_i8`` at
  qwen3-30b-a3b widths, 3072 tokens x top-8, on the prefill form and on the
  decode form (``moe.PREFILL_ROWS_PER_EXPERT`` raised so the wrapper takes
  it), packed and unpacked gate|up, and on a skewed routing with one expert
  past its capacity and over 256 rows; held to the plain versions, rows
  past the capacity 0, two calls bit-equal; beside the bf16 prefill kernel
  on the same routing.

Each time is a CUDA graph of the calls replayed between CUDA events
(``chip_smoke.time_ms``), beside its bound (``chip_smoke.bound``). Prints
the card's name and power limit first and one JSON line last.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` (a module's attribute) set to ``value`` inside."""
    d = obj.__dict__
    old = d[name]
    d[name] = value
    try:
        yield
    finally:
        d[name] = old


def part_b4(cs, out: dict, check_only: bool, rows) -> None:
    import torch

    from deepsearch_tts_tpu_torch.models.common import matmul_f32, rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops.paged_attention import _sm_count

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(16)
    E, H, KV, D, FF = cs.E, cs.H, cs.KV, cs.D, cs.FF
    lib, grid = fl._lib(), _sm_count(dev)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    # the bare product over gate|up, both forms
    w = rnd(E, 2 * FF, scale=E ** -0.5)
    N, K = 2 * FF, E
    for B in (16, 64, 80, 128, 256):
        x = rnd(B, K)
        ref = matmul_f32(x, w)
        row = {}
        for form in ("tc", "partial"):
            s, g = (fl.tc_splits(B, N, K, grid), grid) if form == "tc" else (fl._splits(B, N, K), 0)
            P = torch.empty((s, B, N), dtype=torch.float32, device=dev)

            def call():   # on the current stream: the one a CUDA graph captures
                fl._raise_if(lib.dstts_gemm_partial(
                    x.data_ptr(), w.data_ptr(), P.data_ptr(), B, K, N, s, g,
                    torch.cuda.current_stream(dev).cuda_stream), "gemm")
            call()
            torch.cuda.synchronize()
            err = float((P.sum(0) - ref).abs().max())
            assert err < 1e-2, (form, B, err)
            ms = None if check_only else cs.time_ms(call)[0]
            row[form] = {"splits": s, "err": err, "ms": ms}
        row.update(cs.bound(2 * (K * N + B * K) + 4 * B * N, 2 * B * K * N))
        out["product"][B] = row
        print(f"[product] gate|up B={B:3d} {json.dumps(row)}", flush=True)
    del w

    L = 4
    ln1, ln2 = rnd(L, E, scale=0.1) + 1, rnd(L, E, scale=0.1) + 1
    qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
    wqkv = rnd(L, E, (H + 2 * KV) * D, scale=E ** -0.5)
    wo = rnd(L, H * D, E, scale=(H * D) ** -0.5)
    gateup = rnd(L, E, 2 * FF, scale=E ** -0.5)
    wd = rnd(L, FF, E, scale=FF ** -0.5)
    W4, C = H * D * E + 3 * E * FF, (H + 2 * KV) * D
    kw = dict(n_heads=H, n_kv=KV, head_dim=D, eps=1e-6)
    for B in rows:
        x, a = rnd(B, E), rnd(B, H * D)
        pos = torch.randint(0, 4000, (B,), generator=gen, device=dev)
        cos, sin = rope_angles(pos, D, 1_000_000.0)
        args4, args3 = (a, x, wo, ln2, gateup, wd), (x, ln1, wqkv, qn, kn, cos, sin)
        row = {"b4": {}, "b3": {}}
        for form, start in (("tc", 1), ("partial", 10 ** 9)):
            with patched(fl, "TC_MIN_ROWS", start):
                e4 = e3 = 0.0
                for layer in range(L):
                    got = fl.fused_out_mlp_stacked(*args4, layer)
                    ref = fl.fused_out_mlp_stacked_plain(*args4, layer)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got.float(), ref.float(), rtol=cs.BF16_RTOL,
                                               atol=cs.BF16_ATOL)
                    e4 = max(e4, cs._err(got, ref))
                    if B <= 80:
                        for g, r in zip(fl.fused_qkv_stacked(*args3, layer, **kw),
                                        fl.fused_qkv_stacked_plain(*args3, layer, **kw)):
                            torch.testing.assert_close(g.float(), r.float(), rtol=cs.BF16_RTOL,
                                                       atol=cs.BF16_ATOL)
                            e3 = max(e3, cs._err(g, r))
                t4 = None if check_only else cs.time_ms(
                    lambda: [fl.fused_out_mlp_stacked(*args4, layer) for layer in range(L)],
                    calls=L)[0]
                row["b4"][form] = {"err": e4, "ms": t4}
                if B <= 80:
                    t3 = None if check_only else cs.time_ms(
                        lambda: [fl.fused_qkv_stacked(*args3, layer, **kw) for layer in range(L)],
                        calls=L)[0]
                    row["b3"][form] = {"err": e3, "ms": t3}
        if not check_only:
            row["b4"]["plain_ms"] = cs.time_ms(
                lambda: [fl.fused_out_mlp_stacked_plain(*args4, layer) for layer in range(L)],
                calls=L)[0]
        row["b4"].update(cs.bound(2 * (W4 + B * H * D + 2 * B * E + E), 2 * B * W4))
        row["b3"].update(cs.bound(2 * (E * C + B * E + E + 2 * D + B * C) + 4 * B * D,
                                  2 * B * E * C))
        out["layers"][B] = row
        print(f"[layers] B={B:3d} {json.dumps(row)}", flush=True)


def part_experts(cs, out: dict, check_only: bool) -> None:
    import torch

    from deepsearch_tts_tpu_torch.ops import moe, quant

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(15)
    NE, E, F, k = cs.M_NE, cs.M_E, cs.M_F, cs.M_TOPK
    wgu_bf = (torch.randn((NE, E, 2 * F), generator=gen, device=dev) * E ** -0.5).to(bf)
    wd_bf = (torch.randn((NE, F, E), generator=gen, device=dev) * F ** -0.5).to(bf)
    gu, wd = quant.quantize_stack(wgu_bf), quant.quantize_stack(wd_bf)
    T = 3072
    for name in ("random", "skewed"):
        logits = torch.randn((T, NE), generator=gen, device=dev) * 2
        if name == "skewed":
            logits[:500, 5] += 30.0        # expert 5: 500+ rows, past cap 384 and 256
        _, top_e = moe.route_topk(logits, k)
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        offsets = moe.group_offsets(flat_e, NE)
        xs = torch.randn((T, E), generator=gen, device=dev).to(bf)[order // k]
        S = T * k
        cap = moe.expert_capacity(S, NE)
        sizes = (offsets[1:] - offsets[:-1]).long()
        eid = torch.repeat_interleave(torch.arange(NE, device=dev), sizes)
        dropped = (torch.arange(S, device=dev) - offsets[eid].long()) >= cap
        kept = int(sizes.clamp(max=cap).sum())
        touched = int((sizes > 0).sum())
        row = {"cap": cap, "largest": int(sizes.max()), "dropped": int(dropped.sum())}
        h = moe.grouped_gateup_i8_plain(xs, gu, None, offsets, cap)
        calls = {"gateup": (lambda: moe.grouped_gateup_i8(xs, gu, None, offsets, cap),
                            lambda: moe.grouped_gateup_i8_plain(xs, gu, None, offsets, cap)),
                 "down": (lambda: moe.grouped_down_i8(h, wd, offsets, cap),
                          lambda: moe.grouped_down_i8_plain(h, wd, offsets, cap))}
        for part, (kern, plain) in calls.items():
            ref = plain()
            for form, start in (("tc", moe.PREFILL_ROWS_PER_EXPERT), ("decode", 10 ** 9)):
                with patched(moe, "PREFILL_ROWS_PER_EXPERT", start):
                    n0 = moe.grouped_gateup_i8.prefill_launches + moe.grouped_down_i8.prefill_launches
                    got, again = kern(), kern()
                    torch.cuda.synchronize()
                    ran_tc = (moe.grouped_gateup_i8.prefill_launches
                              + moe.grouped_down_i8.prefill_launches - n0) == 2
                    assert ran_tc == (form == "tc"), (form, part)
                    torch.testing.assert_close(got.float(), ref.float(), rtol=cs.BF16_RTOL,
                                               atol=cs.BF16_ATOL)
                    assert torch.equal(got, again), (form, part, "two calls differ")
                    assert not bool(got[dropped].any()), (form, part, "rows past cap")
                    ms = None if check_only else cs.time_ms(kern, iters=20)[0]
                    row[f"{part} {form}"] = {"err": cs._err(got, ref), "ms": ms}
        if name == "random" and not check_only:
            hb = moe.grouped_gateup(xs, wgu_bf, None, offsets)
            row["bf16 tc ms"] = (cs.time_ms(lambda: moe.grouped_gateup(xs, wgu_bf, None, offsets),
                                            iters=20)[0],
                                 cs.time_ms(lambda: moe.grouped_down(hb, wd_bf, offsets),
                                            iters=20)[0])
        if name == "random":   # unpacked gate / up (MLA's layout) on the prefill form
            wg = {kk: v[..., :F].contiguous() for kk, v in gu.items()}
            wu = {kk: v[..., F:].contiguous() for kk, v in gu.items()}
            got = moe.grouped_gateup_i8(xs, wg, wu, offsets, cap)
            ref = moe.grouped_gateup_i8_plain(xs, wg, wu, offsets, cap)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), ref.float(), rtol=cs.BF16_RTOL,
                                       atol=cs.BF16_ATOL)
            row["gateup unpacked err"] = cs._err(got, ref)
            # a plain version without one k stage of one expert's weights
            e = int(sizes.argmax())
            q = gu["q"].clone()
            q[e, 64:128] = 0
            fault = moe.grouped_gateup_i8_plain(xs, {"q": q, "scales": gu["scales"]}, None,
                                                offsets, cap)
            use = cs._bound_use(fault, moe.grouped_gateup_i8(xs, gu, None, offsets, cap),
                                cs.BF16_RTOL, cs.BF16_ATOL, math.inf)
            assert use > 1.0, ("int8 prefill: a dropped stage passed the bound", use)
            row["dropped stage bound use"] = use
            del wg, wu, q, fault
        row.update({f"bound {p}": cs.bound(nb, flop)["bound_ms"] for p, nb, flop in (
            ("gateup", touched * (E * 2 * F + 8 * F) + 2 * kept * E + 2 * S * F,
             2 * kept * E * 2 * F),
            ("down", touched * (F * E + 4 * E) + 2 * kept * F + 2 * S * E, 2 * kept * F * E))})
        out["experts"][name] = row
        print(f"[experts] T={T} {name} {json.dumps(row)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("b4", "experts", "all"), default="all")
    ap.add_argument("--check-only", action="store_true", help="check, do not time")
    ap.add_argument("--rows", default="1,16,64,80,128,256",
                    help="B4's row counts (B3 also times those up to 80)")
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_b4_experts: torch.cuda.is_available() is False: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from deepsearch_tts_tpu_torch.ops import _build, moe

    for name in ("fused_layer", "moe_i8"):
        _build.load_library(name)
        for line in _build.build_log.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
                print(f"[build] {name}: {line.strip()}", flush=True)
    print(f"[build] occupancy {moe.grouped_i8_occupancy()}", flush=True)
    out: dict = {"product": {}, "layers": {}, "experts": {}}
    if opts.part in ("experts", "all"):
        part_experts(cs, out, opts.check_only)
    if opts.part in ("b4", "all"):
        part_b4(cs, out, opts.check_only, [int(r) for r in opts.rows.split(",")])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
