"""Serve a model behind the OpenAI-compatible endpoint (port of ``cli/serve.py``).

Usage:
    python -m deepsearch_tts_tpu_torch.cli.serve --model qwen3-8b --device cuda \\
        --weights /path/to/safetensors --port 8000 --max_slots 64
    python -m deepsearch_tts_tpu_torch.cli.serve --model qwen3-30b-a3b \\
        --device cuda --pages 1024 --max_seq_len 4096 --max_slots 16

The flags are the JAX CLI's, plus ``--device`` and ``--seed`` (random
weights when ``--weights`` is empty). :func:`build_engine` is the engine
construction on its own, so other programs can reuse it.
"""
from __future__ import annotations

import argparse
import asyncio


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="qwen3-8b")
    p.add_argument("--weights", default="")
    p.add_argument("--tokenizer", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_slots", type=int, default=64)
    p.add_argument("--page_size", type=int, default=64)
    p.add_argument("--pages", type=int, default=4096)
    p.add_argument("--max_seq_len", type=int, default=8192)
    p.add_argument("--decode_chunk", type=int, default=8)
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel ways (0 = single device; >1 is not "
                        "ported yet)")
    p.add_argument("--prefill_lane", type=int, default=0,
                   help="in-flight chunked prefill width (not ported yet: "
                        "only 0 is accepted)")
    p.add_argument("--warmup", type=int, default=0, metavar="PROMPT_LEN",
                   help="build the kernels with one prefill of this prompt "
                        "length and one decode step before accepting requests")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used when --weights is empty")
    return p


def build_engine(args):
    """The engine ``main`` serves, built from parsed flags."""
    from ..device import resolve_device
    from ..engine.engine import Engine
    from ..engine.tokenizer import ByteTokenizer, HFTokenizer
    from ..engine.weights import load_or_init_params

    if args.tp > 1:
        raise NotImplementedError(
            "--tp > 1 is not ported to the torch package yet (ROADMAP.md A13)")
    device = resolve_device(args.device)
    tok = HFTokenizer(args.tokenizer) if args.tokenizer else ByteTokenizer()
    params = None   # random weights from --seed, drawn by the Engine on device
    if args.weights:
        params, _ = load_or_init_params(args.model, args.weights, device=device)
    engine = Engine(args.model, tok, params=params, device=device,
                    max_slots=args.max_slots, page_size=args.page_size,
                    n_pages=args.pages, max_seq_len=args.max_seq_len,
                    decode_chunk_len=args.decode_chunk,
                    prefill_lane=args.prefill_lane, seed=args.seed)
    if args.warmup:
        engine.warmup(prompt_lens=(args.warmup,))
    return engine


def main(argv=None):
    from ..engine.server import OpenAIServer

    args = build_parser().parse_args(argv)
    engine = build_engine(args)
    server = OpenAIServer(engine, args.host, args.port)
    print(f"serving {args.model} on {engine.device} at "
          f"http://{args.host}:{args.port}/v1")
    asyncio.run(server.serve_forever())


if __name__ == "__main__":
    main()
