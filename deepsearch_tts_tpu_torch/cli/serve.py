"""Serve a model behind the OpenAI-compatible endpoint (port of ``cli/serve.py``).

Usage:
    python -m deepsearch_tts_tpu_torch.cli.serve --model qwen3-8b --device cuda \\
        --weights /path/to/safetensors --port 8000 --max_slots 64
    python -m deepsearch_tts_tpu_torch.cli.serve --model qwen3-30b-a3b \\
        --device cuda --pages 1024 --max_seq_len 4096 --max_slots 16
    torchrun --nproc_per_node 2 -m deepsearch_tts_tpu_torch.cli.serve \\
        --model qwen3-8b --tp 2

``--tp N`` runs under ``torchrun`` (one process a rank; the mesh is
``dp = ranks / N`` × ``tp = N``, as JAX builds it, and the engine refuses
dp > 1): every rank builds the sharded engine, rank 0 serves HTTP and the
other ranks follow its scheduler (``Engine.follow``). SIGTERM or Ctrl-C on
rank 0 stops every rank.

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
                   help="tensor-parallel ways (0 = single device; >1 under "
                        "torchrun, one process a rank)")
    p.add_argument("--prefill_lane", type=int, default=16,
                   help="in-flight prefill: a prompt of at most this many "
                        "tokens rides a decode step (0 = off; families "
                        "without a lane path, MLA, need 0)")
    p.add_argument("--warmup", type=int, default=0, metavar="PROMPT_LEN",
                   help="warmup() before accepting requests: the prefills of "
                        "this prompt length and every decode program (each "
                        "captured as a CUDA graph on the card)")
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

    mesh = _tp_mesh(args.tp, args.device)
    device = resolve_device(args.device)
    tok = HFTokenizer(args.tokenizer) if args.tokenizer else ByteTokenizer()
    params = None   # random weights from --seed, drawn by the Engine on device
    if args.weights:
        # under a mesh the checkpoint is read on the host, and each rank
        # moves its slices to the card one matrix at a time
        params, _ = load_or_init_params(args.model, args.weights,
                                        device=device if mesh is None else "cpu")
    engine = Engine(args.model, tok, params=params, device=device, mesh=mesh,
                    max_slots=args.max_slots, page_size=args.page_size,
                    n_pages=args.pages, max_seq_len=args.max_seq_len,
                    decode_chunk_len=args.decode_chunk,
                    prefill_lane=args.prefill_lane, seed=args.seed)
    if args.warmup:
        engine.warmup(prompt_lens=(args.warmup,))
    return engine


def _tp_mesh(tp: int, device: str):
    """The ``--tp`` mesh (None for one device): torch.distributed from
    torchrun's environment, then ``dp = ranks / tp`` × ``tp`` (JAX
    ``cli/serve.py:52-60``)."""
    if tp <= 1:
        return None
    import torch
    import torch.distributed as dist

    from ..parallel.distributed import initialize_multihost
    from ..parallel.mesh import make_mesh

    device_type = torch.device(device).type
    initialize_multihost(device_type=device_type)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % tp:
        raise ValueError(f"--tp {tp} does not divide the {n} ranks (start the ranks with "
                         f"torchrun --nproc_per_node {tp})")
    return make_mesh(dp=n // tp, tp=tp, device_type=device_type)


def main(argv=None):
    import signal

    from ..engine.server import OpenAIServer

    args = build_parser().parse_args(argv)
    engine = build_engine(args)
    if engine.multi and engine.par.rank != 0:
        engine.follow()   # until rank 0 stops
        return
    server = OpenAIServer(engine, args.host, args.port)
    print(f"serving {args.model} on {engine.device} at "
          f"http://{args.host}:{args.port}/v1", flush=True)
    # SIGTERM stops the server as Ctrl-C does, so that the engine's stop
    # reaches the other ranks
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        asyncio.run(server.serve_forever())
    except KeyboardInterrupt:
        pass
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
