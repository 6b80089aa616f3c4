"""deepsearch_tts_tpu_torch — the PyTorch + CUDA port of ``deepsearch_tts_tpu``.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's name and layout (``models/qwen3.py``, ``ops/fused_layer.py``,
``engine/engine.py``, ...) so a reader can hold the two side by side.

* ``models/``  — Qwen3 dense and Qwen3-MoE over layer-stacked weights
                 (``nn.Module`` + plain functions), no-cache and serving
                 forwards, bf16 or int8 weights.
* ``ops/``     — plain-torch attention paths and the hand-written Hopper
                 kernels (CUDA C++ under ``ops/csrc/``, Triton) with a plain
                 PyTorch version beside each.
* ``engine/``  — continuous-batching engine over a paged (bf16 or int8) or
                 slot KV cache with radix prefix reuse, on-device sampling,
                 OpenAI-compatible server, and the host modules it needs
                 (tokenizer, stop scanner, span timer).
* ``native/``  — the C++ radix page index of the prefix cache.
* ``cli/``     — ``serve`` entry point.

This package imports ``torch`` and never ``jax``, nor anything of
``deepsearch_tts_tpu``: where it needs one of that package's JAX-free host
modules it keeps its own copy (``tests/test_torch_host.py`` holds each copy
to its original and fails on any such import).
"""

__version__ = "0.1.0"
