"""deepsearch_tts_tpu_torch — the PyTorch + CUDA port of ``deepsearch_tts_tpu``.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's name and layout (``models/qwen3.py``, ``ops/fused_layer.py``,
``engine/engine.py``, ...) so a reader can hold the two side by side.

* ``models/``  — Qwen3 dense over layer-stacked weights (``nn.Module`` +
                 plain functions), no-cache and paged serving forwards.
* ``ops/``     — plain-torch attention paths and the hand-written Hopper
                 kernels (CUDA C++ under ``ops/csrc/``, Triton) with a plain
                 PyTorch version beside each.
* ``engine/``  — continuous-batching engine over a paged KV cache with radix
                 prefix reuse, on-device sampling, OpenAI-compatible server.
* ``cli/``     — ``serve`` entry point.

This package imports ``torch`` and never ``jax``. It reuses the JAX
package's JAX-free host modules by import (byte tokenizer, stop scanner,
span timer, the C++ radix index); importing those runs
``deepsearch_tts_tpu/__init__.py``, which imports ``jax`` only when
``JAX_PLATFORMS=cpu`` is set — so processes of this port must not set it.
"""

__version__ = "0.1.0"
