"""Device resolution (the port's counterpart of ``utils.is_tpu_backend``).

The JAX package asks the backend whether it runs on a TPU and picks a Pallas
kernel or its interpret/XLA path from the answer. Here the choice follows
the tensor: a wrapper launches its CUDA kernel for a CUDA tensor and runs its
plain version for a CPU tensor. What remains is turning the user's
``--device`` into a ``torch.device`` — explicitly, and never by switching to
the CPU behind the caller's back.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` → ``torch.device``.

    Raises when CUDA is asked for and no card is visible, instead of
    falling back to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False (no CUDA card, or a CPU-only PyTorch build)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev
