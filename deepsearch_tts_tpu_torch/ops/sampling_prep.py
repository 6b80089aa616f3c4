"""Fused sampling preparation: one pass over the [B, V] logits (port of
``ops/sampling_prep.py``, kernel B5 ``_prep_kernel``).

Per element: repetition penalty on seen tokens (x/p if x > 0 else x·p),
EOS column set to -1e30 on rows still under ``min_tokens``, division by the
temperature; the scaled logits are written once and the row logsumexp is
accumulated online (running max + rescaled sum), so the sampler needs no
second [B, V] pass for it.

Kernel: Triton, one program per row looping over V in ``BLOCK_V`` chunks
with masks, so any V works (151936 = 1187·128 included, and widths that are
not a multiple of 128 — the TPU kernel's ``V % 128`` tiling rule is gone).
What bounds it on the H100: bytes — 4 B logits + 1 B seen read and 4 B
scaled written per element, 9 B/elem (~88 MB at B=64, V=151936); the design
reads and writes each element exactly once and keeps the logsumexp state in
registers. ``triton`` is imported inside the launching function, so this
module imports where Triton is absent.

For a CPU tensor the wrapper runs :func:`sampling_prep_plain`; for a CUDA
tensor it launches the kernel or raises. ``sampling_prep.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
BLOCK_V = 4096

_kernel = None


def sampling_prep_plain(logits: torch.Tensor, seen: torch.Tensor,
                        penalty: torch.Tensor, temperature: torch.Tensor,
                        suppress_eos: torch.Tensor, eos_id: int = -1
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference for B5: ``(scaled [B,V] f32, lse [B,1] f32)``."""
    x = logits.float()
    p = penalty.float()[:, None]
    x = torch.where(seen, torch.where(x > 0, x / p, x * p), x)
    if eos_id >= 0:
        col = torch.arange(x.shape[1], device=x.device)[None, :]
        x = torch.where(suppress_eos[:, None] & (col == eos_id),
                        torch.full_like(x, NEG_INF), x)
    scaled = x / temperature.float()[:, None]
    return scaled, torch.logsumexp(scaled, dim=-1, keepdim=True)


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _prep_kernel(logits_ptr, seen_ptr, pen_ptr, temp_ptr, sup_ptr,
                     scaled_ptr, lse_ptr, V, eos_id,
                     HAS_EOS: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        base = row.to(tl.int64) * V
        pen = tl.load(pen_ptr + row)
        temp = tl.load(temp_ptr + row)
        sup = tl.load(sup_ptr + row)
        # per-lane online logsumexp state; -3e38 is below every reachable
        # value (suppressed EOS is -1e30) and keeps exp() finite
        m = tl.full([BLOCK], -3.0e38, tl.float32)
        s = tl.zeros([BLOCK], tl.float32)
        for start in range(0, V, BLOCK):
            cols = start + tl.arange(0, BLOCK)
            mask = cols < V
            x = tl.load(logits_ptr + base + cols, mask=mask, other=0.0)
            seen = tl.load(seen_ptr + base + cols, mask=mask, other=0)
            x = tl.where(seen != 0, tl.where(x > 0, x / pen, x * pen), x)
            if HAS_EOS:
                x = tl.where((cols == eos_id) & (sup != 0), -1e30, x)
            x = x / temp
            tl.store(scaled_ptr + base + cols, x, mask=mask)
            m_new = tl.where(mask, tl.maximum(m, x), m)
            s = s * tl.exp(m - m_new) + tl.where(mask, tl.exp(x - m_new), 0.0)
            m = m_new
        mx = tl.max(m, axis=0)
        tot = tl.sum(s * tl.exp(m - mx), axis=0)
        tl.store(lse_ptr + row, mx + tl.log(tl.maximum(tot, 1e-30)))

    return _prep_kernel


def sampling_prep(logits: torch.Tensor, seen: torch.Tensor,
                  penalty: torch.Tensor, temperature: torch.Tensor,
                  suppress_eos: torch.Tensor, eos_id: int = -1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """B5: ``(scaled [B,V] f32, lse [B,1] f32)`` in one pass.

    logits [B,V] float32; seen [B,V] bool; penalty/temperature [B] float32
    (temperature pre-clamped > 0); suppress_eos [B] bool."""
    global _kernel
    if logits.device.type == "cpu":
        return sampling_prep_plain(logits, seen, penalty, temperature,
                                   suppress_eos, eos_id)
    B, V = logits.shape
    for name, t, shape, dt in (("logits", logits, (B, V), torch.float32),
                               ("seen", seen, (B, V), torch.bool),
                               ("penalty", penalty, (B,), torch.float32),
                               ("temperature", temperature, (B,), torch.float32),
                               ("suppress_eos", suppress_eos, (B,), torch.bool)):
        if t.device != logits.device or t.device.type != "cuda":
            raise ValueError(f"sampling_prep: {name} must be on the CUDA device "
                             f"of logits, got {t.device}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"sampling_prep: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if _kernel is None:
        _kernel = _build_kernel()
    scaled = torch.empty_like(logits)
    lse = torch.empty((B, 1), dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        _kernel[(B,)](logits, seen.view(torch.uint8), penalty, temperature,
                      suppress_eos.view(torch.uint8), scaled, lse, V,
                      int(eos_id), HAS_EOS=eos_id >= 0, BLOCK=BLOCK_V,
                      num_warps=8)
    sampling_prep.launches += 1
    return scaled, lse


sampling_prep.launches = 0
