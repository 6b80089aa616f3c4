"""Fused sampling preparation: one pass over the [B, V] logits (port of
``ops/sampling_prep.py``, kernel B5 ``_prep_kernel``).

Per element: repetition penalty on seen tokens (x/p if x > 0 else x·p),
EOS column set to -1e30 on rows still under ``min_tokens``, division by the
temperature; the scaled logits are written once and the row logsumexp is
accumulated online (running max + rescaled sum), so the sampler needs no
second [B, V] pass for it.

Kernel: Triton, over a (B, S) grid: each row is split into S chunks
(:func:`prep_splits`, from V, B and the card's SM count) so that B·S
programs fill the card, each chunk a multiple of ``BLOCK_V`` columns with
masks at the row's end, so any V works (151936 = 1187·128 included, and
widths that are not a multiple of 128 — the TPU kernel's ``V % 128`` tiling
rule is gone). What bounds it on the H100: bytes — 4 B logits + 1 B seen
read and 4 B scaled written per element, 9 B/elem (21.9 MB at B=16,
V=151936); one program a row (the first port) kept 16 of 132 SMs busy at
B = 16. A program streams its chunk once, writes ``scaled`` and its chunk's
(max, sum of exp(x - max)); the last program of a row to finish (a
per-row ticket it resets) merges the row's S partials in one fixed order
into the lse, so the same logits give the same lse on every call. ``seen``
is read as bytes through a uint8 view of the bool tensor. ``triton`` is
imported inside the launching function, so this module imports where
Triton is absent.

For a CPU tensor the wrapper runs :func:`sampling_prep_plain`; for a CUDA
tensor it launches the kernel or raises. ``sampling_prep.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
BLOCK_V = 4096         # columns a program loads at once; a chunk is a multiple
PROGRAMS_PER_SM = 2    # programs the split aims for on each SM

_kernel = None
_tickets: dict = {}    # device → int32 [rows]: zero between calls


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


def prep_splits(B: int, V: int, sms: int) -> tuple[int, int]:
    """(S, chunk): each of the B rows is cut into S chunks of ``chunk``
    columns (the last one ragged), so that B·S is about
    ``PROGRAMS_PER_SM`` programs an SM; a chunk is a multiple of
    ``BLOCK_V`` and at least one block. From sizes and the SM count only."""
    want = max(1, -(-PROGRAMS_PER_SM * sms // B))
    chunk = max(1, -(-V // want))
    chunk = -(-chunk // BLOCK_V) * BLOCK_V
    return -(-V // chunk), chunk


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _prep_kernel(logits_ptr, seen_ptr, pen_ptr, temp_ptr, sup_ptr,
                     scaled_ptr, lse_ptr, part_ptr, ticket_ptr, V, CHUNK, S, eos_id,
                     HAS_EOS: tl.constexpr, SP: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        chunk = tl.program_id(1)
        base = row.to(tl.int64) * V
        pen = tl.load(pen_ptr + row)
        temp = tl.load(temp_ptr + row)
        sup = tl.load(sup_ptr + row)
        # per-lane online logsumexp state; -3e38 is below every reachable
        # value (suppressed EOS is -1e30) and keeps exp() finite
        m = tl.full([BLOCK], -3.0e38, tl.float32)
        s = tl.zeros([BLOCK], tl.float32)
        c0 = chunk * CHUNK
        for off in range(0, CHUNK, BLOCK):
            cols = c0 + off + tl.arange(0, BLOCK)
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
        # the chunk's (max, sum) into its slot of the row's S partials
        slot = part_ptr + (row * S + chunk) * 2
        tl.store(slot, mx)
        tl.store(slot + 1, tot)
        # release the slot (every thread's stores, then one ticket
        # increment); the row's last program acquires the others'
        tl.debug_barrier()
        done = tl.atomic_add(ticket_ptr + row, 1, sem="acq_rel", scope="gpu")
        if done == S - 1:
            tl.debug_barrier()
            tl.store(ticket_ptr + row, 0)   # ready for the next call
            j = tl.arange(0, SP)
            pm = tl.load(part_ptr + (row * S + j) * 2, mask=j < S, other=-3.0e38,
                         cache_modifier=".cg")
            ps = tl.load(part_ptr + (row * S + j) * 2 + 1, mask=j < S, other=0.0,
                         cache_modifier=".cg")
            big = tl.max(pm, axis=0)
            tl.store(lse_ptr + row,
                     big + tl.log(tl.maximum(tl.sum(ps * tl.exp(pm - big), axis=0), 1e-30)))

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
    from .paged_attention import _sm_count

    import triton

    dev = logits.device
    if _kernel is None:
        _kernel = _build_kernel()
    S, chunk = prep_splits(B, V, _sm_count(dev))
    SP = triton.next_power_of_2(S)
    tickets = _tickets.get(dev)
    if tickets is None or tickets.numel() < B:
        tickets = _tickets[dev] = torch.zeros((max(B, 256),), dtype=torch.int32, device=dev)
    scaled = torch.empty_like(logits)
    lse = torch.empty((B, 1), dtype=torch.float32, device=dev)
    part = torch.empty((B, S, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _kernel[(B, S)](logits, seen.view(torch.uint8), penalty, temperature,
                        suppress_eos.view(torch.uint8), scaled, lse, part, tickets,
                        V, chunk, S, int(eos_id), HAS_EOS=eos_id >= 0, SP=SP,
                        BLOCK=BLOCK_V, num_warps=8)
    sampling_prep.launches += 1
    return scaled, lse


sampling_prep.launches = 0
