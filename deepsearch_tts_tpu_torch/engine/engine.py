"""Continuous-batching inference engine over a paged or contiguous-slot KV
cache (port of ``engine/engine.py``).

Behaviours carried over from the JAX engine:

* ``submit`` returns a ``concurrent.futures.Future``; the scheduler loop
  runs on a daemon thread.
* Grouped prefill: queued requests are prepared on the host (pages, radix
  prefix match), grouped by power-of-two prompt bucket, and each group runs
  ONE prefill program (``engine/prefill_program.py``, JAX's ``_prefill_fn``):
  the batched forward, the first-token sample and the seen-mask fold (and a
  speculative engine's token-history write), its rows padded up JAX's
  ladder 1, 4, 16 (``MAX_PREFILL_GROUP`` rows, ``PREFILL_TOKEN_BUDGET``
  rows x bucket) with padding rows at position -1 and row ``max_slots``.
  A program is keyed ``(bucket, Gp, fresh, ring, P)``, ``P`` the page
  bucket the non-fresh branch gathers (JAX gathers the whole budget); on
  CUDA each key is captured once into the graph pool and replayed, its
  inputs written into static buffers first. Engines with prefix reuse (a
  prefix cache, or slot parking) run the non-fresh (re-prefill) branch for
  every group, as in JAX; without it, groups take fresh causal prefill.
* Decode chunks of ``decode_chunk_len`` steps over all ``max_slots`` rows
  (inactive rows write nothing), with the page table sliced to the
  ``context_buckets`` page bucket of the longest active row (``"fine"``:
  powers of two and their 1.5x midpoints; ``True``: powers of two;
  ``False``: the whole budget), so a step gathers the context it needs and
  not the whole ``max_seq_len`` budget. T=1 layers run the fused functions
  (``ops/fused_layer.py``) on packed bf16 weights.
* The decode-program layer (``engine/decode_program.py``): a chunk is one
  program keyed ``(page bucket, slot bucket, lane, spec, chunk_len)``, a
  function of engine-wide static buffers; on CUDA each key is captured once
  into one ``torch.cuda.CUDAGraph`` (one graph pool for the decode and the
  prefill programs, ``engine/program.py``) and replayed from then on.
  ``warmup()`` builds both kinds (JAX's enumeration, with the prefill
  programs' page widths); a program built after it counts in
  ``stats["post_warmup_builds"]``; ``telemetry()`` names each kind's mode
  (``decode_program``, ``prefill_program``: ``"graph"``, ``"cpu"``, or
  ``"eager"`` under a mesh).
* Pipelined dispatch (``pipeline_decode``, JAX ``engine.py:1349-1476``):
  chunk N+1 is dispatched from chunk N's device carry before N is read
  back, when a row certainly wants tokens past N (:meth:`_can_speculate`)
  and too few rows complete during N (:meth:`_churn_imminent`). Rows reset
  since the carry are told apart by per-slot epochs; rows whose host state
  changed are patched into the static buffers before the replay. Every
  prefill, copy and replay runs on one stream, so a chunk in flight writes
  its KV before any re-admission's prefill overwrites it. A parked row's
  seen mask needs no fold of the in-flight chunk's tokens (JAX's
  ``stale``): admission rebuilds every row's mask from its whole prompt.
* Admission injection: the newest ``n_inject`` prefill groups are
  dispatched without a sync; their fixed-width first-token tensors (each
  group's own copy of its program's output) are copied device to device
  into the next chunk's inject buffer, which scatters them into the
  carry's ``last`` inside the program. After a chunk frees rows with
  nothing queued, the loop waits 2 ms for closed-loop refills (JAX's
  default ``refill_grace="fixed"``; its ``"adaptive"`` and ``"off"`` are
  not ported).
* Page allocation, LRU eviction of cached prefixes and preempt-by-requeue
  under page pressure; finished sequences insert their full pages into the
  radix prefix cache.
* ``cache_mode="slot"``: a contiguous ``[L, max_slots, max_seq_len, K, D]``
  pool (page size = ``max_seq_len``, identity page table, no allocator,
  no page pressure). Decode reads the power-of-two context bucket of the
  longest active row. Prefix reuse is *parking*: a finished row's KV stays
  in place, and a request whose prompt extends its tokens re-enters that
  row and prefills only the rest (token-exact match).
* ``attn_impl``: ``None`` resolves to ``"pallas"`` on CUDA (slot and paged
  cache, bf16 and int8 KV; ``"xla"`` for shapes no kernel takes,
  :func:`attention_kernels_take`) and to ``"xla"`` on the CPU
  (:func:`resolve_attn_impl`; JAX keeps its paged default on the gather
  for a TPU measurement); ``"pallas"`` runs the slot and paged decode
  kernels, flash attention for fresh prefill and K2's paged mode for
  re-prefill over a cached prefix (with int8 KV: K1's and K2's int8
  modes); ``"pallas2"`` and ``"clamp"`` pick the other paged decode entry
  points.
* Seen masks: each row's token-presence mask is rebuilt on the device from
  its whole prompt at admission and extended with every sampled token, so
  it is always presence(prompt + generated) — there is no kept/stale mask
  path to reconcile.
* ``min_tokens`` budget forcing (``tokens_generated = lens - prompt_lens + 1``),
  the host stop scan, finish reasons, ``abort`` and ``telemetry``.
* ``quantize="int8"`` (dense and Qwen3-MoE families; MLA refuses it, as
  the JAX reference cannot serve it): the packed weights' matrices become
  int8 ``{q, scales}`` (``ops/quant.py``; random init quantizes one matrix
  at a time as it draws). Dense T=1 decode takes B10; the MoE family runs
  unfused, its experts on the int8 grouped expert kernel. ``kv_quantize`` in
  ``{"int8", "int8-force"}``: int8 KV pools plus float32 scales pools,
  paged cache only, any ``attn_impl`` (JAX takes ``"xla"`` only: its
  kernels read its int32-packed pages as bf16). JAX refuses ``"int8"`` on its
  TPU for speed (``engine.py:411-421``), a TPU measurement; here both
  spellings are accepted, as JAX accepts them on the CPU.
* ``speculative="ngram"`` (slot cache only): each decode step drafts
  ``spec_k`` tokens per row from a device token history
  (``engine/speculative.py``), runs ONE forward over the row's
  ``spec_k + 1``-token window (the fused layer over B·(K+1) rows, B9 for
  attention), samples every window position in one batched pass and emits
  the longest draft-matching prefix plus the first correction. Rejected
  window KV needs no cleanup: the next window starts at the new length and
  overwrites it before any read. A row advances up to
  ``decode_chunk_len·(spec_k+1)`` positions a chunk (``_max_adv``), and
  every length guard uses that.

* ``prefill_lane`` (Qwen3 families: a forward that takes ``lane_tokens``):
  while decode runs, a queued prompt of at most ``prefill_lane`` tokens
  with no cached prefix rides one decode step whole, as ``prefill_lane``
  extra rows (``_plan_lane``: one prompt a step, ``LANE_MAX_ACT`` a
  chunk); its first token is sampled in the program from that step's lane
  logits and its slot activated when the chunk is read back. Everything
  else, and every cold burst, takes batched prefill. A chunk that carries
  the lane carries its rows on every step, padding (position -1) on steps
  with no prompt, as JAX's lane program does: one graph holds one row
  count. A chunk with no lane prompt runs the lane-less program.
* ``chunk_trim``: a half-length chunk when enough rows are within half a
  chunk of their ``max_tokens`` (JAX's gate, over the chunk wall and the
  inter-chunk gap this loop measures), at the two widest context buckets,
  which ``warmup()`` registers.

* ``mesh`` (a ``parallel.mesh.make_mesh`` ``DeviceMesh``, one process a
  rank under ``torchrun``): the weights are sharded per the family's
  logical axes and ``SERVING_RULES`` (quantized whole first, then sliced),
  the pools hold the local kv heads, and the forward runs Megatron style
  with explicit collectives (``parallel/collectives.py``). Layer fusion
  and weight packing are off, as in JAX (``engine.py:321, 332-350``).
  Rank 0 owns the front end (``submit`` / ``abort``); before each
  scheduler step it broadcasts the new requests, the aborts and its stop
  flag (and the trim gate's measured walls) to every rank, every rank
  then runs the same host scheduler on the same inputs and samples from
  the same all-gathered logits with the same generator, so the ranks
  agree on every token with no second broadcast. The other ranks call
  :meth:`follow`. ``dp > 1`` is refused (ROADMAP.md C). ``ring_prefill_len``
  / ``sp_impl``: fresh prefills at or over that bucket run their attention
  sequence-parallel over ``tp`` (JAX's gate, :meth:`_ring_prefill`). A mesh
  engine runs its chunks serially and eagerly (``telemetry()
  ["decode_program"] == "eager"``): no capture, no pipelining, no
  injection; its prefill programs run their bodies eagerly too
  (``"prefill_program" == "eager"``).

The seen mask of every admitted row is rebuilt from its whole prompt,
parked re-entries included (and so is a speculative engine's token
history); JAX's keep/clear path for parked rows saves a host upload on the
TPU and gives the same mask: here each row's whole prompt is uploaded with
the group's other inputs and its presence built inside the program.
"""
from __future__ import annotations

import inspect
import queue
import sys
import threading
import time
import traceback
import uuid
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..models.registry import get_model
from .decode_program import DecodeBuffers, chunk_body
from .kvcache import PageAllocator, init_kv_pages, init_kv_scales, init_latent_pages
from .prefill_program import FLOAT_FIELDS, PrefillBuffers, prefill_body
from .profiling import SpanTimer
from .program import Program
from .stopping import StopState
from .tokenizer import IncrementalDetokenizer


@dataclass
class GenerationRequest:
    prompt_ids: list[int]
    max_tokens: int = 256
    temperature: float = 0.7
    top_k: int = 20
    top_p: float = 0.8
    min_p: float = 0.05
    repetition_penalty: float = 1.05
    min_tokens: int = 0            # logit-level budget forcing: suppress EOS
    stop: tuple[str, ...] = ()
    include_stop_str: bool = False
    on_delta: Any = None           # optional callable(str) for token streaming
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:16])


@dataclass
class GenerationResult:
    request_id: str
    token_ids: list[int]
    text: str
    finish_reason: str
    prompt_tokens: int
    completion_tokens: int
    cached_prompt_tokens: int = 0


class _Slot:
    """Host-side state for one active sequence."""

    def __init__(self, idx: int):
        self.idx = idx
        self.epoch = 0
        self.reset()

    def reset(self):
        self.epoch += 1   # a chunk dispatched before this reset is stale for the row
        self.req: GenerationRequest | None = None
        self.future: Future | None = None
        self.pages: list[int] = []
        self.shared_pages: list[int] = []
        self.prompt_tokens: list[int] = []
        self.prompt_len = 0
        self.cached_len = 0
        self.generated: list[int] = []
        self.stop: StopState | None = None
        self.detok = None
        self.active = False


# H100 SXM data sheet (dense, 700 W): the speculative regime check's ridge
H100_BF16_FLOP_S = 989e12
H100_HBM_BYTES_S = 3.35e12


def _check_speculative(speculative, cache_mode, kv_quantize, prefill_lane, spec_k,
                       spec_ngram, max_slots, quantize) -> None:
    """The JAX engine's checks of a speculative engine (``engine.py:201-235``),
    its regime warning taken at the H100's ridge point."""
    if speculative != "ngram":
        raise ValueError(f"unknown speculative mode {speculative!r}")
    if cache_mode != "slot":
        raise ValueError(
            "speculative decoding requires cache_mode='slot' (the "
            "contiguous rows make rejected-window KV rewind free)")
    if kv_quantize:
        raise ValueError("speculative decoding excludes int8 KV")
    if prefill_lane:
        raise ValueError(
            "speculative decoding and the prefill lane are mutually "
            "exclusive decode-program variants")
    if spec_k < 1 or spec_ngram < 1:
        raise ValueError("spec_k and spec_ngram must be >= 1")
    # a verify step pushes max_slots·(spec_k+1) rows through every weight
    # product: 2 operations per row for each weight element read. Past the
    # ridge (data-sheet peak over HBM rate, per weight byte) the step is
    # bound by the tensor cores and no longer costs about one plain step
    weight_bytes = 1 if quantize else 2
    ridge = H100_BF16_FLOP_S / H100_HBM_BYTES_S * weight_bytes / 2
    rows = max_slots * (spec_k + 1)
    if rows > ridge:
        import warnings

        warnings.warn(
            f"speculative decoding with max_slots={max_slots}, spec_k={spec_k} "
            f"puts {rows} rows through each verify product, past the ~{ridge:.0f}-row "
            "roofline ridge of an H100 (989 TFLOP/s bf16 over 3.35 TB/s): verify "
            "steps are compute-bound there. Use speculation at small batch.",
            stacklevel=3)


ATTN_IMPLS = ("xla", "pallas", "pallas2", "clamp")


def attention_kernels_take(cfg, cache_mode: str, page_size: int, pages: int) -> bool:
    """Whether the port's attention kernels take an engine's static shapes
    (``cfg`` the config its forward runs with, rows of ``pages`` pages of
    ``page_size`` keys; the wrappers raise on any other): bf16 pools (and
    the int8 pools of int8 KV, at the same shapes, through K1's and K2's
    int8 modes); K1
    and K2 at head_dim 128 with at most 64 query heads a kv head (K1's rows
    at T=1), K2's paged mode over rows of more than one page at ps a
    multiple of 8; K3 at MLA's latent width with heads a multiple of 64,
    over a page table at ps a multiple of 64 or 8, 16, 32."""
    from ..ops import paged_attention as pa
    from ..ops.flash_attention import paged_pages_ok

    if getattr(cfg, "dtype", None) != "bfloat16":
        return False
    if getattr(cfg, "latent_cache", False):
        return (cfg.head_dim == pa.LATENT_DIM and cfg.n_heads % pa.LATENT_HEADS == 0
                and (cache_mode == "slot" or pa.latent_pages_ok(page_size)))
    return (cfg.head_dim == pa.HEAD_DIM and cfg.n_heads // cfg.n_kv_heads <= pa.MAX_QUERY_ROWS
            and paged_pages_ok(page_size, pages))


def resolve_attn_impl(attn_impl: str | None, cache_mode: str, device: torch.device,
                      kernels_take: bool = True) -> str:
    """The engine's attention implementation. ``None`` resolves to the
    port's kernels on CUDA, for the slot and the paged cache alike and for
    bf16 and int8 KV alike, where they take the engine's shapes
    (``kernels_take``: :func:`attention_kernels_take`), and to the plain
    gather on the CPU and for shapes no kernel takes (``attn_impl="pallas"``
    raises there). JAX (``engine.py:260-273``) keeps its paged default on
    the gather for a v5e measurement (XLA's fused gather + attention beat
    its Pallas paged kernels there) and refuses its kernels with int8 KV
    (they read its int32-packed pages as bf16); on the card K1 and K2's
    paged mode serve both caches, their int8 modes the int8 pools the port
    keeps unpacked, and a kernel's plain version serves the tests only."""
    if attn_impl is None:
        return "pallas" if device.type == "cuda" and kernels_take else "xla"
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (one of {ATTN_IMPLS})")
    return attn_impl


class Engine:
    # prefill rows per batched forward
    MAX_PREFILL_GROUP = 16
    # cap rows x bucket per prefill forward: causal scores are [G, H, T, S]
    # float32, so long buckets at full group width would exhaust memory
    PREFILL_TOKEN_BUDGET = 8192
    # prefill-lane prompts that may complete (sample a first token) a chunk
    LANE_MAX_ACT = 8

    def __init__(
        self,
        model_name: str,
        tokenizer,
        params: dict | None = None,
        *,
        device: str | torch.device,
        max_slots: int = 8,
        page_size: int = 16,
        n_pages: int = 512,
        max_seq_len: int = 1024,
        decode_chunk_len: int = 8,
        attn_impl: str | None = None,
        cache_mode: str = "paged",
        layer_fusion: bool | None = None,
        seed: int = 0,
        enable_prefix_cache: bool = True,
        quantize: str | None = None,
        kv_quantize: str | None = None,
        mesh=None,
        prefill_lane: int = 0,
        lane_max_act: int | None = None,
        speculative: str | None = None,
        spec_k: int = 3,
        spec_ngram: int = 2,
        chunk_trim: bool = False,
        ring_prefill_len: int | None = None,
        sp_impl: str = "ring",
        context_buckets: bool | str = "fine",
        pipeline_decode: bool = True,
    ):
        if cache_mode not in ("paged", "slot"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if speculative is not None:
            _check_speculative(speculative, cache_mode, kv_quantize, prefill_lane,
                               spec_k, spec_ngram, max_slots, quantize)
        if chunk_trim and (speculative or prefill_lane):
            raise ValueError(
                "chunk_trim is a plain-decode-program policy (mutually "
                "exclusive with speculative decoding and the prefill lane)")
        self.speculative = speculative
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        # the most positions a row advances in one decode chunk: each step
        # emits 1..spec_k+1 tokens under speculation
        self._max_adv = decode_chunk_len * (self.spec_k + 1 if speculative else 1)
        # chunk_trim: a half-length chunk near known completions; the gate's
        # row threshold is trim_min_rows where set (1: always trim), else
        # amortised over the measured chunk wall and inter-chunk gap
        self.chunk_trim = bool(chunk_trim) and decode_chunk_len >= 2
        self._trim_chunk = max(1, decode_chunk_len // 2)
        self.trim_min_rows: int | None = None
        self._trim_warm: set = set()   # (page bucket, slot bucket) pairs warmup() registered
        self._chunk_ema = 0.0   # smoothed decode-chunk wall (s)
        self._gap_ema = 0.0     # smoothed exposed gap before a non-pipelined chunk (s)
        if sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_impl {sp_impl!r} (ring or ulysses)")
        self.ring_prefill_len = ring_prefill_len
        self.sp_impl = sp_impl
        self.sp_prefills = 0   # prefill forwards that ran sequence-parallel
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize {quantize!r} (None or 'int8')")
        if kv_quantize not in (None, "int8", "int8-force"):
            raise ValueError(f"unknown kv_quantize {kv_quantize!r}")
        self.device = resolve_device(device)
        self.cache_mode = cache_mode
        # slot-mode prefix reuse is parking, not sharing (engine.py:373-381)
        self._slot_park = bool(enable_prefix_cache) and cache_mode == "slot"
        self._parked: dict[int, dict] = {}   # slot idx -> park record
        if cache_mode == "slot":
            page_size, n_pages = max_seq_len, max_slots
            enable_prefix_cache = False
        fam = get_model(model_name)
        self.cfg = cfg = fam.config
        self.forward = fam.forward
        self.mesh, self.par = mesh, None
        if mesh is not None:
            self.par = _mesh_parallel(mesh, fam)
            if layer_fusion:
                raise ValueError("layer_fusion requires single-device serving")
            layer_fusion = False
        lcfg = cfg
        if self.par is not None:
            from ..parallel.sharding import local_config

            lcfg = local_config(cfg, self.par.tp)
        self.attn_impl = resolve_attn_impl(
            attn_impl, cache_mode, self.device,
            attention_kernels_take(lcfg, cache_mode, page_size, -(-max_seq_len // page_size)))
        self.prefill_lane = int(prefill_lane or 0)
        if lane_max_act:   # instance override of the class default
            self.LANE_MAX_ACT = int(lane_max_act)
        if self.prefill_lane and "lane_tokens" not in inspect.signature(fam.forward).parameters:
            raise ValueError(f"model family {model_name!r} has no prefill-lane path")
        # queued lane prompts (prepared requests, their slots reserved)
        self._lane: list[dict] = []
        # beyond JAX's fields the engine reads int8_weights, int8_kv, dtype
        # and fused_decode_fits; a registry-extension config may lack them
        # and gets no int8 and no layer fusion. The pools take torch_dtype,
        # as JAX's take jnp_dtype
        if quantize and not getattr(cfg, "int8_weights", False):
            from .weights import int8_refusal

            raise NotImplementedError(int8_refusal(cfg))
        if kv_quantize:
            if not getattr(cfg, "int8_kv", False):
                # the JAX engine refuses it too (its MoE forward takes no scales)
                raise ValueError(f"model family {model_name!r} does not support int8 KV")
            if cache_mode == "slot":
                raise ValueError("int8 KV requires the paged cache mode")
            # JAX refuses its kernels here (they read its int32-packed pages
            # as bf16, attention.py:88-109); the port's pools are unpacked
            # int8 and K1 / K2 have int8 modes, so any attn_impl serves
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_seq_len = max_seq_len
        self.max_pages_per_seq = -(-max_seq_len // page_size)   # 1 in slot mode
        self.decode_chunk_len = decode_chunk_len
        if layer_fusion is None:
            # as in JAX (engine.py:278-325): on for single-device bf16
            # serving of a family with a fused decode layer (dense, ragged
            # MoE: the plain versions on the CPU, the CUDA kernels where
            # their shapes fit; MLA: where B8 takes its MLP widths, on any
            # device, as JAX gates it), and with int8 weights for the dense
            # family only (B10): ``quantize is None or (quantize == "int8"
            # and is_dense)``
            is_dense = not (getattr(cfg, "latent_cache", False) or hasattr(cfg, "n_experts"))
            layer_fusion = (getattr(cfg, "dtype", None) == "bfloat16"
                            and hasattr(cfg, "fused_decode_fits")
                            and (quantize is None or is_dense)
                            and cfg.fused_decode_fits(self.device))
        self.layer_fusion = bool(layer_fusion)

        from .weights import init_params, pack_matmul_params

        # the config the forward runs with: under a mesh, the local heads
        # and MLP widths
        self.fcfg = cfg
        if self.par is not None:
            self.params, self.fcfg = _shard_params(params, fam, self.par, quantize,
                                                   device=self.device, seed=seed)
        else:
            if params is None:
                params = init_params(fam, device=self.device, seed=seed, quantize=quantize)
            # single-device serving always packs QKV and gate|up (numerically
            # the identity; the fused decode functions read this layout)
            self.params = pack_matmul_params(params)
            if quantize:
                # after packing, as JAX (engine.py:358-366); leaves that are
                # already int8 (a quantized init or tree) pass through
                from ..ops.quant import QUANT_KEYS, quantize_params

                self.params = quantize_params(self.params, keys=QUANT_KEYS)
        self.latent_cache = bool(getattr(cfg, "latent_cache", False))
        if self.latent_cache:
            # MLA: one latent row per token in k_pages, a one-page dummy v pool
            self.k_pages, self.v_pages = init_latent_pages(
                cfg.n_layers, n_pages, page_size, cfg.head_dim, dtype=cfg.torch_dtype,
                device=self.device)
        else:
            self.k_pages, self.v_pages = init_kv_pages(
                cfg.n_layers, n_pages, page_size, self.fcfg.n_kv_heads, cfg.head_dim,
                dtype=torch.int8 if kv_quantize else cfg.torch_dtype, device=self.device)
        self.k_scales = self.v_scales = None
        if kv_quantize:
            self.k_scales, self.v_scales = init_kv_scales(
                cfg.n_layers, n_pages, page_size, self.fcfg.n_kv_heads, device=self.device)
        self.allocator = PageAllocator(n_pages, page_size)
        if enable_prefix_cache:
            from .prefix_cache import make_prefix_cache

            self.prefix_cache = make_prefix_cache(self.allocator)
        else:
            self.prefix_cache = None
        # fresh causal prefill only without prefix reuse: engines with a
        # prefix cache or slot parking run the non-fresh branch even for
        # uncached groups, as JAX does (engine.py:1938-1941); without reuse
        # nothing is ever cached
        self.fresh_prefill = self.prefix_cache is None and not self._slot_park

        B, V = max_slots, cfg.vocab_size
        self.slots = [_Slot(i) for i in range(B)]
        self.page_tables = np.zeros((B, self.max_pages_per_seq), np.int32)
        if cache_mode == "slot":
            self.page_tables[:, 0] = np.arange(B)
        self.seq_lens = np.zeros((B,), np.int32)
        self.last_tok = np.zeros((B,), np.int32)
        # one spare row past the B rows takes the seen-mask writes of the
        # lane's padding activations (slot B), which JAX drops
        self._seen_ext = torch.zeros((B + 1, V), dtype=torch.bool, device=self.device)
        self.seen = self._seen_ext[:B]
        self.samp_host = {
            "temperature": np.full((B,), 0.7, np.float32),
            "top_k": np.full((B,), 20, np.int32),
            "top_p": np.full((B,), 0.8, np.float32),
            "min_p": np.full((B,), 0.05, np.float32),
            "repetition_penalty": np.full((B,), 1.05, np.float32),
        }
        self.min_tokens = np.zeros((B,), np.int32)
        self.prompt_lens = np.zeros((B,), np.int32)
        # speculative: token history for the n-gram drafts, hist[b, q] = the
        # token at position q (valid up to seq_lens[b]), plus one spare
        # column that takes the writes JAX drops out of bounds and one spare
        # row that takes a prefill's padding rows
        self._hist_ext = (torch.zeros((B + 1, max_seq_len + 1), dtype=torch.int64,
                                      device=self.device) if speculative else None)
        self.hist = None if self._hist_ext is None else self._hist_ext[:B]
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

        self._queue: "queue.Queue" = queue.Queue()
        # what _admit reads: the submit queue itself, or under a multi-rank
        # mesh the requests rank 0 broadcast (_sync)
        self.multi = self.par is not None and self.par.world > 1
        self._inbox: "queue.Queue" = queue.Queue() if self.multi else self._queue
        self._abort_inbox: set[str] = set()   # rank 0's aborts not yet broadcast
        self.mirrored: list[Future] = []   # a follower rank's copies of the requests
        self._park_seq = 0   # parking order (the LRU of parked slot rows)
        self._deferred: list[tuple[GenerationRequest, Future]] = []
        # preempted-sequence continuations keyed by future: generated tokens
        # + stop/detok state restored at re-admission
        self._resumes: dict[Future, dict] = {}
        self._aborts: set[str] = set()
        self._wake = threading.Event()
        self._stopping = False
        self._thread: threading.Thread | None = None
        self.stats = {
            "requests": 0, "prefill_tokens": 0, "decode_tokens": 0,
            "decode_steps": 0, "decode_time_s": 0.0, "prefill_time_s": 0.0,
            "preemptions": 0, "slot_steps": 0, "prefill_dispatches": 0,
            "prefill_rows": 0, "slot_park_hits": 0, "slot_park_tokens": 0,
            "lane_tokens": 0, "lane_chunks": 0, "trim_chunks": 0,
            # chunks dispatched from the previous chunk's device carry
            "pipelined_chunks": 0,
            # decode and prefill programs built after warmup(): each a
            # capture while serving
            "post_warmup_builds": 0,
            # prefill groups whose first tokens a chunk took on the device
            "injected_groups": 0,
        }
        self.spans = SpanTimer()

        # the decode-program layer (JAX engine.py:133-139, 512-555). A mesh
        # engine keeps a serial eager chunk: gloo stages every transfer
        # through host memory and rank 0 broadcasts before each step
        if context_buckets not in (False, True, "fine"):
            raise ValueError(f"unknown context_buckets {context_buckets!r} "
                             "(False, True or 'fine')")
        self.context_buckets = context_buckets
        self.decode_program = ("eager" if self.par is not None
                               else "graph" if self.device.type == "cuda" else "cpu")
        self.pipeline_decode = bool(pipeline_decode) and self.par is None
        # dispatched-but-unsynced prefill groups one chunk can take on the
        # device: a cold burst of max_slots / MAX_PREFILL_GROUP groups
        # never syncs a prefill before decode starts
        self.n_inject = max(2, min(6, -(-max_slots // self.MAX_PREFILL_GROUP)))
        # the dispatch round trip pipelining hides, the churn break-even's
        # prior until the exposed gap is measured (0: skip on any
        # completing row)
        self.churn_rtt_s = 0.035
        self._bufs = DecodeBuffers(B, self.max_pages_per_seq, decode_chunk_len, self.n_inject,
                                   self.MAX_PREFILL_GROUP, self.prefill_lane,
                                   self.LANE_MAX_ACT, self.device)
        self._pbufs = PrefillBuffers(
            self.MAX_PREFILL_GROUP, B,
            min(self.MAX_PREFILL_GROUP * max_seq_len, max(max_seq_len, self.PREFILL_TOKEN_BUDGET)),
            self.max_pages_per_seq, max_seq_len, self.device)
        self._programs: dict[tuple, Program] = {}
        # prefill programs keyed (bucket, Gp, fresh, ring, P)
        self._prefill_programs: dict[tuple, Program] = {}
        self._programs_params = None   # the weights tree the programs were built on
        self._graph_pool = self._capture_stream = None
        self._prefill_keys: set = set()   # (bucket, rows, fresh, ring) warmup() ran
        self._warmed = False   # False inside warmup(): builds there are not counted
        # rows whose host state the static buffers do not hold yet
        self._dirty: set[int] = set(range(B))
        self._pending: dict | None = None    # the chunk in flight
        self._inject_handles: list[dict] = []
        self._last_decode_end = 0.0
        self._prefill_clock = 0.0
        self._gap_armed = self._gap_spec = False
        self._gap_t0 = self._gap_pf0 = 0.0

    # ------------------------------------------------------------ public API

    def submit(self, req: GenerationRequest) -> Future:
        fut: Future = Future()
        self._queue.put((req, fut))
        self._wake.set()
        self.start()
        return fut

    def submit_many(self, reqs: list[GenerationRequest]) -> list[Future]:
        """Enqueue a batch atomically so one admission pass sees all of it."""
        futs: list[Future] = [Future() for _ in reqs]
        self._queue.put(list(zip(reqs, futs)))
        self._wake.set()
        self.start()
        return futs

    def generate(self, req: GenerationRequest) -> GenerationResult:
        return self.submit(req).result()

    def abort(self, request_id: str) -> bool:
        """Cancel a queued or in-flight request: queued ones are dropped
        (future cancelled), active ones finish at the next chunk boundary
        with finish_reason='aborted'. Under a multi-rank mesh, on rank 0;
        every rank applies it at the next step."""
        (self._abort_inbox if self.multi else self._aborts).add(request_id)
        self._wake.set()
        return True

    def load_lora_adapter(self, lora_path: str, scale: float | None = None) -> None:
        """Hot-load a LoRA adapter by merging it into the served weights
        (JAX ``engine.py:1141-1170``; the reference demo's vLLM
        ``/load_lora_adapter``). The adapter is a ``train/checkpoint``
        directory of a ``train/lora`` tree on unpacked key names;
        ``scale`` sets every adapter's ``alpha`` to ``scale·rank``. The
        merge (``train/lora.merge_lora``) equals JAX's unpack → apply →
        pack, written one layer matrix at a time into new tensors, and
        ``self.params`` is rebound to the new tree: engines built on the
        same weights keep the old ones, and a forward already running
        finishes on them. Nothing else the engine holds derives from the
        weights (the attention helpers are built per forward) but the decode
        programs, which the engine builds again at its next chunk (each a
        capture on CUDA, counted in ``post_warmup_builds``). As in JAX,
        the prefix cache and parked slots are not flushed: a prompt that
        hits them reuses KV computed with the old weights. int8 weights
        raise JAX's ``ValueError``; so does a sharded engine (ROADMAP.md C)."""
        if self.par is not None:
            raise ValueError("load_lora_adapter merges into unsharded weights; this "
                             "engine is sharded over a mesh")
        from ..train.checkpoint import restore_params
        from ..train.lora import lora_to, merge_lora, rescale_lora

        lora = restore_params(lora_path)
        if scale is not None:
            lora = rescale_lora(lora, scale)
        self.params = merge_lora(self.params, lora_to(lora, self.device), self.cfg)

    @torch.no_grad()
    def warmup(self, prompt_lens=(16,), group_sizes=None, decode=True, fresh_variants=None,
               max_ctx: int | None = None) -> None:
        """Build every program serving reaches before requests arrive (JAX
        ``engine.py:1173-1333``): the prefill program of every (prompt
        bucket, group rows, fresh) — ``group_sizes`` default 1, 4, 16 up to
        ``MAX_PREFILL_GROUP`` padded up that ladder, ``fresh_variants`` the
        one branch this engine runs — at every page-table width a prompt of
        that bucket can read on the non-fresh branch (:meth:`_prefill_widths`:
        from the narrowest prompt of the bucket up to the first width that
        covers ``max_ctx``, all of them without it); with ``decode``, the
        decode program of every context bucket up to the first one that
        covers ``max_ctx`` (all of them without it), both lane variants
        with a prefill lane, the speculative program on a speculative
        engine, and with ``chunk_trim`` the half-length program at the two
        widest, the only buckets a chunk is trimmed at. On CUDA each program
        is captured here. Every dummy position is padding: no KV is written,
        the seen mask and token history are restored, and only the sampler's
        random stream moves. Then a program built later, outside a
        ``warmup()`` call, counts in ``stats["post_warmup_builds"]``. Call
        before submitting requests (under a multi-rank mesh, on every rank:
        the forwards run the collectives and the sampler draws)."""
        self._warmed = False
        self._warmup(prompt_lens, group_sizes, decode, fresh_variants, max_ctx)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = True

    def _warmup(self, prompt_lens, group_sizes, decode, fresh_variants, max_ctx) -> None:
        B = self.max_slots
        if fresh_variants is None:
            # prefix-reusing engines run the non-fresh branch for every group
            fresh_variants = (self.fresh_prefill,)
        if group_sizes is None:
            group_sizes, g = [], 1
            while g <= self.MAX_PREFILL_GROUP:
                group_sizes.append(g)
                g *= 4
        keys = set()
        for plen in prompt_lens:
            T = self._bucket(max(int(plen), 1))
            cap = self._group_cap(T)
            for G in group_sizes:
                Gp = self._pow2(min(G, cap), cap)
                for fresh in fresh_variants:
                    ring = self._ring_prefill(T, fresh)
                    self._prefill_keys.add((T, Gp, bool(fresh), ring))
                    keys.update((T, Gp, bool(fresh), ring, P)
                                for P in self._prefill_widths(T, bool(fresh), max_ctx))
        for key in self._widest_first(keys):
            prog = self._prefill_program(key)
            self._upload_prefill(key, [])   # every row padding
            prog()
        if decode:
            bf = self._bufs
            seen0, act0 = self._seen_ext.clone(), bf.act.clone()
            hist0 = None if self.hist is None else self.hist.clone()
            bf.act.zero_()
            bf.inj_rows.fill_(B)
            if self.prefill_lane:
                bf.lpos.fill_(-1)
                bf.act_slots.fill_(B)
            variants = self._decode_variants(max_ctx)
            keys = [(P, s, lane, self.speculative is not None, None) for P, s in variants
                    for lane in ((False, True) if self.prefill_lane else (False,))]
            if self.chunk_trim:
                keys += [(P, s, False, False, self._trim_chunk) for P, s in variants[-2:]]
                self._trim_warm.update(variants[-2:])
            for key in keys:
                self._program(*key)()
            bf.act.copy_(act0)
            self._seen_ext.copy_(seen0)
            if hist0 is not None:
                self.hist.copy_(hist0)

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stopping = False
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def shutdown(self):
        """Stop the scheduler; on rank 0 of a multi-rank mesh, every rank's
        (at its next step)."""
        self._stopping = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def follow(self) -> None:
        """A multi-rank mesh's ranks other than 0: run the scheduler on this
        thread, on the requests rank 0 broadcasts, until rank 0 shuts down.
        Each request's result lands in a future in :attr:`mirrored`."""
        if not self.multi or self.par.rank == 0:
            raise ValueError("follow() is for the ranks other than 0 of a multi-rank mesh")
        self._loop()

    def _sync(self) -> bool:
        """One step's control message under a multi-rank mesh: rank 0's new
        requests (without their streaming callbacks), aborts, stop flag
        and the trim gate's measured walls, broadcast to every rank; each
        rank queues the requests in the same order (a follower with new
        futures) and adopts the rest. Returns the stop flag."""
        if self.par.rank == 0:
            items = []
            while True:
                try:
                    items.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            aborts = list(self._abort_inbox)
            self._abort_inbox.difference_update(aborts)
            stop = self._stopping   # read once: shutdown() may set it meanwhile
            wire = [[_wire_req(r) for r, _ in item] if isinstance(item, list)
                    else _wire_req(item[0]) for item in items]
            self.par.broadcast((wire, aborts, stop, self._chunk_ema, self._gap_ema))
            for item in items:
                self._inbox.put(item)
        else:
            wire, aborts, stop, self._chunk_ema, self._gap_ema = self.par.broadcast(None)
            for w in wire:
                pairs = [(r, Future()) for r in (w if isinstance(w, list) else [w])]
                self.mirrored.extend(f for _, f in pairs)
                self._inbox.put(pairs if isinstance(w, list) else pairs[0])
        self._aborts.update(aborts)
        if stop:   # no rank tears down before all have the message
            self.par.barrier()
        return stop

    def telemetry(self) -> dict:
        out = dict(self.stats)
        out["spans"] = self.spans.summary()
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if out["decode_time_s"] > 0:
            out["decode_tokens_per_s"] = out["decode_tokens"] / out["decode_time_s"]
        if self.speculative and out["slot_steps"] > 0:
            # tokens emitted per row-step: 1.0 accepts no draft, spec_k+1 all
            out["spec_tokens_per_step"] = out["decode_tokens"] / out["slot_steps"]
        if self._gap_ema > 0.0:
            out["exposed_gap_ema_ms"] = round(self._gap_ema * 1000, 2)
        # "graph": every chunk a replayed CUDA graph; "cpu": the body run
        # eagerly on the CPU; "eager": a mesh engine's serial eager chunk
        out["decode_program"] = self.decode_program
        # the prefill programs (JAX engine.py:1001-1106): the same mode as
        # the decode programs, one engine-wide setting reported per kind
        out["prefill_program"] = self.decode_program
        return out

    # ------------------------------------------------------------- scheduler

    def _loop(self):
        """The scheduler (JAX ``engine.py:1349-1476``): while the host reads
        back chunk N, folds its tokens and admits new requests, the card
        already runs chunk N+1, dispatched from N's device carry. Rows whose
        host state changed in between are told apart by their epochs and
        their results in N+1 dropped; the page and prefix-cache invariants
        hold because the card runs everything in dispatch order (N+1's
        writes past a finished row's end land before any re-admission's
        prefill overwrites them, and past its last full page, which is all
        the prefix cache keeps). Under a multi-rank mesh each iteration
        starts with rank 0's control message (:meth:`_sync`)."""
        while True:
            try:
                stop = self._sync() if self.multi else self._stopping
                with torch.no_grad():
                    if stop:
                        # the chunk in flight is read back: no work is left
                        # on the card and its tokens and counts are kept
                        if self._pending is not None:
                            self._process_decode(self._pending)
                            self._pending = None
                        self._drain_inject()
                        return
                    if self._pending is None:
                        self._apply_aborts()
                        admitted = self._admit(defer=True)
                        if not any(s.active for s in self.slots) and not self._lane:
                            self._drain_inject()   # stale handles (rows aborted)
                            if not admitted and not (self.multi and self.par.rank):
                                # idle (a follower waits in the next broadcast)
                                self._wake.wait(timeout=0.05)
                                self._wake.clear()
                            continue
                        self._pending = self._dispatch_decode(None)
                        self._drain_inject()
                        continue
                    nxt = None
                    if (self.pipeline_decode and not self._aborts
                            and self._can_speculate(self._pending)
                            and not self._churn_imminent(self._pending)):
                        nxt = self._dispatch_decode(self._pending)
                        if nxt is not None:
                            self.stats["pipelined_chunks"] += 1
                    self._drain_inject()
                    freed_before = self._n_free()
                    self._gap_spec = nxt is not None
                    self._process_decode(self._pending)
                    self._pending = nxt
                    self._apply_aborts()
                    self._refill_grace(self._n_free() - freed_before)
                    self._admit(defer=True)
            except Exception as e:  # engine-step crash: fail in-flight work loudly
                traceback.print_exc()
                self._pending = None
                self._inject_handles.clear()   # their slots' futures are failed below
                for s in self.slots:
                    if s.future is not None and not s.future.done():
                        s.future.set_exception(e)
                    s.reset()
                for _, fut in self._deferred:
                    if not fut.done():
                        fut.set_exception(e)
                self._deferred.clear()
                self._resumes.clear()
                self._lane.clear()   # their slots' futures were failed above
                for q in {id(self._inbox): self._inbox, id(self._queue): self._queue}.values():
                    while not q.empty():
                        try:
                            item = q.get_nowait()
                        except queue.Empty:
                            break
                        for _, fut in (item if isinstance(item, list) else [item]):
                            if not fut.done():
                                fut.set_exception(e)
                return

    def _n_free(self) -> int:
        return sum(1 for s in self.slots if not s.active and s.req is None)

    def _refill_grace(self, n_freed: int) -> None:
        """After a chunk freed rows with nothing queued, wait 2 ms for
        closed-loop clients to refill them (JAX's default ``"fixed"``
        grace, ``engine.py:1403-1446``)."""
        if n_freed > 0 and self._queue.empty() and not self._deferred:
            self._wake.wait(timeout=0.002)
            self._wake.clear()

    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_seq_len)

    @staticmethod
    def _pow2(n: int, cap: int) -> int:
        """A prefill group's rows padded up JAX's ladder (powers of 4:
        1, 4, 16, ...), capped: the group shapes ``warmup()`` builds."""
        g = 1
        while g < n:
            g *= 4
        return min(g, cap)

    def _group_cap(self, bucket: int) -> int:
        return max(1, min(self.MAX_PREFILL_GROUP,
                          self.PREFILL_TOKEN_BUDGET // max(bucket, 1)))

    def _decode_buckets(self) -> list[int]:
        """Page-count buckets up to the per-sequence page budget (JAX
        ``engine.py:664-684``): ``context_buckets=True`` the powers of two,
        ``"fine"`` also their 1.5x midpoints, ``False`` the budget alone."""
        cap = self.max_pages_per_seq
        if not self.context_buckets:
            return [cap]
        fine = self.context_buckets == "fine"
        out = set()
        b = 1
        while b < cap:
            out.add(b)
            if fine and 1 < (b * 3) // 2 < cap:
                out.add((b * 3) // 2)
            b *= 2
        out.add(cap)
        return sorted(out)

    def _slot_buckets(self) -> list[int]:
        """Token-width buckets of the slot cache (JAX ``engine.py:625-642``):
        the same ladder from 64 tokens, capped at ``max_seq_len``."""
        cap = self.max_seq_len
        if not self.context_buckets:
            return [cap]
        fine = self.context_buckets == "fine"
        out = set()
        b = 64
        while b < cap:
            out.add(b)
            if fine and 64 < (b * 3) // 2 < cap:
                out.add((b * 3) // 2)
            b *= 2
        out.add(cap)
        return sorted(out)

    def _page_bucket(self, n_tokens: int) -> int:
        """The page-table width a chunk needing ``n_tokens`` reads: the first
        bucket of the ladder that covers them, as ``_dispatch_decode`` walks
        it (JAX ``engine.py:2305-2326``); the whole budget without
        ``context_buckets``."""
        need = -(-n_tokens // self.page_size)
        if self.context_buckets:
            for b in self._decode_buckets():
                if b >= need:
                    return b
        return self.max_pages_per_seq

    def _slot_bucket(self, n_tokens: int) -> int | None:
        """Slot mode: the context width a chunk needing ``n_tokens`` reads,
        the first slot bucket that covers them; None (the whole row) in
        paged mode and without ``context_buckets``."""
        if self.cache_mode != "slot" or not self.context_buckets:
            return None
        for b in self._slot_buckets():
            if b >= n_tokens:
                return b
        return None

    def _decode_variants(self, max_ctx: int | None = None) -> list[tuple[int, int | None]]:
        """The (page bucket, slot bucket) pairs of the decode programs
        ``warmup()`` builds, narrowest first (JAX ``engine.py:1233-1250``):
        every bucket up to the first one that covers ``max_ctx``."""
        if self.cache_mode == "slot":
            buckets = self._slot_buckets() if self.context_buckets else [None]
            if max_ctx is not None and self.context_buckets:
                buckets = ([b for b in buckets if b < max_ctx]
                           + [b for b in buckets if b >= max_ctx][:1])
            return [(1, b) for b in buckets]
        buckets = self._decode_buckets()
        if max_ctx is not None and self.context_buckets:
            need = -(-max_ctx // self.page_size)
            buckets = [b for b in buckets if b < need] + [b for b in buckets if b >= need][:1]
        return [(b, None) for b in buckets]

    def _program(self, P: int, slot_ctx: int | None = None, lane: bool = False,
                 spec: bool = False, chunk_len: int | None = None) -> Program:
        """The decode program of key ``(P, slot_ctx, lane, spec,
        chunk_len)`` (JAX ``_decode_program``, ``engine.py:644-662``, plus
        the page bucket), built on first use; one built after ``warmup()``
        is counted and reported on stderr."""
        if self.cache_mode != "slot":
            slot_ctx = None
        key = (int(P), slot_ctx, bool(lane), bool(spec), chunk_len)
        return self._built(self._programs, key, chunk_body, "decode",
                           "(pages,slot_ctx,lane,spec,chunk)", free_cache=False)

    def _prefill_program(self, key: tuple) -> Program:
        """The prefill program of key ``(bucket, Gp, fresh, ring, P)`` (JAX
        ``_prefill_fn``, ``engine.py:1001-1106``, plus the page-table width
        ``P`` of the non-fresh branch), built on first use; one built after
        ``warmup()`` is counted and reported on stderr. Its capture frees
        the allocator's cache first: the eager run's wide intermediates
        would else be held twice (``Program``)."""
        return self._built(self._prefill_programs, key, prefill_body, "prefill",
                           "(bucket,group,fresh,ring,pages)", free_cache=True)

    def _built(self, programs: dict, key: tuple, make_body, kind: str, names: str, *,
               free_cache: bool) -> Program:
        """``programs[key]``, built on first use from ``make_body(self,
        key)``: captured on CUDA (one graph pool and one capture stream for
        all of the engine's programs), eager on the CPU and under a mesh."""
        if (self._programs or self._prefill_programs) and self._programs_params is not self.params:
            # the weights were rebound (load_lora_adapter): a graph holds the
            # old tensors' addresses, so every program is built again, in a
            # new pool (the allocator retires a pool whose graphs are gone)
            if self.decode_program == "graph":
                torch.cuda.synchronize(self.device)
                self._graph_pool = torch.cuda.graph_pool_handle()
            self._programs.clear()
            self._prefill_programs.clear()
        self._programs_params = self.params
        prog = programs.get(key)
        if prog is None:
            if self._warmed:
                self.stats["post_warmup_builds"] += 1
                print(f"[engine] post-warmup {kind} program build: {names}={key}",
                      file=sys.stderr)
            capture = self.decode_program == "graph"
            if capture and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
            prog = programs[key] = Program(
                key, make_body(self, key), capture=capture, generator=self.generator,
                pool=self._graph_pool, stream=self._capture_stream, free_cache=free_cache)
        return prog

    def _widest_first(self, keys) -> list:
        """Prefill keys in the order ``warmup()`` captures them: the most
        score elements (rows × prompt width × context) first. The programs
        share one graph pool, whose blocks a later capture reuses only when
        they are at least as large as it asks: widest first, the narrower
        keys' intermediates fit in blocks the widest left free, and the
        pool holds about the widest key's peak instead of the sum of every
        width's."""
        def size(key):
            bucket, Gp, fresh, _, P = key
            ctx = bucket if fresh else P * self.page_size
            return Gp * bucket * ctx, Gp * bucket
        return sorted(keys, key=size, reverse=True)

    def _prefill_widths(self, bucket: int, fresh: bool, max_ctx: int | None = None) -> list:
        """The page-table widths ``P`` of the prefill programs ``warmup()``
        builds for ``bucket``: None on the fresh branch; else every page
        bucket from the one that covers the bucket's narrowest prompt (one
        token past the next narrower bucket) up to the first that covers
        ``max_ctx`` (all of them without it), as :meth:`_decode_variants`
        bounds the decode programs. A cached prefix makes a prompt's
        context wider than its bucket."""
        if fresh:
            return [None]
        lo, b = 1, 16
        while b < bucket:
            lo, b = b + 1, b * 2
        widths = [P for P in self._decode_buckets() if P >= self._page_bucket(lo)]
        if max_ctx is not None and self.context_buckets:
            need = -(-max_ctx // self.page_size)
            widths = [P for P in widths if P < need] + [P for P in widths if P >= need][:1]
        return widths

    def _prefill_widths_of(self, key: tuple) -> tuple[int, int]:
        """Prefill program ``key``'s page-table width in pages and its
        prompts' width in ids: ``P`` pages and their tokens on the non-fresh
        branch; on the fresh branch the pages and the tokens of the bucket,
        which hold a whole prompt there."""
        bucket, _, fresh, _, P = key
        if fresh:
            return min(-(-bucket // self.page_size), self.max_pages_per_seq), bucket
        return P, min(P * self.page_size, self.max_seq_len)

    def _free_slot(self) -> _Slot | None:
        """A free row; in slot mode unparked rows first, so parked KV
        survives for re-entry, then the least recently parked one."""
        parked = None
        for s in self.slots:
            if not s.active and s.req is None:
                if s.idx not in self._parked:
                    return s
                if parked is None or (self._parked[s.idx]["t"]
                                      < self._parked[parked.idx]["t"]):
                    parked = s
        return parked

    def _match_parked(self, prompt: list[int]) -> tuple[_Slot, int] | None:
        """Longest parked row whose stored tokens prefix-match ``prompt``:
        ``min(common prefix, usable, len(prompt) - 1)`` tokens, so at least
        one prompt token prefills to produce logits (token-exact)."""
        best, best_len = None, 0
        limit = len(prompt) - 1
        p = np.asarray(prompt[:limit], np.int64)
        for idx, rec in self._parked.items():
            s = self.slots[idx]
            if s.active or s.req is not None:
                continue
            toks = rec["tokens"]
            n = min(rec["usable"], limit, len(toks))
            if n <= best_len:
                continue
            diff = toks[:n] != p[:n]
            m = int(np.argmax(diff)) if diff.any() else n
            if m > best_len:
                best, best_len = s, m
        if best is None or best_len <= 0:
            return None
        return best, best_len

    def _ensure_pages(self, needed: int) -> bool:
        if self.allocator.can_alloc(needed):
            return True
        if self.prefix_cache is not None:
            self.prefix_cache.evict_lru(needed)
        return self.allocator.can_alloc(needed)

    def _apply_aborts(self) -> None:
        if not self._aborts:
            return
        for s in self.slots:
            if s.active and s.req and s.req.request_id in self._aborts:
                self._aborts.discard(s.req.request_id)
                s.stop.finished, s.stop.finish_reason = True, "aborted"
                self._finish_slot(s, reason="aborted")
        # queued lane prompts: a prompt leaves the queue when a chunk takes
        # it, so none of these was dispatched and each is freed at once, as
        # JAX frees a never-dispatched entry (engine.py:1569-1580); one
        # that a chunk in flight carries is freed when that chunk is read
        # back (_process_decode)
        keep = []
        for p in self._lane:
            rid = p["req"].request_id
            if rid in self._aborts:
                self._aborts.discard(rid)
                fut = p["slot"].future
                self._release(p["slot"])
                if fut is not None and not fut.done():
                    fut.cancel()
            else:
                keep.append(p)
        self._lane = keep

    def _admit(self, defer: bool = False) -> bool:
        """Admit queued requests with batched prefill, one forward per
        (prompt bucket, group of <= _group_cap rows), every group dispatched
        before any is read back (JAX ``engine.py:1582-1717``). ``defer``
        (admission injection): the newest ``n_inject`` groups' rows are
        activated without a sync; the next chunk takes their first tokens
        on the device and :meth:`_drain_inject` reads them back after its
        dispatch. A mesh engine syncs every group here."""
        prepared = []
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            if self._deferred:
                req, fut = self._deferred.pop(0)
            else:
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, list):  # submit_many batch
                    self._deferred.extend(item)
                    continue
                req, fut = item
            if req.request_id in self._aborts:
                self._aborts.discard(req.request_id)
                self._resumes.pop(fut, None)
                fut.cancel()
                continue
            try:
                prepared.append(self._prepare_request(slot, req, fut))
            except MemoryError as e:
                slot.reset()
                prompt_need = -(-(min(len(req.prompt_ids), self.max_seq_len) + 1)
                                // self.page_size)
                if prompt_need >= self.n_pages:
                    if not fut.done():   # the prompt alone can never fit
                        fut.set_exception(e)
                else:   # wait until in-flight sequences release pages
                    self._deferred.append((req, fut))
                    break
            except Exception as e:  # surface failures to the caller
                slot.reset()
                if not fut.done():
                    fut.set_exception(e)
        if not prepared:
            return False
        if self.prefill_lane and (any(s.active for s in self.slots) or self._lane
                                  or self._pending is not None):
            # decode is running: whole prompts with no cached prefix that fit
            # one step ride the lane, up to a chunk's backlog; the rest (and
            # every cold burst) takes batched prefill (JAX engine.py:1643-1662)
            overflow = []
            for p in prepared:
                if (len(self._lane) < self.decode_chunk_len and p["cached_len"] == 0
                        and len(p["suffix"]) <= self.prefill_lane):
                    self._lane.append(p)
                else:
                    overflow.append(p)
            if not overflow:
                return True
            prepared = overflow
        groups: dict[int, list] = {}
        for p in prepared:
            groups.setdefault(self._bucket(max(len(p["suffix"]), 1)), []).append(p)
        handles = []
        for bucket, grp in sorted(groups.items()):
            cap = self._group_cap(bucket)
            for i in range(0, len(grp), cap):
                sub = grp[i: i + cap]
                try:
                    handles.append(self._prefill_group_dispatch(bucket, sub))
                except Exception as e:  # fail this group, not the engine
                    traceback.print_exc()
                    for p in sub:
                        self._fail_prepared(p, e)
        room = self.n_inject - len(self._inject_handles)
        if defer and self.par is None and room > 0 and handles:
            # the newest groups: their rows decode from the next chunk on,
            # which takes their first tokens from the card
            handles, injected = handles[:-room], handles[-room:]
            for h in injected:
                for g, p in enumerate(h["grp"]):
                    s = p["slot"]
                    if s.epoch == h["epochs"][g]:
                        self.seq_lens[s.idx] = len(p["prompt"])
                        # a row that ends at its first token stays inactive:
                        # no chunk is queued for it ahead of the next prefill
                        s.active = (s.stop.n_tokens + 1 < s.stop.max_tokens
                                    and len(p["prompt"]) + 1 < self.max_seq_len)
                        self._dirty.add(s.idx)
            self._inject_handles.extend(injected)
            self.stats["injected_groups"] += len(injected)
        for h in handles:
            self._prefill_group_process_safe(h)
        return True

    def _prefill_group_process_safe(self, h: dict) -> None:
        try:
            self._prefill_group_process(h)
        except Exception as e:  # fail this group, not the engine
            traceback.print_exc()
            for p in h["grp"]:
                self._fail_prepared(p, e)

    def _preempt_slot(self, s: _Slot) -> None:
        """Evict an active sequence under page pressure without losing work:
        its tokens and stop/stream state are kept and the request re-enters
        the queue as a continuation; its full pages go to the prefix cache,
        so the re-prefill normally re-adopts them."""
        self.stats["preemptions"] += 1
        req, fut = s.req, s.future
        self._resumes[fut] = {
            "generated": list(s.generated), "stop": s.stop, "detok": s.detok,
            "orig_prompt": list(s.prompt_tokens),
        }
        if self.prefix_cache is not None:
            full_tokens = list(s.prompt_tokens) + list(s.generated)
            n_full = int(self.seq_lens[s.idx]) // self.page_size
            pages = (s.shared_pages + s.pages)[:n_full]
            if pages:
                self.prefix_cache.insert(full_tokens, pages)
        self._release(s)
        self._deferred.append((req, fut))

    def _release(self, s: _Slot) -> None:
        self.allocator.free(s.shared_pages)
        self.allocator.free(s.pages)
        self.page_tables[s.idx, :] = s.idx if self.cache_mode == "slot" else 0
        self.seq_lens[s.idx] = 0
        self._dirty.add(s.idx)
        s.reset()

    def _fail_prepared(self, p: dict, exc: Exception) -> None:
        """Release a prepared-but-unprefilled request after a group failure."""
        fut = p["slot"].future
        self._release(p["slot"])
        if fut is not None and not fut.done():
            fut.set_exception(exc)

    def _prepare_request(self, slot: _Slot, req: GenerationRequest,
                         fut: Future) -> dict:
        """Host-side admission: pages, prefix match, slot state."""
        resume = self._resumes.pop(fut, None)
        if resume is not None:
            # preempted continuation: re-prefill prompt + generated-so-far
            prompt = resume["orig_prompt"] + resume["generated"]
            eff_tokens = max(1, req.max_tokens - len(resume["generated"]))
        else:
            prompt = list(req.prompt_ids)
            eff_tokens = req.max_tokens
        if len(prompt) >= self.max_seq_len:
            # keep the prompt tail, reserving room for generation
            eff_max = max(1, min(eff_tokens, self.max_seq_len - 1))
            keep = max(1, self.max_seq_len - eff_max - 1)
            prompt = prompt[-keep:]
        total_budget = min(len(prompt) + eff_tokens + self._max_adv, self.max_seq_len)

        shared: list[int] = []
        own: list[int] = []
        cached_len = 0
        if self.cache_mode == "slot":
            # the cache row is the slot row; a parked row whose tokens the
            # prompt extends is re-entered instead of the free row
            if self._slot_park:
                best = self._match_parked(prompt)
                if best is not None:
                    slot, cached_len = best
                    self.stats["slot_park_hits"] += 1
                    self.stats["slot_park_tokens"] += cached_len
            self._parked.pop(slot.idx, None)   # the row is being reused
        else:
            if self.prefix_cache is not None and len(prompt) > self.page_size:
                # never match the whole prompt: one token must prefill for logits
                shared, cached_len = self.prefix_cache.match(prompt[:-1])
            n_new_pages = -(-total_budget // self.page_size) - len(shared)
            if not self._ensure_pages(n_new_pages):
                # admit with whatever fits beyond the prompt; decode-time
                # exhaustion preempts by requeue
                min_pages = -(-(len(prompt) + 1) // self.page_size) - len(shared)
                if self._ensure_pages(min_pages):
                    n_new_pages = max(min_pages, self.allocator.num_free // 2)
                    n_new_pages = min(n_new_pages, self.allocator.num_free)
                else:
                    if shared:
                        self.allocator.free(shared)
                    raise MemoryError("KV pages exhausted")
            own = self.allocator.alloc(max(n_new_pages, 0))

        slot.req, slot.future = req, fut
        slot.shared_pages, slot.pages = shared, own
        slot.prompt_tokens, slot.prompt_len = prompt, len(prompt)
        slot.cached_len = cached_len
        slot.generated = []
        eos_ids = tuple(i for i in (self.tokenizer.eos_id,) if i is not None)
        slot.stop = StopState(tuple(req.stop), eos_ids, req.max_tokens,
                              req.include_stop_str)
        slot.detok = IncrementalDetokenizer(self.tokenizer)
        if resume is not None:
            slot.prompt_tokens = resume["orig_prompt"]
            slot.prompt_len = len(resume["orig_prompt"])
            slot.generated = resume["generated"]
            slot.stop = resume["stop"]
            slot.detok = resume["detok"]

        b = slot.idx
        if self.cache_mode == "slot":
            self.page_tables[b, 0] = b
        else:
            all_pages = shared + own
            self.page_tables[b, :] = 0
            self.page_tables[b, : len(all_pages)] = all_pages
        for k, v in (("temperature", req.temperature), ("top_k", req.top_k),
                     ("top_p", req.top_p), ("min_p", req.min_p),
                     ("repetition_penalty", req.repetition_penalty)):
            self.samp_host[k][b] = v
        self.min_tokens[b] = (req.min_tokens if resume is None else
                              max(0, req.min_tokens - len(slot.generated)))
        self.prompt_lens[b] = len(prompt)
        self._dirty.add(b)
        return {"slot": slot, "req": req, "suffix": prompt[cached_len:],
                "cached_len": cached_len, "prompt": prompt,
                "pre_gen": len(slot.generated)}

    # ------------------------------------------------------------ device work

    def _d2h(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s value as it stands at this point of the stream, copied to
        pinned host memory behind the work queued so far; read it after
        :meth:`_event`'s event."""
        if self.device.type != "cuda":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    def _event(self):
        """An event recorded behind the work queued so far (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _t(self, a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
        """A host array on the engine's device, copied asynchronously from
        pinned memory: PyTorch's pinned-memory cache records an event
        behind each copy and hands the block out again only once that
        event shows the copy done."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _forward(self, tokens, positions, tables, seq_lens, *,
                 logits_indices=None, fresh=False, slot_ctx=None, seq_parallel=None,
                 **lane):
        """One forward over the engine's pools (updated in place, int8 KV's
        scales pools too); ``slot_ctx`` (slot mode decode: T=1, or a verify
        window) makes it a slot decode reading that context bucket;
        ``lane`` holds the ``lane_*`` arguments of a step carrying the
        prefill lane; ``seq_parallel`` ("ring" / "ulysses") runs a fresh
        prefill's attention sequence-parallel over the mesh's ``tp``."""
        scales = ({} if self.k_scales is None
                  else {"k_scales": self.k_scales, "v_scales": self.v_scales})
        if self.par is not None:
            scales["par"] = self.par
        if seq_parallel is not None:
            scales["seq_parallel"] = seq_parallel
        return self.forward(
            self.params, self.fcfg, tokens, positions,
            k_pages=self.k_pages, v_pages=self.v_pages, page_table=tables,
            seq_lens=seq_lens, logits_indices=logits_indices, impl=self.attn_impl,
            slot_decode=slot_ctx is not None, slot_ctx=slot_ctx,
            fresh_prefill=fresh, fused_decode=self.layer_fusion, **scales, **lane)

    def _ring_prefill(self, bucket: int, fresh: bool) -> bool:
        """Fresh prefills at/over ``ring_prefill_len`` run sequence-parallel
        attention over the mesh's tp axis (JAX ``engine.py:990-999``)."""
        return (fresh and self.ring_prefill_len is not None
                and self.mesh is not None
                and self.par.tp > 1
                and bucket >= self.ring_prefill_len
                and bucket % self.par.tp == 0)

    def _prefill_group_dispatch(self, bucket: int, grp: list[dict]) -> dict:
        """One prefill program for a group of same-bucket requests (JAX
        ``engine.py:1918-2018``): the group padded up the row ladder to
        ``Gp``, its inputs written into the static buffers and the program
        of key ``(bucket, Gp, fresh, ring, P)`` run (replayed on CUDA),
        queued on the card without a sync; the first tokens' copy to the
        host starts behind it. Returns the handle
        :meth:`_prefill_group_process` reads; its ``first`` holds
        ``MAX_PREFILL_GROUP`` tokens of its own (a later replay of the
        same key rewrites the program's output), which admission injection
        copies device to device."""
        t0 = time.monotonic()
        G = len(grp)
        Gp = self._pow2(G, self._group_cap(bucket))
        fresh = self.fresh_prefill
        ring = self._ring_prefill(bucket, fresh)
        P = None if fresh else self._page_bucket(max(len(p["prompt"]) for p in grp))
        key = (bucket, Gp, fresh, ring, P)
        self.sp_prefills += int(ring)
        with self.spans.span("prefill_dispatch"):
            prog = self._prefill_program(key)
            self._upload_prefill(key, grp)
            first = prog()["first"].clone()
            host = self._d2h(first)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_rows"] += G
        # group-size histogram, "{bucket}x{rows}" -> dispatches (JAX's)
        hist = self.stats.setdefault("prefill_group_hist", {})
        hist[f"{bucket}x{G}"] = hist.get(f"{bucket}x{G}", 0) + 1
        return {"grp": grp, "first": first, "host": host, "event": self._event(), "t0": t0,
                "epochs": [p["slot"].epoch for p in grp]}

    def _upload_prefill(self, key: tuple, grp: list[dict]) -> None:
        """Group ``grp``'s inputs (empty: every row padding) into the static
        prefill buffers of ``key``, in two copies to the card (one of ints,
        one of floats) queued before the program: each row's suffix tokens
        and positions (-1 past it), page-table row, prompt length, last
        position, slot row (``max_slots`` on padding rows), sampler fields
        and ``min_tokens`` (a padding row repeats the last row's, as JAX's),
        and the whole prompt's ids."""
        bucket, Gp = key[:2]
        width, W = self._prefill_widths_of(key)
        G = len(grp)
        tokens = np.zeros((Gp, bucket), np.int64)
        positions = np.full((Gp, bucket), -1, np.int64)
        tables = np.zeros((Gp, width), np.int64)
        seq_lens = np.zeros((Gp,), np.int64)
        logits_idx = np.zeros((Gp,), np.int64)
        rows = np.full((Gp,), self.max_slots, np.int64)
        n_ids = max((len(p["prompt"]) for p in grp), default=0)
        ids = np.zeros((Gp, n_ids), np.int64)
        for g, p in enumerate(grp):
            T, prompt = len(p["suffix"]), p["prompt"]
            tokens[g, :T] = p["suffix"]
            positions[g, :T] = np.arange(p["cached_len"], p["cached_len"] + T)
            tables[g] = self.page_tables[p["slot"].idx, :width]
            seq_lens[g] = len(prompt)
            logits_idx[g] = max(T - 1, 0)
            rows[g] = p["slot"].idx
            ids[g, :len(prompt)] = prompt
        srows = rows[:G] if G else np.zeros((1,), np.int64)
        srows = np.concatenate([srows, np.repeat(srows[-1:], Gp - len(srows))])
        ints = np.concatenate([tokens.ravel(), positions.ravel(), tables.ravel(), seq_lens,
                               logits_idx, rows, self.min_tokens[srows],
                               self.samp_host["top_k"][srows], ids.ravel()]).astype(np.int64)
        flts = np.concatenate([self.samp_host[f][srows] for f in FLOAT_FIELDS])
        di, df = self._t(ints), self._t(flts, torch.float32)
        b, o = self._pbufs.views(key, width, W), 0
        for name in ("tok", "pos", "tables", "seq_lens", "logits_idx", "rows", "min_tokens",
                     "top_k"):
            n = b[name].numel()
            b[name].copy_(di[o: o + n].view(b[name].shape))
            o += n
        # ids past a prompt's length are masked by its seq_lens in the body
        b["ids"][:, :n_ids].copy_(di[o:].view(Gp, n_ids))
        for i, f in enumerate(FLOAT_FIELDS):
            b[f].copy_(df[i * Gp: (i + 1) * Gp])

    def _prefill_group_process(self, h: dict) -> None:
        """Read one dispatched group's first tokens back and fold them into
        slot state (JAX ``engine.py:2020-2047``); rows reset since the
        dispatch are skipped."""
        grp, t0 = h["grp"], h["t0"]
        with self.spans.span("prefill_sync"):
            if h["event"] is not None:
                h["event"].synchronize()
            first_np = h["host"].numpy()
        n_prefill = 0
        for g, p in enumerate(grp):
            slot, prompt = p["slot"], p["prompt"]
            if slot.epoch != h["epochs"][g]:
                continue   # aborted / reset between the dispatch and this sync
            b = slot.idx
            self.seq_lens[b] = len(prompt)
            self.last_tok[b] = int(first_np[g])
            self._dirty.add(b)
            slot.active = True
            self._process_chunk(slot, first_np[g: g + 1])
            n_prefill += len(p["suffix"])
            self.stats["requests"] += 1
            new_gen = len(slot.generated) - p["pre_gen"]
            if slot.stop.finished or len(prompt) + new_gen >= self.max_seq_len:
                self._finish_slot(slot)
        self.stats["prefill_tokens"] += n_prefill
        # the union of [t0, now] with what is counted already: groups
        # dispatched back to back overlap
        now = time.monotonic()
        self.stats["prefill_time_s"] += now - max(t0, self._prefill_clock)
        self._prefill_clock = now

    def _plan_lane(self, chunk: int) -> dict:
        """Take queued lane prompts onto this chunk's steps (JAX
        ``engine.py:2063-2105``): one whole prompt a step from the first
        step, at most ``LANE_MAX_ACT`` a chunk. Each is an activation: its
        first token is sampled from its step's lane logits after the chunk
        and its slot activated. The prompts taken leave the queue."""
        Tp, n = self.prefill_lane, min(chunk, self.LANE_MAX_ACT, len(self._lane))
        taken, self._lane = self._lane[:n], self._lane[n:]
        per_step: list[dict | None] = [None] * chunk
        acts = []
        for step, p in enumerate(taken):
            take = len(p["suffix"])
            toks = np.zeros((Tp,), np.int32)
            pos = np.full((Tp,), -1, np.int32)
            toks[:take] = p["suffix"]
            pos[:take] = np.arange(take)
            per_step[step] = {"slot": p["slot"].idx, "toks": toks, "pos": pos,
                              "row": take - 1}
            acts.append({"i": step, "step": step, "slot": p["slot"].idx, "p": p,
                         "epoch": p["slot"].epoch})
        return {"per_step": per_step, "acts": acts,
                "n_tokens": sum(len(p["suffix"]) for p in taken),
                "max_tokens_needed": max((len(p["suffix"]) + 1 for p in taken), default=0)}

    def _lane_arrays(self, plan: dict, chunk: int, p_cur: int) -> tuple:
        """A lane plan as arrays (JAX ``engine.py:2107-2129``): tokens and
        positions [chunk, Tp], page-table rows [chunk, p_cur], the logit
        row of each step, and the activations' slots (``max_slots`` past
        the last) and steps [LANE_MAX_ACT]."""
        Tp, A = self.prefill_lane, self.LANE_MAX_ACT
        toks = np.zeros((chunk, Tp), np.int32)
        pos = np.full((chunk, Tp), -1, np.int32)
        tabs = np.zeros((chunk, p_cur), np.int32)
        rows = np.zeros((chunk,), np.int32)
        for step, s in enumerate(plan["per_step"]):
            if s is None:
                continue
            toks[step], pos[step], rows[step] = s["toks"], s["pos"], s["row"]
            tabs[step] = self.page_tables[s["slot"], :p_cur]
        act_slots = np.full((A,), self.max_slots, np.int32)
        act_steps = np.zeros((A,), np.int32)
        for a in plan["acts"]:
            act_slots[a["i"]], act_steps[a["i"]] = a["slot"], a["step"]
        return toks, pos, tabs, rows, act_slots, act_steps

    def _trim(self, active: np.ndarray, buckets: tuple, done_adv=None) -> bool:
        """Whether this chunk runs half length (JAX ``engine.py:2327-2361``):
        only at a bucket ``warmup()`` registered, and when the rows within
        half a chunk of their ``max_tokens`` (counting ``done_adv`` [B],
        the tokens of the chunk in flight) reach the threshold —
        ``trim_min_rows`` where set, else the rows whose saved half chunk
        pays the extra inter-chunk gap (``gap·max_slots / (half·step
        wall)``: the measured exposed gap, ``churn_rtt_s`` before one is
        measured), else ``max_slots // 8`` while no chunk is timed."""
        if not self.chunk_trim or buckets not in self._trim_warm:
            return False
        half = self._trim_chunk
        n_near = 0
        for s in self.slots:
            if active[s.idx]:
                done = s.stop.n_tokens + (0 if done_adv is None else int(done_adv[s.idx]))
                n_near += 0 < s.stop.max_tokens - done <= half
        if self.trim_min_rows is not None:
            thr = self.trim_min_rows
        elif self._chunk_ema > 0.0:
            gap = self._gap_ema if self._gap_ema > 0.0 else self.churn_rtt_s
            step_wall = self._chunk_ema / self.decode_chunk_len
            thr = gap * self.max_slots / max(half * step_wall, 1e-9)
        else:
            thr = self.max_slots // 8
        return n_near >= thr

    def _can_speculate(self, h: dict) -> bool:
        """Worth dispatching the next chunk before reading ``h`` back (JAX
        ``engine.py:2145-2160``)? Only if lane work is queued or some row
        stepped in ``h`` certainly still wants tokens after it."""
        if self._lane:
            return True   # lane prompts keep a pipelined chunk productive
        adv = self._max_adv
        for s in self.slots:
            if not s.active or not h["active"][s.idx] or h["epochs"][s.idx] != s.epoch:
                continue
            if (s.stop.max_tokens - s.stop.n_tokens > adv
                    and int(self.seq_lens[s.idx]) + 2 * adv < self.max_seq_len):
                return True
        return False

    def _churn_imminent(self, h: dict) -> bool:
        """Will too many rows complete during ``h`` (JAX
        ``engine.py:2162-2201``)? A pipelined chunk is dispatched before
        ``h``'s completions are read, so each freed row rides it idle;
        skipping exposes the gap to the whole batch. Pipeline while
        ``n <= max_slots · rtt / chunk wall``: ``rtt`` the measured exposed
        gap, ``churn_rtt_s`` before one is measured (``churn_rtt_s = 0``:
        skip on any completing row), and ``n > max_slots // 16`` while no
        chunk is timed. Rows near the length cap count as completing."""
        adv, n = self._max_adv, 0
        for s in self.slots:
            if not s.active or not h["active"][s.idx] or h["epochs"][s.idx] != s.epoch:
                continue
            if (s.stop.max_tokens - s.stop.n_tokens <= adv
                    or int(self.seq_lens[s.idx]) + 2 * adv >= self.max_seq_len):
                n += 1
        if n == 0:
            return False
        if self._chunk_ema <= 0.0:
            return n > max(1, self.max_slots // 16)
        rtt = (self._gap_ema if self._gap_ema > 0.0 and self.churn_rtt_s > 0.0
               else self.churn_rtt_s)
        return n > self.max_slots * rtt / self._chunk_ema

    def _drain_inject(self) -> None:
        """Read back every injected prefill group (JAX ``engine.py:2222-2236``).
        Called after each dispatch attempt: a handle feeds at most one
        chunk, whose carry then holds the rows' live state (a second
        injection would overwrite it with the stale first token)."""
        handles, self._inject_handles = self._inject_handles, []
        for h in handles:
            self._prefill_group_process_safe(h)

    def _upload_rows(self, valid: np.ndarray) -> None:
        """The dirty rows' host state into the static buffers, queued before
        the replay (so after every earlier chunk): page tables, sampler
        fields, ``min_tokens`` and ``prompt_lens`` of each, and ``last`` /
        ``lens`` of those not ``valid`` in the carry (where the device is
        ahead of the host)."""
        if not self._dirty:
            return
        rows = np.fromiter(sorted(self._dirty), np.int64)
        self._dirty.clear()
        state = rows[~valid[rows]]
        h, k, m, P = self.samp_host, len(rows), len(state), self.max_pages_per_seq
        ints = np.concatenate([rows, self.page_tables[rows].reshape(-1), self.min_tokens[rows],
                               self.prompt_lens[rows], h["top_k"][rows], state,
                               self.last_tok[state], self.seq_lens[state]]).astype(np.int64)
        flts = np.concatenate([h[f][rows] for f in ("temperature", "top_p", "min_p",
                                                    "repetition_penalty")])
        di, df = self._t(ints), self._t(flts, torch.float32)
        bf = self._bufs
        r, o = di[:k], k
        bf.tables.index_copy_(0, r, di[o: o + k * P].view(k, P))
        o += k * P
        for buf in (bf.min_tokens, bf.prompt_lens, bf.top_k):
            buf.index_copy_(0, r, di[o: o + k].to(buf.dtype))
            o += k
        for i, buf in enumerate((bf.temperature, bf.top_p, bf.min_p, bf.repetition_penalty)):
            buf.index_copy_(0, r, df[i * k: (i + 1) * k])
        if m:
            sr = di[o: o + m]
            bf.last.index_copy_(0, sr, di[o + m: o + 2 * m])
            bf.lens.index_copy_(0, sr, di[o + 2 * m: o + 3 * m])

    def _upload_step(self, active: np.ndarray) -> None:
        """The chunk's active rows and the injected groups' rows in one copy
        (row ``max_slots``: dropped; a row reset since its admission stays
        dropped), and the groups' first tokens device to device."""
        bf, B = self._bufs, self.max_slots
        rows = np.full(tuple(bf.inj_rows.shape), B, np.int64)
        for gi, h in enumerate(self._inject_handles[:self.n_inject]):
            for g, p in enumerate(h["grp"]):
                if p["slot"].epoch == h["epochs"][g]:
                    rows[gi, g] = p["slot"].idx
            bf.inj_toks[gi].copy_(h["first"])
        d = self._t(np.concatenate([active.astype(np.int64), rows.reshape(-1)]))
        bf.act.copy_(d[:B])
        bf.inj_rows.copy_(d[B:].view(bf.inj_rows.shape))

    def _upload_lane(self, plan: dict, chunk: int, P: int) -> None:
        """A lane plan (:meth:`_lane_arrays`) into the lane buffers."""
        arrs = self._lane_arrays(plan, chunk, P)
        d = self._t(np.concatenate([a.reshape(-1) for a in arrs]).astype(np.int64))
        bf, o = self._bufs, 0
        for buf in (bf.ltok, bf.lpos, bf.ltab[:, :P], bf.lrow, bf.act_slots, bf.act_steps):
            n = buf.numel()
            buf.copy_(d[o: o + n].view(buf.shape))
            o += n

    def _dispatch_decode(self, carry: dict | None) -> dict | None:
        """Dispatch one decode chunk (JAX ``engine.py:2238-2459``); returns
        the handle :meth:`_process_decode` reads back, or None when there is
        nothing to run or a page preemption would have to wait for
        ``carry``'s results. ``carry`` is the chunk still in flight: rows
        stepped in it and not reset since decode on from its device carry,
        at lengths predicted as ``seq_lens`` + its advance."""
        t_prep = time.monotonic()
        chunk, adv, B = self.decode_chunk_len, self._max_adv, self.max_slots
        valid = np.zeros((B,), bool)
        if carry is not None:
            for s in self.slots:
                valid[s.idx] = (s.active and carry["active"][s.idx]
                                and carry["epochs"][s.idx] == s.epoch)
        carry_adv = np.where(valid, carry["adv"], 0) if carry is not None else None
        predicted = self.seq_lens + (0 if carry_adv is None else carry_adv)
        active = np.array([s.active for s in self.slots], bool)
        # a row whose positions could leave the page budget is not stepped
        active &= predicted + adv + 1 <= self.max_seq_len
        for s in self.slots:   # page headroom for this chunk (paged mode only)
            if not active[s.idx] or self.cache_mode == "slot":
                continue
            need_pages = -(-int(predicted[s.idx] + adv + 1) // self.page_size)
            have = len(s.shared_pages) + len(s.pages)
            if need_pages > have:
                extra = need_pages - have
                if not self._ensure_pages(extra):
                    if carry is not None:   # decide after reading the carry back
                        self.spans.add("decode_prep", time.monotonic() - t_prep)
                        return None
                    if sum(1 for x in self.slots if x.active) > 1:
                        self._preempt_slot(s)  # requeue behind the survivors
                    else:   # nothing else will ever free pages
                        self._finish_slot(s, reason="length")
                        self.stats["preemptions"] += 1
                    active[s.idx] = False
                    continue
                new = self.allocator.alloc(extra)
                self.page_tables[s.idx, have: have + extra] = new
                s.pages.extend(new)
                self._dirty.add(s.idx)
        plan = self._plan_lane(chunk) if self.prefill_lane else None
        acts = plan["acts"] if plan else []
        if not active.any() and not acts:
            self.spans.add("decode_prep", time.monotonic() - t_prep)
            return None
        need = int(np.max(np.where(active, predicted, 0))) + adv + 1
        if acts:
            need = max(need, plan["max_tokens_needed"])
        P, slot_ctx = self._page_bucket(need), self._slot_bucket(need)
        if self._trim(active, (P, slot_ctx), carry_adv):
            chunk = self._trim_chunk
            self.stats["trim_chunks"] += 1
        spec = self.speculative is not None
        with self.spans.span("decode_dispatch"):
            self._upload_rows(valid)
            self._upload_step(active)
            if acts:
                self._upload_lane(plan, chunk, P)
            prog = self._program(P, slot_ctx, lane=bool(acts), spec=spec,
                                 chunk_len=chunk if chunk != self.decode_chunk_len else None)
            self.spans.add("decode_prep", time.monotonic() - t_prep)
            out = prog()
            # the outputs and the carry as this chunk leaves them, copied
            # back behind it (the next chunk overwrites them in place)
            host = {k: self._d2h(v) for k, v in out.items()}
            host["last"], host["lens"] = self._d2h(self._bufs.last), self._d2h(self._bufs.lens)
        self.stats["slot_steps"] += int(active.sum()) * chunk
        if self._gap_armed:
            self._gap_armed = False
            if carry is None:
                # the host's time between the last read-back and this
                # dispatch, less the prefill it queued meanwhile
                gap = (time.monotonic() - self._gap_t0) - (
                    self.spans.totals.get("prefill_dispatch", 0.0) - self._gap_pf0)
                if 0.0 < gap < 0.5:   # longer: the engine waited for clients
                    self._gap_ema = gap if self._gap_ema == 0.0 else 0.8 * self._gap_ema + 0.2 * gap
                    self.spans.add("exposed_gap", gap)
        # the chunk's busy window opens with its host prep: an eager body
        # (CPU, mesh) runs inside the dispatch
        return {"active": active, "chunk": chunk, "adv": adv if spec else chunk,
                "epochs": [s.epoch for s in self.slots], "host": host,
                "event": self._event(), "acts": acts,
                "lane_tokens_n": plan["n_tokens"] if acts else 0, "t_dispatch": t_prep}

    def _process_decode(self, h: dict) -> None:
        """Read one chunk back and fold its tokens in (JAX
        ``engine.py:2461-2579``): rows stepped in it and not reset since
        take its tokens; the lane's completed prompts are activated (one
        aborted meanwhile is freed instead)."""
        with self.spans.span("decode_sync"):
            if h["event"] is not None:
                h["event"].synchronize()
            o = {k: v.numpy() for k, v in h["host"].items()}
        t_merge = time.monotonic()
        spec, adv, n_new = "cnts" in o, self._max_adv, 0
        for s in self.slots:
            if not s.active or not h["active"][s.idx] or h["epochs"][s.idx] != s.epoch:
                continue   # finished / aborted / re-admitted since the dispatch
            self.last_tok[s.idx] = o["last"][s.idx]
            self.seq_lens[s.idx] = o["lens"][s.idx]
            if spec:
                # variable emission: each step's window tokens up to its count
                c, wins = o["cnts"][s.idx], o["toks"][s.idx]
                emitted = int(c.sum())
                arr = wins[np.arange(wins.shape[1])[None, :] < c[:, None]]
            else:
                emitted, arr = h["chunk"], o["toks"][s.idx]
            consumed = self._process_chunk(s, arr)
            n_new += consumed
            if s.stop.finished:
                # over-generated tokens: their KV lies past seq_lens, masked
                self.seq_lens[s.idx] -= emitted - consumed
                self._finish_slot(s)
            elif self.seq_lens[s.idx] + adv >= self.max_seq_len:
                self._finish_slot(s, reason="length")
        for a in h["acts"]:   # the lane's prompts (JAX engine.py:2522-2541)
            p = a["p"]
            s, rid = p["slot"], p["req"].request_id
            if s.epoch != a["epoch"] or s.req is None:
                continue
            if rid in self._aborts:   # aborted while its chunk was in flight
                self._aborts.discard(rid)
                fut = s.future
                self._release(s)
                if fut is not None and not fut.done():
                    fut.cancel()
                continue
            f = o["act_first"][a["i"]: a["i"] + 1]
            self.seq_lens[s.idx] = len(p["prompt"])
            self.last_tok[s.idx] = int(f[0])
            self._dirty.add(s.idx)
            s.active = True
            self._process_chunk(s, f)
            self.stats["requests"] += 1
            self.stats["prefill_tokens"] += len(p["suffix"])
            if s.stop.finished or len(p["prompt"]) + 1 >= self.max_seq_len:
                self._finish_slot(s)
        if h["acts"]:   # one first-token sample a chunk that carried the lane
            self.stats["lane_tokens"] += h["lane_tokens_n"]
            self.stats["lane_chunks"] += 1
        now = time.monotonic()
        self.spans.add("decode_merge", now - t_merge)
        self.stats["decode_tokens"] += n_new
        self.stats["decode_steps"] += 1
        # busy time is the union of [dispatch, read-back] windows, so
        # pipelined chunks do not count their overlap twice
        busy = now - max(h["t_dispatch"], self._last_decode_end)
        self.stats["decode_time_s"] += busy
        self._last_decode_end = now
        self._chunk_ema = busy if self._chunk_ema == 0.0 else 0.8 * self._chunk_ema + 0.2 * busy
        # arm the exposed-gap measurement when the next chunk is not
        # pipelined and rows remain (a drained batch waits on clients)
        if not self._gap_spec and any(s.active for s in self.slots):
            self._gap_armed = True
            self._gap_t0 = now
            self._gap_pf0 = self.spans.totals.get("prefill_dispatch", 0.0)

    def _decode_chunk(self) -> None:
        """One chunk dispatched from the host state and read back, with the
        injected groups drained in between (the serial step the tests drive
        by hand)."""
        h = self._dispatch_decode(None)
        self._drain_inject()
        if h is not None:
            self._process_decode(h)

    # ----------------------------------------------------------- host merge

    def _record_token(self, slot: _Slot, tok: int):
        piece = slot.detok.push(tok)
        slot.generated.append(tok)
        before = len(slot.stop.text)
        slot.stop.feed(tok, piece)
        cb = slot.req.on_delta if slot.req else None
        if cb is not None:
            emitted = slot.stop.text[before:]
            if emitted:
                try:
                    cb(emitted)
                except Exception:   # a client callback must not stop the engine
                    traceback.print_exc()

    def _process_chunk(self, s: _Slot, arr: np.ndarray) -> int:
        """Fold one chunk of sampled tokens into slot state; returns tokens
        consumed (including a terminating EOS). Without stop strings or
        streaming this is pure numpy; text is decoded once at finish."""
        st = s.stop
        if st.stop_sequences or (s.req and s.req.on_delta):
            for j in range(len(arr)):
                self._record_token(s, int(arr[j]))
                if st.finished:
                    return j + 1
            return len(arr)
        room = st.max_tokens - st.n_tokens
        take = arr[: max(room, 0)]
        if st.eos_ids:
            hits = np.isin(take, np.asarray(st.eos_ids))
            if hits.any():
                cut = int(np.argmax(hits))
                s.generated.extend(int(t) for t in take[:cut])
                st.n_tokens += cut + 1
                st.finished, st.finish_reason = True, "stop"
                return cut + 1
        s.generated.extend(int(t) for t in take)
        st.n_tokens += len(take)
        if st.n_tokens >= st.max_tokens:
            st.finished, st.finish_reason = True, "length"
        return len(take)

    def _finish_slot(self, slot: _Slot, reason: str | None = None):
        fut = slot.future
        st = slot.stop
        finish = reason or st.finish_reason or "stop"
        gen_ids = list(slot.generated)
        if not st.text and gen_ids and not st.stop_sequences:
            st.text = self.tokenizer.decode(gen_ids)   # deferred detokenization
        result = GenerationResult(
            request_id=slot.req.request_id, token_ids=gen_ids, text=st.text,
            finish_reason=finish, prompt_tokens=slot.prompt_len,
            completion_tokens=st.n_tokens, cached_prompt_tokens=slot.cached_len)
        # the finished sequence's full pages go into the prefix cache
        if self.prefix_cache is not None:
            full_tokens = list(slot.prompt_tokens) + gen_ids
            n_full = int(self.seq_lens[slot.idx]) // self.page_size
            all_pages = (slot.shared_pages + slot.pages)[:n_full]
            if all_pages:
                self.prefix_cache.insert(full_tokens, all_pages)
        if self._slot_park and finish != "aborted":
            # park the row's KV for multi-turn re-entry. usable is one token
            # short: the last kept token's KV is written only when it is fed
            # (the step after sampling), which a chunk boundary can cut off
            self._parked[slot.idx] = {
                "tokens": np.asarray(list(slot.prompt_tokens) + gen_ids, np.int64),
                "usable": slot.prompt_len + max(len(gen_ids) - 1, 0),
                "t": self._park_seq}
            self._park_seq += 1
        self._release(slot)
        if fut is not None and not fut.done():
            fut.set_result(result)


def _wire_req(req: GenerationRequest) -> GenerationRequest:
    """A request as rank 0 broadcasts it: without its streaming callback
    (rank 0's own copy keeps it)."""
    import dataclasses

    return dataclasses.replace(req, on_delta=None)


def _mesh_parallel(mesh, fam):
    """The engine's ``Parallel`` for ``mesh``, after JAX's checks: one
    serving replica over ``tp`` / ``ep`` (``dp``, ``pp`` and ``fsdp`` of 1),
    and a family whose forward takes the sharded arguments."""
    from ..parallel.collectives import Parallel
    from ..parallel.mesh import mesh_shape

    shape = mesh_shape(mesh)
    if shape["dp"] > 1:
        raise ValueError(
            f"Engine(mesh=) serves one replica over tp and ep: dp={shape['dp']} would "
            "split the engine's rows over replicas, which the port refuses (ROADMAP.md C, "
            "dp); run one engine per dp group")
    if shape["pp"] > 1 or shape["fsdp"] > 1:
        raise ValueError(f"Engine(mesh=) shards over tp and ep only (got {shape})")
    if "par" not in inspect.signature(fam.forward).parameters:
        raise ValueError(f"model family {fam.name!r} has no sharded forward")
    return Parallel(mesh)


def _shard_params(params: dict | None, fam, par, quantize: str | None, device=None,
                  seed: int = 0) -> tuple[dict, Any]:
    """A whole param tree → this rank's slices and the local config (JAX
    ``engine.py:448-476``): unpacked (TP would split a packed matrix
    unevenly across q/k/v), quantized whole where asked, then sliced per
    the family's logical axes and ``SERVING_RULES`` — int8 scales by
    ``quantized_logical_axes`` (a row-parallel product's replicated). Where
    tp exceeds the kv heads, each rank keeps the kv head its q heads read
    (``parallel/sharding.kv_heads_local``). One matrix at a time
    (``parallel/sharding.LocalDraw``), so a rank holds its share and one
    matrix on ``device``: ``params`` None is the random draw from ``seed``,
    each matrix cut as it is drawn (a ``custom_init`` family's draw is made
    whole); a given tree may lie on the host."""
    from ..parallel.sharding import SERVING_RULES, LocalDraw, kv_heads_local, local_config
    from .weights import init_params, random_params

    cfg = fam.config
    if fam.logical_axes is None:
        raise ValueError(f"model family {fam.name!r} was registered without logical axes "
                         f"to shard by")
    latent = getattr(cfg, "latent_cache", False)
    rep = (kv_heads_local(cfg.n_kv_heads, par.tp)[1]
           if par.tp > 1 and not latent and hasattr(cfg, "n_kv_heads") else 1)
    # MLA: the single latent head on every rank
    par.kv_rep = par.tp if latent else rep
    draw = LocalDraw(cfg, fam.logical_axes(cfg), SERVING_RULES, par.sizes, par.coords,
                     kv_rep=rep, kv_head=par.tp_rank // rep)
    if params is None and not getattr(cfg, "custom_init", False):
        params = random_params(cfg, device=device, seed=seed, quantize=quantize, local=draw)
        return params, local_config(cfg, par.tp)
    if params is None:
        params = init_params(fam, device=device, seed=seed)
    return draw.place(params, device, quantize), local_config(cfg, par.tp)
