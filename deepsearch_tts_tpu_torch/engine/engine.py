"""Continuous-batching inference engine over a paged or contiguous-slot KV
cache (port of ``engine/engine.py``).

Behaviours carried over from the JAX engine:

* ``submit`` returns a ``concurrent.futures.Future``; the scheduler loop
  runs on a daemon thread.
* Grouped prefill: queued requests are prepared on the host (pages, radix
  prefix match), grouped by power-of-two prompt bucket, and each group runs
  ONE batched forward plus first-token sample (``MAX_PREFILL_GROUP`` rows,
  ``PREFILL_TOKEN_BUDGET`` rows x bucket). Engines with prefix reuse (a
  prefix cache, or slot parking) run the non-fresh (re-prefill) branch for
  every group, as in JAX; without it, groups take fresh causal prefill.
* Decode chunks of ``decode_chunk_len`` steps over all ``max_slots`` rows
  (inactive rows write nothing), with the page table sliced to the
  power-of-two page bucket of the longest active row, so a step gathers the
  context it needs and not the whole ``max_seq_len`` budget. T=1 layers run
  the fused functions (``ops/fused_layer.py``) on packed bf16 weights.
* Page allocation, LRU eviction of cached prefixes and preempt-by-requeue
  under page pressure; finished sequences insert their full pages into the
  radix prefix cache.
* ``cache_mode="slot"``: a contiguous ``[L, max_slots, max_seq_len, K, D]``
  pool (page size = ``max_seq_len``, identity page table, no allocator,
  no page pressure). Decode reads the power-of-two context bucket of the
  longest active row. Prefix reuse is *parking*: a finished row's KV stays
  in place, and a request whose prompt extends its tokens re-enters that
  row and prefills only the rest (token-exact match).
* ``attn_impl``: ``None`` resolves as in JAX with the accelerator swapped
  (:func:`resolve_attn_impl`); ``"pallas"`` runs the slot and paged decode
  kernels and, for fresh prefill, flash attention; ``"pallas2"`` and
  ``"clamp"`` pick the other paged decode entry points.
* Seen masks: each row's token-presence mask is rebuilt on the device from
  its whole prompt at admission and extended with every sampled token, so
  it is always presence(prompt + generated) — there is no kept/stale mask
  path to reconcile.
* ``min_tokens`` budget forcing (``tokens_generated = lens - prompt_lens + 1``),
  the host stop scan, finish reasons, ``abort`` and ``telemetry``.
* ``quantize="int8"`` (dense family): the packed weights' matrices become
  int8 ``{q, scales}`` (``ops/quant.py``; random init quantizes one matrix
  at a time as it draws), and T=1 decode takes B10. ``kv_quantize`` in
  ``{"int8", "int8-force"}``: int8 KV pools plus float32 scales pools,
  paged cache and ``attn_impl="xla"`` only. JAX refuses ``"int8"`` on its
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

Left out, because they are JAX dispatch machinery: pipelined dispatch from
the device carry (and ``_can_speculate``, which decides it), admission
injection, the compile caches and warm-program bookkeeping. Eager CUDA
launches are already asynchronous; each decode chunk is queued step after
step and synchronised once, when its tokens are read back. The seen mask
of every admitted row is rebuilt from its whole prompt, parked re-entries
included (and so is a speculative engine's token history); JAX's
keep/clear path for parked rows saves a host upload on the TPU and gives
the same mask. Options of the JAX engine that the port does not carry yet
raise ``NotImplementedError`` naming the ROADMAP.md item.
"""
from __future__ import annotations

import queue
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
from .kvcache import PageAllocator, init_kv_pages, init_kv_scales, init_latent_pages
from .profiling import SpanTimer
from .sampling import SamplingParams, sample, update_seen
from .speculative import accept_drafts, ngram_draft
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
        self.reset()

    def reset(self):
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


def _not_ported(option: str, item: str):
    return NotImplementedError(
        f"Engine option {option} is not ported to the torch package yet "
        f"(ROADMAP.md {item})")


ATTN_IMPLS = ("xla", "pallas", "pallas2", "clamp")


def resolve_attn_impl(attn_impl: str | None, cache_mode: str,
                      device: torch.device) -> str:
    """The engine's attention implementation. ``None`` resolves as the JAX
    engine does (``engine.py:260-273``) with the accelerator swapped: the
    slot kernel on CUDA for the slot cache, the plain gather otherwise."""
    if attn_impl is None:
        return "pallas" if cache_mode == "slot" and device.type == "cuda" else "xla"
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (one of {ATTN_IMPLS})")
    return attn_impl


class Engine:
    # prefill rows per batched forward
    MAX_PREFILL_GROUP = 16
    # cap rows x bucket per prefill forward: causal scores are [G, H, T, S]
    # float32, so long buckets at full group width would exhaust memory
    PREFILL_TOKEN_BUDGET = 8192

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
        speculative: str | None = None,
        spec_k: int = 3,
        spec_ngram: int = 2,
        chunk_trim: bool = False,
        ring_prefill_len: int | None = None,
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
        unported = [
            (bool(prefill_lane), f"prefill_lane={prefill_lane}", "A4 (prefill lane)"),
            (bool(chunk_trim), "chunk_trim=True", "A4 (decode-chunk trim)"),
            (mesh is not None, "mesh", "A13 (parallel serving)"),
            (ring_prefill_len is not None, "ring_prefill_len", "A13 (ring prefill)"),
        ]
        for bad, option, item in unported:
            if bad:
                raise _not_ported(option, item)
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize {quantize!r} (None or 'int8')")
        if kv_quantize not in (None, "int8", "int8-force"):
            raise ValueError(f"unknown kv_quantize {kv_quantize!r}")
        self.device = resolve_device(device)
        self.attn_impl = resolve_attn_impl(attn_impl, cache_mode, self.device)
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
        # beyond JAX's fields the engine reads int8_weights, int8_kv, dtype
        # and fused_decode_fits; a registry-extension config may lack them
        # and gets no int8 and no layer fusion. The pools take torch_dtype,
        # as JAX's take jnp_dtype
        if quantize and not getattr(cfg, "int8_weights", False):
            from .weights import INT8_EXPERTS_NOT_PORTED

            raise NotImplementedError(INT8_EXPERTS_NOT_PORTED)
        if kv_quantize:
            if not getattr(cfg, "int8_kv", False):
                # the JAX engine refuses it too (its MoE forward takes no scales)
                raise ValueError(f"model family {model_name!r} does not support int8 KV")
            if cache_mode == "slot":
                raise ValueError("int8 KV requires the paged cache mode")
            if self.attn_impl != "xla":
                # JAX's Pallas decode ignores the scales and reads the
                # int32-packed pages as bf16 (attention.py:88-109)
                raise ValueError(f"int8 KV attends through the gather (attn_impl='xla'), "
                                 f"not attn_impl={self.attn_impl!r}")
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
            # their shapes fit; int8 weights, dense only, take B10; MLA:
            # where B8 takes its MLP widths, on any device, as JAX gates it)
            layer_fusion = (getattr(cfg, "dtype", None) == "bfloat16"
                            and hasattr(cfg, "fused_decode_fits")
                            and cfg.fused_decode_fits(self.device))
        self.layer_fusion = bool(layer_fusion)

        from .weights import init_params, pack_matmul_params

        if params is None:
            params = init_params(fam, device=self.device, seed=seed, quantize=quantize)
        # single-device serving always packs QKV and gate|up (numerically the
        # identity; the fused decode functions read this layout)
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
                cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim,
                dtype=torch.int8 if kv_quantize else cfg.torch_dtype, device=self.device)
        self.k_scales = self.v_scales = None
        if kv_quantize:
            self.k_scales, self.v_scales = init_kv_scales(
                cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, device=self.device)
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
        self.seen = torch.zeros((B, V), dtype=torch.bool, device=self.device)
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
        # column that takes the writes JAX drops out of bounds
        self.hist = (torch.zeros((B, max_seq_len + 1), dtype=torch.int64, device=self.device)
                     if speculative else None)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

        self._queue: "queue.Queue" = queue.Queue()
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
        }
        self.spans = SpanTimer()

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
        with finish_reason='aborted'."""
        self._aborts.add(request_id)
        self._wake.set()
        return True

    def load_lora_adapter(self, lora_path: str, scale: float | None = None) -> None:
        raise _not_ported("load_lora_adapter", "A12 (LoRA)")

    @torch.no_grad()
    def warmup(self, prompt_lens=(16,)) -> None:
        """Build the CUDA kernels and JIT the Triton kernel before serving:
        one prefill per prompt bucket and one decode step (a speculative
        engine's verify step, on copies of its seen mask and history) on
        dummy inputs whose positions are all padding, so no KV is written
        and no engine state but the sampler's random stream changes. Call
        before submitting requests."""
        dev = self.device
        for plen in prompt_lens:
            T = self._bucket(max(int(plen), 1))
            logits, _ = self._forward(
                torch.zeros((1, T), dtype=torch.int64, device=dev),
                torch.full((1, T), -1, dtype=torch.int64, device=dev),
                torch.zeros((1, 1), dtype=torch.int64, device=dev),
                torch.zeros((1,), dtype=torch.int64, device=dev),
                logits_indices=torch.zeros((1,), dtype=torch.int64, device=dev),
                fresh=self.fresh_prefill)
            sample(logits[:, 0], self._samp_params(np.arange(1)),
                   torch.zeros_like(self.seen[:1]), self.generator)
        B = self.max_slots
        zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
        tables = self._t(self.page_tables[:, :1])
        if self.speculative:
            # the verify step itself, on copies of the seen mask and history
            rows_r = np.repeat(np.arange(B), self.spec_k + 1)
            self._spec_step(zeros, zeros, torch.zeros((B,), dtype=torch.bool, device=dev),
                            tables, self._slot_bucket(1), self._samp_params(rows_r),
                            zeros, self.seen.clone(), self.hist.clone())
        else:
            logits, _ = self._forward(zeros[:, None], torch.full((B, 1), -1, device=dev),
                                      tables, zeros, slot_ctx=self._slot_bucket(1))
            sample(logits[:, 0], self._samp_params(np.arange(B)),
                   torch.zeros_like(self.seen), self.generator)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stopping = False
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def shutdown(self):
        self._stopping = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

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
        return out

    # ------------------------------------------------------------- scheduler

    def _loop(self):
        while not self._stopping:
            try:
                with torch.no_grad():
                    self._apply_aborts()
                    admitted = self._admit()
                    if not any(s.active for s in self.slots):
                        if not admitted:
                            self._wake.wait(timeout=0.05)
                            self._wake.clear()
                        continue
                    self._decode_chunk()
            except Exception as e:  # engine-step crash: fail in-flight work loudly
                traceback.print_exc()
                for s in self.slots:
                    if s.future is not None and not s.future.done():
                        s.future.set_exception(e)
                    s.reset()
                for _, fut in self._deferred:
                    if not fut.done():
                        fut.set_exception(e)
                self._deferred.clear()
                self._resumes.clear()
                while not self._queue.empty():
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    for _, fut in (item if isinstance(item, list) else [item]):
                        if not fut.done():
                            fut.set_exception(e)
                return

    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_seq_len)

    def _page_bucket(self, n_tokens: int) -> int:
        """Power-of-two page count covering ``n_tokens`` (capped)."""
        need = -(-n_tokens // self.page_size)
        b = 1
        while b < need:
            b *= 2
        return min(b, self.max_pages_per_seq)

    def _group_cap(self, bucket: int) -> int:
        return max(1, min(self.MAX_PREFILL_GROUP,
                          self.PREFILL_TOKEN_BUDGET // max(bucket, 1)))

    def _slot_bucket(self, n_tokens: int) -> int | None:
        """Slot mode: the power-of-two context width from 64 covering
        ``n_tokens`` (capped at ``max_seq_len``), which decode reads; None in
        paged mode."""
        if self.cache_mode != "slot":
            return None
        b = 64
        while b < n_tokens:
            b *= 2
        return min(b, self.max_seq_len)

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

    def _admit(self) -> bool:
        """Admit queued requests with batched prefill, one forward per
        (prompt bucket, group of <= _group_cap rows)."""
        prepared = []
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            if self._deferred:
                req, fut = self._deferred.pop(0)
            else:
                try:
                    item = self._queue.get_nowait()
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
        groups: dict[int, list] = {}
        for p in prepared:
            groups.setdefault(self._bucket(max(len(p["suffix"]), 1)), []).append(p)
        for bucket, grp in sorted(groups.items()):
            cap = self._group_cap(bucket)
            for i in range(0, len(grp), cap):
                sub = grp[i: i + cap]
                try:
                    self._prefill_group(bucket, sub)
                except Exception as e:  # fail this group, not the engine
                    traceback.print_exc()
                    for p in sub:
                        self._fail_prepared(p, e)
        return True

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
        return {"slot": slot, "req": req, "suffix": prompt[cached_len:],
                "cached_len": cached_len, "prompt": prompt,
                "pre_gen": len(slot.generated)}

    # ------------------------------------------------------------ device work

    def _t(self, a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype, non_blocking=True)

    def _samp_params(self, rows: np.ndarray, min_tokens=None,
                     tokens_generated=None) -> SamplingParams:
        h = self.samp_host
        return SamplingParams(
            self._t(h["temperature"][rows], torch.float32),
            self._t(h["top_k"][rows], torch.int32),
            self._t(h["top_p"][rows], torch.float32),
            self._t(h["min_p"][rows], torch.float32),
            self._t(h["repetition_penalty"][rows], torch.float32),
            min_tokens=min_tokens, tokens_generated=tokens_generated,
            eos_id=-1 if self.tokenizer.eos_id is None else self.tokenizer.eos_id)

    def _forward(self, tokens, positions, tables, seq_lens, *,
                 logits_indices=None, fresh=False, slot_ctx=None):
        """One forward over the engine's pools (updated in place, int8 KV's
        scales pools too); ``slot_ctx`` (slot mode decode: T=1, or a verify
        window) makes it a slot decode reading that context bucket."""
        scales = ({} if self.k_scales is None
                  else {"k_scales": self.k_scales, "v_scales": self.v_scales})
        return self.forward(
            self.params, self.cfg, tokens, positions,
            k_pages=self.k_pages, v_pages=self.v_pages, page_table=tables,
            seq_lens=seq_lens, logits_indices=logits_indices, impl=self.attn_impl,
            slot_decode=slot_ctx is not None, slot_ctx=slot_ctx,
            fresh_prefill=fresh, fused_decode=self.layer_fusion, **scales)

    def _prefill_group(self, bucket: int, grp: list[dict]) -> None:
        """One batched prefill forward + first-token sample for a group of
        same-bucket requests; folds the first tokens into slot state."""
        t0 = time.monotonic()
        G = len(grp)
        P = self._page_bucket(max(p["cached_len"] + len(p["suffix"]) for p in grp))
        tokens = np.zeros((G, bucket), np.int64)
        positions = np.full((G, bucket), -1, np.int64)
        seq_lens = np.zeros((G,), np.int64)
        logits_idx = np.zeros((G,), np.int64)
        rows = np.zeros((G,), np.int64)
        seen_r, seen_c = [], []
        for g, p in enumerate(grp):
            T = len(p["suffix"])
            tokens[g, :T] = p["suffix"]
            positions[g, :T] = np.arange(p["cached_len"], p["cached_len"] + T)
            seq_lens[g] = len(p["prompt"])
            logits_idx[g] = max(T - 1, 0)
            rows[g] = p["slot"].idx
            ids = np.asarray(p["prompt"], np.int64)
            ids = ids[ids < self.cfg.vocab_size]
            seen_r.append(np.full(ids.shape, g, np.int64))
            seen_c.append(ids)
        tables = self.page_tables[rows, :P]
        with self.spans.span("prefill"):
            logits, _ = self._forward(
                self._t(tokens), self._t(positions), self._t(tables),
                self._t(seq_lens), logits_indices=self._t(logits_idx),
                fresh=self.fresh_prefill)
            # token presence of each row's whole prompt, built on the device
            seen_rows = torch.zeros((G, self.cfg.vocab_size), dtype=torch.bool,
                                    device=self.device)
            seen_rows[self._t(np.concatenate(seen_r)),
                      self._t(np.concatenate(seen_c))] = True
            min_toks = self._t(self.min_tokens[rows])
            sp = self._samp_params(rows, min_tokens=min_toks,
                                   tokens_generated=torch.zeros_like(min_toks))
            first = sample(logits[:, 0], sp, seen_rows, self.generator)
            rows_t = self._t(rows)
            self.seen[rows_t] = seen_rows
            self.seen[rows_t, first] = True
            if self.hist is not None:
                hist_rows = np.zeros((G, self.hist.shape[1]), np.int64)
                for g, p in enumerate(grp):
                    hist_rows[g, :len(p["prompt"])] = p["prompt"]
                self.hist[rows_t] = self._t(hist_rows)
            first_np = first.cpu().numpy()
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_rows"] += G

        n_prefill = 0
        for g, p in enumerate(grp):
            slot, prompt = p["slot"], p["prompt"]
            b = slot.idx
            self.seq_lens[b] = len(prompt)
            self.last_tok[b] = int(first_np[g])
            slot.active = True
            self._process_chunk(slot, first_np[g: g + 1])
            n_prefill += len(p["suffix"])
            self.stats["requests"] += 1
            new_gen = len(slot.generated) - p["pre_gen"]
            if slot.stop.finished or len(prompt) + new_gen >= self.max_seq_len:
                self._finish_slot(slot)
        self.stats["prefill_tokens"] += n_prefill
        self.stats["prefill_time_s"] += time.monotonic() - t0

    def _spec_step(self, last, lens, act, tables, slot_ctx, samp, plens, seen, hist):
        """One speculative verify step (JAX ``engine.py:814-864``): draft
        ``spec_k`` tokens a row, one forward over the window ``[last,
        drafts]`` at positions ``lens..lens+K`` (-1 on inactive rows), one
        sampler pass over all B·(K+1) positions, exact-match acceptance.
        ``samp`` holds the per-row sampler params and ``min_tokens``
        repeated per window position. Marks the emitted tokens in ``seen``
        and ``hist`` (in place); returns ``(next last token, lens + emitted,
        window samples [B,K+1], emitted counts [B])``."""
        K1 = self.spec_k + 1
        B, S = last.shape[0], self.max_seq_len
        off = torch.arange(K1, device=last.device)[None, :]
        draft = ngram_draft(hist[:, :S], lens, self.spec_k, n=self.spec_ngram)
        win = torch.cat([last[:, None], draft], dim=1)
        pos = torch.where(act[:, None], lens[:, None] + off, -1)
        logits, _ = self._forward(win, pos, tables, lens + K1 * act.long(), slot_ctx=slot_ctx)
        # the window sees the window-start seen set (JAX's documented
        # approximation); tokens_generated counts each position's own
        sp = samp._replace(tokens_generated=((lens - plens + 1)[:, None] + off).reshape(-1))
        t = sample(logits.reshape(B * K1, -1), sp, seen.repeat_interleave(K1, dim=0),
                   self.generator).reshape(B, K1)
        ncons, nxt, alive = accept_drafts(t, draft, act)
        emit = alive & act[:, None]
        # unemitted positions re-mark a token already present: the row's
        # first sample (emitted) or, on an inactive row, its last token
        fill = torch.where(act, t[:, 0], last)[:, None]
        seen.scatter_(1, torch.where(emit, t, fill), True)
        posw = lens[:, None] + 1 + off
        hist.scatter_(1, torch.where(emit & (posw < S), posw, S), t)
        return torch.where(act, nxt, last), lens + ncons, t, ncons

    def _decode_chunk(self) -> None:
        """Run one decode chunk over every slot row and fold its tokens in."""
        t0 = time.monotonic()
        chunk, adv = self.decode_chunk_len, self._max_adv
        active = np.array([s.active for s in self.slots], bool)
        # a row whose positions could leave the page budget is not stepped
        active &= self.seq_lens + adv + 1 <= self.max_seq_len
        for s in self.slots:   # page headroom for this chunk (paged mode only)
            if not active[s.idx] or self.cache_mode == "slot":
                continue
            need_pages = -(-int(self.seq_lens[s.idx] + chunk + 1) // self.page_size)
            have = len(s.shared_pages) + len(s.pages)
            if need_pages > have:
                extra = need_pages - have
                if not self._ensure_pages(extra):
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
        if not active.any():
            return
        need = int(np.max(np.where(active, self.seq_lens, 0))) + adv + 1
        P = self._page_bucket(need)
        slot_ctx = self._slot_bucket(need)

        rows = np.arange(self.max_slots)
        spec = self.speculative is not None
        with self.spans.span("decode"):
            tables = self._t(self.page_tables[:, :P])
            last = self._t(self.last_tok)
            lens = self._t(self.seq_lens)
            act = self._t(active, torch.bool)
            plens = self._t(self.prompt_lens)
            toks, cnts = [], []
            if spec:
                rows_r = np.repeat(rows, self.spec_k + 1)
                samp = self._samp_params(rows_r, min_tokens=self._t(self.min_tokens[rows_r]))
                # invariant: hist[b, lens[b]] == last[b] (JAX engine.py:803-806)
                self.hist[torch.arange(self.max_slots, device=self.device),
                          lens.clamp(0, self.max_seq_len - 1)] = last
                for _ in range(chunk):
                    last, lens, t, ncons = self._spec_step(
                        last, lens, act, tables, slot_ctx, samp, plens, self.seen, self.hist)
                    toks.append(t)
                    cnts.append(ncons)
                cnts_np = torch.stack(cnts, dim=1).cpu().numpy()   # [B, chunk]
            else:
                samp = self._samp_params(rows, min_tokens=self._t(self.min_tokens))
                act_i = act.long()
                for _ in range(chunk):
                    sp = samp._replace(tokens_generated=lens - plens + 1)
                    pos = torch.where(act, lens, torch.full_like(lens, -1))[:, None]
                    logits, _ = self._forward(last[:, None], pos, tables, lens + act_i,
                                              slot_ctx=slot_ctx)
                    nxt = sample(logits[:, 0], sp, self.seen, self.generator)
                    nxt = torch.where(act, nxt, last)
                    update_seen(self.seen, nxt)
                    lens = lens + act_i
                    last = nxt
                    toks.append(nxt)
            # the sync point: [B, chunk] tokens, [B, chunk, K+1] under speculation
            toks_np = torch.stack(toks, dim=1).cpu().numpy()
            last_np = last.cpu().numpy()
            lens_np = lens.cpu().numpy()
        self.stats["slot_steps"] += int(active.sum()) * chunk

        n_new = 0
        for s in self.slots:
            if not s.active or not active[s.idx]:
                continue
            self.last_tok[s.idx] = last_np[s.idx]
            self.seq_lens[s.idx] = lens_np[s.idx]
            if spec:
                # variable emission: each step's window tokens up to its count
                c, wins = cnts_np[s.idx], toks_np[s.idx]
                emitted = int(c.sum())
                arr = wins[np.arange(wins.shape[1])[None, :] < c[:, None]]
            else:
                emitted, arr = chunk, toks_np[s.idx]
            consumed = self._process_chunk(s, arr)
            n_new += consumed
            if s.stop.finished:
                # over-generated tokens: their KV lies past seq_lens, masked
                self.seq_lens[s.idx] -= emitted - consumed
                self._finish_slot(s)
            elif self.seq_lens[s.idx] + adv >= self.max_seq_len:
                self._finish_slot(s, reason="length")
        self.stats["decode_tokens"] += n_new
        self.stats["decode_steps"] += 1
        self.stats["decode_time_s"] += time.monotonic() - t0

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
                "t": time.monotonic()}
        self._release(slot)
        if fut is not None and not fut.done():
            fut.set_result(result)
