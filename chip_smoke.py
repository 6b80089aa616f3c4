#!/usr/bin/env python3
"""Drive the torch port's serving path once on one CUDA card.

    python3 chip_smoke.py                 # everything (needs one CUDA card)
    python3 chip_smoke.py --profile       # adds profiled full-batch bursts
    python3 chip_smoke.py --kernels-only  # build + kernel checks, then stop
    python3 chip_smoke.py --train-only    # build + train, moe-train, lora
    python3 chip_smoke.py --parallel-only # build + the parallel phase
    python3 chip_smoke.py --programs-only # build + the programs phase
    python3 chip_smoke.py --mla-only      # build + MLA kernels + MLA serve phases

Phases, each raising on failure (non-zero exit, no final line):

1. environment: card name and power limit (nvidia-smi), torch/CUDA/Triton;
2. build: the CUDA C++ libraries from ``deepsearch_tts_tpu_torch/ops/csrc``
   (one nvcc per source, started together, timed) and the Triton kernels'
   JIT;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the serving path's shapes (qwen3-8b widths), with the tolerance
   stated below, timed with CUDA events after warm-up: B3, B4 (at 1, 8,
   16, 64, 80, 128 and 256 rows; where their products take the wgmma form,
   ``gemm_tc``, the parent's ``gemm_partial`` timed beside; at 80 rows a
   plain output whose second 64-row group lost a gate|up k stage must fail
   B4's bound), B5, then
   the attention kernels B1 (slot; also B = 1 over one full 4096-token row,
   the case K1's context split is for, and B = 64, where one split fills
   the card, both beside SDPA), B6 (the three paged
   entries) and B2 (flash prefill: T = 1, 127, 128, 512, 3030 at B = 1
   and 2, 3072, G = 2, and qwen3-14b's G = 5), K1 and K2 held to a bound
   scaled by each query position's output (``ATTN_RMS_FRAC``), which a
   plain attention missing one split or tile of the B = 1 row must fail;
   K2's paged mode (``flash_attention_paged``, re-prefill over the pages
   after the chunk's write: ``PAGED_PREFILLS``) under the same bound at the
   CLI engine's long prompt (B = 1, 3044 tokens from 0 over 48 pages of
   64), 1024 tokens after a 2000-token prefix (mid-page), B = 16 x 64 with
   ragged starts, a padding row and tail padding, the slot layout (ps =
   4096 and 3000, identity table), G = 8, G = 5, ps = 16 and ps = 48, each
   timed beside its plain version, SDPA over the pre-gathered context with
   a boolean mask and, at B = 1, causal SDPA (a plain attention over a
   table with one page of the long prompt swapped must fail the bound);
   K1's and K2's int8 modes at qwen3-32b's 64 / 8 heads over int8 pages
   of 64 keys and their scales (``_check_int8_decode``: K1's int8 mode,
   ``decode_i8``, at B = 16 rows of the B6 lengths through all three entries,
   K1's own 19,278-key rows, one 4096-key row and 16 of them, each timed;
   pages of 8, 16 and 48 keys, qwen3-14b's G = 5, a chunk of 4, a row with
   no key under ``min_one``; its plan kernel against the host model;
   ``I8_PREFILLS`` and ``I8_BUCKET``: the long prompt, the ragged 16 x 64
   group, 100 tokens after 3000 cached and the 4096 bucket's 64 pages;
   first ``widen_kv_pages``' bf16 pages equal to the plain dequantization
   bit for bit, the widening and the bf16 paged mode over the pages
   unquantized timed beside it) under the same bound, each timed beside
   its plain version, its bound and SDPA over the pre-dequantized context;
   then B11, the one-layer forms (``fused_mlp``, ``fused_qkv``,
   ``fused_out_mlp`` with packed and unpacked gate/up) at qwen3-8b widths,
   B = 1 and 16, and B11's own path: its counters set to 0, each entry
   driven once on a 16-row decode layer, the counts read (no serving path
   runs B11); then, at qwen3-30b-a3b widths, B7, both entries of the
   grouped expert kernels, one expert empty: the decode kernel at 16
   tokens x top-8 and one token below the wrappers' crossover
   (``moe.PREFILL_ROWS_PER_EXPERT``), the prefill kernel at the crossover,
   3072 and 3072 skewed (one expert over 256 rows), each timed shape beside
   ``torch._grouped_mm`` where this PyTorch has it; and B3 / B1 / B2 at its
   query group G = 8;
4. serve: ``deepsearch_tts_tpu_torch.cli.serve.build_engine`` builds
   qwen3-8b (full width, bf16, random weights from a seed, the CLI's
   defaults: the prefill lane of 16 rows on) on the card; an
   ``OpenAIServer`` on an ephemeral localhost port answers chat and
   completion requests over HTTP; the kernel launch counters, reset just
   before, must show that decode and sampling went through the kernels, and
   attention too (``attn_impl`` resolves to ``"pallas"`` on the card): K2's
   paged mode once a layer and prefill dispatch, K1
   (``pallas_paged_attention``) once a layer and decode step, so no layer
   attends through the plain KV gather; the long prompt, TTFT and
   the graph pool's MiB logged; then the lane check: while a long greedy request decodes, six prompts of
   at most 16 tokens over HTTP and one in-process ride the lane whole
   (``lane_tokens`` = their prompt tokens, each activated), B3 / B4 once a
   layer and step, B5 once a sample (a lane chunk samples its prompts'
   first tokens in one call), the in-process stream teacher-forced through
   the no-cache forward;
4a. programs, in every serve and slot-serve phase right after the engine's
   ``warmup()`` (``--programs-only``: eight engines built for it alone,
   warmed to ``max_ctx=512``: qwen3-8b paged with the CLI's defaults, slot,
   speculative slot and paged ``"pallas"``; qwen3-30b-a3b bf16 paged and int8; qwen3-32b
   int8 with int8 KV; deepseek-v3 at 5 layers, slot): every decode
   program the warmup built is a captured CUDA graph; the narrowest
   bucket's program (and its lane variant) replayed and held to the eager
   body it captured, on copies of the same state and generator state:
   tokens, carry, seen mask and history equal, greedy and seeded at
   temperature 0.7, one replay moving the launch counters as one eager run
   does; ms a chunk of each (replay, eager), the programs, their capture
   seconds and the graph pool's MiB. Then the prefill programs (the
   ``--programs-only`` engines and the paged ``"pallas"`` one): every one
   a captured CUDA graph, the narrowest and the widest warmed key replayed
   and held to its eager body on a group of the idle engine's rows (first
   tokens greedy and seeded, the written KV bit for bit, the seen mask and
   history), the trace check (K2, K2's paged mode, B5, both expert forms),
   ms a prefill replayed and eager. The serve phases run the CLI's ``--warmup 64``
   (programs, capture seconds and pool MiB logged) and warm the longer
   prompts' prefill programs on top, then read their counters with no chunk in flight (a pipelined
   chunk counts at its dispatch) and log the chunks pipelined, the prefill
   groups injected and by size, and the post-warmup builds (0 required);
5. reference: the same weights' paged prefill + fused decode logits (on the
   engine's ``attn_impl``: K2's paged mode and K1) against the plain
   no-cache forward on a short input;
6. slot serve: ``Engine(cache_mode="slot", prefill_lane=16)`` on the same
   weights, whose ``attn_impl`` resolves to ``"pallas"`` on the card, over
   HTTP: decode must run B1 once per layer and step, every prefill K2's
   paged mode over the slot row as one page, a multi-turn follow-up must
   re-enter its parked row, and phase 4's lane check;
7. Pallas paged serve: ``Engine(attn_impl="pallas",
   enable_prefix_cache=False)``: fresh prefill through B2 (a ~3000-token
   prompt, timed beside phase 4's), decode through ``pallas_paged_attention``;
   then short runs with ``attn_impl="pallas2"`` and ``"clamp"``;
8. reference: slot prefill + B1 decode, and B2 fresh prefill + B6 decode,
   against the plain no-cache forward;
8a. ``chunk_trim`` on the same weights (``trim_min_rows=1``, after
   ``warmup()``): three greedy requests trim a chunk and give the untrimmed
   engine's tokens;
8b. lora: a fresh qwen3-8b engine with the CLI's defaults (paged, prefix
   cache, the lane of 16) on the same weights hot-loads a rank-16 adapter
   (``train/lora.init_lora`` on the unpacked views, B drawn from a seed,
   saved by ``train/checkpoint.save_params``) through ``POST
   /v1/load_lora_adapter`` on its ``OpenAIServer``: the merged leaves
   within 1 bf16 ulp of the plain per-leaf float32 merge, the memory the
   load allocates within the new leaves + the adapter + the merge's
   float32 scratch + ``LORA_SLACK``, a fresh prompt's greedy output
   changed, B3 / B4 / B5 after the load, its serving logits held to the
   no-cache forward on the merged weights; a second engine on the same
   tree keeps the old weights and greedy output;
9. release: the qwen3-8b engines and weights are dropped; less than 1 GiB
   may stay allocated on the card; then the wide phase (``phase_wide``):
   qwen3-14b's widths (40 / 8 heads, G = 5) at 2 layers through
   ``build_engine`` with ``--page_size 48`` and a slot engine of 3000-key
   rows, each resolving ``attn_impl`` to ``"pallas"``, a multi-turn
   follow-up reusing its cached prefix, K2's paged mode once a layer and
   prefill, K1 once a layer and decode step, the paged engine's serving
   logits over two pages held to the no-cache forward; then, before 9a,
   the two training
   phases (``--train-only`` runs them and 8b alone, 8b on random qwen3-8b
   weights):
9c. train: full SFT of qwen3-4b at its published widths (random bf16
   weights from seed 0) through ``train/trainer.train_loop``, 5 steps of
   B=2, T=512 on one fixed batch, the loss on each row's second half, lr
   3e-4 under warmup-cosine decay: finite losses and grad norms, the last
   loss below the first; the eval step on the trained params equals the
   next train step's loss (that step timed); the 7.5 GiB checkpoint
   written and read back onto the card bit for bit (timed); an ``Engine``
   on the trained weights serves greedy requests through B3 / B4 / B5
   (counters zeroed before) and its serving logits pass phase 5's check;
9d. moe-train: Qwen3-MoE at qwen3-30b-a3b's widths, 48 -> 2 layers
   (registered here): the loss and gradients of one batch through the
   grouped expert kernel's prefill form (its ``autograd.Function``; the
   counters' ``prefill_launches`` must move) are non-zero on every expert
   with rows the loss reaches and on the router, zero on the others, and
   equal those with ``plain_experts`` within ``BF16_RTOL`` of each leaf's
   norm; then one optimizer step;
9a. product (``--product-only`` runs it alone, after the build):
   ``deepsearch_tts_tpu_torch.cli.deep_search.main`` on the card. First the
   scripted scenario of ``tests/test_product_path_engine.py`` (families
   whose greedy decode replays a token script computed by a dry run of
   the port's agent stack; the scripts on the card): ``--mode solve
   --backend engine --search_backend replay --temperature 0.0`` must answer
   "Paris" after two searches, in three policy requests with prefix reuse,
   B5 once a sample. Then B3 / B4 at the qwen3-4b aux's widths against
   their plain versions, and qwen3-8b at full width with qwen3-4b
   co-served as the aux (random weights from ``--seed 0``): solve, verify
   over its rows, solve_budget_forcing (logit) over the same rows,
   solve_bestofn and search; each mode's rows checked, B3 / B4 once a layer
   and decode step of each fused engine, B5 once a sample, the
   budget-forcing re-entry turns held to ``min_tokens``; the ``product``
   line reports each mode's wall time, turns, tokens, decode rate, prefix
   reuse, first-turn prefill and peak memory;
9b. eval (after the product phase; ``--product-only`` runs it too): an
   ``OpenAIServer`` over a qwen3-8b paged engine (random weights from seed
   0, 16 slots, 1024 pages, prefix cache, the lane of 16);
   ``deepsearch_tts_tpu_torch.cli.evaluate.main --task qa --use_llm``
   judges the product phase's solve rows through it: both metrics files,
   one 8-token judge request a row, B3 / B4 36 a decode step, B5 one a
   sample; with the engine alive, ``--task math --use_math_grader`` and
   ``--task code`` give their known values. Then, on scripted families
   (``--backend engine --device cuda``): ``cli/lcb_run.main`` per scenario
   (codegen: a correct, a wrong and a sleeping program scored by two forked
   workers while the engine threads run: pass@1 1 / 0 / 0, statuses pass /
   fail / timeout; codeexecution and testoutput 1.0), ``cli/report.main``
   (title, plan, sections and report equal a dry run of
   ``generate_report``) and the in-band demo (``build_demo_session`` +
   ``run_inband_agent``: the reply cut at ``<|end_search_query|>``, the
   events equal a dry run's, the second call re-entering the prefix cache);
   every engine on the card, B5 once a sample; the ``eval`` line reports
   each part's wall seconds and peak memory;
10. MoE serve: phase 4 for qwen3-30b-a3b at its published widths, cut to
    8 of its 48 layers (``MOE_SERVE``, registered here, so that the smoke
    keeps near its length with every engine's warmup capturing its decode
    programs; random bf16 weights; the lane check without teacher forcing: B3, B7 and the experts
    over B + 16 rows): decode through B3, B7 and the grouped expert kernel, whose
    counters must equal 8 x the decode steps (B3, B7) and 8 x (decode
    steps + prefill forwards) (each expert entry, either kernel; the long
    prompt's prefill takes the prefill kernel, the decode steps the decode
    one, and the kernel line counts each); peak memory logged;
11. MoE reference: phase 5 on the qwen3-30b-a3b weights, the no-cache
    forward running the expert FFN's plain versions (``plain_experts``), so
    that the check covers the grouped expert kernel too;
12. MoE slot: phase 6 on the same weights after the paged pools are freed:
    B1 decode at G = 8, B3, B7, the grouped expert kernel and a parked-row
    re-entry;
13. int8 kernels (run with phase 3): B10 (``fused_qkv_stacked_i8``,
    ``fused_out_mlp_stacked_i8``) at qwen3-32b and qwen3-8b widths, B = 1,
    16 and 64 on every layer of a four-layer stack (qwen3-32b also at 65,
    80 and 128 rows: one launch a 64-row group, timed, a ring stage left
    out failing the bound at 80; the lm_head product at 65), a plain output with one
    ring stage of K or one column tile left out failing each check at B = 1
    and 16; B10's bare int8 product at the qwen3-32b ``lm_head`` shape
    beside ``torch._weight_int8pack_mm`` and at the layer shapes and a
    ragged one from 1 to 64 rows; and B12 (``quantize_int8``): round to
    nearest bit-equal to its plain version on a [5120, 51200] matrix,
    stochastic rounding held to its properties;
13a. int8 MoE kernels (run with phase 3): both entries of the int8
    grouped expert kernel (``grouped_gateup_i8`` / ``grouped_down_i8``,
    ``csrc/moe_i8.cu``) against their plain versions at qwen3-30b-a3b
    widths on B12-quantized expert stacks: 16 tokens x top-8 (expert 7
    empty, expert 3 over its capacity of 8: its last rows must be 0), 64
    and 3072 tokens, each timed beside the bf16 grouped expert kernel on
    the same routing and, for information, bf16 ``torch._grouped_mm``; at
    3072 the prefill form (``grouped_expert_i8_tc``, counted in
    ``prefill_launches``), packed and unpacked, beside the parent's form
    (the decode kernel), a plain gate|up without one k stage failing the
    bound, and a skewed 3072-token routing (an expert over 256 rows and
    past its capacity: those rows 0, two calls bit-equal);
13b. int8 MoE serve, after the qwen3-30b-a3b weights are released:
    ``Engine(MOE_SERVE, quantize="int8", prefill_lane=16)`` (8 of 48
    layers), paged, the bf16 engine's other settings (weights drawn and
    quantized one expert matrix at a time: B12 once a matrix), served as
    phase 4 unfused (JAX's gate): the int8 grouped expert kernel twice a
    layer and forward (16 a decode step), the bf16 expert kernels never;
    its serving logits held to the no-cache forward with ``plain_int8`` at
    8 tokens (no expert row can drop there) and, at 16 + 8 tokens, to the
    same serving calls on the plain versions (a 24-token forward drops
    rows past an expert's capacity that a one-token decode step keeps);
    released (< 1 GiB);
14. int8 serve, after the qwen3-30b-a3b weights are released: qwen3-32b
    (full width, 16 of its 64 layers: ``I8_SERVE``, registered here;
    random weights from seed 0 drawn and quantized one matrix at a time)
    with ``quantize="int8"`` and ``kv_quantize="int8"``,
    the CLI's paged cache and prefix cache, over HTTP as phase 4: B12 once
    per quantized matrix at build, B10 once per layer and decode step;
    ``attn_impl`` resolves to ``"pallas"``: K2's int8 paged mode once per
    layer and prefill, K1's int8 mode once per layer and decode step, no
    plain gather (the programs check finds both in the replays' traces);
15. int8 reference: its serving logits against the no-cache forward on the
    same int8 params with the plain int8 products; then a decode step of 64
    rows carrying a 16-row lane (B10 over 80 rows, the lm_head over 65)
    held to the same step with the plain int8 products, and an
    ``Engine(max_slots=64, prefill_lane=16)`` on those weights serving a
    lane prompt beside a decoding request;
16. speculative kernels (run with phase 3): B9 (``slot_window_attention``,
    K1 in its T-row mode) against its plain version on phase 3's slot pool,
    W = 4 and 8 (qwen3-8b widths) and W = 4, 8 and 16 (G = 8; 16 splits
    into two launches); B3 / B4 / B10 at 64 rows, a verify step's
    16 x (3 + 1); B3 / B4 (and B7 at qwen3-30b-a3b widths) also at 80 rows,
    a lane step at 64 slots (B3 / B4: one weight pass of ``gemm_tc``; B7:
    a second 64-row group);
17. speculative serve, after phase 6: ``Engine(cache_mode="slot",
    speculative="ngram", spec_k=3)`` on the qwen3-8b weights over HTTP,
    phase 6's requests, then a greedy full batch whose tokens per verify
    step must exceed 1; B9, B3 and B4 once per layer and verify step, B1
    never; a B=1 greedy run of 128 tokens beside phase 6's on the plain
    slot engine; one greedy stream teacher-forced through the no-cache
    forward;
18. speculative reference: one 4-token window after a slot prefill, through
    the fused layers and B9, against the no-cache forward on prompt +
    window;
19. MoE speculative, after phase 12 on the same weights: 8 greedy requests
    x 32 tokens, B9 once per layer and verify step, the grouped expert
    kernel on every forward (windows unfused, as in JAX), and phase 18 with
    ``plain_experts``;
20. MLA kernels (run with phase 3): B8 (``fused_mlp_stacked``) at
    deepseek-v3 widths, E = 7168 with the dense F = 18432 (norm and
    residual) and the shared-expert F = 2048 (neither), B = 1, 16 and 64
    (the parent's form timed beside where the wgmma form runs), both
    layers of a two-layer stack; K3 (``latent_attention``) at D = 576 with
    deepseek-v3's 128 and kimi-k2's 64 query heads over one cache head,
    B = 16 and 4096-token rows with ragged limits and inactive rows, through
    B1's entry (``slot_attention`` with ``v_pool=None``, the slot identity
    table) and through the three B6 entries over a shuffled table of
    64-token pages, and at B = 1 over one full 4096-key row and B = 64,
    each beside SDPA, under the rms-scaled bound (a plain attention missing
    a split of the B = 1 row must fail it); K3's prefill mode
    (``latent_prefill``: MLA's prefills over the pool after the chunk's
    write) at ``LATENT_PREFILLS``, 128 and 64 heads (the 3044-token prompt,
    the 4096 bucket, 100 and 300 tokens after a 3000-token prefix, a
    ragged 16 x 64 group with tail padding, 15 slot rows x 64 over
    4096-key rows, 16 verify windows of 4 (split and merged), pages of 16
    and of 32) under the same bound, each timed beside its plain version,
    its bound and one SDPA call over the pre-gathered context (causal at B
    = 1; the kernels SDPA ran are logged; a plain attention over the long
    prompt's table with one page swapped must fail the bound); the grouped
    expert kernels at
    E = 7168, F = 2048, 256 experts, top-8, gate and up unpacked: the decode
    kernel at 16 tokens, the prefill kernel at 3072 (also packed, beside
    ``torch._grouped_mm``);
21. MLA serve, after the qwen3-32b int8 engine is released (less than
    1 GiB may stay allocated): deepseek-v3 at its published widths cut to
    5 of its 61 layers (3 dense + 2 MoE, 26.6 B parameters, 53.2 GB of
    random bf16 weights drawn one matrix at a time), registered from this
    script under its own name, served as phase 4 through ``build_engine``:
    B8 on the three dense MLPs and the two shared experts of every decode
    step, the grouped expert kernel on the routed experts, K3 through B6's
    entry once a layer and decode step, its prefills (re-prefills over the
    prefix cache) through K3's prefill mode once a layer and prefill; its
    serving logits held to the no-cache forward with ``plain_experts``;
22. MLA slot serve: phase 6 on the same weights, K3 through B1's entry
    once per layer and decode step, K1 (B1 at D = 128) never, its prefills
    (the slot row as one page) through K3's prefill mode;
23. MLA paged ``attn_impl="pallas"`` without prefix cache:
    ``warmup(prompt_lens=(64, 128))`` (programs and pool MiB logged), its
    narrowest and widest prefill programs replayed as phase 4's, then a
    short run whose fresh prefills take K3's prefill mode and whose decode
    takes K3 through ``pallas_paged_attention``, with no post-warmup build;
    then slot and paged prefill + K3 decode against the no-cache forward;
    the weights are released and less than 1 GiB may stay allocated. In
    phases 21-23 every replayed prefill program launches K3's prefill mode
    once a layer (its counter and the replay's trace), and
    ``LatentAttention`` calls no plain attention function on the card.
24. parallel (``phase_parallel``), on the card that now holds nothing
    else: two ranks, each a process (``parallel/launch.run_ranks``: a
    collective timeout, every rank killed on a failure or the deadline),
    NCCL with a card a rank, gloo with both on one card (the transfers
    staged through host memory). qwen3-8b at full width and depth over
    tp=2: a slot engine (K1 at 16 / 4 local heads) and a paged
    ``attn_impl="pallas"`` engine without prefix cache (K2, B6), B5 on
    both, each held to the tp=1 no-cache forward on the same seed-0
    weights by a teacher-forced probe (a prefill, then one decode step a
    token); a 4000-token fresh prompt through ring attention and through
    Ulysses (K2 inside), held to the same forward; a burst of 16 requests
    on each engine and a 2040-token request that ``ring_prefill_len``
    routes, each kernel's launches counted on each rank, the ranks' greedy
    tokens equal; qwen3-30b-a3b's widths at 2 layers over ep=2 through
    the grouped expert kernels (both forms), held to the ep=1 forward on
    the plain experts; then ``torchrun --nproc_per_node 2 -m
    deepsearch_tts_tpu_torch.cli.serve --tp 2`` answers one HTTP request
    and SIGTERM stops it. Its line names the backend, the card count and
    what it did not run, with each rank's ms a step and peak memory.

MLA (phases 21-23) has no prefill lane, as in JAX: it is served with
``--prefill_lane 0``. The times at row counts past 64 are printed under
``past_64`` in the runs line.

Every kernel entry of the JSON line before the last carries its bound
(``bound_ms``: the larger of its bytes over 3.35 TB/s and its operations
over the peak rate of their type, from the timed call's inputs) and, where
one PyTorch call computes the same function, that call's time
(``library_ms``, timed here only). The last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# qwen3-8b widths (deepsearch_tts_tpu_torch/models/qwen3.py QWEN3_CONFIGS)
E, H, KV, D, FF, V = 4096, 32, 8, 128, 12288, 151936
V_ODD = 50257            # a vocab width that is not a multiple of 128
V_MLA = 129280           # deepseek-v3's vocab width
SLOTS = 16               # the serve phase's max_slots: its decode batch
# bf16 outputs of kernel and plain version differ by float32 summation order
# and the resulting bf16 rounding of intermediates: the JAX suite's own bound
# for the stacked fused kernels (tests/test_fused_layer.py:181,190)
BF16_RTOL, BF16_ATOL = 2e-2, 1e-2
# B5 is float32 end to end; only the order of the lse sum differs
F32_RTOL, F32_ATOL = 1e-5, 1e-5
# attention kernels against their plain versions: bf16 outputs, float32
# scores in another summation order, and p rounded to bf16 where the plain
# version keeps float32 (B2); the JAX suite's own bound for these kernels
# (tests/test_kernels.py:131,166)
ATTN_RTOL, ATTN_ATOL = 5e-2, 2e-2
# K1 and K2 (the split-context decode and the wgmma prefill) are held
# tighter: the absolute part of the bound is at most this share of the
# reference's root mean square over each query position's heads and
# columns. Over a long row of randn keys the outputs are ~0.026 (a softmax
# average of ~1500 effective keys), so ATTN_ATOL alone would pass a result
# missing a whole 256-key split; a sound kernel uses ~0.16 of this bound
# (its error is the bf16 rounding of the output), one that drops a 64-key
# tile or weighs a split wrong ~9-17 times it (phase_attention_kernels
# asserts the latter on the B = 1 row)
ATTN_RMS_FRAC = 5e-2
CTX = 4096              # max_seq_len of the serve phases: the slot row width
# per-row limits / sequence lengths of the B1 and B6 checks: single keys,
# page and tile edges, the full row, and inactive rows (0, clamped to 1)
LIMITS = [1, 17, 500, 4095, 0, 4096, 2048, 64, 65, 1000, 3000, 129, 256, 4000, 7, 0]
SEQS = [1, 17, 500, 4095, 64, 65, 4096, 2048, 129, 1000, 3000, 256, 7, 4000, 333, 2]
# qwen3-30b-a3b widths (models/qwen3_moe.py QWEN3_MOE_CONFIGS): hidden, q /
# kv heads (G = 8), experts, top-k, expert width
MOE_MODEL = "qwen3-30b-a3b"
M_E, M_H, M_KV, M_NE, M_TOPK, M_F = 2048, 32, 4, 128, 8, 768
# its serve phases (bf16 and int8): the published widths cut in depth, 48
# -> 8 layers (registered here under their own name), so that the whole
# smoke, whose every engine now captures its decode programs at warmup,
# stays near its earlier length
MOE_SERVE_LAYERS = 8
MOE_SERVE = f"{MOE_MODEL}-{MOE_SERVE_LAYERS}-layers"
LIBS = ("fused_layer", "attention", "quant", "moe_i8")
LONG_TEXT = "The search returned a page about the rivers of Europe. " * 55
# qwen3-32b widths (models/qwen3.py QWEN3_CONFIGS): the int8 slice's model,
# served at 16 of its 64 layers (registered here under their own name), so
# that the whole smoke, whose engines now capture their prefill programs
# too, stays within its time: at 64 layers the int8 phase took 162.1 s and
# the whole smoke 918.9 s (H100, PERF.md). A full-depth run sets both
# names: ``c.I8_SERVE_LAYERS = 64; c.I8_SERVE = "qwen3-32b-64-layers"``
I8_MODEL = "qwen3-32b"
I8_SERVE_LAYERS = 16
I8_SERVE = f"{I8_MODEL}-{I8_SERVE_LAYERS}-layers"
Q_E, Q_H, Q_KV, Q_F = 5120, 64, 8, 25600
# the least time of a call: bytes over the HBM rate, operations over the
# peak rate of their type (H100 SXM5 80 GB data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12     # tensor cores, bf16 (B10 widens int8 to bf16)
F32_FLOP_S = 67e12       # float32 outside the tensor cores
# B12's stochastic rounding is unbiased: the mean of (q - x/s) over the
# [5120, 51200] check matrix has a standard deviation below 0.5/sqrt(2.6e8)
# = 3.1e-5; a bound 30 times that fails a biased rounding (round to
# nearest of a uniform fraction is off by its mean, up to 0.5)
STOCH_MEAN_BOUND = 1e-3
# the speculative engine of phases 17-19, and its verify window
SPEC_KW = dict(speculative="ngram", spec_k=3)
# the prefill lane: cli/serve.py's --prefill_lane default, and the prompts of
# the lane checks (at most LANE bytes each, each with a first byte that no
# other prompt of the smoke starts with: a parked slot row is re-entered on
# any shared first token, and a re-entry prefills batched)
LANE = 16
LANE_ROWS = 64 + LANE     # a lane step's rows at the CLIs' default 64 slots
LANE_PROMPTS = ("@ lane one", "# lane two?", "$ three", "% lane 4", "& five!", "~ six")
LANE_GREEDY = "^ greedy lane"
WIN = SPEC_KW["spec_k"] + 1
GREEDY = dict(temperature=0.0, repetition_penalty=1.0)
# the five matrix shapes a qwen3-32b int8 build quantizes (B12)
B12_SHAPES = {"wqkv": (Q_E, (Q_H + 2 * Q_KV) * 128), "wo": (Q_H * 128, Q_E),
              "w_gateup": (Q_E, 2 * Q_F), "w_down": (Q_F, Q_E), "lm_head": (Q_E, V)}
# deepseek-v3 widths (models/deepseek_v3.py DEEPSEEK_V3_CONFIGS), the MLA
# slice's model: served at its published widths with 5 of its 61 layers,
# under a name this script registers (3 dense + 2 MoE layers)
MLA_MODEL, MLA_LAYERS = "deepseek-v3-5-layers", 5
X_E, X_FD, X_FS, X_NE, X_TOPK = 7168, 18432, 2048, 256, 8
X_D, X_V = 576, 512      # latent row (kv_lora_rank 512 + rope 64), value columns
X_SCALE = 192 ** -0.5    # MLA's softmax scale, (qk_nope 128 + qk_rope 64)^-1/2
# the product phase: cli/deep_search.py's engines (policy qwen3-8b, aux
# qwen3-4b co-served) and the aux's widths, which B3 / B4 take when
# fused_decode_fits holds (hidden 2560 beside n_heads x head_dim 4096)
PRODUCT_MAIN, PRODUCT_AUX = "qwen3-8b", "qwen3-4b"
A_E, A_H, A_KV, A_F = 2560, 32, 8, 9728
PRODUCT_PROBLEMS, PRODUCT_PAGES = 4, 1024
# tokens a turn: random weights make no tool call, no boxed answer and
# (nearly) no EOS, so every trajectory runs its 7 turns (--max_search_calls
# 2, + 5) to this length; at 256 the five modes took 685 s on an H100 at
# 700 W (the eager engine's step is 38-69 ms with plain-attention decode)
PRODUCT_MAX_TOKENS = 64
PRODUCT_DIR = os.path.join(HERE, "build", "product_smoke")
SCRIPT_LEN = 6144        # the scripted families' token script (positions)


# kernel times at row counts past 64 (prefill-lane and verify steps: one
# launch a 64-row group), kept apart from the kernel line's decode-batch
# times: "<kernel> <model> B=<rows>" -> err, ms, plain_ms, bound_ms, ...
PAST_64: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, calls: int = 1, iters: int = 50) -> tuple[float, float]:
    """(device ms, eager ms) per call of a kernel, where ``fn`` makes
    ``calls`` calls. Device time: ``fn`` captured once in a CUDA graph,
    replayed ``iters`` times between two CUDA events (no host launch cost).
    Eager time: ``iters`` back-to-back runs of ``fn`` between two events,
    host launch cost included where the host is the bottleneck."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    out = []
    for run in (graph.replay, fn):
        run()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            run()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / (iters * calls))
    graph.reset()   # its private memory pool goes back at once
    return out[0], out[1]


_LAPS: dict = {}      # phase → wall seconds (``_lap``)
_LAP_T = [0.0]


def _lap(name: str) -> None:
    """Log and keep the wall seconds since the previous lap."""
    now = time.time()
    _LAPS[name] = round(now - _LAP_T[0], 1)
    _LAP_T[0] = now
    log(f"[time] {name}: {_LAPS[name]} s")


def _held_gib() -> float:
    """GiB still allocated on the card after a phase's release, once dropped
    tensors and graph pools are collected and torch's cuBLAS workspaces are
    given back (torch keeps one a thread's handle and stream; each thread
    that captures decode programs adds one on the capture stream)."""
    import torch

    gc.collect()
    before = torch.cuda.memory_allocated()
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"[release] cuBLAS workspaces given back: {(before - held) / 2**20:.1f} MiB")
    return held / 2**30


def _free() -> None:
    """Give the memory of dropped tensors and CUDA graphs back to the card
    (graph pools can sit in reference cycles until a collection)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def time_eager_ms(fn, iters: int) -> float:
    """ms per call of ``fn`` run eagerly between two CUDA events (for a
    function that reads values back to the host, which no graph captures)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


# the card's memory and this process's CUDA context (phase_env)
ENV_MEMORY: dict = {}


def phase_env() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    import triton

    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {triton.__version__} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    # what a process cannot use of the card: its CUDA context (total less the
    # free memory once CUDA has initialised; parallel/plan.py's reserve)
    free, total = torch.cuda.mem_get_info()
    ENV_MEMORY.update(total_mib=total / 2**20, context_mib=(total - free) / 2**20)
    log(f"[env] memory: total {total / 2**20:.0f} MiB "
        f"({torch.cuda.get_device_properties(0).total_memory / 2**20:.0f} MiB by the "
        f"device properties), free after CUDA init {free / 2**20:.0f} MiB: context "
        f"{(total - free) / 2**20:.0f} MiB")
    return smi.splitlines()[0]


def phase_build() -> None:
    from deepsearch_tts_tpu_torch.ops import _build

    def build(name):
        t = time.time()
        _build.load_library(name)
        return time.time() - t

    t0 = time.time()
    with ThreadPoolExecutor(len(LIBS)) as ex:
        secs = dict(zip(LIBS, ex.map(build, LIBS)))
    log(f"[build] nvcc " + ", ".join(f"{n}.cu {t:.2f} s" for n, t in secs.items())
        + f" (started together; {time.time() - t0:.2f} s in all)")
    for name in LIBS:
        for line in _build.build_log.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
                log(f"[build] {name}: {line.strip()}")
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    from deepsearch_tts_tpu_torch.ops import moe

    occ = pa.attention_occupancy()
    log("[build] attention blocks an SM (runtime occupancy): " +
        ", ".join(f"{k} {v}" for k, v in occ.items()))
    occ = {**moe.grouped_occupancy(), **moe.grouped_i8_occupancy()}
    log("[build] grouped expert blocks an SM (runtime occupancy): " +
        ", ".join(f"{k} {v}" for k, v in occ.items()))


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(nbytes: float, flop: float, rate: float = BF16_FLOP_S) -> dict:
    """``bound_ms`` / ``bound_by`` of a call that must move ``nbytes`` (each
    input read once, each output written once) and do ``flop`` operations
    at ``rate``."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, flop / rate * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


@contextlib.contextmanager
def _parent_products():
    """The bf16 products of B3 / B4 / B8 on the parent's form (gemm_partial,
    a block a 64-row group) inside: ``fused_layer.TC_MIN_ROWS`` raised past
    any row count. Yields the row count from which they take the wgmma
    form outside."""
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    taken = fl.TC_MIN_ROWS
    fl.TC_MIN_ROWS = 1 << 30
    try:
        yield taken
    finally:
        fl.TC_MIN_ROWS = taken


def _b4_row_group_fault(args4, got) -> None:
    """A plain B4 (layer 0) whose rows past 64 (a second row group of the
    parent's form) lost the first 64-row k stage of gate|up must fail the
    bound that the kernel's output ``got`` meets."""
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    a, x, wo, ln2, gateup, wd = args4
    gu = gateup[:1].clone()
    gu[:, :64] = 0
    fault = fl.fused_out_mlp_stacked_plain(a, x, wo, ln2, gateup, wd, 0, eps=1e-6)
    fault[64:] = fl.fused_out_mlp_stacked_plain(a[64:], x[64:], wo[:1], ln2[:1], gu, wd[:1], 0,
                                                eps=1e-6)
    use = _bound_use(fault, got, BF16_RTOL, BF16_ATOL, math.inf)
    assert use > 1.0, ("B4: a row group without a weight stage passed the bound", use)
    log(f"[kernel] B4 fused_out_mlp_stacked B={a.shape[0]:3d} plain output whose rows past 64 "
        f"lost gate|up's first k stage: {use:.1f} times the bound")


def phase_kernels(gen) -> dict:
    """Each wrapper vs its plain version; returns per-kernel results."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

    dev = torch.device("cuda")
    bf = torch.bfloat16
    # a four-layer stack: every layer is checked (the layer offsets), and the
    # timed loop walks the layers, so each call reads its weights cold as in
    # serving (4 x 386 MB of weights, far beyond the 50 MB L2)
    L = 4

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    ln1, ln2 = rnd(L, E, scale=0.1) + 1, rnd(L, E, scale=0.1) + 1
    qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
    wqkv = rnd(L, E, (H + 2 * KV) * D, scale=E ** -0.5)
    wo = rnd(L, H * D, E, scale=(H * D) ** -0.5)
    gateup = rnd(L, E, 2 * FF, scale=E ** -0.5)
    wd = rnd(L, FF, E, scale=FF ** -0.5)
    res = {"fused_qkv_stacked": {"err": 0.0}, "fused_out_mlp_stacked": {"err": 0.0},
           "sampling_prep": {"err": 0.0}}
    # 64: a verify step's rows; LANE_ROWS: a lane step's, its inputs from a
    # generator of their own, and 128 / 256 (a verify step at 64 slots has
    # 64·(K+1) rows) from another, so that later phases see their old
    # inputs. Wherever the products take the wgmma form (fl.TC_MIN_ROWS), the
    # parent's form (gemm_partial, a block a 64-row group) is timed beside
    lane_gen = torch.Generator(device=dev).manual_seed(13)
    wide_gen = torch.Generator(device=dev).manual_seed(16)
    for B in (1, 8, SLOTS, SLOTS * WIN, LANE_ROWS, 128, 256):
        g = lane_gen if B == LANE_ROWS else wide_gen if B > LANE_ROWS else gen
        x = (torch.randn((B, E), generator=g, device=dev)).to(bf)
        a = (torch.randn((B, H * D), generator=g, device=dev)).to(bf)
        pos = torch.randint(0, 4000, (B,), generator=g, device=dev)
        cos, sin = rope_angles(pos, D, 1_000_000.0)
        kw = dict(n_heads=H, n_kv=KV, head_dim=D, eps=1e-6)
        args3 = (x, ln1, wqkv, qn, kn, cos, sin)
        args4 = (a, x, wo, ln2, gateup, wd)
        e3 = e4 = 0.0
        for layer in range(L):
            got = fl.fused_qkv_stacked(*args3, layer, **kw)
            ref = fl.fused_qkv_stacked_plain(*args3, layer, **kw)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.float(), r.float(), rtol=BF16_RTOL,
                                           atol=BF16_ATOL)
                e3 = max(e3, _err(g, r))
            got4 = fl.fused_out_mlp_stacked(*args4, layer, eps=1e-6)
            ref4 = fl.fused_out_mlp_stacked_plain(*args4, layer, eps=1e-6)
            torch.cuda.synchronize()
            torch.testing.assert_close(got4.float(), ref4.float(), rtol=BF16_RTOL,
                                       atol=BF16_ATOL)
            e4 = max(e4, _err(got4, ref4))
            if B == LANE_ROWS and layer == 0:
                _b4_row_group_fault(args4, got4)

        def layers(f, args, **k):
            return lambda: [f(*args, layer, **k) for layer in range(L)]

        t3 = time_ms(layers(fl.fused_qkv_stacked, args3, **kw), calls=L)
        p3 = time_ms(layers(fl.fused_qkv_stacked_plain, args3, **kw), calls=L)
        t4 = time_ms(layers(fl.fused_out_mlp_stacked, args4, eps=1e-6), calls=L)
        p4 = time_ms(layers(fl.fused_out_mlp_stacked_plain, args4, eps=1e-6), calls=L)
        with _parent_products() as taken:
            parent3 = (time_ms(layers(fl.fused_qkv_stacked, args3, **kw), calls=L)[0]
                       if B >= taken else None)
            parent4 = (time_ms(layers(fl.fused_out_mlp_stacked, args4, eps=1e-6), calls=L)[0]
                       if B >= taken else None)
        C, W4 = (H + 2 * KV) * D, H * D * E + 3 * E * FF
        b3 = bound(2 * (E * C + B * E + E + 2 * D + B * C) + 4 * B * D, 2 * B * E * C)
        b4 = bound(2 * (W4 + B * H * D + 2 * B * E + E), 2 * B * W4)
        for name, e, t, p, bd, par in (("B3 fused_qkv_stacked", e3, t3, p3, b3, parent3),
                                       ("B4 fused_out_mlp_stacked", e4, t4, p4, b4, parent4)):
            log(f"[kernel] {name:25s} B={B:3d} max_abs_err={e:.3e} | device "
                f"kernel {t[0]:.4f} ms plain {p[0]:.4f} ms | eager kernel "
                f"{t[1]:.4f} ms plain {p[1]:.4f} ms | bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']})"
                + (f" | parent's form (gemm_partial) {par:.4f} ms" if par is not None else ""))
            name = name.split()[1]
            res[name]["err"] = max(res[name]["err"], e)
            if B == SLOTS:
                res[name].update(ms=t[0], plain_ms=p[0], library_ms=None, parent_ms=par, **bd)
            if B >= LANE_ROWS:
                PAST_64[f"{name} qwen3-8b B={B}"] = dict(err=e, ms=t[0], plain_ms=p[0],
                                                         library_ms=None, parent_ms=par, **bd)

    # B3 with bf16 cos / sin (read as stored: widening is exact) at B = 1,
    # 16 and 64, and a plain output whose input norm left out one K chunk
    # (1024 columns of the sum of squares) failing B3's bound; inputs from
    # a generator of their own, so later phases see their old ones
    aux = torch.Generator(device=dev).manual_seed(3)
    for B in (1, SLOTS, 64):
        x = (torch.randn((B, E), generator=aux, device=dev)).to(bf)
        pos = torch.randint(0, 4000, (B,), generator=aux, device=dev)
        cos, sin = (c.to(bf) for c in rope_angles(pos, D, 1_000_000.0))
        kw = dict(n_heads=H, n_kv=KV, head_dim=D, eps=1e-6)
        args3 = (x, ln1, wqkv, qn, kn, cos, sin)
        e3 = 0.0
        for layer in range(L):
            got = fl.fused_qkv_stacked(*args3, layer, **kw)
            ref = fl.fused_qkv_stacked_plain(*args3, layer, **kw)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.float(), r.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
                e3 = max(e3, _err(g, r))
        res["fused_qkv_stacked"]["err"] = max(res["fused_qkv_stacked"]["err"], e3)
        fault = _qkv_norm_fault(x, ln1[0], wqkv[0], qn[0], kn[0], cos, sin, drop=1, **kw)
        ref0 = torch.cat(fl.fused_qkv_stacked_plain(*args3, 0, **kw), 1)
        use = _bound_use(torch.cat(fault, 1)[:, None], ref0[:, None], BF16_RTOL, BF16_ATOL,
                         math.inf)
        assert use > 1.0, ("B3: a norm without one K chunk passed the bound", B, use)
        log(f"[kernel] B3 fused_qkv_stacked B={B:3d} bf16 cos/sin: max_abs_err={e3:.3e}; plain "
            f"output with K chunk 1 of the input norm left out: {use:.1f} times the bound")

    # B5 over the three vocab widths at B = 1, 16, 64 (a verify step's
    # rows) and 65 (a ragged split), timed at each B; the same inputs twice
    # give the same bits (the lse merged in one fixed order), and an lse
    # that leaves out one chunk's partial fails the F32 bound. Shapes that
    # earlier versions of this script did not check draw their inputs from
    # a generator of their own, so every later phase sees the same inputs
    aux = torch.Generator(device=dev).manual_seed(1)
    for Vw in (V, V_MLA, V_ODD):
        eos = Vw - 1
        for B in (1, SLOTS, 64, 65):
            g = gen if Vw in (V, V_ODD) and B in (1, SLOTS, 64) else aux
            logits = torch.randn((B, Vw), generator=g, device=dev) * 3
            seen = torch.rand((B, Vw), generator=g, device=dev) < 0.1
            pen = torch.tensor([1.0, 1.05, 1.3], device=dev).repeat(B)[:B].contiguous()
            temp = torch.tensor([0.7, 1.0, 0.3, 1.5], device=dev).repeat(B)[:B].contiguous()
            sup = (torch.arange(B, device=dev) % 2 == 0)
            args5 = (logits, seen, pen, temp, sup, eos)
            s_k, l_k = sp.sampling_prep(*args5)
            s_r, l_r = sp.sampling_prep_plain(*args5)
            s_2, l_2 = sp.sampling_prep(*args5)
            torch.cuda.synchronize()
            torch.testing.assert_close(s_k, s_r, rtol=F32_RTOL, atol=F32_ATOL)
            torch.testing.assert_close(l_k, l_r, rtol=F32_RTOL, atol=F32_ATOL)
            assert torch.equal(s_k, s_2) and torch.equal(l_k, l_2), (
                "sampling_prep: two calls on the same inputs differ", Vw, B)
            e5 = max(_err(s_k, s_r), _err(l_k, l_r))
            S, chunk = sp.prep_splits(B, Vw, torch.cuda.get_device_properties(0)
                                      .multi_processor_count)
            drop = S // 2   # the lse without chunk `drop`'s partial
            keep = torch.ones(Vw, dtype=torch.bool, device=dev)
            keep[drop * chunk:(drop + 1) * chunk] = False
            fault = torch.logsumexp(s_r[:, keep], dim=-1, keepdim=True)
            use = _bound_use(fault[:, :, None], l_r[:, :, None], F32_RTOL, F32_ATOL, math.inf)
            assert S == 1 or use > 1.0, ("B5 lse fault passed the bound", Vw, B, use)
            t5 = time_ms(lambda: sp.sampling_prep(*args5))
            p5 = time_ms(lambda: sp.sampling_prep_plain(*args5))
            # logits f32 + seen + 3 row values read, scaled f32 + lse
            # written; ~8 float32 operations an element
            bd5 = bound(B * Vw * 9 + B * 16, 8 * B * Vw, rate=F32_FLOP_S)
            log(f"[kernel] B5 sampling_prep V={Vw:6d} B={B:3d} S={S:3d} chunk={chunk:6d} "
                f"max_abs_err={e5:.3e} (lse without chunk {drop}: "
                f"{'one chunk, no fault' if S == 1 else f'bound use {use:.1f}'}) | device "
                f"kernel {t5[0]:.4f} ms plain {p5[0]:.4f} ms | eager kernel {t5[1]:.4f} ms "
                f"plain {p5[1]:.4f} ms | bound "
                f"{bd5['bound_ms']:.4f} ms ({bd5['bound_by']}) | "
                f"{(B * Vw * 9 + B * 16) / t5[0] / 1e6:.1f} GB/s")
            res["sampling_prep"]["err"] = max(res["sampling_prep"]["err"], e5)
            if B == SLOTS and Vw == V:
                res["sampling_prep"].update(ms=t5[0], plain_ms=p5[0], library_ms=None,
                                            shape=f"B={B} V={Vw}", **bd5)
    return res


def phase_one_layer_kernels(gen) -> tuple[dict, dict]:
    """B11, the one-layer forms (``fused_mlp``, ``fused_qkv``,
    ``fused_out_mlp`` with packed and unpacked gate/up), against their plain
    versions at qwen3-8b widths, B = 1 and 16, timed at 16 with their bounds;
    then B11's own path (no serving path calls it: the JAX package's tests
    are its callers): the counters set to 0, each entry driven once on a
    16-row decode layer, the counts read. Returns (per-kernel results, the
    path's launches)."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    dev = torch.device("cuda")
    res: dict = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    ln = rnd(E, scale=0.1) + 1
    qn, kn = rnd(D, scale=0.1) + 1, rnd(D, scale=0.1) + 1
    C = (H + 2 * KV) * D
    wqkv, wo = rnd(E, C, scale=E ** -0.5), rnd(H * D, E, scale=(H * D) ** -0.5)
    wg, wu = rnd(E, FF, scale=E ** -0.5), rnd(E, FF, scale=E ** -0.5)
    wd = rnd(FF, E, scale=FF ** -0.5)
    gateup = torch.cat([wg, wu], dim=1)   # the packed [E, 2F] layout
    kw = dict(n_heads=H, n_kv=KV, head_dim=D, eps=1e-6)
    w_mlp, w_out = 3 * E * FF, H * D * E + 3 * E * FF
    for B in (1, SLOTS):
        x, a = rnd(B, E), rnd(B, H * D)
        cos, sin = (c.to(torch.bfloat16) for c in rope_angles(
            torch.randint(0, 4000, (B,), generator=gen, device=dev), D, 1_000_000.0))
        timed = B == SLOTS

        def check(name, label, kernel, plain, nbytes, flop):
            _check_kernel(res, name, f"B={B} {label}", kernel, plain, rtol=BF16_RTOL,
                          atol=BF16_ATOL, timed=timed, nbytes=nbytes, flop=flop)

        check("fused_mlp", "E=4096 F=12288", lambda: fl.fused_mlp(x, ln, wg, wu, wd),
              lambda: fl.fused_mlp_plain(x, ln, wg, wu, wd),
              2 * (w_mlp + 2 * B * E + E), 2 * B * w_mlp)
        check("fused_qkv", "E=4096 H=32 KV=8",
              lambda: fl.fused_qkv(x, ln, wqkv, qn, kn, cos, sin, **kw),
              lambda: fl.fused_qkv_plain(x, ln, wqkv, qn, kn, cos, sin, **kw),
              2 * (E * C + B * E + E + 2 * D + B * C + B * D), 2 * B * E * C)
        # float32 cos / sin too (not timed: the row keeps bf16's time)
        _check_kernel(res, "fused_qkv", f"B={B} cos/sin float32",
                      lambda: fl.fused_qkv(x, ln, wqkv, qn, kn, cos.float(), sin.float(), **kw),
                      lambda: fl.fused_qkv_plain(x, ln, wqkv, qn, kn, cos.float(), sin.float(),
                                                 **kw), rtol=BF16_RTOL, atol=BF16_ATOL)
        nb_out = 2 * (w_out + B * H * D + 2 * B * E + E)
        # packed first: the unpacked call's time is the one the row keeps
        check("fused_out_mlp", "packed gate|up",
              lambda: fl.fused_out_mlp(a, x, wo, ln, gateup, gateup, wd, packed_gateup=True),
              lambda: fl.fused_out_mlp_plain(a, x, wo, ln, gateup, gateup, wd,
                                             packed_gateup=True), nb_out, 2 * B * w_out)
        check("fused_out_mlp", "unpacked gate, up",
              lambda: fl.fused_out_mlp(a, x, wo, ln, wg, wu, wd),
              lambda: fl.fused_out_mlp_plain(a, x, wo, ln, wg, wu, wd), nb_out, 2 * B * w_out)

    # fused_qkv at a verify step's 64 rows, cos / sin in both dtypes (inputs
    # from a generator of their own), timed for the record
    aux = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn((64, E), generator=aux, device=dev)).to(torch.bfloat16)
    pos = torch.randint(0, 4000, (64,), generator=aux, device=dev)
    for cdt in (torch.bfloat16, torch.float32):
        cos, sin = (c.to(cdt) for c in rope_angles(pos, D, 1_000_000.0))
        sub: dict = {}
        _check_kernel(sub, "fused_qkv", f"B=64 cos/sin {str(cdt).split('.')[-1]}",
                      lambda: fl.fused_qkv(x, ln, wqkv, qn, kn, cos, sin, **kw),
                      lambda: fl.fused_qkv_plain(x, ln, wqkv, qn, kn, cos, sin, **kw),
                      rtol=BF16_RTOL, atol=BF16_ATOL, timed=True,
                      nbytes=2 * (E * C + 64 * E + E + 2 * D + 64 * C + 64 * D)
                      + (2 if cdt == torch.bfloat16 else 4) * 64 * D, flop=2 * 64 * E * C)
        res["fused_qkv"]["err"] = max(res["fused_qkv"]["err"], sub["fused_qkv"]["err"])
        with _parent_products() as taken:   # the parent's form where the wgmma form runs
            if 64 >= taken:
                par = time_ms(lambda: fl.fused_qkv(x, ln, wqkv, qn, kn, cos, sin, **kw),
                              iters=20)[0]
                log(f"[kernel] fused_qkv B=64 cos/sin {str(cdt).split('.')[-1]}: parent's "
                    f"form (gemm_partial) {par:.4f} ms")

    # B11's path: its three entry points on one 16-row decode layer
    fns = (fl.fused_qkv, fl.fused_out_mlp, fl.fused_mlp)
    for f in fns:
        f.launches = 0
    x = rnd(SLOTS, E)
    cos, sin = rope_angles(torch.arange(SLOTS, device=dev), D, 1_000_000.0)
    q = fl.fused_qkv(x, ln, wqkv, qn, kn, cos, sin, **kw)[0].contiguous()
    x2 = fl.fused_out_mlp(q, x, wo, ln, wg, wu, wd)
    x3 = fl.fused_out_mlp(q, x2, wo, ln, gateup, gateup, wd, packed_gateup=True)
    out = fl.fused_mlp(x3, ln, wg, wu, wd)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in fns}
    assert bool(torch.isfinite(out.float()).all()) and out.shape == (SLOTS, E)
    assert all(n > 0 for n in launches.values()), launches
    log(f"[b11-path] one decode layer through the one-layer forms: launches {launches}")
    return res, launches


def _x2_ulp(a, x, wo_q, wo_s):
    """One bf16 ulp of each element of x2 = x + a @ wo (int8, scaled).
    B10-out (like B4) rounds x2 to bf16 and then adds the MLP to it; a
    kernel whose float32 sums run in another order can round x2 one ulp the
    other way, and where the MLP cancels x2 that ulp (0.0156 for |x2| in
    [2, 4)) is the whole difference of two outputs near 0, beyond the
    relative bound. Over a 64-row check (327,680 outputs a layer at
    qwen3-32b) such an element turns up."""
    import torch

    x2 = (x.float() + (a.float() @ wo_q.float()) * wo_s.float()).abs()
    return torch.exp2(torch.floor(torch.log2(x2.clamp(min=1e-30))) - 7)


def _qkv_norm_fault(x, ln, w, qn, kn, cos, sin, *, drop: int, n_heads, n_kv, head_dim, eps):
    """B3's plain output with an input norm whose sum of squares leaves out
    K chunk ``drop`` (columns 1024·drop .. +1024, the chunks of 128 of the
    norm's threads): what a kernel that lost that chunk of the norm would
    give. The q / k heads are normalised again per head, so the fault shows
    on the v heads."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import matmul_f32
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    xf = x.float()
    keep = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
    keep[1024 * drop:1024 * (drop + 1)] = False
    inv = torch.rsqrt(xf[:, keep].square().sum(-1, keepdim=True) / x.shape[1] + eps)
    xn = ((xf * inv) * ln.float()).to(x.dtype)
    return fl._qkv_epilogue(matmul_f32(xn, w), x, qn, kn, cos, sin, n_heads=n_heads,
                            n_kv=n_kv, head_dim=head_dim, eps=eps)


def _bound_use(got, ref, rtol: float, atol: float, rms_frac: float) -> float:
    """The largest share of its bound that an element's error takes: the
    bound is ``min(atol, rms_frac · rms) + rtol · |ref|``, rms taken over
    the reference's last two dimensions (a query position's heads and
    columns); above 1 the check fails."""
    import torch

    r = ref.float()
    rms = r.pow(2).mean(dim=(-2, -1), keepdim=True).sqrt()
    tol = torch.clamp(rms_frac * rms, max=atol) + rtol * r.abs()
    return float(((got.float() - r).abs() / tol.clamp(min=1e-30)).max())


def _check_kernel(res: dict, name: str, label: str, kernel, plain, *, rtol: float,
                  atol: float, timed: bool = False, nbytes: int = 0, flop: int = 0,
                  plain_graph: bool = True, library=None, exact: bool = False,
                  rate: float = BF16_FLOP_S, slack=None, rms_frac=None) -> None:
    """``kernel()`` against ``plain()`` (tensors or tuples of them) at the
    stated tolerance (``exact``: bit for bit; ``slack``: an absolute
    allowance per element added to it; ``rms_frac``: the absolute part is
    at most that share of the reference's root mean square over its last
    two dimensions, see ``_rms_bound``); the largest error is kept in
    ``res[name]``. ``timed`` also records device ms of both
    (``plain_graph=False``: the plain version syncs with the host, so its
    time is the eager one), the bound from ``nbytes`` (every input read and
    every output written once) and ``flop``, and the time of ``library``,
    one PyTorch call computing the same function, where there is one."""
    import torch

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    e, use = 0.0, None
    for g, r in zip(got, ref):
        if rms_frac is not None:
            u = _bound_use(g, r, rtol, atol, rms_frac)
            assert u <= 1.0, (name, label, f"{u:.2f} times the bound (rms share "
                              f"{rms_frac}), largest error {_err(g, r)}")
            use = max(use or 0.0, u)
        elif exact:
            assert g.dtype == r.dtype and torch.equal(g, r), (
                name, label, f"{int((g != r).sum())} of {g.numel()} elements differ")
        elif slack is not None:
            d = (g.float() - r.float()).abs()
            bad = d > atol + rtol * r.float().abs() + slack
            assert not bool(bad.any()), (name, label, f"{int(bad.sum())} of {g.numel()} "
                                         f"elements beyond the bound, largest {float(d.max())}")
        else:
            torch.testing.assert_close(g.float(), r.float(), rtol=rtol, atol=atol)
        e = max(e, _err(g, r))
    r = res.setdefault(name, {"err": 0.0})
    r["err"] = max(r["err"], e)
    msg = f"[kernel] {name:26s} {label:34s} max_abs_err={e:.3e}"
    if use is not None:
        msg += f" (bound use {use:.3f})"
    if timed:
        t = time_ms(kernel, iters=20)
        p = time_ms(plain, iters=5) if plain_graph else (time_eager_ms(plain, 5),) * 2
        r.update(ms=t[0], plain_ms=p[0], shape=label, **bound(nbytes, flop, rate),
                 library_ms=None if library is None else time_ms(library, iters=20)[0])
        msg += (f" | device kernel {t[0]:.4f} ms plain {p[0]:.4f} ms"
                f"{'' if plain_graph else ' (eager: it syncs)'} | eager "
                f"kernel {t[1]:.4f} ms plain {p[1]:.4f} ms | bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        if r["library_ms"] is not None:
            msg += f" | library {r['library_ms']:.4f} ms"
        if nbytes:
            msg += f" | {nbytes / t[0] / 1e6:.1f} GB/s"
        if flop:
            msg += f" | {flop / t[0] / 1e9:.1f} TFLOP/s"
    log(msg)


def _bound_rejects_split_faults(ref, q, k, v, *, scale=None, tag: str = "K1") -> None:
    """The rms-scaled attention bound is tight enough to see a fault of the
    context split: over one full row (q [1,H,D], k [1,KV,S,D], v
    [1,KV,S,Dv], ``ref`` B1's plain output) a plain attention with p
    rounded to bf16 passes the bound, and the same with one 256-key split
    dropped, with the last 64-key tile dropped, or with one split weighed
    twice, each fails it."""
    import torch

    H, D = q.shape[1], q.shape[2]
    S = k.shape[2]
    kk = k[0].float().repeat_interleave(H // k.shape[1], 0)    # [H,S,D]
    vv = v[0].float().repeat_interleave(H // k.shape[1], 0)
    s = torch.einsum("hd,hsd->hs", q[0].float() * (scale or D ** -0.5), kk)
    chunk = S // 16

    def attend(lo=0, hi=0, bias=-torch.inf):
        b = torch.zeros(S, device=q.device)
        b[lo:hi] = bias
        p = torch.softmax(s + b, -1).to(torch.bfloat16).float()
        return torch.einsum("hs,hsd->hd", p, vv).to(torch.bfloat16)[None]

    uses, flat = {}, {}
    for fault, kw in (("sound", dict()), ("one split dropped", dict(lo=chunk, hi=2 * chunk)),
                      ("last 64-key tile dropped", dict(lo=S - 64, hi=S)),
                      ("one split weighed twice",
                       dict(lo=chunk, hi=2 * chunk, bias=math.log(2.0)))):
        out = attend(**kw)
        uses[fault] = _bound_use(out, ref, ATTN_RTOL, ATTN_ATOL, ATTN_RMS_FRAC)
        flat[fault] = _bound_use(out, ref, ATTN_RTOL, ATTN_ATOL, math.inf)
    log(f"[kernel] {tag} bound over one full row, bound use: " +
        ", ".join(f"{t} {u:.3f}" for t, u in uses.items()) +
        " (ATTN_ATOL alone: " + ", ".join(f"{u:.3f}" for u in flat.values()) + ")")
    assert uses.pop("sound") <= 1.0 and min(uses.values()) > 1.0, uses


def phase_attention_kernels(gen) -> dict:
    """B1, the three B6 entries and B2 against their plain versions at
    qwen3-8b attention widths (H=32, K=8, D=128, bf16); returns per-kernel
    results (error, and device ms of kernel and plain at the shape noted)."""
    import torch

    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev = torch.device("cuda")
    res: dict = {}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def check(*a, **k):
        _check_kernel(res, *a, rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, **k)

    # B1: a two-layer slot pool of SLOTS rows x CTX tokens
    L = 2
    kp, vp = rnd(L * SLOTS, CTX, KV, D), rnd(L * SLOTS, CTX, KV, D)
    q = rnd(SLOTS, H, D)
    lim = torch.tensor(LIMITS, device=dev)
    kw = dict(n_rows=SLOTS, slot_ctx=CTX)
    keys = sum(max(x, 1) for x in LIMITS)
    io = keys * KV * D * 2 * 2 + 2 * SLOTS * H * D * 2 + SLOTS * 8
    # the yardstick: SDPA over layer 1's contiguous rows, keys masked past
    # each row's limit (inactive rows keep one key, as B1 clamps them)
    k1, v1 = (t[SLOTS:].transpose(1, 2).contiguous() for t in (kp, vp))
    mask = (torch.arange(CTX, device=dev)[None] < lim.clamp(min=1)[:, None])[:, None, None]
    q4 = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for layer in range(L):
        for v, tag in ((vp, ""), (None, " v=k")):
            check("slot_attention", f"B={SLOTS} layer={layer} ctx={CTX}{tag}",
                  lambda: sa.slot_attention(q, kp, v, lim, layer, **kw),
                  lambda: sa.slot_attention_plain(q, kp, v, lim, layer, **kw),
                  timed=layer == 1 and v is not None, nbytes=io, flop=4 * H * D * keys,
                  library=lambda: sdpa(q4, k1, v1, attn_mask=mask, enable_gqa=True))
    _check_windows(check, rnd, kp, vp, H, KV, (4, 8), timed_w=WIN,
                   library_kv=(k1, v1))
    del k1, v1
    # B1 at B = 1 over one full 4096-token row: the case the context split
    # is for (16 splits of 256 keys), beside SDPA over the same row
    row: dict = {}
    qb, lb = rnd(1, H, D), torch.tensor([CTX], device=dev)
    kb1, vb1 = (t[1:2].transpose(1, 2) for t in (kp, vp))
    kw1 = dict(n_rows=1, slot_ctx=CTX)
    _check_kernel(row, "slot_attention", f"B=1 layer=1 ctx={CTX} (one full row)",
                  lambda: sa.slot_attention(qb, kp[:2], vp[:2], lb, 1, **kw1),
                  lambda: sa.slot_attention_plain(qb, kp[:2], vp[:2], lb, 1, **kw1),
                  rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                  nbytes=CTX * KV * D * 4 + 4 * H * D + 8, flop=4 * H * D * CTX,
                  library=lambda: sdpa(qb[:, :, None], kb1, vb1, enable_gqa=True))
    res["slot_attention_b1"] = row["slot_attention"]
    _bound_rejects_split_faults(sa.slot_attention_plain(qb, kp[:2], vp[:2], lb, 1, **kw1),
                                qb, kb1, vb1)
    del kb1, vb1
    # B1 at B = 64: B·KV = 512 blocks fill the card, so one split and no
    # merge (LIMITS' rows four times over), beside SDPA over the same rows
    n64, wide = 4 * SLOTS, {}
    k64, v64, q64 = rnd(n64, CTX, KV, D), rnd(n64, CTX, KV, D), rnd(n64, H, D)
    lim64 = torch.tensor(LIMITS * 4, device=dev)
    mask64 = (torch.arange(CTX, device=dev)[None] < lim64.clamp(min=1)[:, None])[:, None, None]
    kt64, vt64 = (t.transpose(1, 2) for t in (k64, v64))
    kw64 = dict(n_rows=n64, slot_ctx=CTX)
    _check_kernel(wide, "slot_attention", f"B={n64} layer=0 ctx={CTX} (one split)",
                  lambda: sa.slot_attention(q64, k64, v64, lim64, 0, **kw64),
                  lambda: sa.slot_attention_plain(q64, k64, v64, lim64, 0, **kw64),
                  rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                  nbytes=4 * keys * KV * D * 4 + 2 * n64 * H * D * 2 + n64 * 8,
                  flop=4 * H * D * 4 * keys,
                  library=lambda: sdpa(q64[:, :, None], kt64, vt64, attn_mask=mask64,
                                       enable_gqa=True))
    res["slot_attention_b64"] = wide["slot_attention"]
    del k64, v64, kt64, vt64

    # B6: ps=64, P=64 pages per row, page 0 the (zeroed) null page
    ps, P = 64, CTX // 64
    NP = 1 + SLOTS * P
    kpg, vpg = rnd(NP, ps, KV, D), rnd(NP, ps, KV, D)
    kpg[0], vpg[0] = 0, 0
    seq = torch.tensor(SEQS, device=dev)
    perm = torch.randperm(NP - 1, generator=gen, device=dev)[: SLOTS * P].view(SLOTS, P)
    used = (seq + ps - 1) // ps
    table = torch.where(torch.arange(P, device=dev)[None] < used[:, None], perm + 1, 0)
    read = int(seq.sum()) * KV * D * 2 * 2 + 2 * SLOTS * H * D * 2 + SLOTS * (P + 2) * 8
    flop6 = 4 * H * D * int(seq.sum())
    q1 = rnd(SLOTS, 1, H, D)
    qpos1 = (seq - 1)[:, None]
    # the yardstick: SDPA over the pre-gathered context (the gather not
    # timed), each row's keys masked past its seq_len, as K2's paged mode is
    # measured
    kg6, vg6 = (t[table].reshape(SLOTS, P * ps, KV, D).transpose(1, 2) for t in (kpg, vpg))
    mask6 = (torch.arange(P * ps, device=dev)[None] < seq[:, None])[:, None, None]
    qt1 = q1.transpose(1, 2)
    lib6 = lambda: sdpa(qt1, kg6, vg6, attn_mask=mask6, enable_gqa=True)  # noqa: E731
    check("pallas_paged_attention", f"B={SLOTS} T=1 ps={ps} P={P}",
          lambda: pa.pallas_paged_attention(q1, kpg, vpg, table, seq, qpos1),
          lambda: pa.pallas_paged_attention_plain(q1, kpg, vpg, table, seq, qpos1),
          timed=True, nbytes=read, flop=flop6, library=lib6)
    # chunks: T=4 (16 query rows a block) and T=16 (64, the most K1 holds)
    for T in (4, 16):
        seqT = seq.clamp(min=T)
        qposT = seqT[:, None] - T + torch.arange(T, device=dev)[None]
        qT = rnd(SLOTS, T, H, D)
        check("pallas_paged_attention", f"B={SLOTS} T={T} ps={ps} P={P}",
              lambda: pa.pallas_paged_attention(qT, kpg, vpg, table, seqT, qposT),
              lambda: pa.pallas_paged_attention_plain(qT, kpg, vpg, table, seqT, qposT))
    for name in ("pallas_paged_decode", "pallas_paged_decode_clamp"):
        fk, fp = getattr(pa, name), getattr(pa, name + "_plain")
        check(name, f"B={SLOTS} T=1 ps={ps} P={P}",
              lambda: fk(q1, kpg, vpg, table, seq), lambda: fp(q1, kpg, vpg, table, seq),
              timed=True, nbytes=read, flop=flop6, library=lib6)
    del kp, vp, kpg, vpg, kg6, vg6

    # B2: causal prefill: one query, a ragged 127 (one partial tile), lengths
    # that are not a multiple of the tile (3030), and the timed 3072
    # (and B = 2 at 3030: a ragged tail in a batch row that has a next one)
    for B, T in ((1, 1), (1, 127), (1, 128), (4, 512), (1, 3030), (2, 3030), (1, 3072)):
        qf, kf, vf = rnd(B, T, H, D), rnd(B, T, KV, D), rnd(B, T, KV, D)
        qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))
        check("flash_attention", f"B={B} T={T}",
              lambda: fa.flash_attention(qf, kf, vf),
              lambda: fa.flash_attention_plain(qf, kf, vf),
              timed=T == 3072, flop=4 * B * H * D * T * (T + 1) // 2,
              nbytes=2 * B * T * D * (2 * H + 2 * KV),
              library=lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    # G = 2: 16 kv heads, a block's 128 rows hold 64 positions
    qf, kf, vf = rnd(1, 1000, H, D), rnd(1, 1000, 16, D), rnd(1, 1000, 16, D)
    check("flash_attention", "G=2 B=1 T=1000", lambda: fa.flash_attention(qf, kf, vf),
          lambda: fa.flash_attention_plain(qf, kf, vf))
    # G = 5 (qwen3-14b's 40 / 8 heads): 25 positions in 125 of a block's 128
    # rows; 1001 positions leave one in the last block
    qf, kf, vf = rnd(1, 1001, 40, D), rnd(1, 1001, 8, D), rnd(1, 1001, 8, D)
    check("flash_attention", "G=5 B=1 T=1001", lambda: fa.flash_attention(qf, kf, vf),
          lambda: fa.flash_attention_plain(qf, kf, vf))
    del qf, kf, vf
    _check_paged_prefills(res, gen)
    _check_int8_decode(res, gen)
    _check_paged_prefills(res, gen, I8_PREFILLS + (I8_BUCKET,), "flash_attention_paged_i8")
    return res


def _int8_pools(gen, n: int, ps: int, kv: int):
    """int8 K and V pages [n, ps, kv, D] and their float32 scales [n, ps, kv]:
    random rows quantized as the engine writes them (``quantize_kv_rows``)."""
    import torch

    from deepsearch_tts_tpu_torch.engine.kvcache import quantize_kv_rows

    kp, ks = quantize_kv_rows(torch.randn((n, ps, kv, D), generator=gen, device="cuda"))
    vp, vs = quantize_kv_rows(torch.randn((n, ps, kv, D), generator=gen, device="cuda"))
    return kp, vp, ks, vs


def _check_int8_decode(res: dict, gen) -> None:
    """K1's int8 mode (``decode_i8``: its plan kernel, then the persistent
    grid) against its plain version (``paged_int8_plain``) under the
    rms-scaled attention bound, at qwen3-32b's widths (64 / 8 heads, D =
    128) over int8 pages: B = 16, T = 1, 64 pages of 64 keys a row, the B6
    rows' ragged lengths (:data:`SEQS`, 19,613 keys) through all three
    entries and K1's own rows (:data:`LIMITS`, 19,280 keys, two rows with
    none) through ``pallas_paged_attention``, B = 1 over one 4096-key row
    and B = 16 rows of 4096 keys, each timed beside the plain version, its
    bound (bytes: each row's int8 keys and values and their scales once, q,
    out, the table) and SDPA over the pre-dequantized context (the gather
    and the dequantization not timed); untimed: pages of 8, 16 and 48 keys,
    qwen3-14b's G = 5, a chunk of T = 4 (32 query rows a kv head: two
    query groups of 16), a row with no key under ``min_one`` (it sees key
    0). The plan kernel alone against its host model
    (``paged_attention.decode_i8_plan``) at SEQS and LIMITS: the same
    pieces, longest first, and its counters reset.
    ``res["decode_attention_i8"]`` keeps the SEQS shape's numbers and the
    largest error, ``res["decode_attention_i8_shapes"]`` each timed
    shape's."""
    import torch

    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops.attention import dequant_context

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    occ = pa.attention_occupancy()
    log(f"[kernel] decode_i8 blocks an SM (runtime occupancy): 8 rows an item "
        f"{occ['K1 int8 (8 rows an item)']}, 16 rows "
        f"{occ['K1 int8 (16 rows an item)']} "
        f"(the grid takes {pa.I8_BLOCKS_PER_SM[8]} / {pa.I8_BLOCKS_PER_SM[16]})")
    shapes = {}

    def case(tag, lens, ps=64, heads=(Q_H, Q_KV), T=1, timed=False, min_one=False,
             entries=("pallas_paged_attention",)):
        h, kv = heads
        B, P = len(lens), -(-CTX // ps)
        NP = 1 + B * P
        kp, vp, ks, vs = _int8_pools(gen, NP, ps, kv)
        sc = dict(k_scales=ks, v_scales=vs)
        q = torch.randn((B, T, h, D), generator=gen, device=dev).to(torch.bfloat16)
        perm = torch.randperm(NP - 1, generator=gen, device=dev)[: B * P].view(B, P)
        seq = torch.tensor(lens, device=dev)
        used = (seq.clamp(min=1) + ps - 1) // ps
        table = torch.where(torch.arange(P, device=dev)[None] < used[:, None], perm + 1, 0)
        qpos = (seq - T).clamp(min=0)[:, None] + torch.arange(T, device=dev)[None]
        keys = int(seq.sum())
        label = f"B={B} T={T} H={h} KV={kv} ps={ps} P={P} {keys} keys ({tag})"
        one: dict = {}
        if min_one:   # the decode form (no positions): a row of length 0 sees key 0
            seq1 = seq.clamp(min=1)
            _check_kernel(one, "decode_attention_i8", label + " min_one",
                          lambda: pa.decode_attention_cuda(q, kp, vp, seq, page_table=table,
                                                           min_one=True, **sc),
                          lambda: pa.paged_int8_plain(q, kp, vp, ks, vs, table, seq1,
                                                      (seq1 - 1)[:, None]),
                          rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC)
            entries = ()
        kw = {}
        if timed and entries:
            kd, vd = (dequant_context(p_, s_, table, torch.bfloat16).transpose(1, 2)
                      for p_, s_ in ((kp, ks), (vp, vs)))
            mask = (torch.arange(P * ps, device=dev)[None] < seq[:, None])[:, None, None]
            qt = q.transpose(1, 2)
            kw = dict(timed=True, flop=4 * h * D * keys * T,
                      nbytes=(keys * kv * (D + 4) * 2 + 2 * B * T * h * D * 2
                              + B * (P + 2) * 8),
                      library=lambda: sdpa(qt, kd, vd, attn_mask=mask, enable_gqa=True))
        for i, name in enumerate(entries):
            fk, fp = getattr(pa, name), getattr(pa, name + "_plain")
            args = (q, kp, vp, table, seq) + ((qpos,) if name == "pallas_paged_attention" else ())
            _check_kernel(one, "decode_attention_i8",
                          label + ("" if i == 0 else f" via {name}"),
                          lambda: fk(*args, **sc), lambda: fp(*args, **sc),
                          rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC,
                          **(kw if i == 0 else {}))
        r = res.setdefault("decode_attention_i8", {"err": 0.0})
        r["err"] = max(r["err"], one["decode_attention_i8"]["err"])
        if timed:
            shapes[label] = one["decode_attention_i8"]
            if tag == "SEQS":
                res["decode_attention_i8"] = {**one["decode_attention_i8"], "err": r["err"]}

    entries = ("pallas_paged_attention", "pallas_paged_decode", "pallas_paged_decode_clamp")
    case("SEQS", SEQS, timed=True, entries=entries)
    case("LIMITS", LIMITS, timed=True)
    case("one full row", [CTX], timed=True)
    case("16 full rows", [CTX] * SLOTS, timed=True)
    for ps in (8, 16, 48):
        case(f"pages of {ps}", SEQS[:8], ps=ps)
    case("qwen3-14b G=5", SEQS, heads=(40, 8), entries=entries)
    case("a chunk of 4", [4, 100, 2048, 4096], T=4)
    case("a row with no key", [0, 1, 700, 64], min_one=True)
    res["decode_attention_i8"]["err"] = max(
        res["decode_attention_i8"]["err"], *(r["err"] for r in shapes.values()))
    res["decode_attention_i8_shapes"] = shapes
    # the plan kernel against its host model
    for tag, lens in (("SEQS", SEQS), ("LIMITS", LIMITS)):
        seq = torch.tensor(lens, device=dev)
        qpos = (seq - 1).clamp(min=0)[:, None]
        got = pa.decode_i8_plan_cuda(seq, qpos, T=1, G=Q_H // Q_KV, KV=Q_KV, max_keys=CTX)
        want = pa.decode_i8_plan(seq.cpu(), qpos.cpu(), T=1, G=Q_H // Q_KV, KV=Q_KV,
                                 sms=pa._sm_count(dev), max_keys=CTX)
        lengths = [-(-(k1 - k0) // pa.KEY_TILE) for _, k0, k1, _ in got["items"]]
        assert (got["C"], got["W"], got["rows"]) == (want["C"], want["W"], want["rows"]), tag
        assert sorted(got["items"]) == sorted(want["items"]), tag
        assert lengths == sorted(lengths, reverse=True), tag
        assert got["counter"] == 0 and not any(got["cnt"]), tag
        log(f"[kernel] decode_i8_plan {tag}: equal to its host model: W = {got['W']} tiles, "
            f"C = {got['C']}, {len(got['items'])} pieces longest first "
            f"({sum(z > 1 for *_, z, _ in got['rows'])} of {len(got['rows'])} rows split)")


# K2's paged mode in phase 3: (label, B, T, each row's chunk start (< 0: a
# padding row), its valid queries (fewer than T: tail padding), ps, P,
# (query heads, kv heads), slot layout: one page of ps keys a row, the
# identity table at layer 1 of 2). The first is the CLI engine's long
# prompt, whose numbers the kernel line keeps; ps = 16 takes four one-page
# boxes a tile, ps = 48 boxes of 16 keys, three a page; qwen3-14b's 40 / 8
# heads (G = 5) fold 25 positions into 125 of a block's 128 rows; the slot
# row of 3000 keys takes boxes of 64 that run past its end; the last two are
# a multi-turn follow-up padded as Engine._bucket pads it (a power of two):
# few units of ~24 key tiles each, which the plan cuts into pieces, and at
# T=512 six blocks of 32 positions of tail padding that take no item
PAGED_PREFILLS = (
    ("B=1 T=3044 from 0 over 48 pages of 64", 1, 3044, (0,), (3044,), 64, 48, (H, KV), False),
    ("B=1 T=1024 after a 2000-token prefix (mid-page)", 1, 1024, (2000,), (1024,), 64, 48,
     (H, KV), False),
    ("B=16 T=64 ragged starts, a padding row, tail padding", 16, 64,
     (0, 5, 64, 100, 127, 128, 300, 511, 700, 1000, 1023, 1500, 2000, 2047, 3000, -1),
     (64, 64, 60, 64, 33, 64, 64, 1, 64, 64, 64, 50, 64, 64, 64, 0), 64, 48, (H, KV), False),
    ("B=4 T=512 slot layout (ps=4096, identity table)", 4, 512, (0, 700, 3000, 1),
     (512, 512, 400, 512), CTX, 1, (H, KV), True),
    ("G=8 B=2 T=700 (300- and 0-token prefixes)", 2, 700, (300, 0), (700, 650), 64, 16,
     (H, 4), False),
    ("B=2 T=200 ps=16 (one-page boxes)", 2, 200, (37, 0), (200, 180), 16, 16, (H, KV), False),
    ("B=2 T=300 ps=48 (boxes of 16)", 2, 300, (100, 0), (300, 250), 48, 16, (H, KV), False),
    ("G=5 (qwen3-14b) B=2 T=701 (300- and 0-token prefixes)", 2, 701, (300, 0), (701, 650),
     64, 16, (40, 8), False),
    ("B=2 T=512 slot layout (ps=3000: boxes past the row)", 2, 512, (0, 2600), (512, 400),
     3000, 1, (H, KV), True),
    ("B=1 T=128: 100 new tokens after a 3000-token prefix", 1, 128, (3000,), (100,), 64,
     CTX // 64, (H, KV), False),
    ("B=1 T=512: 300 new tokens after a 3000-token prefix", 1, 512, (3000,), (300,), 64,
     CTX // 64, (H, KV), False),
)

# K3's prefill mode in phase 20 (MLA's prefills: ``latent_prefill``), each
# at deepseek-v3's 128 and kimi-k2's 64 query heads over one 576-column
# latent head: (label, B, T, starts, valid, ps, P, slot); slot: rows B ..
# 2B-1 of a 2B-row pool of CTX keys a row, no table (``row_offset``)
LATENT_PREFILLS = (
    ("B=1 T=3044 from 0 over 48 pages of 64", 1, 3044, (0,), (3044,), 64, 48, False),
    ("B=1 T=4096 from 0 over 64 pages of 64 (the 4096 bucket)", 1, 4096, (0,), (4096,),
     64, 64, False),
    ("B=1 T=128: 100 new tokens after a 3000-token prefix", 1, 128, (3000,), (100,), 64,
     CTX // 64, False),
    ("B=1 T=512: 300 new tokens after a 3000-token prefix", 1, 512, (3000,), (300,), 64,
     CTX // 64, False),
    ("B=16 T=64 ragged starts, a padding row, tail padding", 16, 64,
     (0, 5, 64, 100, 127, 128, 300, 511, 700, 1000, 1023, 1500, 2000, 2047, 3000, -1),
     (64, 64, 60, 64, 33, 64, 64, 1, 64, 64, 64, 50, 64, 64, 64, 0), 64, 48, False),
    ("B=15 T=64 slot rows of 4096 keys", 15, 64, tuple(range(0, 3000, 200)), (64,) * 15, CTX,
     1, True),
    ("B=16 T=4 verify windows over slot rows (split, merged)", 16, 4,
     tuple(max(x - 4, -1) for x in LIMITS), tuple(4 if x > 4 else 0 for x in LIMITS), CTX, 1,
     True),
    ("B=2 T=200 ps=16", 2, 200, (37, 0), (200, 180), 16, 16, False),
    ("B=2 T=300 ps=32", 2, 300, (100, 0), (300, 250), 32, 16, False),
)


def _paged_prefill_inputs(gen, B, T, starts, valid, ps, P, heads, slot):
    """Pools of random pages (the chunk's keys already among them), q, each
    row's table of distinct random pages (page 0 in none; slot: rows B ..
    2B-1 of a 2B-row pool), positions from each start for its valid queries
    (-1 after), seq_lens."""
    import torch

    dev = torch.device("cuda")
    h, kv = heads
    N = 2 * B if slot else 1 + B * P
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    kp, vp, q = rnd(N, ps, kv, D), rnd(N, ps, kv, D), rnd(B, T, h, D)
    if slot:
        table = (B + torch.arange(B, device=dev))[:, None]
    else:
        table = 1 + torch.randperm(N - 1, generator=gen, device=dev)[: B * P].view(B, P)
    pos = torch.full((B, T), -1, dtype=torch.int64, device=dev)
    for b, (s0, n) in enumerate(zip(starts, valid)):
        if s0 >= 0:
            pos[b, :n] = s0 + torch.arange(n, device=dev)
    seq = torch.tensor([s0 + n if s0 >= 0 else 0 for s0, n in zip(starts, valid)], device=dev)
    return q, kp, vp, table, seq, pos


# K2's int8 paged mode in phase 3: PAGED_PREFILLS' long prompt, ragged
# group and short follow-up after a 3000-token prefix at qwen3-32b's heads
I8_PREFILLS = tuple((label, B, T, starts, valid, ps, P, (Q_H, Q_KV), slot)
                    for label, B, T, starts, valid, ps, P, _, slot in
                    (PAGED_PREFILLS[0], PAGED_PREFILLS[2], PAGED_PREFILLS[9]))
# the int8 engine's one-row prefill program at the 4096 bucket: the long
# prompt's 3044 tokens padded to 4096 over the bucket's 64 pages
I8_BUCKET = ("B=1 T=4096 bucket: 3044 tokens from 0 over 64 pages", 1, 4096, (0,), (3044,), 64,
             64, (Q_H, Q_KV), False)


def _check_paged_prefills(res: dict, gen, shapes_in=PAGED_PREFILLS,
                          name: str = "flash_attention_paged") -> None:
    """K2's paged mode against its plain version at :data:`PAGED_PREFILLS`
    under the rms-scaled attention bound (whole tail-padding blocks: zeros
    in both), the plan kernel first held to its host model
    (:func:`_check_paged_plan`), each shape timed beside its plain
    version, its bound (operations: 4·H·D a visible (query, key) pair of a
    real query, padding queries uncounted; bytes: q and out, each row's
    keys up to its largest limit once) and two
    PyTorch calls over the pre-gathered context (the gather not timed):
    SDPA with a boolean mask, and where the rows are one causal block (B =
    1) causal SDPA (``is_causal`` from position 0, else
    ``causal_lower_right`` over the row's keys, kv heads repeated so the
    efficient kernel takes it), held to the same bound. ``library_ms`` is
    the faster of the two. The plain version over the long prompt's table
    with one page swapped for page 0 (in no row's table) must fail the
    bound the kernel passes. ``res[name]`` keeps the first shape's (the
    long prompt's) numbers and the largest error of all shapes,
    ``res[name + "_shapes"]`` each shape's. ``name``
    ``"flash_attention_paged_i8"``: the int8 paged mode at ``shapes_in``
    (:data:`I8_PREFILLS` and :data:`I8_BUCKET`), over the same pages
    quantized as the engine writes them, with their scales (the bytes:
    int8 keys and values and their scales; the library calls over the
    pre-dequantized context), its first launch (``widen_kv_pages``) held
    to the plain dequantization of every page below each row's
    ``seq_lens`` bit for bit and timed alone (``r["widen_ms"]``), the bf16
    paged mode over the pages before quantization timed beside it
    (``r["bf16_paged_ms"]``)."""
    import torch
    from torch.nn.attention.bias import causal_lower_right

    from deepsearch_tts_tpu_torch.engine.kvcache import quantize_kv_rows
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops.attention import dequant_context

    int8 = name.endswith("_i8")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = {}
    for label, B, T, starts, valid, ps, P, heads, slot in shapes_in:
        q, kp, vp, table, seq, pos = _paged_prefill_inputs(gen, B, T, starts, valid, ps, P,
                                                           heads, slot)
        (h, kv), S = heads, P * ps
        lim = fa.paged_key_limits(seq, pos, S, h // kv)
        _check_paged_plan(label, seq, pos, S, h // kv, kv)
        sc, key_bytes = {}, kv * D * 2 * 2
        if int8:
            bf16_ms = time_ms(lambda: fa.flash_attention_paged(q, kp, vp, table, seq, pos),
                              iters=20)[0]
            (kp, ks), (vp, vs) = quantize_kv_rows(kp), quantize_kv_rows(vp)
            sc, key_bytes = dict(k_scales=ks, v_scales=vs), kv * (D + 4) * 2
            widen_ms = _check_widen(label, kp, vp, ks, vs, table, seq)
            kt, vt = (dequant_context(p, s, table, torch.bfloat16).transpose(1, 2)
                      for p, s in ((kp, ks), (vp, vs)))
        else:
            kt, vt = (t[table].reshape(B, S, kv, D).transpose(1, 2) for t in (kp, vp))
        mask = (torch.arange(S, device=q.device)[None, None] < lim[:, :, None])[:, None]
        qt = q.transpose(1, 2)
        one: dict = {}
        _check_kernel(one, name, label,
                      lambda: fa.flash_attention_paged(q, kp, vp, table, seq, pos, **sc),
                      lambda: fa.flash_attention_paged_plain(q, kp, vp, table, seq, pos, **sc),
                      rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                      flop=4 * h * D * int(lim[pos >= 0].sum()),
                      nbytes=(int(lim.amax(1).sum()) * key_bytes + 2 * B * T * h * D * 2
                              + B * (T + P + 1) * 8),
                      library=lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
        r = one[name]
        r["library_masked_ms"] = r["library_ms"]
        if int8:
            r["widen_ms"], r["bf16_paged_ms"] = widen_ms, bf16_ms
            log(f"[kernel] {name} {label}: the widening alone {widen_ms:.4f} ms, the bf16 "
                f"paged mode over the pages unquantized {bf16_ms:.4f} ms")
        if B == 1:
            s0, n = starts[0], valid[0]
            qn = qt[:, :, :n].contiguous()      # the real queries
            if s0 == 0:
                causal = lambda: sdpa(qn, kt[:, :, :n], vt[:, :, :n], is_causal=True,  # noqa: E731
                                      enable_gqa=True)
            else:
                kr, vr = (t[:, :, :s0 + n].repeat_interleave(h // kv, 1) for t in (kt, vt))
                bias = causal_lower_right(n, s0 + n)
                causal = lambda: sdpa(qn, kr, vr, attn_mask=bias)  # noqa: E731
            ref = fa.flash_attention_paged_plain(q, kp, vp, table, seq, pos, **sc)
            use = _bound_use(causal().transpose(1, 2), ref[:, :n], ATTN_RTOL, ATTN_ATOL,
                             ATTN_RMS_FRAC)
            assert use <= 1.0, (label, "causal SDPA", use)
            r["library_causal_ms"] = time_ms(causal, iters=20)[0]
            r["library_ms"] = min(r["library_masked_ms"], r["library_causal_ms"])
            log(f"[kernel] {name} {label}: causal SDPA "
                f"{r['library_causal_ms']:.4f} ms (bound use {use:.3f}), masked SDPA "
                f"{r['library_masked_ms']:.4f} ms, kernel {r['ms']:.4f} ms")
            if not int8 and label == PAGED_PREFILLS[0][0]:
                _paged_page_fault(ref, q, kp, vp, table, seq, pos, page=P // 4)
            del ref
        shapes[label] = r
        del q, kp, vp, kt, vt, mask, qt
    res[name] = {**shapes[shapes_in[0][0]], "err": max(r["err"] for r in shapes.values())}
    res[name + "_shapes"] = shapes


def _check_widen(label: str, kp, vp, ks, vs, table, seq) -> float:
    """``widen_kv_pages`` against ``(int8.float() * scale).to(bf16)`` of
    the table's pages: equal bit for bit on every page that holds a key
    below its row's ``seq_lens``, and its table ``b·P + p``. Returns its
    time alone (ms)."""
    import torch

    from deepsearch_tts_tpu_torch.ops import flash_attention as fa

    B, P = table.shape
    ps = kp.shape[1]
    kw, vw, wt = fa.widen_kv_pages(kp, vp, ks, vs, table, seq)
    need = torch.arange(P, device=seq.device)[None] * ps < seq[:, None]
    for w, pool, s in ((kw, kp, ks), (vw, vp, vs)):
        want = (pool[table].float() * s[table][..., None]).to(torch.bfloat16)
        assert torch.equal(w.view(B, P, *w.shape[1:])[need], want[need]), label
    assert torch.equal(wt, torch.arange(B * P, device=wt.device).view(B, P)), label
    log(f"[kernel] widen_kv_pages {label}: {int(need.sum())} pages bit for bit")
    return time_ms(lambda: fa.widen_kv_pages(kp, vp, ks, vs, table, seq), iters=20)[0]


def _check_paged_plan(label: str, seq, pos, S: int, G: int, kv: int) -> None:
    """``flash_paged_plan`` on the card against its host model
    (``flash_attention.paged_plan``) at this card's SM count and the
    wrapper's split gate: the header (items, C, split units, the work
    counter at 0, the split threshold), each unit's key limit and partial
    slot base, the split units, and the items as a multiset (equal
    lengths come in any order) in non-increasing length."""
    import torch

    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops.paged_attention import _sm_count

    B, T = pos.shape
    sms = _sm_count(pos.device)
    split = fa.paged_splits_allowed(B, T, G, kv, S, sms)
    got = fa.paged_plan_cuda(seq, pos, S, G, kv, split)
    want = fa.paged_plan(seq, pos, S, G, kv, sms, split)
    nqb = want["nqb"]
    items = [((b * nqb + m) * kv + kh, k0, kend, slot)
             for b, m, kh, z, k0, kend, slot in want["items"]]
    assert got["hdr"][:5].tolist() == [len(items), want["C"], len(want["split_units"]), 0,
                                       want["thr"]], (label, got["hdr"].tolist())
    assert got["ulim"].tolist() == want["ulim"], label
    assert got["sbase"].tolist() == want["sbase"], label
    split = [(u, sum(1 for it in want["items"] if it[0] * nqb + it[1] == u) // kv,
              want["sbase"][u], 0) for u in want["split_units"]]
    assert [tuple(x) for x in got["split_units"].tolist()] == split, label
    recs = [tuple(x) for x in got["items"].tolist()]
    assert sorted(recs) == sorted(items), label
    order = [-(-(kend - k0) // fa.KEY_TILE) for _, k0, kend, _ in recs]
    assert order == sorted(order, reverse=True), label
    log(f"[kernel] flash_paged_plan {label}: {len(recs)} items (C = {want['C']} tiles, "
        f"{len(want['split_units'])} split units, {len(want['zero_units'])} zero units) "
        f"equal to the host model")


def _paged_page_fault(ref, q, kp, vp, table, seq, pos, page: int) -> None:
    """The rms-scaled bound sees a wrong page: the kernel's output passes
    it, the plain version over the same table with its ``page``-th page
    swapped for page 0 (random keys, in no row's table) fails it."""
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa

    bad = table.clone()
    bad[:, page] = 0
    uses = {"kernel": _bound_use(fa.flash_attention_paged(q, kp, vp, table, seq, pos), ref,
                                 ATTN_RTOL, ATTN_ATOL, ATTN_RMS_FRAC),
            f"page {page} swapped": _bound_use(
                fa.flash_attention_paged_plain(q, kp, vp, bad, seq, pos), ref, ATTN_RTOL,
                ATTN_ATOL, ATTN_RMS_FRAC)}
    log("[kernel] K2 paged bound over the long prompt, bound use: " +
        ", ".join(f"{k} {u:.3f}" for k, u in uses.items()))
    assert uses["kernel"] <= 1.0 < uses[f"page {page} swapped"], uses


def _check_windows(check, rnd, kp, vp, h, kv, widths, timed_w=None, library_kv=None):
    """B9 on a two-layer slot pool of SLOTS rows x CTX tokens: windows of
    each width in ``widths``, bases from LIMITS (limit 0: an inactive row,
    base -1; 4096: a window that ends at the last slot position), seq_lens
    covering each window; both layers, with v and with v = k. The layer-1
    call at width ``timed_w`` is timed, beside SDPA over layer 1's rows
    (``library_kv``) with each query's key mask."""
    import torch

    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev = kp.device
    kw = dict(n_rows=SLOTS, slot_ctx=CTX)
    for W in widths:
        base = torch.tensor([min(x, CTX - W + 1) - 1 for x in LIMITS], device=dev)
        seq = torch.where(base >= 0, base + W, 0)
        # query t of row b sees keys < min(max(seq, 1), max(base, 0) + 1 + t)
        lim = torch.minimum(seq.clamp(min=1)[:, None],
                            base.clamp(min=0)[:, None] + torch.arange(1, W + 1, device=dev))
        assert int((base < 0).sum()) >= 1 and int(lim[:, -1].max()) == CTX
        qw = rnd(SLOTS, W, h, D)
        # the context is read once per row, to its widest limit
        io = int(lim[:, -1].sum()) * kv * D * 2 * 2 + 2 * SLOTS * W * h * D * 2 + 2 * SLOTS * 8
        library = None
        if library_kv is not None and W == timed_w:
            mask = (torch.arange(CTX, device=dev)[None, None] < lim[:, :, None])[:, None]
            qt = qw.transpose(1, 2)
            library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, *library_kv, attn_mask=mask, enable_gqa=True)
        for layer in range(2):
            for v, tag in ((vp, ""), (None, " v=k")):
                check("slot_window_attention",
                      f"G={h // kv} B={SLOTS} W={W} layer={layer} ctx={CTX}{tag}",
                      lambda: sa.slot_window_attention(qw, kp, v, seq, base, layer, **kw),
                      lambda: sa.slot_window_attention_plain(qw, kp, v, seq, base, layer, **kw),
                      timed=W == timed_w and layer == 1 and v is not None, nbytes=io,
                      flop=4 * h * D * int(lim.sum()), library=library)


def _b7_faults(a, x, wo, ln, router) -> None:
    """B7's bound (BF16_RTOL / BF16_ATOL on x2, hn and the logits) sees a
    fault of its schedule: against the sound plain output of layer 0, a
    plain output with one ring stage (32 k rows) of one split wo tile left
    out, one with one router partial left out (a phase-2 warp's share of
    K: k-step pairs 1, 5, 9, ... of one block's 8 expert columns), and one
    with hn normalised by a sum of squares missing one tile each take more
    than the whole bound."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import matmul_f32
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    grid = pa._sm_count(a.device)
    E = x.shape[1]
    tiles, nk = fl.b7_tiles(E, a.shape[1])
    runs = fl.i8_partition(tiles, nk, grid)
    # a tile that more than one block streams, and a ring stage of it
    t = next(t for t in range(tiles) if sum(any(s[0] == t for s in r) for r in runs) > 1)
    ref = fl.fused_out_router_stacked_plain(a, x, wo, ln, router, 0)
    w = wo[:1].clone()
    w[0, 5 * fl._KT:6 * fl._KT, t * fl._TILE:(t + 1) * fl._TILE] = 0
    r = router[:1].clone()
    warp1 = (torch.arange(E, device=a.device) // 32) % 4 == 1   # warp 1's k rows
    r[0, warp1, fl.B7_BAND:2 * fl.B7_BAND] = 0                   # of expert columns 8 .. 15
    x2 = ref[0]
    ss = x2.float().square()
    ss[:, t * fl._TILE:(t + 1) * fl._TILE] = 0
    hn = ((x2.float() * torch.rsqrt(ss.sum(-1, keepdim=True) / E + 1e-6))
          * ln[0].float()).to(x2.dtype)
    faults = {f"stage 5 of wo tile {t} dropped": fl.fused_out_router_stacked_plain(
                  a, x, w, ln, router, 0),
              "router partial (warp 1 of expert columns 8 .. 15) dropped":
                  fl.fused_out_router_stacked_plain(a, x, wo, ln, r, 0),
              f"sum of squares of tile {t} dropped": (x2, hn, matmul_f32(hn, router[0]))}
    uses = {n: max(_bound_use(g, w_, BF16_RTOL, BF16_ATOL, math.inf) for g, w_ in zip(f, ref))
            for n, f in faults.items()}
    log("[kernel] fused_out_router_stacked B=16 faults, bound use: " +
        ", ".join(f"{n} {u:.2f}" for n, u in uses.items()))
    assert min(uses.values()) > 1.0, uses


def phase_moe_kernels(gen) -> dict:
    """B7 and both entries of the grouped expert kernels (decode and
    prefill) against their plain versions at qwen3-30b-a3b widths, and B3,
    K1 (B1) and K2 (B2) at its query group G = H/K = 8; returns per-kernel
    results (the B3, B1 and B2 errors at G = 8 under ``"g8"``)."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev, bf = torch.device("cuda"), torch.bfloat16
    res: dict = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def check(*a, **k):
        _check_kernel(res, *a, rtol=BF16_RTOL, atol=BF16_ATOL, **k)

    # B7: the 2-layer check stack of the contract, then an 8-layer stack
    # (138 MB, beyond the 50 MB L2) for the timing, walked layer by layer;
    # B = 1, 16, 64 (a verify step's rows) and 80 (two row groups, the last
    # ragged; all but B = 16 from a generator of their own, so that later
    # phases see the inputs they saw before); the same inputs twice give the
    # same bits
    aux = torch.Generator(device=dev).manual_seed(1)
    for L, timed in ((2, False), (8, True)):
        wo = rnd(L, M_H * D, M_E, scale=(M_H * D) ** -0.5)
        ln = rnd(L, M_E, scale=0.1) + 1
        router = rnd(L, M_E, M_NE, scale=M_E ** -0.5)
        for B in (1, SLOTS, 64, LANE_ROWS):
            g = gen if B == SLOTS else aux
            a = (torch.randn((B, M_H * D), generator=g, device=dev)).to(bf)
            x = (torch.randn((B, M_E), generator=g, device=dev)).to(bf)
            for layer in range(L):
                args = (a, x, wo, ln, router, layer)
                check("fused_out_router_stacked", f"B={B} layer={layer} L={L}",
                      lambda: fl.fused_out_router_stacked(*args),
                      lambda: fl.fused_out_router_stacked_plain(*args))
                once, twice = fl.fused_out_router_stacked(*args), fl.fused_out_router_stacked(*args)
                assert all(torch.equal(u, v) for u, v in zip(once, twice)), (
                    "fused_out_router_stacked: two calls on the same inputs differ", B, layer)
            if timed and B == SLOTS:
                _b7_faults(a, x, wo, ln, router)
            if timed:
                def walk(f):
                    return lambda: [f(a, x, wo, ln, router, layer) for layer in range(L)]

                t = time_ms(walk(fl.fused_out_router_stacked), calls=L)
                p = time_ms(walk(fl.fused_out_router_stacked_plain), calls=L)
                w7 = M_H * D * M_E + M_E * M_NE
                nb = 2 * (w7 + B * M_H * D + 3 * B * M_E + M_E) + 4 * B * M_NE
                bd = bound(nb, 2 * B * w7)
                if B == SLOTS:
                    res["fused_out_router_stacked"].update(
                        ms=t[0], plain_ms=p[0], shape=f"B={B} (8 layers walked)",
                        library_ms=None, **bd)
                if B == LANE_ROWS:   # two cooperative launches, one barrier count
                    PAST_64[f"fused_out_router_stacked {MOE_MODEL} B={B}"] = dict(
                        err=res["fused_out_router_stacked"]["err"], ms=t[0], plain_ms=p[0],
                        library_ms=None, **bd)
                log(f"[kernel] B7 fused_out_router_stacked B={B} | device kernel "
                    f"{t[0]:.4f} ms plain {p[0]:.4f} ms | eager "
                    f"kernel {t[1]:.4f} ms plain {p[1]:.4f} ms | bound {bd['bound_ms']:.4f} "
                    f"ms ({bd['bound_by']}) | {nb / t[0] / 1e6:.1f} GB/s")
        del wo, ln, router
    # B7 at widths beyond the served configs' that the fused layer's gate
    # (shapes_ok) takes: E not a multiple of 1024 with 512 experts (phase 2's
    # items outnumber the grid: blocks take several), E above one phase-2 K
    # chunk (two chunks), and a wo smaller than the grid (blocks with empty
    # shares, a tile spanning more blocks than one batch of slots); layer 1
    # of a 2-layer stack, from the generator of the new shapes
    for E7, HD7, NE7 in ((2560, 4096, 512), (5120, 1024, 128), (256, 256, 128)):
        wo = (torch.randn((2, HD7, E7), generator=aux, device=dev) * HD7 ** -0.5).to(bf)
        ln = (torch.randn((2, E7), generator=aux, device=dev) * 0.1 + 1).to(bf)
        router = (torch.randn((2, E7, NE7), generator=aux, device=dev) * E7 ** -0.5).to(bf)
        for B in (1, SLOTS, 64, 80):
            a = torch.randn((B, HD7), generator=aux, device=dev).to(bf)
            x = torch.randn((B, E7), generator=aux, device=dev).to(bf)
            args = (a, x, wo, ln, router, 1)
            check("fused_out_router_stacked", f"B={B} E={E7} H*D={HD7} NE={NE7} layer=1 L=2",
                  lambda: fl.fused_out_router_stacked(*args),
                  lambda: fl.fused_out_router_stacked_plain(*args))
            once, twice = fl.fused_out_router_stacked(*args), fl.fused_out_router_stacked(*args)
            assert all(torch.equal(u, v) for u, v in zip(once, twice)), (
                "fused_out_router_stacked: two calls on the same inputs differ", B, E7, NE7)
        del wo, ln, router

    # grouped expert FFN over the rows of one layer of a 2-layer expert stack
    # (layer 1: the layer offset); expert 7 gets no rows. The decode kernel
    # at 16 tokens and one token below the prefill kernel's crossover (which
    # the wrapper takes from static sizes), the prefill kernel at the
    # crossover, at 3072 (timed) and at 3072 skewed (expert 3 over 256
    # rows); the timed shapes beside torch._grouped_mm where this PyTorch
    # has it
    grouped_mm = getattr(torch, "_grouped_mm", None)
    log(f"[kernel] grouped expert yardstick: torch._grouped_mm "
        f"{'present' if grouped_mm else 'absent'} in torch {torch.__version__}")
    wgu = rnd(2, M_NE, M_E, 2 * M_F, scale=M_E ** -0.5)[1]
    wd = rnd(2, M_NE, M_F, M_E, scale=M_F ** -0.5)[1]
    cross = moe.PREFILL_ROWS_PER_EXPERT * M_NE // M_TOPK   # tokens at the crossover
    for T, tag in ((SLOTS, "decode"), (cross - 1, "below"), (cross, "above"),
                   (3072, "prefill"), (3072, "skewed")):
        logits = torch.randn((T, M_NE), generator=gen, device=dev) * 2
        logits[:, 7] = -1e30
        if tag == "skewed":
            logits[:, 3] += 4.0
        _, top_e = moe.route_topk(logits, M_TOPK)
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        offsets = moe.group_offsets(flat_e, M_NE)
        xs = rnd(T, M_E)[order // M_TOPK]
        sizes = offsets[1:] - offsets[:-1]
        assert int(sizes[7]) == 0, "expert 7 must be empty"
        rows = T * M_TOPK
        prefill = moe.grouped_prefill(rows, M_NE, M_E, M_F)
        assert prefill == (tag in ("above", "prefill", "skewed")), (tag, rows)
        if tag != "decode":   # ragged experts: rows not a multiple of 128
            assert bool((sizes % 128 != 0).any())
        if tag == "skewed":
            assert int(sizes[3]) > 256, int(sizes[3])
        touched = int((sizes > 0).sum())
        label = (f"T={T} x top-{M_TOPK} ({touched} experts, largest {int(sizes.max())} rows)"
                 f"{' skewed' if tag == 'skewed' else ''}")
        sfx = "_prefill" if prefill else ""
        timed = tag in ("decode", "prefill")
        h = moe.grouped_gateup_plain(xs, wgu, None, offsets)
        # the yardstick: torch._grouped_mm, the same ragged products in one
        # call (gate|up without the SwiGLU), where this PyTorch has it
        ends = offsets[1:]
        check("grouped_gateup" + sfx, label, lambda: moe.grouped_gateup(xs, wgu, None, offsets),
              lambda: moe.grouped_gateup_plain(xs, wgu, None, offsets), timed=timed,
              nbytes=2 * (touched * M_E * 2 * M_F + rows * (M_E + M_F)) + 4 * (M_NE + 1),
              flop=2 * rows * M_E * 2 * M_F, plain_graph=False,
              library=timed and grouped_mm and (lambda: grouped_mm(xs, wgu, offs=ends)) or None)
        check("grouped_down" + sfx, label, lambda: moe.grouped_down(h, wd, offsets),
              lambda: moe.grouped_down_plain(h, wd, offsets), timed=timed,
              nbytes=2 * (touched * M_F * M_E + rows * (M_F + M_E)) + 4 * (M_NE + 1),
              flop=2 * rows * M_F * M_E, plain_graph=False,
              library=timed and grouped_mm and (lambda: grouped_mm(h, wd, offs=ends)) or None)
        if timed:   # gate and up unpacked, as MLA's experts are
            wg, wu = wgu[..., :M_F].contiguous(), wgu[..., M_F:].contiguous()
            check("grouped_gateup" + sfx, label + " unpacked",
                  lambda: moe.grouped_gateup(xs, wg, wu, offsets),
                  lambda: moe.grouped_gateup_plain(xs, wg, wu, offsets))
            del wg, wu
    del wgu, wd

    # B3 at G = 8: E = 2048, 32 q and 4 kv heads ((H + 2K)·D = 5120 columns,
    # another split-K choice, per-head norm and rope over 4 kv heads), every
    # layer of a 4-layer stack, at B = 1 and the decode batch
    scratch: dict = {}
    L = 4
    ln = rnd(L, M_E, scale=0.1) + 1
    qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
    wqkv = rnd(L, M_E, (M_H + 2 * M_KV) * D, scale=M_E ** -0.5)
    kw3 = dict(n_heads=M_H, n_kv=M_KV, head_dim=D, eps=1e-6)
    for B in (1, SLOTS):
        x = rnd(B, M_E)
        cos, sin = rope_angles(torch.randint(0, 4000, (B,), generator=gen, device=dev),
                               D, 1_000_000.0)
        for layer in range(L):
            args3 = (x, ln, wqkv, qn, kn, cos, sin, layer)
            _check_kernel(scratch, "fused_qkv_stacked", f"G=8 B={B} layer={layer} L={L}",
                          lambda: fl.fused_qkv_stacked(*args3, **kw3),
                          lambda: fl.fused_qkv_stacked_plain(*args3, **kw3),
                          rtol=BF16_RTOL, atol=BF16_ATOL)
    del ln, qn, kn, wqkv

    # K1 (B1) and K2 (B2) at G = 8
    L = 2
    kp, vp = rnd(L * SLOTS, CTX, M_KV, D), rnd(L * SLOTS, CTX, M_KV, D)
    q = rnd(SLOTS, M_H, D)
    lim = torch.tensor(LIMITS, device=dev)
    kw = dict(n_rows=SLOTS, slot_ctx=CTX)
    for layer in range(L):
        keys = sum(max(x, 1) for x in LIMITS)
        _check_kernel(scratch, "slot_attention", f"G=8 B={SLOTS} layer={layer} ctx={CTX}",
                      lambda: sa.slot_attention(q, kp, vp, lim, layer, **kw),
                      lambda: sa.slot_attention_plain(q, kp, vp, lim, layer, **kw),
                      rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC,
                      timed=layer == 1,
                      nbytes=keys * M_KV * D * 4 + 4 * SLOTS * M_H * D + 8 * SLOTS,
                      flop=4 * M_H * D * keys)
    # B9 at G = 8: W = 16 holds 128 query rows a block, two K1 launches
    _check_windows(lambda *a, **k: _check_kernel(
        scratch, *a, rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, **k),
        rnd, kp, vp, M_H, M_KV, (4, 8, 16))
    del kp, vp
    for B, T in ((4, 512), (1, 3030), (2, 3030), (1, 3072)):
        qf, kf, vf = rnd(B, T, M_H, D), rnd(B, T, M_KV, D), rnd(B, T, M_KV, D)
        _check_kernel(scratch, "flash_attention", f"G=8 B={B} T={T}",
                      lambda: fa.flash_attention(qf, kf, vf),
                      lambda: fa.flash_attention_plain(qf, kf, vf),
                      rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC,
                      timed=T == 3072,
                      flop=4 * B * M_H * D * T * (T + 1) // 2,
                      nbytes=2 * B * T * D * (2 * M_H + 2 * M_KV))
    res["g8"] = scratch
    return res


def _int8pack(x, w_t, scales):
    """One PyTorch call that computes B10's bare product, the yardstick of
    ``int8_product``: ``torch._weight_int8pack_mm`` with the [N, K] int8
    weight and the scales rounded to x's dtype (its only difference), or
    None where this PyTorch has no CUDA kernel for it."""
    import torch

    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None
    try:
        fn(x, w_t, scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"[kernel] torch._weight_int8pack_mm: no CUDA kernel here ({str(e)[:120]})")
        return None
    return lambda: fn(x, w_t, scales)


def _i8_fault_uses(tag: str, ref, faults: dict) -> None:
    """B10's bound sees a scheduling fault: each faulted plain output (one
    ring stage of a product's K left out, or one column tile left out)
    against the sound plain output ``ref`` takes more than its whole bound
    (BF16_RTOL / BF16_ATOL)."""
    uses = {name: _bound_use(got, ref, BF16_RTOL, BF16_ATOL, math.inf)
            for name, got in faults.items()}
    log(f"[kernel] {tag} faults, bound use: " +
        ", ".join(f"{n} {u:.2f}" for n, u in uses.items()))
    assert min(uses.values()) > 1.0, (tag, uses)


def _i8_past_64(res, gen, L, norms, wqkv, wo, gu, wd, kw, drop) -> None:
    """B10's two entries at qwen3-32b widths past 64 rows (C4): 65 (a lane
    step's lm_head rows), 80 (a lane step at 64 slots) and 128 rows, one
    launch a 64-row group; every layer of the stack checked, the layers
    walked for the time, each with its bound; at 80 rows a plain output
    with one ring stage of wqkv or wd left out must fail the bound."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    dev, bf = torch.device("cuda"), torch.bfloat16
    ln1, ln2, qn, kn = norms
    (wq, ws), (woq, wos), (guq, gus), (wdq, wds) = wqkv, wo, gu, wd
    e, C, hd, f = wq.shape[1], wq.shape[2], woq.shape[1], wdq.shape[1]
    for B in (65, LANE_ROWS, 128):
        x = torch.randn((B, e), generator=gen, device=dev).to(bf)
        a = torch.randn((B, hd), generator=gen, device=dev).to(bf)
        cos, sin = rope_angles(torch.randint(0, 4000, (B,), generator=gen, device=dev),
                               D, 1_000_000.0)
        args_q = (x, ln1, wq, ws, qn, kn, cos, sin)
        args_o = (a, x, woq, wos, ln2, guq, gus, wdq, wds)
        sub: dict = {}
        for layer in range(L):
            label = f"{I8_MODEL} B={B} layer={layer}"
            _check_kernel(sub, "fused_qkv_stacked_i8", label,
                          lambda: fl.fused_qkv_stacked_i8(*args_q, layer, **kw),
                          lambda: fl.fused_qkv_stacked_i8_plain(*args_q, layer, **kw),
                          rtol=BF16_RTOL, atol=BF16_ATOL)
            _check_kernel(sub, "fused_out_mlp_stacked_i8", label,
                          lambda: fl.fused_out_mlp_stacked_i8(*args_o, layer, eps=1e-6),
                          lambda: fl.fused_out_mlp_stacked_i8_plain(*args_o, layer, eps=1e-6),
                          rtol=BF16_RTOL, atol=BF16_ATOL,
                          slack=_x2_ulp(a, x, woq[layer], wos[layer]))
        if B == LANE_ROWS:
            ref = torch.cat(fl.fused_qkv_stacked_i8_plain(*args_q, 0, **kw), 1)
            wf = drop(wq[0], stage=17)[None]
            _i8_fault_uses(f"fused_qkv_stacked_i8 B={B}", ref, {
                "stage 17 of wqkv dropped": torch.cat(fl.fused_qkv_stacked_i8_plain(
                    x, ln1, wf, ws, qn, kn, cos, sin, 0, **kw), 1)})
            ref = fl.fused_out_mlp_stacked_i8_plain(*args_o, 0, eps=1e-6)
            wf = drop(wdq[0], stage=201)[None]
            _i8_fault_uses(f"fused_out_mlp_stacked_i8 B={B}", ref, {
                "stage 201 of wd dropped": fl.fused_out_mlp_stacked_i8_plain(
                    a, x, woq, wos, ln2, guq, gus, wf, wds, 0, eps=1e-6)})
            del ref, wf
        w_o = hd * e + 3 * e * f
        for name, fk, fp, args, k, nbytes, flop in (
                ("fused_qkv_stacked_i8", fl.fused_qkv_stacked_i8,
                 fl.fused_qkv_stacked_i8_plain, args_q, kw,
                 e * C + 4 * C + 2 * (B * e + e + 2 * D + B * C) + 4 * B * D, 2 * B * e * C),
                ("fused_out_mlp_stacked_i8", fl.fused_out_mlp_stacked_i8,
                 fl.fused_out_mlp_stacked_i8_plain, args_o, {"eps": 1e-6},
                 w_o + 4 * (2 * e + 2 * f) + 2 * (B * hd + 2 * B * e + e), 2 * B * w_o)):
            t = time_ms(lambda: [fk(*args, layer, **k) for layer in range(L)], calls=L)
            p = time_ms(lambda: [fp(*args, layer, **k) for layer in range(L)], calls=L)
            bd = bound(nbytes, flop)
            PAST_64[f"{name} {I8_MODEL} B={B}"] = dict(err=sub[name]["err"], ms=t[0],
                                                       plain_ms=p[0], library_ms=None, **bd)
            res[name]["err"] = max(res[name]["err"], sub[name]["err"])
            log(f"[kernel] {name:26s} {I8_MODEL} B={B} ({len(fl.i8_row_groups(B))} launches) | "
                f"device kernel {t[0]:.4f} ms plain {p[0]:.4f} ms | eager kernel {t[1]:.4f} "
                f"ms plain {p[1]:.4f} ms | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) | "
                f"{nbytes / t[0] / 1e6:.1f} GB/s")


def phase_int8_kernels(gen) -> dict:
    """B10's two entries and its bare int8 product, and B12, against their
    plain versions (B10 at qwen3-32b and qwen3-8b widths, B = 1, 16 and 64,
    every layer of a four-layer stack; the product at qwen3-32b's lm_head
    shape (a half-filled last 256-column tile), at each qwen3-32b layer shape
    and at qwen3-8b's down projection and a ragged [5120, 51328] at 1, 16,
    32, 48 and 64 rows; B12 at the five qwen3-32b shapes, stochastic at
    [5120, 51200], and on its element-load, fp16, float32 and unaligned-q
    paths); a plain
    output with one ring stage of K or one column tile left out must fail
    each B10 check at B = 1 and 16. Returns per-kernel results, timed at
    qwen3-32b widths and the decode batch, ``int8_product`` beside
    ``torch._weight_int8pack_mm``."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import quant

    dev, bf = torch.device("cuda"), torch.bfloat16
    res: dict = {}
    gen_rows = torch.Generator(device=dev).manual_seed(17)   # the past-64 rows' inputs

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def i8(L, K, N):
        """An int8 stack whose dequantized values have std ~K^-1/2, and its
        [L,1,N] column scales (q uniform in [-127, 127]: std ~73)."""
        q = torch.randint(-127, 128, (L, K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (0.5 + torch.rand((L, 1, N), generator=gen, device=dev)) / (73 * K ** 0.5)
        return q, s

    def check(*a, **k):
        _check_kernel(res, *a, rtol=BF16_RTOL, atol=BF16_ATOL, **k)

    def drop(w, stage=None, tile=None):
        """w [K,N] with one ring stage of rows (its tile width's k rows) or
        one column tile zeroed: what a schedule that skipped it would sum."""
        w = w.clone()
        tw = fl.i8_tile_cols(w.shape[1])
        if stage is not None:
            rows = 8192 // tw
            w[stage * rows:(stage + 1) * rows] = 0
        if tile is not None:
            w[:, tile * tw:(tile + 1) * tw] = 0
        return w

    # a four-layer stack walked layer by layer, each call reading its
    # weights cold (487 MB of int8 a layer at qwen3-32b, beyond the 50 MB L2)
    L = 4
    for model, (e, h, kv, f) in ((I8_MODEL, (Q_E, Q_H, Q_KV, Q_F)),
                                 ("qwen3-8b", (E, H, KV, FF))):
        C = (h + 2 * kv) * D
        ln1, ln2 = rnd(L, e, scale=0.1) + 1, rnd(L, e, scale=0.1) + 1
        qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
        wq, ws = i8(L, e, C)
        woq, wos = i8(L, h * D, e)
        guq, gus = i8(L, e, 2 * f)
        wdq, wds = i8(L, f, e)
        kw = dict(n_heads=h, n_kv=kv, head_dim=D, eps=1e-6)
        for B in (1, SLOTS, SLOTS * WIN):
            x, a = rnd(B, e), rnd(B, h * D)
            cos, sin = rope_angles(torch.randint(0, 4000, (B,), generator=gen, device=dev),
                                   D, 1_000_000.0)
            args_q = (x, ln1, wq, ws, qn, kn, cos, sin)
            args_o = (a, x, woq, wos, ln2, guq, gus, wdq, wds)
            for layer in range(L):
                label = f"{model} B={B} layer={layer}"
                check("fused_qkv_stacked_i8", label,
                      lambda: fl.fused_qkv_stacked_i8(*args_q, layer, **kw),
                      lambda: fl.fused_qkv_stacked_i8_plain(*args_q, layer, **kw))
                # the new 64-row check also allows one bf16 ulp of x2 (see
                # _x2_ulp); the 1- and 16-row checks keep the plain bound
                check("fused_out_mlp_stacked_i8", label,
                      lambda: fl.fused_out_mlp_stacked_i8(*args_o, layer, eps=1e-6),
                      lambda: fl.fused_out_mlp_stacked_i8_plain(*args_o, layer, eps=1e-6),
                      slack=(_x2_ulp(a, x, woq[layer], wos[layer]) if B == SLOTS * WIN
                             else None))
            if model == I8_MODEL and B in (1, SLOTS):
                # faults of the schedule: a product of layer 0 with one ring
                # stage left out (64 rows of wqkv's 5120, of wd's 25600),
                # and one column tile of it left out
                ref = torch.cat(fl.fused_qkv_stacked_i8_plain(*args_q, 0, **kw), 1)
                faults = {}
                for name, kw_drop in (("stage 17 of wqkv dropped", {"stage": 17}),
                                      ("tile 5 of wqkv dropped", {"tile": 5})):
                    wf = drop(wq[0], **kw_drop)[None]
                    faults[name] = torch.cat(fl.fused_qkv_stacked_i8_plain(
                        x, ln1, wf, ws, qn, kn, cos, sin, 0, **kw), 1)
                _i8_fault_uses(f"fused_qkv_stacked_i8 B={B}", ref, faults)
                ref = fl.fused_out_mlp_stacked_i8_plain(*args_o, 0, eps=1e-6)
                faults = {}
                for name, kw_drop in (("stage 201 of wd dropped", {"stage": 201}),
                                      ("tile 7 of wd dropped", {"tile": 7})):
                    wf = drop(wdq[0], **kw_drop)[None]
                    faults[name] = fl.fused_out_mlp_stacked_i8_plain(
                        a, x, woq, wos, ln2, guq, gus, wf, wds, 0, eps=1e-6)
                _i8_fault_uses(f"fused_out_mlp_stacked_i8 B={B}", ref, faults)
                del ref, faults, wf

            def walk(f, args, **k):
                return lambda: [f(*args, layer, **k) for layer in range(L)]

            wo_ = h * D * e + 3 * e * f
            for name, fk, fp, args, k, nbytes, flop in (
                    ("fused_qkv_stacked_i8", fl.fused_qkv_stacked_i8,
                     fl.fused_qkv_stacked_i8_plain, args_q, kw,
                     e * C + 4 * C + 2 * (B * e + e + 2 * D + B * C) + 4 * B * D,
                     2 * B * e * C),
                    ("fused_out_mlp_stacked_i8", fl.fused_out_mlp_stacked_i8,
                     fl.fused_out_mlp_stacked_i8_plain, args_o, {"eps": 1e-6},
                     wo_ + 4 * (2 * e + 2 * f) + 2 * (B * h * D + 2 * B * e + e),
                     2 * B * wo_)):
                t = time_ms(walk(fk, args, **k), calls=L)
                p = time_ms(walk(fp, args, **k), calls=L)
                bd = bound(nbytes, flop)
                if model == I8_MODEL and B == SLOTS:   # the int8 serve phase's shape
                    res[name].update(ms=t[0], plain_ms=p[0], library_ms=None, **bd,
                                     shape=f"{model} B={B} ({L} layers walked)")
                log(f"[kernel] {name:26s} {model} B={B} | device kernel {t[0]:.4f} ms "
                    f"plain {p[0]:.4f} ms | eager kernel {t[1]:.4f} ms plain {p[1]:.4f} "
                    f"ms | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) | "
                    f"{nbytes / t[0] / 1e6:.1f} GB/s")
            if model == I8_MODEL and B == SLOTS:
                # for information: torch._weight_int8pack_mm on B10-out's three
                # products, layer by layer (three calls and no epilogues: not
                # one call computing the function, so no library_ms)
                pk = [(w[l].t().contiguous(), s[l, 0].to(bf)) for l in range(L)
                      for w, s in ((woq, wos), (guq, gus), (wdq, wds))]
                xs = (a, rnd(B, e), rnd(B, f))
                if _int8pack(a, *pk[0]) is not None:
                    lib3 = time_ms(lambda: [torch._weight_int8pack_mm(xs[i % 3], *pk[i])
                                            for i in range(3 * L)], calls=L)[0]
                    log(f"[kernel] fused_out_mlp_stacked_i8 {model} B={B}: three "
                        f"torch._weight_int8pack_mm calls a layer {lib3:.4f} ms")
                del pk
        if model == I8_MODEL:
            _i8_past_64(res, gen_rows, L, (ln1, ln2, qn, kn), (wq, ws), (woq, wos),
                        (guq, gus), (wdq, wds), kw, drop)
        del wq, ws, woq, wos, guq, gus, wdq, wds

    # the bare int8 product at the lm_head shape (778 MB of int8; 593.5
    # 256-column tiles: the last half full), beside one library call
    V32 = V
    hq, hs = i8(1, Q_E, V32)
    hq, hs = hq[0], hs[0]
    lib = None
    for B in (1, SLOTS):
        x = rnd(B, Q_E)
        if B == SLOTS:
            lib = _int8pack(x, hq.t().contiguous(), hs[0].to(bf))
        check("int8_product", f"lm_head B={B} [{Q_E}, {V32}]",
              lambda: fl.int8_product(x, hq, hs), lambda: fl.int8_product_plain(x, hq, hs),
              timed=B == SLOTS, nbytes=Q_E * V32 + 4 * V32 + 2 * B * (Q_E + V32),
              flop=2 * B * Q_E * V32, library=lib)
        ref = fl.int8_product_plain(x, hq, hs)
        _i8_fault_uses(f"int8_product lm_head B={B}", ref, {
            "stage 77 dropped": fl.int8_product_plain(x, drop(hq, stage=77), hs),
            "tile 300 dropped": fl.int8_product_plain(x, drop(hq, tile=300), hs)})
    if lib is None:
        log("[kernel] int8_product: torch._weight_int8pack_mm has no CUDA kernel here")
    # the lm_head of a lane step at 64 slots: 64 decode rows and the lane's
    # row, two launches (64 + 1 rows)
    B = 64 + 1
    x = torch.randn((B, Q_E), generator=gen_rows, device=dev).to(bf)
    lib = _int8pack(x, hq.t().contiguous(), hs[0].to(bf))
    sub: dict = {}
    _check_kernel(sub, "int8_product", f"lm_head B={B} [{Q_E}, {V32}]",
                  lambda: fl.int8_product(x, hq, hs), lambda: fl.int8_product_plain(x, hq, hs),
                  rtol=BF16_RTOL, atol=BF16_ATOL, timed=True,
                  nbytes=Q_E * V32 + 4 * V32 + 2 * B * (Q_E + V32), flop=2 * B * Q_E * V32,
                  library=lib)
    PAST_64[f"int8_product lm_head B={B}"] = sub["int8_product"]
    res["int8_product"]["err"] = max(res["int8_product"]["err"], sub["int8_product"]["err"])
    del hq, hs, lib

    # the bare product as int8_matmul runs it in a prefill of up to 64 rows,
    # on each qwen3-32b layer shape (B = 16 beside torch._weight_int8pack_mm,
    # for information), qwen3-8b's down projection and [5120, 51328] (200.5
    # 256-column tiles: a half-filled last one): 17-32 rows take the
    # kernel's MT=2 instance, 33-64 its MT=4 one (48: a partly filled last
    # m-tile)
    for wname, (K8, N8) in (("wqkv", (Q_E, (Q_H + 2 * Q_KV) * D)), ("wo", (Q_H * D, Q_E)),
                            ("w_gateup", (Q_E, 2 * Q_F)), ("w_down", (Q_F, Q_E)),
                            ("qwen3-8b w_down", (FF, E)), ("ragged", (Q_E, 51328))):
        wq8, ws8 = i8(1, K8, N8)
        wq8, ws8 = wq8[0], ws8[0]
        for B in (1, 16, 32, 48, 64):
            x = rnd(B, K8)
            check("int8_product", f"{wname} B={B} [{K8}, {N8}]",
                  lambda: fl.int8_product(x, wq8, ws8),
                  lambda: fl.int8_product_plain(x, wq8, ws8))
            if B == SLOTS and not wname.startswith(("qwen3-8b", "ragged")):
                t = time_ms(lambda: fl.int8_product(x, wq8, ws8), iters=20)[0]
                lb = _int8pack(x, wq8.t().contiguous(), ws8[0].to(bf))
                tl = time_ms(lb, iters=20)[0] if lb is not None else None
                log(f"[kernel] int8_product {wname} B={B} [{K8}, {N8}] | device kernel "
                    f"{t:.4f} ms | bound {K8 * N8 / HBM_BYTES_S * 1e3:.4f} ms (bytes) | "
                    f"torch._weight_int8pack_mm "
                    f"{'none' if tl is None else f'{tl:.4f} ms'}")
        del wq8, ws8

    # B12 at the five qwen3-32b shapes a build quantizes: round to nearest
    # bit-equal, timed, each with its bound (the row keeps w_gateup's); a
    # plain version whose amax left out one cluster block's rows (its
    # partial amax dropped in the merge) must differ from the kernel's
    # scales. The matrices draw from a generator of their own, except
    # w_gateup, which draws from gen as before
    aux = torch.Generator(device=dev).manual_seed(5)
    res["b12_shapes"] = {}
    for wname, (K12, N12) in B12_SHAPES.items():
        w = (torch.randn((K12, N12), generator=gen if wname == "w_gateup" else aux, device=dev)
             * K12 ** -0.5).to(bf)
        sub: dict = {}
        _check_kernel(sub, "quantize_int8", f"{wname} [{K12}, {N12}] bf16, round to nearest",
                      lambda: quant.quantize_int8(w), lambda: quant.quantize_int8_plain(w),
                      rtol=BF16_RTOL, atol=BF16_ATOL, timed=True, exact=True,
                      nbytes=3 * K12 * N12 + 4 * N12,
                      flop=6 * K12 * N12, rate=F32_FLOP_S)
        plan = quant.quant_plan(K12, N12)
        q_k, s_k = quant.quantize_int8(w)
        xa = w.float().abs()
        r0, r1 = plan.rows, min(K12, 2 * plan.rows)   # cluster block 1's rows
        amax = torch.maximum(xa[:r0].amax(0, keepdim=True), xa[r1:].amax(0, keepdim=True)
                             if r1 < K12 else torch.zeros_like(xa[:1]))
        s_f = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
        q_f, _ = quant.quantize_int8_plain(w, scale=s_f)
        torch.cuda.synchronize()
        bad_s, bad_q = int((s_f != s_k).sum()), int((q_f != q_k).sum())
        assert plan.cs == 1 or (bad_s > 0 and bad_q > 0), (wname, "a dropped amax passed", plan)
        sub["quantize_int8"].update(plan=plan._asdict())
        res["b12_shapes"][wname] = sub["quantize_int8"]
        log(f"[kernel] quantize_int8 {wname}: plan {plan._asdict()}; block 1's amax "
            f"dropped: {bad_s} of {N12} scales and {bad_q} of q differ")
        if wname == "w_gateup":
            res["quantize_int8"] = dict(sub["quantize_int8"])
            w_gu = w
        del w, xa, q_k, s_k, q_f, s_f, amax
    w, (K12, N12) = w_gu, B12_SHAPES["w_gateup"]
    del w_gu
    res["quantize_int8"]["err"] = max(v["err"] for v in res["b12_shapes"].values())
    # stochastic rounding: the round-to-nearest scales, q in {floor(x/s),
    # floor(x/s) + 1} (clipped), unbiased, one stream per seed, and the
    # plain version's Philox stream to the bit
    q_rn, s_rn = quant.quantize_int8(w)
    q1, s1 = quant.quantize_int8(w, seed=1, stochastic=True)
    q1b, _ = quant.quantize_int8(w, seed=1, stochastic=True)
    q2, _ = quant.quantize_int8(w, seed=2, stochastic=True)
    torch.cuda.synchronize()
    assert torch.equal(s1, s_rn), "stochastic scales differ from round-to-nearest's"
    assert torch.equal(q1, quant.quantize_int8_plain(w, seed=1, stochastic=True)[0]), (
        "stochastic q differs from the plain Philox model's")
    y = w.float() / s1
    lo = torch.floor(y).clamp(-127, 127)
    d = q1.float() - lo
    assert bool(((d == 0) | (d == 1)).all()), "stochastic q outside {floor, floor + 1}"
    mean_err = float((q1.float() - y).mean())
    mean_up = float(d.mean() - (y - torch.floor(y)).mean())
    assert abs(mean_err) < STOCH_MEAN_BOUND and abs(mean_up) < STOCH_MEAN_BOUND, (
        mean_err, mean_up)
    assert torch.equal(q1, q1b), "the same seed gave another q"
    changed = float((q1 != q2).float().mean())
    assert changed > 0.1, f"another seed changed only {changed:.4f} of q"
    log(f"[kernel] quantize_int8 stochastic [{K12}, {N12}]: scales equal round to "
        f"nearest's; q equal to the plain Philox model's and in {{floor, floor + 1}}; "
        f"mean(q - x/s) {mean_err:.2e}, "
        f"mean(q - floor) - mean(frac) {mean_up:.2e} (bound {STOCH_MEAN_BOUND}); "
        f"seed 1 twice equal; seed 2 differs on {changed:.3f} of q; "
        f"{float((q1 != q_rn).float().mean()):.3f} of q differ from round to nearest")
    del w, y, lo, d, q_rn, q1, q1b, q2
    # B12's other paths, bit for bit: rows whose stride is no multiple of 16
    # bytes (the threads' element loads instead of TMA; a cluster of 4 at
    # [3000, 1030], stochastic too), fp16 and float32 weights, and a q that
    # is not 8-byte aligned (byte stores instead of 8-byte ones)
    edge: dict = {}
    for K12, N12, dt, stoch, offset in ((7, 130, bf, False, 0), (3000, 1030, bf, False, 0),
                                        (3000, 1030, bf, True, 0),
                                        (4096, 6144, torch.float16, False, 0),
                                        (2048, 5120, torch.float32, False, 0),
                                        (1000, 77, torch.float32, False, 0),
                                        (5120, 1024, bf, False, 1)):
        w = (torch.randn((K12, N12), generator=aux, device=dev) * K12 ** -0.5).to(dt)
        buf = torch.empty(K12 * N12 + offset, dtype=torch.int8, device=dev)
        out = (buf[offset:].view(K12, N12), torch.empty((1, N12), device=dev))
        _check_kernel(edge, "quantize_int8", f"[{K12}, {N12}] {str(dt).split('.')[-1]}"
                      f"{', stochastic' if stoch else ''}{', q offset 1 B' if offset else ''}",
                      lambda: quant.quantize_int8(w, seed=3, stochastic=stoch, out=out),
                      lambda: quant.quantize_int8_plain(w, seed=3, stochastic=stoch),
                      rtol=BF16_RTOL, atol=BF16_ATOL, exact=True)
    res["quantize_int8"]["err"] = max(res["quantize_int8"]["err"], edge["quantize_int8"]["err"])
    del w, buf, out
    _free()   # the B12 checks' ~20 GB of temporaries go back before the MLA phase
    return res


def phase_moe_i8_kernels() -> tuple[dict, dict]:
    """Both entries of the int8 grouped expert kernel (``grouped_gateup_i8``,
    ``grouped_down_i8``: ``csrc/moe_i8.cu``) against their plain versions at
    qwen3-30b-a3b widths, on layer 1 of a two-layer expert stack quantized
    by B12 (the layer offset): 16 tokens x top-8 with expert 7 empty and
    expert 3 past its capacity (10 rows, cap 8: the last two rows must come
    out 0), 64 tokens (the decode form) and 3072 tokens (the prefill form,
    ``prefill_launches`` counting it), then 3072 tokens skewed (expert 5
    over 256 rows and past its capacity of 384); gate|up packed, and
    unpacked at 16 and 3072 tokens (MLA's layout); two calls bit-equal;
    rows past the capacity 0; at 3072 a plain version without one 64-row k
    stage of the largest expert's gate|up must fail the bound, and the
    parent's form (the decode kernel, which took every row count before
    the prefill form) is timed beside. Each timed beside the bf16 grouped
    expert kernel on the same routing (the bf16 weights before
    quantization) and, for information, ``torch._grouped_mm`` in bf16: no
    PyTorch call takes int8 weights with per-column scales, so
    ``library_ms`` is null. Its own generator (the skewed routing another):
    the other phases see the inputs they saw before. Returns the
    kernel-line results (16 tokens; ``*_prefill``: 3072 tokens) and every
    shape's numbers."""
    import torch

    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import quant

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(15)
    res: dict = {}
    shapes: dict = {}
    # bf16 [2, NE, E, 2F] / [2, NE, F, E] stacks, quantized one expert
    # matrix at a time (B12); the kernels read layer 1
    wgu_bf = (torch.randn((2, M_NE, M_E, 2 * M_F), generator=gen, device=dev)
              * M_E ** -0.5).to(bf)
    wd_bf = (torch.randn((2, M_NE, M_F, M_E), generator=gen, device=dev) * M_F ** -0.5).to(bf)
    gu_all, wd_all = quant.quantize_stack(wgu_bf), quant.quantize_stack(wd_bf)
    gu = {k: v[1] for k, v in gu_all.items()}
    wd = {k: v[1] for k, v in wd_all.items()}
    wgu_bf, wd_bf = wgu_bf[1], wd_bf[1]
    grouped_mm = getattr(torch, "_grouped_mm", None)
    for T in (SLOTS, 64, 3072):
        logits = torch.randn((T, M_NE), generator=gen, device=dev) * 2
        if T == SLOTS:
            logits[:, 7] = -1e30          # an empty expert
            logits[:10, 3] += 30.0        # 10 of 16 tokens: past the capacity of 8
        _, top_e = moe.route_topk(logits, M_TOPK)
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        offsets = moe.group_offsets(flat_e, M_NE)
        xs = (torch.randn((T, M_E), generator=gen, device=dev)).to(bf)[order // M_TOPK]
        S = T * M_TOPK
        cap = moe.expert_capacity(S, M_NE)
        sizes = (offsets[1:] - offsets[:-1]).long()
        kept = int(sizes.clamp(max=cap).sum())
        touched = int((sizes > 0).sum())
        if T == SLOTS:
            assert int(sizes[7]) == 0 and int(sizes[3]) == 10 and cap == 8, (sizes, cap)
        eid = torch.repeat_interleave(torch.arange(M_NE, device=dev), sizes)
        dropped = (torch.arange(S, device=dev) - offsets[eid].long()) >= cap
        label = (f"T={T} x top-{M_TOPK} ({touched} experts, largest {int(sizes.max())} rows, "
                 f"cap {cap}, {int(dropped.sum())} dropped)")
        into = res if T == SLOTS else {}
        prefill = moe.grouped_prefill(S, M_NE, M_E, M_F)
        assert prefill == (T == 3072), (T, prefill)
        n_pre = moe.grouped_gateup_i8.prefill_launches + moe.grouped_down_i8.prefill_launches
        h = moe.grouped_gateup_i8_plain(xs, gu, None, offsets, cap)
        nb_gu = (touched * (M_E * 2 * M_F + 4 * 2 * M_F) + 2 * kept * M_E + 2 * S * M_F
                 + 4 * (M_NE + 1))
        nb_dn = (touched * (M_F * M_E + 4 * M_E) + 2 * kept * M_F + 2 * S * M_E
                 + 4 * (M_NE + 1))
        _check_kernel(into, "grouped_gateup_i8", label,
                      lambda: moe.grouped_gateup_i8(xs, gu, None, offsets, cap),
                      lambda: moe.grouped_gateup_i8_plain(xs, gu, None, offsets, cap),
                      rtol=BF16_RTOL, atol=BF16_ATOL, timed=True, nbytes=nb_gu,
                      flop=2 * kept * M_E * 2 * M_F, plain_graph=False)
        _check_kernel(into, "grouped_down_i8", label,
                      lambda: moe.grouped_down_i8(h, wd, offsets, cap),
                      lambda: moe.grouped_down_i8_plain(h, wd, offsets, cap),
                      rtol=BF16_RTOL, atol=BF16_ATOL, timed=True, nbytes=nb_dn,
                      flop=2 * kept * M_F * M_E, plain_graph=False)
        got_h = moe.grouped_gateup_i8(xs, gu, None, offsets, cap)
        got_y = moe.grouped_down_i8(h, wd, offsets, cap)
        assert torch.equal(got_h, moe.grouped_gateup_i8(xs, gu, None, offsets, cap))
        assert torch.equal(got_y, moe.grouped_down_i8(h, wd, offsets, cap))
        assert not bool(got_h[dropped].any()) and not bool(got_y[dropped].any()), \
            "rows past the capacity must be 0"
        ran = (moe.grouped_gateup_i8.prefill_launches + moe.grouped_down_i8.prefill_launches
               - n_pre)
        assert (ran > 0) == prefill, ("the prefill form's launches", T, ran)
        if prefill:
            _i8_prefill_extra(res, into, label, xs, h, gu, wd, offsets, cap, sizes)
        if T in (SLOTS, 3072):   # gate and up unpacked, as MLA's experts are
            wg = {k: v[..., :v.shape[-1] // 2].contiguous() for k, v in gu.items()}
            wu = {k: v[..., v.shape[-1] // 2:].contiguous() for k, v in gu.items()}
            _check_kernel(into, "grouped_gateup_i8", label + " unpacked",
                          lambda: moe.grouped_gateup_i8(xs, wg, wu, offsets, cap),
                          lambda: moe.grouped_gateup_i8_plain(xs, wg, wu, offsets, cap),
                          rtol=BF16_RTOL, atol=BF16_ATOL)
            del wg, wu
        # the bf16 grouped expert kernel (decode or prefill, as its wrapper
        # chooses) and torch._grouped_mm on the same routing, for comparison
        hb = moe.grouped_gateup(xs, wgu_bf, None, offsets)
        ends = offsets[1:]
        bf16_ms = (time_ms(lambda: moe.grouped_gateup(xs, wgu_bf, None, offsets), iters=20)[0],
                   time_ms(lambda: moe.grouped_down(hb, wd_bf, offsets), iters=20)[0])
        lib_ms = ((time_ms(lambda: grouped_mm(xs, wgu_bf, offs=ends), iters=20)[0],
                   time_ms(lambda: grouped_mm(hb, wd_bf, offs=ends), iters=20)[0])
                  if grouped_mm else (None, None))
        for i, name in enumerate(("grouped_gateup_i8", "grouped_down_i8")):
            r = into[name]
            shapes[f"{name} T={T}"] = {**{k: r[k] for k in ("err", "ms", "plain_ms",
                                                             "bound_ms", "bound_by")},
                                       "parent_ms": r.get("parent_ms"),
                                       "bf16_kernel_ms": bf16_ms[i],
                                       "bf16_grouped_mm_ms": lib_ms[i], "cap": cap,
                                       "dropped": int(dropped.sum()), "experts": touched}
            if prefill:
                res[name + "_prefill"] = {**r, "library_ms": None}
            elif T != SLOTS:
                res[name]["err"] = max(res[name]["err"], r["err"])
        log(f"[kernel] int8 experts T={T} ({'prefill' if prefill else 'decode'} form): kernel "
            f"{into['grouped_gateup_i8']['ms']:.4f} / "
            f"{into['grouped_down_i8']['ms']:.4f} ms (bound "
            f"{into['grouped_gateup_i8']['bound_ms']:.4f} / "
            f"{into['grouped_down_i8']['bound_ms']:.4f}) | bf16 grouped expert kernel "
            f"{bf16_ms[0]:.4f} / {bf16_ms[1]:.4f} ms | bf16 torch._grouped_mm "
            + (f"{lib_ms[0]:.4f} / {lib_ms[1]:.4f} ms" if grouped_mm else "absent"))
        del h, hb, got_h, got_y
    _i8_prefill_skewed(res, gu, wd)
    del gu_all, wd_all, wgu_bf, wd_bf
    _free()
    return res, shapes


@contextlib.contextmanager
def _i8_parent_form():
    """The int8 grouped expert wrappers on the parent's form inside (the
    decode kernel, which took every row count before the prefill form):
    ``moe.PREFILL_ROWS_PER_EXPERT`` raised past any size. (The bf16
    wrappers read it too: nothing else runs inside.)"""
    from deepsearch_tts_tpu_torch.ops import moe

    old = moe.PREFILL_ROWS_PER_EXPERT
    moe.PREFILL_ROWS_PER_EXPERT = 1 << 30
    try:
        yield
    finally:
        moe.PREFILL_ROWS_PER_EXPERT = old


def _i8_prefill_extra(res, into, label, xs, h, gu, wd, offsets, cap, sizes) -> None:
    """At 3072 tokens: the parent's form timed beside the prefill form's
    time in ``into``, and a plain gate|up without one 64-row k stage of the
    largest expert's weights failing the bound the kernel meets."""
    import torch

    from deepsearch_tts_tpu_torch.ops import moe

    with _i8_parent_form():
        for name, call in (("grouped_gateup_i8",
                            lambda: moe.grouped_gateup_i8(xs, gu, None, offsets, cap)),
                           ("grouped_down_i8", lambda: moe.grouped_down_i8(h, wd, offsets, cap))):
            into[name]["parent_ms"] = time_ms(call, iters=20)[0]
    e = int(sizes.argmax())
    q = gu["q"].clone()
    q[e, 64:128] = 0
    fault = moe.grouped_gateup_i8_plain(xs, {"q": q, "scales": gu["scales"]}, None, offsets, cap)
    got = moe.grouped_gateup_i8(xs, gu, None, offsets, cap)
    use = _bound_use(fault, got, BF16_RTOL, BF16_ATOL, math.inf)
    assert use > 1.0, ("int8 prefill: a plain gate|up without a k stage passed the bound", use)
    log(f"[kernel] int8 experts {label}: parent's form (the decode kernel) "
        f"{into['grouped_gateup_i8']['parent_ms']:.4f} / "
        f"{into['grouped_down_i8']['parent_ms']:.4f} ms; plain gate|up without k stage 1 of "
        f"expert {e}: {use:.1f} times the bound")
    del q, fault, got
    torch.cuda.synchronize()


def _i8_prefill_skewed(res, gu, wd) -> None:
    """The prefill form on a skewed 3072-token routing (its own generator):
    expert 5 takes 500 tokens, over one 256-row tile and past its capacity
    of 384; packed gate|up and down against the plain versions, rows past
    the capacity 0, two calls bit-equal, the prefill form counted."""
    import torch

    from deepsearch_tts_tpu_torch.ops import moe

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(17)
    T = 3072
    logits = torch.randn((T, M_NE), generator=gen, device=dev) * 2
    logits[:500, 5] += 30.0
    _, top_e = moe.route_topk(logits, M_TOPK)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    offsets = moe.group_offsets(flat_e, M_NE)
    xs = torch.randn((T, M_E), generator=gen, device=dev).to(bf)[order // M_TOPK]
    S = T * M_TOPK
    cap = moe.expert_capacity(S, M_NE)
    sizes = (offsets[1:] - offsets[:-1]).long()
    assert int(sizes[5]) > cap > 256, (int(sizes[5]), cap)
    eid = torch.repeat_interleave(torch.arange(M_NE, device=dev), sizes)
    dropped = (torch.arange(S, device=dev) - offsets[eid].long()) >= cap
    n_pre = moe.grouped_gateup_i8.prefill_launches + moe.grouped_down_i8.prefill_launches
    h = moe.grouped_gateup_i8_plain(xs, gu, None, offsets, cap)
    label = f"T={T} skewed (expert 5 {int(sizes[5])} rows, cap {cap}, {int(dropped.sum())} dropped)"
    for name, kern, plain in (
            ("grouped_gateup_i8_prefill", lambda: moe.grouped_gateup_i8(xs, gu, None, offsets, cap),
             lambda: h),
            ("grouped_down_i8_prefill", lambda: moe.grouped_down_i8(h, wd, offsets, cap),
             lambda: moe.grouped_down_i8_plain(h, wd, offsets, cap))):
        got = kern()
        _check_kernel(res, name, label, lambda: got, plain, rtol=BF16_RTOL, atol=BF16_ATOL)
        assert torch.equal(got, kern()), (name, "two calls differ")
        assert not bool(got[dropped].any()), (name, "rows past the capacity must be 0")
    assert (moe.grouped_gateup_i8.prefill_launches + moe.grouped_down_i8.prefill_launches
            - n_pre) == 4
    del h, xs


def _latent_prefill_inputs(gen, B, T, starts, valid, ps, P, H, slot):
    """A latent pool of random rows (the chunk's rows already among them),
    q [B, T, H, 576], each row's table of distinct random pages (page 0 in
    none; slot: no table, rows B .. 2B-1 of a 2B-row pool), positions from
    each start for its valid queries (-1 after), seq_lens."""
    import torch

    dev = torch.device("cuda")
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    N = 2 * B if slot else 1 + B * P
    pool, q = rnd(N, ps, 1, X_D), rnd(B, T, H, X_D)
    table = None if slot else 1 + torch.randperm(N - 1, generator=gen, device=dev)[
        : B * P].view(B, P)
    pos = torch.full((B, T), -1, dtype=torch.int64, device=dev)
    for b, (s0, n) in enumerate(zip(starts, valid)):
        if s0 >= 0:
            pos[b, :n] = s0 + torch.arange(n, device=dev)
    seq = torch.tensor([s0 + n if s0 >= 0 else 0 for s0, n in zip(starts, valid)], device=dev)
    return q, pool, table, seq, pos


def _sdpa_kernels(fn) -> str:
    """The device kernels one call of ``fn`` runs (torch.profiler), by
    name: which backend SDPA took."""
    own, other = _traced_kernels(fn)
    return ", ".join(sorted(set(own) | set(other)))


def _latent_page_fault(q, pool, table, seq, pos, page: int) -> None:
    """The rms-scaled bound sees a wrong latent page: K3's prefill mode
    passes it, the plain version over the same table with its ``page``-th
    page swapped for page 0 (random rows, in no row's table) fails it."""
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    kw = dict(scale=X_SCALE)
    ref = pa.latent_prefill_plain(q, pool, seq, pos, page_table=table, **kw)
    bad = table.clone()
    bad[:, page] = 0
    uses = {"kernel": _bound_use(pa.latent_prefill(q, pool, seq, pos, page_table=table, **kw),
                                 ref, ATTN_RTOL, ATTN_ATOL, ATTN_RMS_FRAC),
            f"page {page} swapped": _bound_use(
                pa.latent_prefill_plain(q, pool, seq, pos, page_table=bad, **kw), ref,
                ATTN_RTOL, ATTN_ATOL, ATTN_RMS_FRAC)}
    log("[kernel] K3 prefill bound over the long prompt, bound use: " +
        ", ".join(f"{k} {u:.3f}" for k, u in uses.items()))
    assert uses["kernel"] <= 1.0 < uses[f"page {page} swapped"], uses


def _check_latent_prefills(res: dict, other: dict, gen) -> None:
    """K3's prefill mode (``latent_prefill``) against its plain version at
    :data:`LATENT_PREFILLS`, at 128 and 64 heads, under the rms-scaled
    attention bound (padding queries: zeros in both), each shape timed
    beside its plain version, its bound (operations: 2·H·(576 + 512) a
    visible (query, key) pair of a real query; bytes: q, out, and each
    row's latent keys up to its largest limit once) and one SDPA call over
    the pre-gathered context (the gather not timed): q as [B, H, T, 576]
    over the latent rows broadcast to every head, causal (``is_causal`` from
    position 0, ``causal_lower_right`` after a prefix) at B = 1, else with
    each query's key mask; the kernels SDPA ran are logged once a shape.
    The plain version over the long prompt's table with one page swapped
    must fail the bound the kernel passes (:func:`_latent_page_fault`).
    ``res["latent_prefill"]`` keeps the 3044-token prompt's numbers at 128
    heads and the largest error of all shapes, ``other["latent_prefill
    shapes"]`` every shape's."""
    import torch
    from torch.nn.attention.bias import causal_lower_right

    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes, err = {}, 0.0
    for label, B, T, starts, valid, ps, P, slot in LATENT_PREFILLS:
        for H, model in ((128, "deepseek-v3"), (64, "kimi-k2")):
            q, pool, table, seq, pos = _latent_prefill_inputs(gen, B, T, starts, valid, ps, P,
                                                              H, slot)
            kw = dict(page_table=table, row_offset=B if slot else 0, scale=X_SCALE)
            S = ps if slot else P * ps
            lim = pa.latent_key_limits(seq, pos, S)
            ctx = pa._latent_context(pool, B, table, kw["row_offset"])   # [B, S, 1, 576]
            kt = ctx.transpose(1, 2).expand(B, H, S, X_D)
            mask = (torch.arange(S, device=q.device)[None, None] < lim[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            if B == 1:
                s0, n = starts[0], valid[0]
                qn, kn = qt[:, :, :n], kt[:, :, :s0 + n]
                causal = (dict(is_causal=True) if s0 == 0
                          else dict(attn_mask=causal_lower_right(n, s0 + n)))
                library = lambda: sdpa(qn, kn, kn[..., :X_V], scale=X_SCALE, **causal)  # noqa: E731
            else:
                library = lambda: sdpa(qt, kt, kt[..., :X_V], attn_mask=mask, scale=X_SCALE)  # noqa: E731
            one: dict = {}
            real = int(lim[pos >= 0].sum())
            _check_kernel(one, "latent_prefill", f"{label} {model} H={H}",
                          lambda: pa.latent_prefill(q, pool, seq, pos, **kw),
                          lambda: pa.latent_prefill_plain(q, pool, seq, pos, **kw),
                          rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                          flop=2 * H * (X_D + X_V) * real,
                          nbytes=(int(lim.amax(1).sum()) * X_D * 2
                                  + B * T * H * (X_D + X_V) * 2 + B * (T + P + 1) * 8),
                          library=library)
            r = one["latent_prefill"]
            if label == LATENT_PREFILLS[0][0] and H == 128:
                _latent_page_fault(q, pool, table, seq, pos, page=P // 4)
            r["sdpa_kernels"] = _sdpa_kernels(library)
            log(f"[kernel] latent_prefill {label} {model} H={H}: SDPA ran {r['sdpa_kernels']}")
            shapes[f"{label} H={H}"] = r
            err = max(err, r["err"])
            del q, pool, table, ctx, kt, mask, qt
        _free()
    first = f"{LATENT_PREFILLS[0][0]} H=128"
    res["latent_prefill"] = {**shapes[first], "err": err}
    other["latent_prefill shapes"] = shapes


def phase_mla_kernels(gen) -> tuple[dict, dict]:
    """B8 and K3 against their plain versions at deepseek-v3 widths (K3 also
    at kimi-k2's 64 heads, and at B = 1 and 64 beside SDPA), and the grouped
    expert kernels at its expert shape; returns the per-kernel results of
    the JSON line (B8 timed at the dense width, K3 at H = 128, B = 16) and
    the other timed shapes."""
    import torch

    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev, bf = torch.device("cuda"), torch.bfloat16
    res: dict = {}
    other: dict = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def check(name, *a, **k):
        _check_kernel(res if k.get("timed") else other, name, *a, **k)

    def attn_check(name, *a, **k):
        check(name, *a, rtol=ATTN_RTOL, atol=ATTN_ATOL, **{"rms_frac": ATTN_RMS_FRAC, **k})

    _free()   # the earlier kernel phases' tensors and graphs
    # B8: two-layer stacks (793 MB a dense layer, 88 MB a shared expert:
    # beyond the 50 MB L2), each layer checked at B = 1, 16 and 64 (a
    # verify step's rows, its inputs from a generator of their own); the
    # timing walks both layers, so each call reads its weights cold as in
    # serving; where the products take the wgmma form, the parent's form
    # (gemm_partial) is timed beside
    L = 2
    wide_gen = torch.Generator(device=dev).manual_seed(18)
    for F, norm, tag in ((X_FD, True, "dense"), (X_FS, False, "shared")):
        ln = rnd(L, X_E, scale=0.1) + 1
        wg, wu = rnd(L, X_E, F, scale=X_E ** -0.5), rnd(L, X_E, F, scale=X_E ** -0.5)
        wd = rnd(L, F, X_E, scale=F ** -0.5)
        kw = dict(eps=1e-6, norm=norm, residual=norm)
        for B in (1, SLOTS, 64):
            x = (rnd(B, X_E) if B <= SLOTS
                 else torch.randn((B, X_E), generator=wide_gen, device=dev).to(bf))
            for layer in range(L):
                _check_kernel(other, "fused_mlp_stacked", f"{tag} F={F} B={B} layer={layer}",
                              lambda: fl.fused_mlp_stacked(x, ln, wg, wu, wd, layer, **kw),
                              lambda: fl.fused_mlp_stacked_plain(x, ln, wg, wu, wd, layer, **kw),
                              rtol=BF16_RTOL, atol=BF16_ATOL)

            def walk(f):
                return lambda: [f(x, ln, wg, wu, wd, layer, **kw) for layer in range(L)]

            t = time_ms(walk(fl.fused_mlp_stacked), calls=L)
            p = time_ms(walk(fl.fused_mlp_stacked_plain), calls=L)
            with _parent_products() as taken:
                par = time_ms(walk(fl.fused_mlp_stacked), calls=L)[0] if B >= taken else None
            bd = bound(2 * (3 * X_E * F + 2 * B * X_E + norm * X_E), 2 * B * 3 * X_E * F)
            log(f"[kernel] B8 fused_mlp_stacked {tag} F={F} B={B} | device kernel "
                f"{t[0]:.4f} ms plain {p[0]:.4f} ms | eager kernel {t[1]:.4f} ms plain "
                f"{p[1]:.4f} ms | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) | "
                f"{6 * X_E * F / t[0] / 1e6:.1f} GB/s"
                + (f" | parent's form (gemm_partial) {par:.4f} ms" if par is not None else ""))
            r = dict(ms=t[0], plain_ms=p[0], library_ms=None, parent_ms=par, **bd,
                     shape=f"{tag} E={X_E} F={F} B={B} ({L} layers walked)")
            if tag == "dense" and B == SLOTS:
                res["fused_mlp_stacked"] = {"err": 0.0, **r}
            other[f"fused_mlp_stacked {tag} B={B}"] = r
        del ln, wg, wu, wd
        _free()
    res["fused_mlp_stacked"]["err"] = other.pop("fused_mlp_stacked")["err"]

    # K3 through B1's entry: a two-layer slot pool of SLOTS rows x CTX
    # tokens of one 576-column cache head, LIMITS as K1's check. The
    # yardstick is SDPA over layer 1's rows with each row's key mask, the
    # H heads of a row as its H query rows over the one cache head: the
    # same function as enable_gqa over [B, H, 1, 576] queries, whose math
    # path expands k and v to every head (over 60 GB at H = 128)
    lim = torch.tensor(LIMITS, device=dev)
    keys = sum(max(x, 1) for x in LIMITS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(n_rows=SLOTS, slot_ctx=CTX, scale=X_SCALE, v_width=X_V)
    pool = rnd(2 * SLOTS, CTX, 1, X_D)
    k1 = pool[SLOTS:].transpose(1, 2)                         # [B, 1, CTX, 576]
    mask = (torch.arange(CTX, device=dev)[None] < lim.clamp(min=1)[:, None])[:, None, None]
    for h, model in ((128, "deepseek-v3"), (64, "kimi-k2")):
        q = rnd(SLOTS, h, X_D)
        q4 = q[:, None]                                       # [B, 1, H, 576]
        io = keys * X_D * 2 + SLOTS * h * (X_D + X_V) * 2 + SLOTS * 8
        for layer in range(2):
            attn_check("slot_attention_latent", f"{model} H={h} B={SLOTS} layer={layer} "
                       f"ctx={CTX}",
                       lambda: sa.slot_attention(q, pool, None, lim, layer, **kw),
                       lambda: sa.slot_attention_plain(q, pool, None, lim, layer, **kw),
                       timed=layer == 1 and h == 128, nbytes=io,
                       flop=2 * h * (X_D + X_V) * keys,
                       library=lambda: sdpa(q4, k1, k1[..., :X_V], attn_mask=mask,
                                            scale=X_SCALE))
        if h == 64:   # the kimi-k2 time, for PERF.md
            other["slot_attention_latent H=64"] = {
                "ms": time_ms(lambda: sa.slot_attention(q, pool, None, lim, 1, **kw),
                              iters=20)[0], **bound(io, 2 * h * (X_D + X_V) * keys)}
    # B = 1 over one full 4096-key row (16 splits of 256 keys), beside SDPA
    # over the same row, and the bound's view of a split fault there
    qb, lb = rnd(1, 128, X_D), torch.tensor([CTX], device=dev)
    kb = pool[1:2].transpose(1, 2)                            # [1, 1, CTX, 576]
    kw1 = dict(kw, n_rows=1)
    row: dict = {}
    _check_kernel(row, "slot_attention_latent",
                  f"deepseek-v3 H=128 B=1 layer=1 ctx={CTX} (one full row)",
                  lambda: sa.slot_attention(qb, pool[:2], None, lb, 1, **kw1),
                  lambda: sa.slot_attention_plain(qb, pool[:2], None, lb, 1, **kw1),
                  rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                  nbytes=CTX * X_D * 2 + 128 * (X_D + X_V) * 2 + 8,
                  flop=2 * 128 * (X_D + X_V) * CTX,
                  library=lambda: sdpa(qb[:, None], kb, kb[..., :X_V], scale=X_SCALE))
    other["slot_attention_latent B=1"] = row.pop("slot_attention_latent")
    _bound_rejects_split_faults(sa.slot_attention_plain(qb, pool[:2], None, lb, 1, **kw1),
                                qb, kb, kb[..., :X_V], scale=X_SCALE, tag="K3")
    del pool, k1, kb
    _free()
    # B = 64 (LIMITS four times over): 128 blocks of 64 heads, three splits
    n64 = 4 * SLOTS
    pool64 = rnd(n64, CTX, 1, X_D)
    q64, lim64 = rnd(n64, 128, X_D), torch.tensor(LIMITS * 4, device=dev)
    k64 = pool64.transpose(1, 2)
    mask64 = (torch.arange(CTX, device=dev)[None] < lim64.clamp(min=1)[:, None])[:, None, None]
    kw64 = dict(kw, n_rows=n64)
    _check_kernel(row, "slot_attention_latent", f"deepseek-v3 H=128 B={n64} layer=0 ctx={CTX}",
                  lambda: sa.slot_attention(q64, pool64, None, lim64, 0, **kw64),
                  lambda: sa.slot_attention_plain(q64, pool64, None, lim64, 0, **kw64),
                  rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, timed=True,
                  nbytes=4 * keys * X_D * 2 + n64 * 128 * (X_D + X_V) * 2 + n64 * 8,
                  flop=2 * 128 * (X_D + X_V) * 4 * keys,
                  library=lambda: sdpa(q64[:, None], k64, k64[..., :X_V], attn_mask=mask64,
                                       scale=X_SCALE))
    other["slot_attention_latent B=64"] = row.pop("slot_attention_latent")
    del pool64, q64, k64
    _free()

    # K3 through the three B6 entries: 64-token pages of a shuffled table
    # (page 0 the zeroed null page), SEQS as K1's check; the pool is k and v
    ps, P = 64, CTX // 64
    NP = 1 + SLOTS * P
    pages = rnd(NP, ps, 1, X_D)
    pages[0] = 0
    seq = torch.tensor(SEQS, device=dev)
    perm = torch.randperm(NP - 1, generator=gen, device=dev)[: SLOTS * P].view(SLOTS, P)
    used = (seq + ps - 1) // ps
    table = torch.where(torch.arange(P, device=dev)[None] < used[:, None], perm + 1, 0)
    qpos = (seq - 1)[:, None]
    nkeys = int(seq.sum())
    # the yardstick: SDPA over the pre-gathered latent context (the gather
    # not timed), heads as query rows, each row's keys masked past its
    # seq_len, as the B1 sibling above
    kg = pages[table].reshape(SLOTS, P * ps, 1, X_D).transpose(1, 2)   # [B, 1, S, 576]
    maskg = (torch.arange(P * ps, device=dev)[None] < seq[:, None])[:, None, None]
    for h, model in ((128, "deepseek-v3"), (64, "kimi-k2")):
        q1 = rnd(SLOTS, 1, h, X_D)
        io = nkeys * X_D * 2 + SLOTS * h * (X_D + X_V) * 2 + SLOTS * (P + 2) * 8
        flop = 2 * h * (X_D + X_V) * nkeys
        for name in ("pallas_paged_attention", "pallas_paged_decode",
                     "pallas_paged_decode_clamp"):
            extra = (qpos,) if name == "pallas_paged_attention" else ()
            fk, fp = getattr(pa, name), getattr(pa, name + "_plain")
            timed = h == 128 and name == "pallas_paged_attention"
            attn_check("paged_attention_latent", f"{name} {model} H={h} B={SLOTS} ps={ps} "
                       f"P={P}",
                       lambda: fk(q1, pages, pages, table, seq, *extra, scale=X_SCALE,
                                  v_width=X_V),
                       lambda: fp(q1, pages, pages, table, seq, *extra, scale=X_SCALE,
                                  v_width=X_V), timed=timed, nbytes=io, flop=flop,
                       library=lambda: sdpa(q1, kg, kg[..., :X_V], attn_mask=maskg,
                                            scale=X_SCALE))
            if h == 64 and name == "pallas_paged_attention":
                other["paged_attention_latent H=64"] = {
                    "ms": time_ms(lambda: fk(q1, pages, pages, table, seq, *extra,
                                             scale=X_SCALE, v_width=X_V), iters=20)[0],
                    **bound(io, flop)}
    del pages, kg
    _free()
    for name in ("slot_attention_latent", "paged_attention_latent"):
        res[name]["err"] = max(res[name]["err"], other.pop(name)["err"])
    _check_latent_prefills(res, other, gen)
    res["slot_attention_latent"]["err"] = max(
        res["slot_attention_latent"]["err"], *(other[f"slot_attention_latent B={n}"]["err"]
                                               for n in (1, n64)))

    # the grouped expert kernels at deepseek-v3's expert shape, gate and up
    # unpacked (MLA's routed experts): the decode kernel over the rows of 16
    # tokens x top-8, the prefill kernel over 3072 tokens x top-8, there
    # also packed, beside torch._grouped_mm over the packed copy
    wg = torch.empty((X_NE, X_E, X_FS), dtype=bf, device=dev)
    wu, wd = torch.empty_like(wg), torch.empty((X_NE, X_FS, X_E), dtype=bf, device=dev)
    wgu = torch.empty((X_NE, X_E, 2 * X_FS), dtype=bf, device=dev)
    for e in range(0, X_NE, 32):   # drawn 32 experts at a time
        wg[e:e + 32], wu[e:e + 32] = (rnd(32, X_E, X_FS, scale=X_E ** -0.5) for _ in "gu")
        wd[e:e + 32] = rnd(32, X_FS, X_E, scale=X_FS ** -0.5)
        wgu[e:e + 32] = torch.cat([wg[e:e + 32], wu[e:e + 32]], dim=-1)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    for T in (SLOTS, 3072):
        logits = torch.randn((T, X_NE), generator=gen, device=dev) * 2
        _, top_e = moe.route_topk(logits, X_TOPK)
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        offsets = moe.group_offsets(flat_e, X_NE)
        xs = rnd(T, X_E)[order // X_TOPK]
        sizes = offsets[1:] - offsets[:-1]
        touched = int((sizes > 0).sum())
        rows = T * X_TOPK
        prefill = moe.grouped_prefill(rows, X_NE, X_E, X_FS)
        assert prefill == (T != SLOTS), (T, prefill)
        sfx = "_prefill" if prefill else ""
        label = (f"deepseek-v3 T={T} x top-{X_TOPK} ({touched} of {X_NE} experts, largest "
                 f"{int(sizes.max())} rows) unpacked")
        h = moe.grouped_gateup_plain(xs, wg, wu, offsets)
        ends = offsets[1:]
        gu_bytes = 2 * (touched * X_E * 2 * X_FS + rows * (X_E + X_FS)) + 4 * (X_NE + 1)
        _check_kernel(other, "grouped_gateup" + sfx, label,
                      lambda: moe.grouped_gateup(xs, wg, wu, offsets),
                      lambda: moe.grouped_gateup_plain(xs, wg, wu, offsets), rtol=BF16_RTOL,
                      atol=BF16_ATOL, timed=True, plain_graph=False, nbytes=gu_bytes,
                      flop=2 * rows * X_E * 2 * X_FS,
                      library=prefill and grouped_mm and (lambda: grouped_mm(xs, wgu, offs=ends))
                      or None)
        _check_kernel(other, "grouped_down" + sfx, label,
                      lambda: moe.grouped_down(h, wd, offsets),
                      lambda: moe.grouped_down_plain(h, wd, offsets), rtol=BF16_RTOL,
                      atol=BF16_ATOL, timed=True, plain_graph=False,
                      nbytes=2 * (touched * X_FS * X_E + rows * (X_FS + X_E)) + 4 * (X_NE + 1),
                      flop=2 * rows * X_FS * X_E,
                      library=prefill and grouped_mm and (lambda: grouped_mm(h, wd, offs=ends))
                      or None)
        if prefill:
            _check_kernel(other, "grouped_gateup_prefill", label[:-len("unpacked")] + "packed",
                          lambda: moe.grouped_gateup(xs, wgu, None, offsets),
                          lambda: moe.grouped_gateup_plain(xs, wgu, None, offsets),
                          rtol=BF16_RTOL, atol=BF16_ATOL)
        for n in ("grouped_gateup", "grouped_down"):
            other[f"{n} deepseek-v3 T={T}"] = other.pop(n + sfx)
    del wg, wu, wd, wgu, h
    return res, other


@contextlib.contextmanager
def _serve_http(engine):
    """An ``OpenAIServer`` for ``engine`` on an ephemeral localhost port,
    run on its own thread; yields the ``/v1`` base URL."""
    import asyncio

    from deepsearch_tts_tpu_torch.engine.server import OpenAIServer

    loop = asyncio.new_event_loop()
    server = OpenAIServer(engine, "127.0.0.1", 0)
    loop.run_until_complete(server.start())
    port = server._server.sockets[0].getsockname()[1]
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{port}/v1"
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=30)
        loop.run_until_complete(server.stop())
        loop.close()


def _release(engine) -> dict:
    """Stop ``engine`` and free its KV pools; returns its params."""
    import torch

    engine.shutdown()
    params = engine.params
    engine.k_pages = engine.v_pages = engine.k_scales = engine.v_scales = None
    engine.seen = engine._seen_ext = engine.hist = engine._hist_ext = None
    engine._programs.clear()   # the graphs hold the graph pool
    engine._prefill_programs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return params


# the wide phase: shapes the attention kernels take beyond qwen3-8b's, at
# qwen3-14b's published widths (40 / 8 heads: G = 5), 2 of its 40 layers,
# registered here under its own name: the CLI's paged engine at 48-key
# pages (K2's paged mode in boxes of 16) and a slot engine of 3000-key rows
# (boxes of 64 past a row's end)
WIDE_MODEL, WIDE_LAYERS, WIDE_PAGE, WIDE_ROW = "qwen3-14b-2-layers", 2, 48, 3000
WIDE_SYSTEM = "You are a careful search assistant who cites every page. " * 6


def _register_wide() -> None:
    """qwen3-14b's published widths, ``WIDE_LAYERS`` of its 40 layers,
    registered under ``WIDE_MODEL``."""
    from deepsearch_tts_tpu_torch.engine.weights import convert_qwen3_dense
    from deepsearch_tts_tpu_torch.models import qwen3, registry

    cfg = dataclasses.replace(qwen3.QWEN3_CONFIGS["qwen3-14b"], n_layers=WIDE_LAYERS)
    registry.register(WIDE_MODEL, cfg, qwen3.forward, convert_qwen3_dense)


def _wide_turns(tag: str, engine, counters: dict) -> dict:
    """A greedy prompt, then its multi-turn follow-up (the first turn's
    prompt and answer and more): the follow-up must reuse the cached
    prefix (a prefix hit, or a park hit on the slot engine); K2's paged
    mode once a layer and prefill dispatch, K1 once a layer and decode
    step, B5 once a sample."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest

    tok = engine.tokenizer
    first = tok.encode(WIDE_SYSTEM + "Which river flows through Vienna?")
    _zero(counters)
    st0 = _settled(engine)
    r1 = engine.generate(GenerationRequest(prompt_ids=first, max_tokens=16, **GREEDY))
    follow = first + r1.token_ids + tok.encode(" And which one through Budapest?")
    r2 = engine.generate(GenerationRequest(prompt_ids=follow, max_tokens=16, **GREEDY))
    st1 = _settled(engine)
    assert r1.completion_tokens >= 1 and r2.completion_tokens >= 1, (r1, r2)
    assert r2.cached_prompt_tokens > 0, r2
    launches = _check_launches(tag, engine, counters, st0, st1)
    log(f"[{tag}] attn_impl={engine.attn_impl}, {len(first)}-token prompt, follow-up of "
        f"{len(follow)} tokens with {r2.cached_prompt_tokens} cached; launches {launches}")
    return {"launches": launches, "cached_tokens": r2.cached_prompt_tokens,
            "prompt_tokens": len(follow)}


def phase_wide(card: str) -> dict:
    """``WIDE_MODEL`` through ``cli/serve.py``'s ``build_engine`` at
    ``--page_size 48`` (the prefix cache and the lane on, the CLI's
    defaults), then a slot engine with parking of ``WIDE_ROW``-key rows on
    the same weights: on both ``attn_impl`` resolves to ``"pallas"``, a
    multi-turn follow-up reuses its cached prefix, and every layer of every
    prefill and decode step attends through K2's paged mode and K1 (B6's
    entry, B1's on the slot engine); the paged engine's serving logits over
    two pages held to the no-cache forward (phase 5)."""
    import torch

    from deepsearch_tts_tpu_torch.cli.serve import build_engine, build_parser
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    _register_wide()
    out: dict = {}
    args = build_parser().parse_args([
        "--model", WIDE_MODEL, "--device", "cuda", "--seed", "0",
        "--max_slots", str(SLOTS), "--page_size", str(WIDE_PAGE), "--pages", "256",
        "--max_seq_len", "4096", "--decode_chunk", "8", "--warmup", "0"])
    engine = build_engine(args)
    assert engine.attn_impl == "pallas" and engine.layer_fusion, engine.attn_impl
    try:
        counters = {**_counters("qwen3-8b"), "flash_attention_paged": fa.flash_attention_paged,
                    "pallas_paged_attention": pa.pallas_paged_attention}
        out["paged"] = _wide_turns("wide", engine, counters)
        phase_reference(engine, tag="wide-reference", t0=56, steps=8)
    finally:
        params = _release(engine)
    engine = _engine(params, model=WIDE_MODEL, cache_mode="slot", max_seq_len=WIDE_ROW)
    assert engine.attn_impl == "pallas" and engine.layer_fusion, engine.attn_impl
    try:
        counters = {**_counters("qwen3-8b"), "flash_attention_paged": fa.flash_attention_paged,
                    "slot_attention": sa.slot_attention}
        out["slot"] = _wide_turns("wide-slot", engine, counters)
        assert engine.stats["slot_park_hits"] > 0, engine.stats
    finally:
        _release(engine)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[wide] {card} | qwen3-14b widths (G = 5), {WIDE_LAYERS} layers: 48-key pages "
        f"and {WIDE_ROW}-key slot rows served on the kernels")
    return out


def _engine(params, model: str = "qwen3-8b", **kw):
    """``model`` on the card over the served weights, ``SLOTS`` rows of
    ``CTX`` keys unless ``kw`` says otherwise."""
    from deepsearch_tts_tpu_torch.engine.engine import Engine
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer

    return Engine(model, ByteTokenizer(), params=params, device="cuda",
                  **{"max_slots": SLOTS, "max_seq_len": CTX, "decode_chunk_len": 8, **kw})


def phase_slot_serve(card: str, params: dict, model: str = "qwen3-8b",
                     profile: bool = False, tag: str = "slot", spec: bool = False,
                     b1_tokens: int = 0, b1_plain_ms: float | None = None,
                     lane: bool = False) -> dict:
    """The slot engine with parking, default ``attn_impl``, over HTTP, on
    the served weights of ``model``; with ``spec`` the speculative engine
    (``SPEC_KW``), whose full-batch burst is greedy and must emit more than
    one token per verify step, and whose greedy stream is teacher-forced
    through the no-cache forward. ``b1_tokens``: one more greedy request of
    that many tokens alone (ms per token logged beside ``b1_plain_ms``).
    ``lane``: the engine takes the CLI's prefill lane, and ends with
    :func:`_lane_check`."""
    import torch

    from deepsearch_tts_tpu_torch.engine.weights import pack_matmul_params
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa
    from deepsearch_tts_tpu_torch.ops.paged_attention import latent_prefill

    # the engine packs its params; on the served (packed) tree that is the
    # identity (MLA's two-stack tree is handed back whole), so the same
    # weights are reused instead of drawn again
    packed = pack_matmul_params(params)
    assert packed is params or all(packed["layers"][k] is t
                                   for k, t in params["layers"].items())
    t0 = time.time()
    engine = _engine(params, model=model, cache_mode="slot", **(SPEC_KW if spec else {}),
                     prefill_lane=LANE if lane else 0)
    # every bucket the phase's requests reach (at most 160 tokens generated;
    # prompts of up to 64 tokens in groups of up to 16, the lane's and the
    # raw completions' in groups of up to 4, the multi-turn's first turn of
    # 350 alone; the slot cache reads one page-table width)
    engine.warmup(prompt_lens=(64,), max_ctx=1024)
    engine.warmup(prompt_lens=(16, 32), group_sizes=(1, 4), decode=False)
    engine.warmup(prompt_lens=(512,), group_sizes=(1,), decode=False)
    log(f"[{tag}] engine built and warmed in {time.time() - t0:.1f} s; attn_impl="
        f"{engine.attn_impl}; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    assert engine.attn_impl == "pallas" and engine.layer_fusion, engine.attn_impl
    out: dict = {"programs": _check_programs(tag, engine)}
    # a speculative engine runs only verify windows: B9, never B1; a parked
    # row's re-entry (and every prefill: parking makes each non-fresh) takes
    # K2's paged mode over the slot row as one page
    counters = {**_counters(model), "slot_attention": sa.slot_attention,
                "flash_attention_paged": fa.flash_attention_paged}
    idle = ()
    if model == MLA_MODEL:
        # MLA's 576-column latent rows take K3 through B1's entry; K1 idles,
        # and its prefills (the slot row as one page) take K3's prefill mode
        counters["slot_attention_latent"] = sa.slot_attention_latent
        counters["latent_prefill"] = latent_prefill
        idle = ("slot_attention", "flash_attention_paged")
        _latent_prefill_programs(tag, engine, out["programs"])
    if spec:
        counters["slot_window_attention"] = sa.slot_window_attention
        idle = ("slot_attention",)
    try:
        with _serve_http(engine) as base:
            def chat(content, **kw):
                payload = {"messages": [{"role": "user", "content": content}], **kw}
                return _post(f"{base}/chat/completions", payload)

            _zero(counters)
            st0 = dict(engine.stats)
            ttfts = []
            for i in range(5):
                code, body, dt = chat(f"Time to first token, please ({i}).", max_tokens=1)
                assert code == 200 and body["usage"]["completion_tokens"] == 1, body
                ttfts.append(dt)
            out["ttft_s"] = sorted(ttfts)[2]

            results = _burst(chat, 4, 48)
            log(f"[{tag}] 4 concurrent chat: completion tokens "
                f"{[r[1]['usage']['completion_tokens'] for r in results]}")

            # the same greedy request twice, sent together, so that both
            # take the same path: a raw completion whose first byte no
            # parked chat row shares re-enters no parked row (a parked
            # prefix was computed by another prefill group, rounded
            # otherwise), and neither can re-enter the other's row (sent one
            # after the other, the second would)
            pair: list = [None, None]
            hits0 = engine.stats["slot_park_hits"]

            def greedy(i):
                pair[i] = _post(f"{base}/completions", {
                    "prompt": "Greedy: count to five.", "max_tokens": 24,
                    "temperature": 0.0, "repetition_penalty": 1.0})

            ths = [threading.Thread(target=greedy, args=(i,)) for i in range(2)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            texts = [r[1]["choices"][0]["text"] for r in pair]
            assert all(r[0] == 200 for r in pair) and texts[0] == texts[1], texts
            assert engine.stats["slot_park_hits"] == hits0, "the greedy pair re-entered a row"

            r = chat("Budget: think for a while.", max_tokens=40, min_tokens=32)
            assert r[0] == 200 and r[1]["usage"]["completion_tokens"] >= 32, r[1]["usage"]

            hits0 = engine.stats["slot_park_hits"]
            msgs = [{"role": "system",
                     "content": "You are a careful search assistant. " * 8},
                    {"role": "user", "content": "Which river flows through Vienna?"}]
            r = _post(f"{base}/chat/completions", {"messages": msgs, "max_tokens": 16})
            assert r[0] == 200
            msgs += [{"role": "assistant", "content": "The Danube."},
                     {"role": "user", "content": "And through Budapest?"}]
            r = _post(f"{base}/chat/completions", {"messages": msgs, "max_tokens": 16})
            cached = r[1]["usage"]["prompt_tokens_details"]["cached_tokens"]
            hits = engine.stats["slot_park_hits"] - hits0
            assert r[0] == 200 and cached > 0 and hits >= 1, (r[1]["usage"], hits)
            log(f"[{tag}] multi-turn follow-up: prompt_tokens "
                f"{r[1]['usage']['prompt_tokens']} cached_tokens {cached} "
                f"(parked-row re-entries {hits})")

            d0 = _settled(engine)
            results = _burst(chat, SLOTS, 64, **(GREEDY if spec else {}))
            d1 = _settled(engine)
            dt = d1["decode_time_s"] - d0["decode_time_s"]
            out["burst_decode_tok_s"] = (d1["decode_tokens"] - d0["decode_tokens"]) / dt
            out["burst_step_ms"] = 1e3 * dt / ((d1["decode_steps"] - d0["decode_steps"])
                                               * engine.decode_chunk_len)
            if spec:
                # tokens emitted per row and verify step (JAX's telemetry key
                # over the whole phase, and the greedy burst's own)
                out["burst_spec_tokens_per_step"] = (
                    (d1["decode_tokens"] - d0["decode_tokens"])
                    / (d1["slot_steps"] - d0["slot_steps"]))
                out["spec_tokens_per_step"] = engine.telemetry()["spec_tokens_per_step"]
                log(f"[{tag}] greedy burst: {out['burst_spec_tokens_per_step']:.3f} tokens "
                    f"per row and verify step (phase {out['spec_tokens_per_step']:.3f})")
                assert out["burst_spec_tokens_per_step"] > 1.0, out
            if profile:
                out["idle_share"] = _profile_burst(chat, engine)
            if b1_tokens:
                out["b1_ms_per_token"] = _b1_run(tag, engine, b1_tokens, b1_plain_ms)
            if lane:
                out["lane"] = _lane_check(tag, engine, base, counters)

            st1 = _settled(engine)
            out["post_warmup_builds"] = st1["post_warmup_builds"]
            out["pipelined_chunks"] = st1["pipelined_chunks"] - st0["pipelined_chunks"]
            log(f"[{tag}] decode programs: {engine.telemetry()['decode_program']}; "
                f"{out['pipelined_chunks']} chunks pipelined of "
                f"{st1['decode_steps'] - st0['decode_steps']}; post-warmup builds "
                f"{out['post_warmup_builds']}; prefill groups "
                f"{st1.get('prefill_group_hist')}")
            assert out["post_warmup_builds"] == 0, out["post_warmup_builds"]
            out["launches"] = _check_launches(tag, engine, counters, st0, st1, idle)
            log(f"[{tag}] park hits {st1['slot_park_hits'] - st0['slot_park_hits']}")
            out["decode_tok_s"] = ((st1["decode_tokens"] - st0["decode_tokens"])
                                   / (st1["decode_time_s"] - st0["decode_time_s"]))
        step = "verify step" if spec else "decode step"
        log(f"[{tag}] {card} | TTFT median of 5 {out['ttft_s'] * 1000:.1f} ms | decode "
            f"{out['decode_tok_s']:.1f} tok/s over the whole phase | full batch of "
            f"{SLOTS}: {out['burst_decode_tok_s']:.1f} tok/s decode "
            f"({out['burst_step_ms']:.2f} ms per {step})")
        if spec:
            _teacher_forced(tag, engine)
    finally:
        _release(engine)
    return out


def _lane_check(tag: str, engine, base: str, counters: dict, teacher: bool = True) -> dict:
    """The prefill lane on a serving engine: while one long greedy request
    decodes, ``LANE_PROMPTS`` arrive over HTTP and one greedy prompt
    in-process, each of at most ``LANE`` tokens. Every one must ride the
    lane whole (``lane_tokens`` = their prompt tokens; only the long request
    prefills batched) and be activated (a first token); the fused layer once
    a layer and step (lane steps carry B + LANE rows), B5 once a sample
    (lane chunks sample their prompts' first tokens in one call); with
    ``teacher``, the in-process stream teacher-forced through the no-cache
    forward."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest

    tok = engine.tokenizer
    st0 = _settled(engine)
    n0 = {n: f.launches for n, f in counters.items()}
    long = engine.submit(GenerationRequest(prompt_ids=tok.encode("Lane: a long answer."),
                                           max_tokens=160, **GREEDY))
    t0 = time.time()
    while engine.stats["decode_steps"] == st0["decode_steps"]:   # it decodes
        assert time.time() - t0 < 120 and not long.done()
        time.sleep(0.002)
    results: list = [None] * len(LANE_PROMPTS)

    def post(i):
        results[i] = _post(f"{base}/completions", {"prompt": LANE_PROMPTS[i], "max_tokens": 8})

    ths = [threading.Thread(target=post, args=(i,)) for i in range(len(LANE_PROMPTS))]
    for t in ths:
        t.start()
    mine_ids = tok.encode(LANE_GREEDY)
    mine = engine.generate(GenerationRequest(prompt_ids=mine_ids, max_tokens=24, **GREEDY))
    for t in ths:
        t.join(timeout=600)
    assert not long.done(), "the long request ended before the lane prompts arrived"
    long.result(timeout=600)
    st1 = _settled(engine)
    lens = [len(tok.encode(p)) for p in LANE_PROMPTS] + [len(mine_ids)]
    assert max(lens) <= engine.prefill_lane, lens
    for r, n in zip(results, lens):
        assert r is not None and r[0] == 200, r
        u = r[1]["usage"]
        assert u["prompt_tokens"] == n and u["completion_tokens"] >= 1, u
    assert mine.completion_tokens >= 8, mine
    d = {k: st1[k] - st0[k] for k in ("lane_tokens", "lane_chunks", "requests",
                                      "prefill_rows")}
    assert d["lane_tokens"] == sum(lens) and d["requests"] == len(lens) + 1, (d, lens)
    assert d["prefill_rows"] == 1 and d["lane_chunks"] >= 1, d
    steps, prefills, lanes = _steps(engine, st0, st1)
    L = engine.cfg.n_layers
    launches = {n: f.launches - n0[n] for n, f in counters.items()}
    for name, n in launches.items():
        want = (steps + prefills + lanes if name == "sampling_prep"
                else None if name.startswith("grouped_") or name == "int8_product"
                else L * prefills if name == "flash_attention_paged"
                else L * steps)
        assert want is None or n == want > 0, (name, n, want)
    log(f"[{tag}] lane: {len(lens)} prompts of {lens} tokens rode it over {lanes} chunks "
        f"(lane_tokens {d['lane_tokens']}), beside one long greedy request; {steps} steps, "
        f"{prefills} prefill dispatch(es), launches {launches}")
    if teacher:
        _teacher_forced(f"{tag}-lane", engine, (mine_ids, mine))
    return d


def _b1_run(tag: str, engine, n: int, plain_ms: float | None) -> float:
    """One greedy request of ``n`` tokens alone on ``engine``: decode ms per
    generated token (logged beside ``plain_ms``, the plain engine's)."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest

    s0 = _settled(engine)
    r = engine.generate(GenerationRequest(
        prompt_ids=engine.tokenizer.encode("Alone: repeat the search results twice."),
        max_tokens=n, **GREEDY))
    s1 = _settled(engine)
    ms = 1e3 * (s1["decode_time_s"] - s0["decode_time_s"]) / max(
        s1["decode_tokens"] - s0["decode_tokens"], 1)
    steps = s1["slot_steps"] - s0["slot_steps"]
    log(f"[{tag}] B=1 greedy: {r.completion_tokens} tokens, {ms:.3f} ms per token "
        f"({steps} row-steps)" + ("" if plain_ms is None else
                                  f" against {plain_ms:.3f} ms on the plain slot engine"))
    return ms


def _teacher_forced(tag: str, engine, stream=None) -> None:
    """One greedy stream of ``engine`` (``stream``: a (prompt, result) it
    already ran) fed whole through the no-cache forward: each generated
    token must be that forward's argmax at its position, for at least 90 %
    of them."""
    import torch

    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest

    if stream is None:
        prompt = engine.tokenizer.encode("Teacher forcing: the rivers of Europe, again.")
        r = engine.generate(GenerationRequest(prompt_ids=prompt, max_tokens=48, **GREEDY))
    else:
        prompt, r = stream
    ids = torch.tensor([prompt + r.token_ids], device=engine.device)
    assert len(r.token_ids) >= 8, r
    with torch.no_grad():
        logits, _ = engine.forward(engine.params, engine.cfg, ids[:, :-1],
                                   torch.arange(ids.shape[1] - 1, device=engine.device)[None])
    pred = logits[0, len(prompt) - 1:].argmax(-1)
    agree = (pred == ids[0, len(prompt):]).float().mean().item()
    log(f"[{tag}] teacher-forced greedy stream of {len(r.token_ids)} tokens: argmax "
        f"agreement with the no-cache forward {agree:.3f} (bound >= 0.9)")
    assert agree >= 0.9, agree


def phase_int8_lane(params: dict) -> dict:
    """The prefill lane at the CLIs' 64 slots on the qwen3-32b int8 weights
    (C4): a step of 64 decode rows and a 16-token lane runs B10 over 80
    rows (two launches a product) and the int8 lm_head over 65; its logits
    are held to the same step with the plain int8 products
    (``plain_int8``), and an ``Engine(max_slots=64, prefill_lane=16)``
    serves a lane prompt beside a decoding request."""
    import torch

    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest
    from deepsearch_tts_tpu_torch.engine.kvcache import init_kv_pages, init_kv_scales
    from deepsearch_tts_tpu_torch.models import qwen3
    from deepsearch_tts_tpu_torch.models.registry import get_model
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    cfg, dev = get_model(I8_SERVE).config, torch.device("cuda")
    B, L = 64, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(19)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    lane = torch.randint(0, cfg.vocab_size, (LANE,), generator=gen, device=dev)
    n_lane = LANE - 3                                  # three padding rows
    lane_pos = torch.where(torch.arange(LANE, device=dev) < n_lane,
                           torch.arange(LANE, device=dev), -1)
    out = {}
    counters = _counters(I8_MODEL)
    logits = []
    for plain in (False, True):
        # one 64-token page a decode row (pages 1-64, position 0) and one for
        # the lane (page 65), int8 with their scales, as the engine's pools
        kp, vp = init_kv_pages(L, B + 2, 64, cfg.n_kv_heads, cfg.head_dim, dtype=torch.int8,
                               device=dev)
        ks, vs = init_kv_scales(L, B + 2, 64, cfg.n_kv_heads, device=dev)
        _zero(counters)
        with torch.no_grad():
            lg, _ = qwen3.forward(
                params, cfg, toks, torch.zeros((B, 1), dtype=torch.int64, device=dev),
                k_pages=kp, v_pages=vp, k_scales=ks, v_scales=vs,
                page_table=torch.arange(1, B + 1, device=dev)[:, None],
                seq_lens=torch.ones((B,), dtype=torch.int64, device=dev), fused_decode=True,
                plain_int8=plain, lane_tokens=lane, lane_positions=lane_pos,
                lane_table=torch.tensor([B + 1], device=dev),
                lane_logit_row=torch.tensor(n_lane - 1, device=dev))
        torch.cuda.synchronize()
        launches = {n: f.launches for n, f in counters.items()}
        want = ({"fused_qkv_stacked_i8": 0, "fused_out_mlp_stacked_i8": 0, "int8_product": 0}
                if plain else {"fused_qkv_stacked_i8": L, "fused_out_mlp_stacked_i8": L,
                               "int8_product": 1})
        assert all(launches[n] == v for n, v in want.items()), (plain, launches, want)
        logits.append(lg[:, 0])
        del kp, vp, ks, vs
    _hold_to_reference("int8-lane", f"a {B}-slot decode step with a {LANE}-row lane "
                       f"(B10 over {B + LANE} rows, the lm_head over {B + 1})", *logits,
                       ref="the same step with the plain int8 products")
    # the engine at the CLIs' 64 slots: the lane prompt rides a decode step
    from concurrent.futures import Future

    from deepsearch_tts_tpu_torch.engine.engine import Engine
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer

    engine = Engine(I8_SERVE, ByteTokenizer(), params=params, device="cuda", quantize="int8",
                    kv_quantize="int8", max_slots=B, prefill_lane=LANE, page_size=64,
                    n_pages=64, max_seq_len=1024, decode_chunk_len=8)

    def queue(ids, n):
        fut = Future()
        engine._queue.put((GenerationRequest(prompt_ids=ids, max_tokens=n, **GREEDY), fut))
        return fut

    tok = engine.tokenizer
    with torch.no_grad():
        long = queue(tok.encode("Lane: a long answer."), 40)
        engine._admit()
        engine._decode_chunk()
        short = queue(tok.encode(LANE_GREEDY), 8)
        engine._admit()
        assert len(engine._lane) == 1, "the short prompt must queue for the lane"
        _zero(counters)
        st0 = dict(engine.stats)
        engine._decode_chunk()
        st1 = dict(engine.stats)
        launches = {n: f.launches for n, f in counters.items()}
        steps = engine.decode_chunk_len
        assert st1["lane_tokens"] - st0["lane_tokens"] == len(tok.encode(LANE_GREEDY)), st1
        assert launches["fused_qkv_stacked_i8"] == launches["fused_out_mlp_stacked_i8"] \
            == L * steps and launches["int8_product"] == steps, launches
        while not (long.done() and short.done()):
            engine._admit()
            engine._decode_chunk()
    out["engine"] = {"lane_tokens": st1["lane_tokens"], "launches": launches,
                     "short_tokens": short.result().completion_tokens}
    log(f"[int8-lane] Engine(max_slots={B}, prefill_lane={LANE}, quantize='int8', "
        f"kv_quantize='int8'): the lane prompt rode a decode step (lane_tokens "
        f"{st1['lane_tokens']}); launches in that chunk {launches}; completions "
        f"{long.result().completion_tokens} / {short.result().completion_tokens}")
    _release(engine)
    return out


def phase_trim(params: dict) -> dict:
    """``chunk_trim`` on the qwen3-8b weights: with ``trim_min_rows=1`` and
    warmup() (which registers the two widest context buckets: 64 and 128
    tokens at ``max_seq_len=128``), a request of 11 tokens on 8-step chunks
    trims its second chunk; its greedy stream equals the untrimmed
    engine's."""
    from deepsearch_tts_tpu_torch.engine.engine import Engine, GenerationRequest
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer

    runs = []
    for trim in (False, True):
        engine = Engine("qwen3-8b", ByteTokenizer(), params=params, device="cuda",
                        max_slots=SLOTS, max_seq_len=128, page_size=64, n_pages=16,
                        decode_chunk_len=8, chunk_trim=trim)
        engine.warmup(prompt_lens=(32,))   # the three prompts: bucket 32, 4 rows
        engine.trim_min_rows = 1
        prompt = engine.tokenizer.encode("Trim: the rivers of Europe.")
        reqs = [GenerationRequest(prompt_ids=prompt + [i], max_tokens=n, **GREEDY)
                for i, n in enumerate((11, 13, 9))]
        futs = engine.submit_many(reqs)   # one admission: the same prefill group
        runs.append(([f.result(timeout=600).token_ids for f in futs],
                     engine.stats["trim_chunks"], engine.stats["decode_steps"]))
        _release(engine)
    (plain, t0, c0), (trimmed, t1, c1) = runs
    log(f"[trim] chunk_trim: {t1} of {c1} chunks trimmed (untrimmed engine: {t0} of {c0}); "
        f"greedy streams equal: {plain == trimmed}")
    assert t0 == 0 and t1 > 0, (t0, t1)
    assert plain == trimmed, (plain, trimmed)
    return {"trim_chunks": t1, "chunks": c1}


def phase_spec_reference(params: dict, model: str = "qwen3-8b", tag: str = "spec-reference",
                         **plain_kw) -> None:
    """A 16-token slot prefill, then one ``WIN``-token verify window through
    the serving path (fused layers where the family fuses windows, B9 for
    attention) against the no-cache forward on prompt + window: every
    window row's logits. ``plain_kw`` keeps the reference off the kernels
    (``plain_experts``)."""
    import torch

    from deepsearch_tts_tpu_torch.engine.kvcache import init_kv_pages
    from deepsearch_tts_tpu_torch.models.registry import get_model
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    fam = get_model(model)
    cfg, fwd, dev = fam.config, fam.forward, torch.device("cuda")
    T0, T = 16, 16 + WIN
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None]
    one = lambda n: torch.tensor([n], device=dev)   # noqa: E731
    with torch.no_grad():
        ref, _ = fwd(params, cfg, toks, pos, **plain_kw)
        kp, vp = init_kv_pages(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim,
                               dtype=cfg.torch_dtype, device=dev)
        kw = dict(k_pages=kp, v_pages=vp, impl="pallas")
        fwd(params, cfg, toks[:, :T0], pos[:, :T0], page_table=torch.tensor([[0]], device=dev),
            seq_lens=one(T0), logits_indices=one(T0 - 1), **kw)
        n0 = sa.slot_window_attention.launches
        got, _ = fwd(params, cfg, toks[:, T0:], pos[:, T0:], seq_lens=one(T), slot_decode=True,
                     slot_ctx=64, fused_decode=True, **kw)
        launched = sa.slot_window_attention.launches - n0
    got, want = got[0], ref[0, T0:]
    assert got.shape == want.shape == (WIN, cfg.vocab_size) and torch.isfinite(got).all()
    assert launched == cfg.n_layers, launched
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[{tag}] {WIN}-token verify window (B9 x {launched}) logits vs no-cache forward: "
        f"max_abs_err {(got - want).abs().max().item():.4f}, min cosine "
        f"{cos.min().item():.5f} (bound > 0.99), argmax agreement {agree:.2f} (bound >= 0.75)")
    assert cos.min().item() > 0.99, cos
    assert agree >= 0.75, agree


def phase_moe_spec(card: str, params: dict) -> dict:
    """The speculative slot engine on the qwen3-30b-a3b weights: 8 greedy
    requests x 32 tokens; its windows run unfused (B3 and B7 idle, as in
    JAX), attention through B9 and the expert FFN through the grouped
    expert kernel."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    engine = _engine(params, model=MOE_SERVE, cache_mode="slot", **SPEC_KW)
    engine.warmup(prompt_lens=(64,), max_ctx=512)   # 8 prompts of ~50 tokens, 32 out
    assert engine.attn_impl == "pallas", engine.attn_impl
    counters = {**_counters(MOE_SERVE), "slot_window_attention": sa.slot_window_attention,
                "slot_attention": sa.slot_attention}
    idle = ("slot_attention", fl.fused_qkv_stacked.__name__,
            fl.fused_out_router_stacked.__name__)
    out: dict = {}
    try:
        _zero(counters)
        st0 = dict(engine.stats)
        futs = engine.submit_many([GenerationRequest(
            prompt_ids=engine.tokenizer.encode(f"MoE speculative {i}: the rivers of Europe."),
            max_tokens=32, **GREEDY) for i in range(8)])
        res = [f.result(timeout=600) for f in futs]
        st1 = _settled(engine)
        assert all(len(r.token_ids) >= 1 for r in res)
        out["launches"] = _check_launches("moe-spec", engine, counters, st0, st1, idle)
        dt = st1["decode_time_s"] - st0["decode_time_s"]
        out["spec_tokens_per_step"] = engine.telemetry()["spec_tokens_per_step"]
        out["step_ms"] = 1e3 * dt / ((st1["decode_steps"] - st0["decode_steps"])
                                     * engine.decode_chunk_len)
        out["decode_tok_s"] = (st1["decode_tokens"] - st0["decode_tokens"]) / dt
        log(f"[moe-spec] {card} | 8 greedy requests: completion tokens "
            f"{[r.completion_tokens for r in res]}, {out['spec_tokens_per_step']:.3f} tokens "
            f"per row and verify step, {out['step_ms']:.2f} ms per verify step, "
            f"{out['decode_tok_s']:.1f} tok/s decode")
    finally:
        _release(engine)
    return out


def phase_pallas_serve(card: str, params: dict, xla_long_s: float) -> dict:
    """The paged engine with ``attn_impl="pallas"`` and no prefix cache
    (fresh prefill through B2, decode through ``pallas_paged_attention``),
    then short runs with the other two B6 entries."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    engine = _engine(params, attn_impl="pallas", enable_prefix_cache=False,
                     page_size=64, n_pages=1024)
    engine.warmup(prompt_lens=(64,))
    engine.warmup(prompt_lens=(CTX,), group_sizes=(1,), decode=False)   # the long prompt
    cfg, out = engine.cfg, {"prefill": _check_prefill_programs("pallas", engine)}
    try:
        with _serve_http(engine) as base:
            def chat(content, **kw):
                payload = {"messages": [{"role": "user", "content": content}], **kw}
                return _post(f"{base}/chat/completions", payload)

            fa.flash_attention.launches = pa.pallas_paged_attention.launches = 0
            st0 = dict(engine.stats)
            r = chat(LONG_TEXT, max_tokens=8)
            u = r[1]["usage"]
            assert r[0] == 200 and u["prompt_tokens"] > 2900 and u["completion_tokens"] >= 1, u
            out["long_prompt_s"] = r[2]
            log(f"[pallas] {card} | long prompt: {u['prompt_tokens']} prompt tokens "
                f"answered in {r[2] * 1000:.1f} ms (B2 prefill) against "
                f"{xla_long_s * 1000:.1f} ms on the CLI engine of phase 4 (K2's paged mode)")
            d0 = dict(engine.stats)
            _burst(chat, SLOTS, 64)
            d1 = _settled(engine)
            dt = d1["decode_time_s"] - d0["decode_time_s"]
            out["burst_decode_tok_s"] = (d1["decode_tokens"] - d0["decode_tokens"]) / dt
            out["burst_step_ms"] = 1e3 * dt / ((d1["decode_steps"] - d0["decode_steps"])
                                               * engine.decode_chunk_len)
            steps = (d1["decode_steps"] - st0["decode_steps"]) * engine.decode_chunk_len
            prefills = d1["prefill_dispatches"] - st0["prefill_dispatches"]
            launches = {"flash_attention": fa.flash_attention.launches,
                        "pallas_paged_attention": pa.pallas_paged_attention.launches}
            log(f"[pallas] decode steps {steps}, fresh prefill dispatches {prefills}, "
                f"launches {launches} | full batch of {SLOTS}: "
                f"{out['burst_decode_tok_s']:.1f} tok/s decode "
                f"({out['burst_step_ms']:.2f} ms per decode step)")
            assert launches["flash_attention"] == cfg.n_layers * prefills > 0, launches
            assert launches["pallas_paged_attention"] == cfg.n_layers * steps > 0, launches
            out["launches"] = launches
    finally:
        _release(engine)

    for impl, name in (("pallas2", "pallas_paged_decode"),
                       ("clamp", "pallas_paged_decode_clamp")):
        engine = _engine(params, attn_impl=impl, page_size=64, n_pages=256)
        try:
            fn = getattr(pa, name)
            fn.launches = 0
            st0 = dict(engine.stats)
            futs = engine.submit_many([
                GenerationRequest(prompt_ids=list(range(40 + 9 * i, 90 + 13 * i)),
                                  max_tokens=24) for i in range(4)])
            res = [f.result(timeout=600) for f in futs]
            steps = (engine.stats["decode_steps"] - st0["decode_steps"]) \
                * engine.decode_chunk_len
            assert all(len(r.token_ids) >= 1 for r in res)
            assert fn.launches == cfg.n_layers * steps > 0, (name, fn.launches, steps)
            out["launches"][name] = fn.launches
            log(f"[pallas] attn_impl={impl}: {steps} decode steps, {name} launches "
                f"{fn.launches}")
        finally:
            _release(engine)
    return out


def phase_mla_pallas(card: str, params: dict) -> dict:
    """The MLA model's paged engine with ``attn_impl="pallas"`` and no
    prefix cache: 16 concurrent requests whose fresh prefills take K3's
    prefill mode and whose decode takes K3 through ``pallas_paged_attention``
    (the pool as k and v), each once per layer and prefill or step, K1
    never; B8 and the grouped expert kernel as in phase 21. Its prefill
    programs are replayed and held as phase 21's are."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa

    import torch

    torch.cuda.reset_peak_memory_stats()
    engine = _engine(params, model=MLA_MODEL, attn_impl="pallas", page_size=64, n_pages=256,
                     enable_prefix_cache=False)
    engine.warmup(prompt_lens=(64, 128))   # prompts of 36 to 124 tokens
    assert engine.fresh_prefill
    progs = list(engine._prefill_programs.values())
    log(f"[mla-pallas] warmup: {len(engine._programs)} decode and {len(progs)} prefill "
        f"programs, the prefill ones captured in {sum(p.capture_s for p in progs):.2f} s; "
        f"graph pool {_pool_mib(engine)} MiB; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counters = {**_counters(MLA_MODEL), "paged_attention_latent": pa.paged_attention_latent,
                "pallas_paged_attention": pa.pallas_paged_attention,
                "latent_prefill": pa.latent_prefill}
    out: dict = {"pool_mib": _pool_mib(engine)}
    try:
        out["prefill_programs"] = _check_prefill_programs("mla-pallas", engine)
        _latent_prefill_programs("mla-pallas", engine, {"prefill": out["prefill_programs"]})
        _zero(counters)
        st0 = dict(engine.stats)
        futs = engine.submit_many([GenerationRequest(
            prompt_ids=engine.tokenizer.encode(f"MLA paged {i}: " + "the rivers of Europe. "
                                               * (1 + i % 5)), max_tokens=32)
            for i in range(SLOTS)])
        res = [f.result(timeout=600) for f in futs]
        st1 = _settled(engine)
        assert all(len(r.token_ids) >= 1 for r in res)
        out["launches"] = _check_launches("mla-pallas", engine, counters, st0, st1,
                                          idle=("pallas_paged_attention",))
        out["post_warmup_builds"] = st1["post_warmup_builds"] - st0["post_warmup_builds"]
        assert out["post_warmup_builds"] == 0, out["post_warmup_builds"]
        dt = st1["decode_time_s"] - st0["decode_time_s"]
        out["step_ms"] = 1e3 * dt / ((st1["decode_steps"] - st0["decode_steps"])
                                     * engine.decode_chunk_len)
        out["decode_tok_s"] = (st1["decode_tokens"] - st0["decode_tokens"]) / dt
        log(f"[mla-pallas] {card} | {SLOTS} requests: {out['decode_tok_s']:.1f} tok/s "
            f"decode, {out['step_ms']:.2f} ms per decode step")
    finally:
        _release(engine)
    return out


def phase_attention_reference(params: dict, model: str = "qwen3-8b", tag: str = "reference",
                              **plain_kw) -> None:
    """Slot prefill + B1 decode, and fresh prefill (B2 where the family runs
    it) + B6 decode, against the plain no-cache forward on the served
    weights (24 tokens); on the MLA model both decodes take K3. ``plain_kw``
    keeps the reference off the kernels (``plain_experts``)."""
    import torch

    from deepsearch_tts_tpu_torch.engine.kvcache import init_kv_pages
    from deepsearch_tts_tpu_torch.models.registry import get_model

    fam, dev = get_model(model), params["embed"].device
    cfg, forward = fam.config, fam.forward
    T0, T = 16, 24
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None]
    one = lambda n: torch.tensor([n], device=dev)   # noqa: E731
    latent = getattr(cfg, "latent_cache", False)
    with torch.no_grad():
        free, _ = forward(params, cfg, toks, pos, **plain_kw)
        for label, prefill_kw, decode_kw in (
                ("slot prefill + B1 decode", {},
                 dict(slot_decode=True, slot_ctx=64, page_table=None)),
                ("fresh prefill + B6 decode", dict(fresh_prefill=True), {})):
            kp, vp = init_kv_pages(cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim,
                                   dtype=cfg.torch_dtype, device=dev)
            kw = dict(k_pages=kp, v_pages=vp, page_table=torch.tensor([[0]], device=dev),
                      impl="pallas")
            replay = _RouteReplay(cfg) if latent else None
            with replay.record() if replay else contextlib.nullcontext():
                got = [forward(params, cfg, toks[:, :T0], pos[:, :T0], seq_lens=one(T0),
                               logits_indices=one(T0 - 1), **kw, **prefill_kw)[0][:, 0]]
                for t in range(T0, T):
                    got.append(forward(params, cfg, toks[:, t:t + 1], pos[:, t:t + 1],
                                       seq_lens=one(t + 1), fused_decode=True,
                                       **{**kw, **decode_kw})[0][:, 0])
            ref = free
            if replay:
                with replay.replay():
                    ref, _ = forward(params, cfg, toks, pos, **plain_kw)
                log(f"[{tag}] {label}: routing replayed, the reference's own expert set "
                    f"differs on {replay.differ} of {replay.rows} rows")
            _hold_to_reference(tag, label, torch.cat(got), ref[0, T0 - 1:],
                               free[0, T0 - 1:] if replay else None)


# ------------------------------------------------------------ product phase
#
# The agent pipeline of cli/deep_search.py on the card. Part 1 replays the
# scripted scenario of tests/test_product_path_engine.py (position-scripted
# families whose greedy decode at position p emits script[p + 1], the
# scripts computed from a dry run of the port's own agent stack with
# recording clients): exact answers, two searches, prefix reuse. Part 2
# serves qwen3-8b at full width (random weights) with qwen3-4b co-served as
# the aux through every mode; random weights make no tool calls, so part 1
# is the check of the loop and part 2 of the engines and their kernels.


def _tool_call_text(query: str, intent: str) -> str:
    body = json.dumps({"name": "deep_websearch",
                       "arguments": {"search_query": query, "search_intent": intent}},
                      ensure_ascii=False)
    # the leading newline of ChatTemplate's re-render of a tool-call turn:
    # turn N+1's prompt is then a byte-exact extension of turn N's
    return "\n<tool_call>\n" + body + "\n</tool_call>"


SCRIPT_QUESTION = "What is the capital of France? Answer with the city name."
SCRIPT_MAIN = [_tool_call_text("capital of France", "find the capital city of France"),
               _tool_call_text("Paris population", "find the population of Paris"),
               "I found it. The capital of France is \\boxed{Paris}."]
SCRIPT_AUX = ["**Final Information**\nParis is the capital of France.",
              "**Final Information**\nAbout 2.1 million people live in Paris proper."]
REPLAY_STORE = {
    "searches": {
        "capital of France": [
            {"id": 1, "title": "France - Factbook", "url": "https://example.org/france",
             "site_name": "example.org", "date": "2024-01-01",
             "snippet": "Paris is the capital and largest city of France."},
            {"id": 2, "title": "Geography of France", "url": "https://example.org/geo",
             "site_name": "example.org", "date": "2024-01-02",
             "snippet": "France's capital city is Paris, on the Seine."}],
        "Paris population": [
            {"id": 1, "title": "Paris demographics", "url": "https://example.org/paris-pop",
             "site_name": "example.org", "date": "2024-02-01",
             "snippet": "The city of Paris has about 2.1 million residents within its "
                        "administrative limits."}],
    },
    "pages": {
        "https://example.org/france":
            "France is a country in Western Europe. Paris is the capital and largest city "
            "of France. It is known for the Eiffel Tower and the Louvre.",
        "https://example.org/geo":
            "Geography of France. France's capital city is Paris, on the Seine. The "
            "country borders Belgium, Germany, and Spain.",
        "https://example.org/paris-pop":
            "Paris demographics. The city of Paris has about 2.1 million residents within "
            "its administrative limits. The wider metropolitan area holds over 12 million "
            "people.",
    },
}
PRODUCT_QUESTIONS = [SCRIPT_QUESTION, "How many people live in Paris proper?",
                     "Which river runs through Paris?", "Which countries border France?"]


class _Recorder:
    """A model client that plays planned replies in order and records
    (prompt, reply) pairs."""

    def __init__(self, chat_replies=(), complete_replies=()):
        self.chat_replies, self.complete_replies = list(chat_replies), list(complete_replies)
        self.chat_calls, self.complete_calls = [], []

    async def chat(self, messages, tools=None, **opts):
        from deepsearch_tts_tpu_torch.agents.client import ChatResponse
        from deepsearch_tts_tpu_torch.engine.tokenizer import parse_tool_calls

        out = self.chat_replies.pop(0)
        self.chat_calls.append((json.loads(json.dumps(messages)), list(tools or []), out))
        content, calls = parse_tool_calls(out)
        return ChatResponse(type="tool" if calls else "normal", content=content,
                            tool_calls=calls, finish_reason="stop")

    async def complete(self, prompt, **opts):
        from deepsearch_tts_tpu_torch.agents.client import CompletionResponse

        out = self.complete_replies.pop(0)
        self.complete_calls.append((prompt, out))
        return CompletionResponse(out, "stop")


def _token_script(tok, segments):
    """Reply ids (+ EOS) written at each prompt's encoded length, on the
    card; writes that overlap must agree."""
    import torch

    script = torch.full((SCRIPT_LEN,), ord("x"), dtype=torch.int64)
    written: dict[int, int] = {}
    for prompt_text, reply_text in segments:
        p = len(tok.encode(prompt_text))
        for off, t in enumerate(tok.encode(reply_text) + [tok.eos_id]):
            assert written.get(p + off, t) == t, f"script conflict at position {p + off}"
            written[p + off] = t
            script[p + off] = t
    return script.cuda()


def _script_forward(params, cfg, tokens, positions, *, k_pages=None, v_pages=None,
                    logits_indices=None, **kw):
    """Greedy decode at absolute position ``p`` emits ``script[p + 1]``."""
    import torch

    script = params["script"]
    pos = positions
    if logits_indices is not None:
        pos = torch.gather(positions, 1, logits_indices[:, None])
    nxt = script[torch.clamp(pos + 1, 0, script.shape[0] - 1)]
    logits = 30.0 * torch.nn.functional.one_hot(nxt, cfg.vocab_size).to(torch.float32)
    return logits, (k_pages, v_pages)


def _product_argv(mode: str, out: str, extra=()) -> list:
    return ["--mode", mode, "--backend", "engine", "--search_backend", "replay",
            "--replay_path", os.path.join(PRODUCT_DIR, "replay.json"),
            "--output_dir", out, "--device", "cuda",
            "--price_config_path", os.path.join(HERE, "model_config", "aihubmix_price.json"),
            *extra]


@contextlib.contextmanager
def _product_probe():
    """Records, while open, the engines ``cli/deep_search.py`` builds (its
    ``make_clients``), every request an engine is handed (``min_tokens``
    and result) and every prefill group read back (engine, seconds from its
    dispatch, rows, new and cached tokens)."""
    from deepsearch_tts_tpu_torch.cli import deep_search as ds
    from deepsearch_tts_tpu_torch.engine.engine import Engine

    rec = {"engines": [], "requests": [], "prefills": []}
    make_clients, submit, process = (ds.make_clients, Engine.submit,
                                     Engine._prefill_group_process)

    def make(args):
        import torch

        t = time.time()
        main, aux, engine = make_clients(args)
        torch.cuda.synchronize()   # random weights are drawn on the card
        rec["engines"] = [main.engine, aux.engine]
        rec["build_s"] = time.time() - t
        return main, aux, engine

    def sub(self, req):
        fut = submit(self, req)
        rec["requests"].append((self, req.min_tokens, fut))
        return fut

    def pro(self, h):
        process(self, h)
        grp = h["grp"]
        rec["prefills"].append((self, time.monotonic() - h["t0"], len(grp),
                                sum(len(p["suffix"]) for p in grp),
                                sum(p["cached_len"] for p in grp)))

    ds.make_clients, Engine.submit, Engine._prefill_group_process = make, sub, pro
    try:
        yield rec
    finally:
        ds.make_clients, Engine.submit, Engine._prefill_group_process = (make_clients, submit,
                                                                         process)


def _newest(out: str, pattern: str) -> str:
    import glob

    files = sorted(glob.glob(os.path.join(out, pattern)))
    assert files, f"no {pattern} in {out}"
    return files[-1]


def phase_product_scripted() -> dict:
    """Part 1: ``cli/deep_search.py --mode solve --backend engine
    --search_backend replay --device cuda --temperature 0.0`` over the
    scripted families, the scripts as CUDA tensors: the answer, the two
    searches with their queries, the seven message roles, three engine
    requests with prefix reuse, and B5 launched on every sample."""
    import asyncio

    from deepsearch_tts_tpu_torch.agents.policy import PolicyAgent
    from deepsearch_tts_tpu_torch.agents.websearch import WebSearchTool
    from deepsearch_tts_tpu_torch.cli import deep_search as ds
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

    tok = ByteTokenizer()
    out = os.path.join(PRODUCT_DIR, "scripted")
    problems = os.path.join(PRODUCT_DIR, "scripted.json")
    with open(problems, "w", encoding="utf-8") as f:
        json.dump([{"Question": SCRIPT_QUESTION}], f)
    argv = _product_argv("solve", out, [
        "--input_path", problems, "--model_name", "script-main", "--aux_model_name",
        "script-aux", "--engine_max_slots", "4", "--engine_page_size", "16",
        "--engine_pages", "1025", "--engine_max_seq_len", "4096", "--temperature", "0.0",
        "--max_tokens", "512", "--max_search_calls", "5",
        # the scripted families have no prefill-lane path (as in the tests)
        "--engine_prefill_lane", "0"])
    args = ds.build_parser().parse_args(argv)
    # the dry run: the port's own agent stack with recording clients
    backend, fetcher = ds.make_search(args)
    main, aux = _Recorder(chat_replies=SCRIPT_MAIN), _Recorder(complete_replies=SCRIPT_AUX)
    gen = {"temperature": args.temperature, "top_p": args.top_p, "min_p": args.min_p,
           "top_k_sampling": args.top_k_sampling,
           "repetition_penalty": args.repetition_penalty,
           "max_tokens": min(args.max_tokens, 16384)}
    agent = PolicyAgent(main, search_tool=WebSearchTool(backend, fetcher, aux,
                                                        top_k=args.top_k, gen_opts=gen),
                        max_search_calls=args.max_search_calls, gen_opts=gen)
    assert asyncio.run(agent.solve(SCRIPT_QUESTION)).answer == "Paris"
    scripts = {
        "script-main": _token_script(tok, (
            (tok.apply_chat_template(m, t, add_generation_prompt=True), o)
            for m, t, o in main.chat_calls)),
        "script-aux": _token_script(tok, aux.complete_calls)}
    _register_scripts(scripts)
    sp.sampling_prep.launches = 0
    t0 = time.time()
    with _product_probe() as rec:
        ds.main(argv)
    wall = time.time() - t0
    row, = json.load(open(_newest(out, "policy_results_*.json"), encoding="utf-8"))
    stats = json.load(open(_newest(out, "statistics_*.json"), encoding="utf-8"))
    assert all(e.device.type == "cuda" for e in rec["engines"]), rec["engines"]
    assert row["pred_answer"] == "Paris", row["pred_answer"]
    assert [w["search_query"] for w in row["web_search"]] == ["capital of France",
                                                              "Paris population"]
    assert "capital of France" in row["web_search"][0]["extracted_info"]
    roles = [m["role"] for m in row["messages"]]
    assert roles == ["system", "user", "assistant", "tool", "assistant", "tool",
                     "assistant"], roles
    assert "\\boxed{Paris}" in row["messages"][-1]["content"]
    eng = stats["engine"]
    assert eng["requests"] == 3, eng
    assert eng["prefix_cache"]["hits"] >= 1 and eng["prefix_cache"]["tokens_reused"] > 0, eng
    samples = sum(sum(_steps(e, dict.fromkeys(e.stats, 0), e.stats)) for e in rec["engines"])
    assert sp.sampling_prep.launches == samples > 0, (sp.sampling_prep.launches, samples)
    res = {"wall_s": wall, "requests": eng["requests"],
           "prefix_hits": eng["prefix_cache"]["hits"],
           "tokens_reused": eng["prefix_cache"]["tokens_reused"],
           "aux_requests": rec["engines"][1].stats["requests"],
           "sampling_prep_launches": sp.sampling_prep.launches}
    log(f"[product-scripted] solve on the card: pred_answer 'Paris', searches "
        f"{[w['search_query'] for w in row['web_search']]}, roles {roles}; engine requests "
        f"{res['requests']} (aux {res['aux_requests']}), prefix hits {res['prefix_hits']}, "
        f"tokens reused {res['tokens_reused']}; B5 launches {res['sampling_prep_launches']} "
        f"(= samples); {wall:.2f} s")
    _unregister(*scripts)
    return res


def phase_product_kernels() -> dict:
    """B3 and B4 at the aux qwen3-4b's widths (hidden 2560, q heads 32 x
    128, F = 9728) against their plain versions, every layer of a two-layer
    stack, at the aux engine's decode batches (B = 1, 4, 8); the inputs
    draw from a generator of their own."""
    import torch

    from deepsearch_tts_tpu_torch.models.common import rope_angles
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl

    dev, bf, L = torch.device("cuda"), torch.bfloat16, 2
    g = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    assert fl.shapes_ok(A_E, A_H * D, A_F, D)
    ln1, ln2 = rnd(L, A_E, scale=0.1) + 1, rnd(L, A_E, scale=0.1) + 1
    qn, kn = rnd(L, D, scale=0.1) + 1, rnd(L, D, scale=0.1) + 1
    wqkv = rnd(L, A_E, (A_H + 2 * A_KV) * D, scale=A_E ** -0.5)
    wo = rnd(L, A_H * D, A_E, scale=(A_H * D) ** -0.5)
    gateup = rnd(L, A_E, 2 * A_F, scale=A_E ** -0.5)
    wd = rnd(L, A_F, A_E, scale=A_F ** -0.5)
    errs = {"fused_qkv_stacked": 0.0, "fused_out_mlp_stacked": 0.0}
    kw = dict(n_heads=A_H, n_kv=A_KV, head_dim=D, eps=1e-6)
    for B in (1, 4, 8):
        x, a = rnd(B, A_E), rnd(B, A_H * D)
        pos = torch.randint(0, 4000, (B,), generator=g, device=dev)
        cos, sin = rope_angles(pos, D, 1_000_000.0)
        for layer in range(L):
            got = fl.fused_qkv_stacked(x, ln1, wqkv, qn, kn, cos, sin, layer, **kw)
            ref = fl.fused_qkv_stacked_plain(x, ln1, wqkv, qn, kn, cos, sin, layer, **kw)
            got4 = fl.fused_out_mlp_stacked(a, x, wo, ln2, gateup, wd, layer, eps=1e-6)
            ref4 = fl.fused_out_mlp_stacked_plain(a, x, wo, ln2, gateup, wd, layer, eps=1e-6)
            torch.cuda.synchronize()
            for gt, r in zip(got, ref):
                torch.testing.assert_close(gt.float(), r.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
                errs["fused_qkv_stacked"] = max(errs["fused_qkv_stacked"], _err(gt, r))
            torch.testing.assert_close(got4.float(), ref4.float(), rtol=BF16_RTOL,
                                       atol=BF16_ATOL)
            errs["fused_out_mlp_stacked"] = max(errs["fused_out_mlp_stacked"], _err(got4, ref4))
    log(f"[product-kernels] B3 / B4 at {PRODUCT_AUX} widths (E={A_E}, H*D={A_H * D}, "
        f"F={A_F}), B = 1, 4, 8: max_abs_err B3 {errs['fused_qkv_stacked']:.3e}, "
        f"B4 {errs['fused_out_mlp_stacked']:.3e}")
    return errs


def _product_rows_ok(mode: str, rows: list, n: int) -> None:
    """The reference trace fields each mode's rows carry (tests/test_cli.py)."""
    assert len(rows) == n, (mode, len(rows), n)
    for r in rows:
        assert {"Question", "pred_answer", "messages", "web_search"} <= set(r), (mode, set(r))
        assert r["pred_answer"] and r["messages"][0]["role"] == "system", (mode, r["messages"][:1])
        if mode.startswith("verify"):
            assert "confidence_score" in r and "verification_searches" in r, (mode, set(r))
        if mode.endswith("budget_forcing"):
            # the nudge, then the re-entry turn
            i = max(k for k, m in enumerate(r["messages"]) if m["role"] == "user")
            assert "additional search" in r["messages"][i]["content"], r["messages"][i]
            assert any(m["role"] == "assistant" for m in r["messages"][i + 1:]), mode
        if mode == "solve_bestofn":
            assert "best_of_n" in r or r["pred_answer"].startswith("Error"), (mode, set(r))


def _product_mode(card: str, counters: dict, mode: str, argv: list, mdir: str,
                  n: int | None) -> dict:
    """One mode of :func:`phase_product` through ``cli/deep_search.py``; the
    engines it builds are gone when it returns."""
    import torch

    from deepsearch_tts_tpu_torch.cli import deep_search as ds

    _zero(counters)
    _free()
    held = _held_gib()
    assert held < 1.0, (mode, held)   # the last mode's engines are gone
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with _product_probe() as rec:
        ds.main(argv)
    wall = time.time() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    main, aux = rec["engines"]
    assert main.device.type == aux.device.type == "cuda"
    assert main.layer_fusion, "the qwen3-8b policy must run the fused decode layers"
    if mode == "solve":
        log(f"[product] {PRODUCT_AUX} aux: layer_fusion={aux.layer_fusion} "
            f"({'B3 / B4' if aux.layer_fusion else 'the layer-by-layer plain decode'}; "
            f"fused_decode_fits at hidden {aux.cfg.hidden}, q heads x head_dim "
            f"{aux.cfg.n_heads * aux.cfg.head_dim})")
    tel = {name: e.telemetry() for name, e in (("main", main), ("aux", aux))}
    counts = {k: _steps(e, dict.fromkeys(e.stats, 0), e.stats)
              for k, e in (("main", main), ("aux", aux))}
    steps = {k: c[0] for k, c in counts.items()}
    samples = sum(sum(c) for c in counts.values())   # steps, prefills, lane chunks
    fused = main.cfg.n_layers * steps["main"] + (
        aux.cfg.n_layers * steps["aux"] if aux.layer_fusion else 0)
    launches = {k: f.launches for k, f in counters.items()}
    log(f"[product:{mode}] decode steps main {steps['main']} aux {steps['aux']}, "
        f"prefill dispatches main {tel['main']['prefill_dispatches']} aux "
        f"{tel['aux']['prefill_dispatches']}, launches {launches}")
    assert launches["fused_qkv_stacked"] == launches["fused_out_mlp_stacked"] == fused, (
        launches, fused)
    assert launches["sampling_prep"] == samples > 0, (launches, samples)
    if mode == "search":
        assert steps["aux"] > 0 and tel["main"]["requests"] == 0, tel
    else:
        assert steps["main"] > 0 and main.cfg.n_layers * steps["main"] > 0
        result = _newest(mdir, ("verifier" if mode.startswith("verify") else "policy")
                         + "_results_*.json")
        rows = json.load(open(result, encoding="utf-8"))
        _product_rows_ok(mode, rows, n)
    if mode == "solve_budget_forcing":
        # logit budget forcing: min_tokens on each trajectory's re-entry
        # turn only, and the engine held EOS back for those tokens
        forced = [f.result() for e, m, f in rec["requests"] if e is main and m]
        assert len(forced) == n and all(
            r.completion_tokens >= 64 for r in forced), [r.completion_tokens for r in forced]
    stats = json.load(open(_newest(mdir, "statistics_*.json"), encoding="utf-8")) \
        if mode != "search" else {}
    who = "aux" if mode == "search" else "main"
    eng = (main, aux)[who == "aux"]
    first = {"s": 0.0, "rows": 0, "tokens": 0}
    for e, dt, g, new, cached in rec["prefills"]:
        # the dispatches of the trajectories' first turns: the first
        # ones of the engine that serves them, one row a trajectory
        if e is eng and first["rows"] < (n or 1):
            first["s"] += dt
            first["rows"] += g
            first["tokens"] += new + cached
    usage = stats.get("token_usage", {}).get("main", {})
    t = tel[who]
    res = {
        "wall_s": wall, "trajectories": n or 1, "build_s": rec["build_s"],
        "policy_turns": tel["main"]["requests"], "aux_requests": tel["aux"]["requests"],
        "prompt_tokens": usage.get("prompt_tokens", sum(
            f.result().prompt_tokens for e, _, f in rec["requests"] if e is eng)),
        "generated_tokens": usage.get("completion_tokens", t["decode_tokens"]),
        "decode_tokens_per_s": t.get("decode_tokens_per_s"),
        "tokens_reused": t.get("prefix_cache", {}).get("tokens_reused"),
        "prefix_hits": t.get("prefix_cache", {}).get("hits"),
        "first_turn_prefill_s": first["s"], "first_turn_prefill_share": first["s"] / wall,
        "first_turn_prompt_tokens": first["tokens"],
        "prefill_s": t["prefill_time_s"], "decode_s": t["decode_time_s"],
        "peak_gib": peak, "engine": who, "launches": launches,
        "aux_layer_fusion": aux.layer_fusion,
    }
    log(f"[product:{mode}] {res['wall_s']:.2f} s wall ({res['build_s']:.2f} s building "
        f"both engines), {res['trajectories']} trajectories, policy turns "
        f"{res['policy_turns']}, aux requests {res['aux_requests']}, prompt tokens "
        f"{res['prompt_tokens']}, generated {res['generated_tokens']}, {who} decode "
        f"{res['decode_tokens_per_s'] or 0:.1f} tok/s, prefix hits {res['prefix_hits']} "
        f"({res['tokens_reused']} tokens reused), first turn's prefill "
        f"{res['first_turn_prefill_s']:.3f} s ({100 * res['first_turn_prefill_share']:.1f} % "
        f"of the wall), peak {peak:.2f} GiB | {card}")
    return res


def _product_phases(card: str) -> dict:
    """The product phase: the scripted scenario, B3 / B4 at the aux's
    widths, then the pipeline at full width; its results by part."""
    import shutil

    shutil.rmtree(PRODUCT_DIR, ignore_errors=True)
    os.makedirs(PRODUCT_DIR)
    with open(os.path.join(PRODUCT_DIR, "replay.json"), "w", encoding="utf-8") as f:
        json.dump(REPLAY_STORE, f)
    out = {"scripted": phase_product_scripted(),
           "aux_width_err": phase_product_kernels()}
    out["modes"] = phase_product(card)
    return out


def phase_product(card: str) -> dict:
    """Part 2: qwen3-8b at its published widths (36 layers, bf16, random
    weights from --seed 0) with qwen3-4b co-served as the aux, through
    ``cli/deep_search.py`` on the card: ByteTokenizer, the replay store,
    four problems at --concurrent_limit 4, --max_tokens 64
    (``PRODUCT_MAX_TOKENS``), --max_search_calls 2, the CLI's default sampler, --engine_pages 1024
    --engine_max_slots 16 (the aux half of each). The paper's pipeline in
    order: solve, verify over its rows, solve_budget_forcing (logit, 64
    forced tokens) over the same rows, solve_bestofn (2 samples, 2
    problems), and search (the aux's complete through the explorer). Each
    mode's rows are checked; B3 / B4 must count 36 a decode step of each
    engine that runs the fused decode, B5 one a sample."""
    import torch

    problems = os.path.join(PRODUCT_DIR, "problems.json")
    with open(problems, "w", encoding="utf-8") as f:
        json.dump([{"Question": q, "answer": "Paris", "id": i}
                   for i, q in enumerate(PRODUCT_QUESTIONS[:PRODUCT_PROBLEMS])], f)
    common = ["--model_name", PRODUCT_MAIN, "--aux_model_name", PRODUCT_AUX, "--seed", "0",
              "--concurrent_limit", "4", "--max_tokens", str(PRODUCT_MAX_TOKENS),
              "--max_search_calls", "2",
              "--engine_pages", str(PRODUCT_PAGES), "--engine_max_slots", str(SLOTS)]
    solved = os.path.join(PRODUCT_DIR, "solve")
    modes = [
        ("solve", solved, ["--input_path", problems], PRODUCT_PROBLEMS),
        ("verify", os.path.join(PRODUCT_DIR, "verify"), ["--input_path", None],
         PRODUCT_PROBLEMS),
        ("solve_budget_forcing", os.path.join(PRODUCT_DIR, "sbf"),
         ["--input_path", None, "--budget_forcing", "logit", "--min_thinking_tokens", "64"],
         PRODUCT_PROBLEMS),
        ("solve_bestofn", os.path.join(PRODUCT_DIR, "bestofn"),
         ["--input_path", problems, "--n_samples", "2", "--limit", "2"], 2),
        ("search", os.path.join(PRODUCT_DIR, "search"),
         ["--query", "capital of France", "--context", "find the capital city of France"],
         None),
    ]
    counters = _counters(PRODUCT_MAIN)
    out: dict = {}
    for mode, mdir, extra, n in modes:
        extra = [_newest(solved, "policy_results_*.json") if a is None else a for a in extra]
        out[mode] = _product_mode(card, counters, mode,
                                  _product_argv(mode, mdir, common + extra), mdir, n)
    _free()
    held = _held_gib()
    log(f"[product] engines released: {held:.3f} GiB still allocated")
    assert held < 1.0, held
    return out


# --------------------------------------------------------------------- eval
# cli/evaluate.py judges the product phase's solve rows with an LLM judge
# over HTTP on a qwen3-8b engine at full width; cli/lcb_run.py,
# cli/report.py and the in-band demo run with --backend engine on scripted
# families, whose exact outcomes a dry run with recording clients fixes.

EVAL_DIR = os.path.join(PRODUCT_DIR, "eval")
# known metric values of cli/evaluate's math and code tasks (the math
# grader takes the first four rows; the code task's second program is wrong)
EVAL_MATH_ROWS = [
    {"Question": "Half of one?", "answer": "0.5", "pred_answer": "\\boxed{\\frac{1}{2}}"},
    {"Question": "Percent?", "answer": "50%", "Output": "so \\boxed{0.5}"},
    {"Question": "Root?", "answer": "2", "pred_answer": "\\boxed{\\sqrt{4}}"},
    {"Question": "Factor?", "answer": "(x-1)(x+1)", "pred_answer": "\\boxed{x^2-1}"},
    {"Question": "Wrong?", "answer": "3", "pred_answer": "\\boxed{4}"},
    {"Question": "Planet?", "answer": "5", "pred_answer": "\\boxed{Jupiter}"},
    {"Question": "Gave up?", "answer": "7", "pred_answer": "I give up"},
]
EVAL_CODE_ROWS = [
    {"Question": "double", "pred_answer": "print(int(input()) * 2)",
     "test_cases": [{"input": "2\n", "expected_output": "4\n"}]},
    {"Question": "double", "Output": "```python\nprint(int(input()) + 2)\n```",
     "test_cases": [{"input": "3\n", "expected_output": "6\n"}]},
    {"Question": "inc", "pred_answer": "def inc(x):\n    return x + 1",
     "test_cases": [{"fn_name": "inc", "args": [1], "expected": 2}]},
]
JUDGE_TOKENS = 8         # cli/evaluate.py's max_tokens of a judge request
LCB_TIMEOUT = 3          # lcb_run's --timeout (seconds a test may run)
# codegen problems: (question, program, status); the questions differ in
# length, so the replies' script positions do not overlap
LCB_CODEGEN = [
    ("Read one line from standard input and print it back unchanged.",
     "print(input())", "pass"),
    ("Read an integer n from standard input and print twice its value. "
     + "Keep the program short. " * 6, "print(input())", "fail"),
    ("Print the number 1 after a long pause. " + "Take your time over it. " * 16,
     f"import time\ntime.sleep({10 * LCB_TIMEOUT})\nprint(1)", "timeout"),
]
LCB_EXEC = {"question_id": "q1", "contest_id": "c1", "contest_date": "2024-01-01",
            "difficulty": "easy", "function_name": "f", "code": "def f(x):\n    return x + 1",
            "input": "f(x = 1)", "output": "2", "id": "e1", "problem_id": "p1", "numsteps": 3}
LCB_TOP = {"question_title": "Add", "question_content": "Add one.", "question_id": "q9",
           "contest_id": "c1", "contest_date": "2024-01-01", "difficulty": "easy",
           "starter_code": "def addOne(x):\n    ...", "function_name": "addOne", "test_id": 2,
           "test": json.dumps([{"input": "5", "output": "6", "testtype": "functional"}])}
REPORT_QUESTION = "How do tides work?"
# the report's seven calls: plan, write / check a section twice, final,
# title; lengths chosen so that no two replies' script positions overlap
REPORT_REPLIES = [
    json.dumps({"sections": [{"name": "Forces"}, {"name": "Cycles"}]}),
    "## Forces\nThe moon pulls the oceans.", "OK", "## Cycles\nTwo tides a day.", "OK",
    "# Tides\nThe moon's pull makes two tides a day.", "How Tides Work"]
DEMO_QUESTION = "What is the capital of France?"
DEMO_SEARCH = ("I should look this up. <|begin_search_query|>capital of France"
               "<|end_search_query|>")
DEMO_PAST_STOP = " and more"    # the scripted reply goes on past the stop string
DEMO_ANSWER = "The results say Paris. \\boxed{Paris}"
DEMO_AUX = ["find the capital city of France",
            "**Final Information**\nParis is the capital of France."]
# the scripted engines: the CLI flags the product phase's scripted part uses
SCRIPTED_FLAGS = ["--device", "cuda", "--engine_max_slots", "4", "--engine_page_size", "16",
                  "--engine_pages", "1025", "--engine_max_seq_len", "4096",
                  "--engine_prefill_lane", "0"]


def _register_scripts(scripts: dict) -> None:
    """Register each ``name: script`` (a CUDA tensor) as a family whose
    greedy decode replays it (:func:`_script_forward`)."""
    import torch

    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
    from deepsearch_tts_tpu_torch.models import registry

    class ScriptCfg:
        vocab_size = ByteTokenizer().vocab_size
        n_layers = 1
        n_kv_heads = 1
        head_dim = 8
        torch_dtype = torch.float32
        custom_init = True

    for name, script in scripts.items():
        registry.register(name, ScriptCfg(), _script_forward,
                          init_params=lambda cfg, *, seed, device, s=script: {"script": s})


def _unregister(*names) -> None:
    from deepsearch_tts_tpu_torch.models import registry

    for name in names:
        registry.MODEL_REGISTRY.pop(name)


def _printed(fn, argv) -> str:
    """What ``fn(argv)`` prints (a CLI's ``main``); echoed to the log."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    out = buf.getvalue()
    for line in out.splitlines()[-8:]:
        log(f"    | {line[:160]}")
    return out


def _samples(engines) -> int:
    """B5's calls of the ``engines`` (each once): steps, prefills, lane
    chunks since they were built."""
    uniq = {id(e): e for e in engines}.values()
    return sum(sum(_steps(e, dict.fromkeys(e.stats, 0), e.stats)) for e in uniq)


def _part_done(tag: str, t0: float, res: dict) -> dict:
    import torch

    torch.cuda.synchronize()
    res.update(wall_s=time.time() - t0, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    _free()
    held = _held_gib()
    log(f"[eval:{tag}] {res['wall_s']:.2f} s wall, peak {res['peak_gib']:.2f} GiB, "
        f"{held:.3f} GiB still allocated after")
    assert held < 1.0, (tag, held)
    return res


def phase_eval_judge(card: str) -> dict:
    """Full width: an ``OpenAIServer`` over a qwen3-8b paged engine (random
    weights from seed 0, 16 slots, 1024 pages of 64, prefix cache, the lane
    of 16); ``cli/evaluate.py --task qa --use_llm`` judges the product
    phase's solve rows through it: both metrics files, one 8-token judge
    request a row, B3 / B4 36 a decode step, B5 one a sample. With the
    engine alive, ``--task math --use_math_grader`` and ``--task code``
    give their known metric values."""
    import shutil

    import torch

    from deepsearch_tts_tpu_torch.cli import evaluate
    from deepsearch_tts_tpu_torch.engine.engine import Engine
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer

    os.makedirs(EVAL_DIR, exist_ok=True)
    solved = os.path.join(EVAL_DIR, "policy_results_solve.json")
    shutil.copy(_newest(os.path.join(PRODUCT_DIR, "solve"), "policy_results_*.json"), solved)
    rows = json.load(open(solved, encoding="utf-8"))
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    engine = Engine(PRODUCT_MAIN, ByteTokenizer(), device="cuda", seed=0, max_slots=SLOTS,
                    page_size=64, n_pages=PRODUCT_PAGES, max_seq_len=CTX, prefill_lane=LANE)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    assert engine.device.type == "cuda" and engine.layer_fusion
    counters = _counters(PRODUCT_MAIN)
    seen = []
    submit = Engine.submit

    def sub(self, req):
        fut = submit(self, req)
        seen.append((req.max_tokens, fut))
        return fut

    Engine.submit = sub
    try:
        with _serve_http(engine) as base:
            _zero(counters)
            st0 = dict(engine.stats)
            t1 = time.time()
            _printed(evaluate.main, ["--output_path", solved, "--task", "qa", "--use_llm",
                                     "--api_base_url", base, "--model_name", PRODUCT_MAIN])
            judge_s = time.time() - t1
            st1 = _settled(engine)
            launches = _check_launches("eval-judge", engine, counters, st0, st1)
            # host-only tasks with the engine (its thread and CUDA context) alive
            math_path = os.path.join(EVAL_DIR, "math.json")
            code_path = os.path.join(EVAL_DIR, "code.json")
            json.dump(EVAL_MATH_ROWS, open(math_path, "w", encoding="utf-8"))
            json.dump(EVAL_CODE_ROWS, open(code_path, "w", encoding="utf-8"))
            t2 = time.time()
            math = json.loads(_printed(evaluate.main, ["--output_path", math_path, "--task",
                                                       "math", "--use_math_grader"]))
            t3 = time.time()
            code = json.loads(_printed(evaluate.main, ["--output_path", code_path,
                                                       "--task", "code"]))
            math_s, code_s = t3 - t2, time.time() - t3
    finally:
        Engine.submit = submit
    per_item = json.load(open(solved + ".metrics.json", encoding="utf-8"))
    overall = json.load(open(solved + ".metrics.overall.json", encoding="utf-8"))
    assert len(per_item) == overall["total"] == len(rows) > 0, (len(per_item), overall)
    assert all("llm_rationale" in r and not r["llm_rationale"].startswith(("Error",
                                                                          "judge-error"))
               for r in per_item), [r.get("llm_rationale") for r in per_item]
    results = [f.result() for _, f in seen]
    assert len(seen) == len(rows) and all(m == JUDGE_TOKENS for m, _ in seen), seen
    assert all(r.completion_tokens == JUDGE_TOKENS or r.finish_reason == "stop"
               for r in results), [(r.completion_tokens, r.finish_reason) for r in results]
    steps, prefills, lanes = _steps(engine, st0, st1)
    assert math["llm_equal"] == 4 / 7 and math["total"] == 7, math
    assert code == {"pass@1": 2 / 3}, code
    tel = engine.telemetry()
    prefill_s = st1["prefill_time_s"] - st0["prefill_time_s"]
    decode_s = st1["decode_time_s"] - st0["decode_time_s"]
    res = {"rows": len(rows), "build_s": build_s, "judge_s": judge_s,
           "judge_s_per_row": judge_s / len(rows), "decode_steps": steps,
           "prefill_dispatches": prefills, "lane_chunks": lanes, "prefill_s": prefill_s,
           "decode_s": decode_s, "decode_ms_per_step": 1e3 * decode_s / steps,
           "completion_tokens": [r.completion_tokens for r in results],
           "prompt_tokens": [r.prompt_tokens for r in results],
           "prefix_hits": tel.get("prefix_cache", {}).get("hits"),
           "llm_equal": overall["llm_equal"], "math_llm_equal": math["llm_equal"],
           "code_pass@1": code["pass@1"], "math_task_s": math_s, "code_task_s": code_s,
           "launches": launches}
    log(f"[eval:judge] {len(rows)} rows judged over HTTP in {judge_s:.2f} s "
        f"({res['judge_s_per_row']:.3f} s a row; engine built in {build_s:.2f} s): "
        f"prompt tokens {res['prompt_tokens']}, completion tokens "
        f"{res['completion_tokens']}, decode steps {steps} ({res['decode_ms_per_step']:.2f} "
        f"ms a step, {decode_s:.3f} s), prefill dispatches {prefills} ({prefill_s:.3f} s), "
        f"lane chunks {lanes}, llm_equal {overall['llm_equal']}; with the engine alive: math "
        f"(grader) llm_equal {math['llm_equal']:.4f} in {math_s:.2f} s, code pass@1 "
        f"{code['pass@1']:.4f} in {code_s:.2f} s | {card}")
    _release(engine)
    del engine, seen, results
    return _part_done("judge", t0, res)


def _lcb_run(scenario: str, path: str, name: str, replies: list) -> dict:
    """``cli/lcb_run.main --backend engine`` on the scripted family ``name``
    (one reply a problem); the metrics printed, the per-problem results
    scored, and whether the policy engine's thread was alive while they
    were (the unused aux engine never starts one)."""
    import torch

    from deepsearch_tts_tpu_torch.cli import lcb_run
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
    from deepsearch_tts_tpu_torch.evaluate import code_eval, lcb_benchmarks, lcb_prompts
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

    tok = ByteTokenizer()
    if scenario == "codegen":
        rows, msgs = json.load(open(path, encoding="utf-8")), lcb_prompts.codegen_messages
    else:
        scen = {"codeexecution": "codeexecution", "testoutput": "testoutputprediction"}
        rows = lcb_benchmarks.load_scenario_rows(path, scen[scenario])
        msgs = {"codeexecution": lcb_prompts.code_execution_messages,
                "testoutput": lcb_prompts.test_output_prediction_messages}[scenario]
    _register_scripts({name: _token_script(tok, (
        (tok.apply_chat_template(msgs(r, name), add_generation_prompt=True), out)
        for r, out in zip(rows, replies)))})
    fn = {"codegen": "codegen_metrics", "codeexecution": "code_execution_metrics",
          "testoutput": "test_output_metrics"}[scenario]
    scored = {}
    metrics_fn = getattr(code_eval, fn)

    def probe(*a, **kw):
        th = rec["engines"][0]._thread
        scored["thread_alive"] = th is not None and th.is_alive()
        out = metrics_fn(*a, **kw)
        scored["per_problem"] = out["per_problem"]
        return out

    setattr(code_eval, fn, probe)
    sp.sampling_prep.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        with _product_probe() as rec:
            argv = ["--input_path", path, "--scenario", scenario, "--backend", "engine",
                    "--model_name", name, "--timeout", str(LCB_TIMEOUT),
                    "--output_dir", os.path.join(EVAL_DIR, "lcb")] + SCRIPTED_FLAGS
            if scenario == "codegen":
                argv += ["--num_workers", "2"]
            out = _printed(lcb_run.main, argv)
    finally:
        setattr(code_eval, fn, metrics_fn)
        _unregister(name)
    metrics = json.loads("".join(ln for ln in out.splitlines()
                                 if not ln.startswith("generations")))
    engines = rec["engines"]
    assert [e.device.type for e in engines] == ["cuda", "cuda"], engines
    samples = _samples(engines)
    assert sp.sampling_prep.launches == samples > 0, (sp.sampling_prep.launches, samples)
    assert scored["thread_alive"], scored
    res = {"metrics": metrics, "per_problem_pass@1": [
        code_eval.pass_at_k(p["n"], p["correct"], 1) for p in scored["per_problem"]],
        "samples": samples, "sampling_prep_launches": sp.sampling_prep.launches,
        "aux_layers": engines[1].cfg.n_layers}
    if scenario == "codegen":
        res["statuses"] = [p["details"][0][0]["status"] for p in scored["per_problem"]]
    del rec, engines
    return _part_done(f"lcb-{scenario}", t0, res)


def phase_eval_lcb() -> dict:
    """``cli/lcb_run.py --backend engine --device cuda`` per scenario on
    scripted families (and ``deep_search``'s qwen3-4b aux, built and not
    used, as in JAX): codegen over a correct program, a wrong one and one
    that sleeps past ``--timeout``, scored by two forked workers while the
    policy engine's thread runs: pass@1 1, 0, 0, statuses pass / fail /
    timeout;
    codeexecution and testoutput 1.0 each."""
    os.makedirs(EVAL_DIR, exist_ok=True)
    paths = {s: os.path.join(EVAL_DIR, f"lcb_{s}.json") for s in
             ("codegen", "codeexecution", "testoutput")}
    json.dump([{"id": f"p{i}", "question_content": q,
                "test_cases": [{"input": inp, "expected_output": want}]}
               for i, ((q, _, _), (inp, want)) in enumerate(zip(
                   LCB_CODEGEN, (("hello\n", "hello\n"), ("4\n", "8\n"), ("", "1\n"))))],
              open(paths["codegen"], "w", encoding="utf-8"))
    json.dump([LCB_EXEC], open(paths["codeexecution"], "w", encoding="utf-8"))
    json.dump([LCB_TOP], open(paths["testoutput"], "w", encoding="utf-8"))
    out = {
        "codegen": _lcb_run("codegen", paths["codegen"], "script-lcb-codegen",
                            [f"```python\n{prog}\n```" for _, prog, _ in LCB_CODEGEN]),
        "codeexecution": _lcb_run("codeexecution", paths["codeexecution"],
                                  "script-lcb-exec", ["assert f(x = 1) == 2\n[/ANSWER]"]),
        "testoutput": _lcb_run("testoutput", paths["testoutput"], "script-lcb-top",
                               ["```\nassert addOne(5) == 6\n```"]),
    }
    cg = out["codegen"]
    assert cg["per_problem_pass@1"] == [1.0, 0.0, 0.0], cg
    assert cg["statuses"] == [s for _, _, s in LCB_CODEGEN], cg
    assert cg["metrics"] == {"pass@1": 1 / 3}, cg
    assert out["codeexecution"]["metrics"] == {"pass@1": 1.0}, out["codeexecution"]
    assert out["testoutput"]["metrics"] == {"pass@1": 1.0}, out["testoutput"]
    log(f"[eval:lcb] codegen pass@1 per problem {cg['per_problem_pass@1']} (statuses "
        f"{cg['statuses']}, scored by 2 forked workers with the engine thread alive), "
        f"codeexecution {out['codeexecution']['metrics']}, testoutput "
        f"{out['testoutput']['metrics']}")
    return out


def phase_eval_report() -> dict:
    """``cli/report.py --backend engine --device cuda`` on a scripted family
    (policy and aux alike): the title, plan, section names and report equal
    a dry run of ``generate_report`` with recording clients."""
    import asyncio

    import torch

    from deepsearch_tts_tpu_torch.agents.report import generate_report
    from deepsearch_tts_tpu_torch.agents.websearch import WebSearchTool
    from deepsearch_tts_tpu_torch.cli import deep_search as ds
    from deepsearch_tts_tpu_torch.cli import report
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

    name, tok = "script-report", ByteTokenizer()
    os.makedirs(EVAL_DIR, exist_ok=True)
    path = os.path.join(EVAL_DIR, "report.json")
    json.dump([{"Question": REPORT_QUESTION, "id": 1}], open(path, "w", encoding="utf-8"))
    # the dry run: report.py's search stack (an empty replay store: the CLI
    # takes no --replay_path) with a recording client
    ds_args = ds.build_parser().parse_args(["--search_backend", "replay"])
    backend, fetcher = ds.make_search(ds_args)
    rec_client = _Recorder(complete_replies=REPORT_REPLIES)
    dry = asyncio.run(generate_report(REPORT_QUESTION, rec_client, WebSearchTool(
        backend, fetcher, rec_client, use_explorer=False)))
    assert not rec_client.complete_replies
    _register_scripts({name: _token_script(tok, rec_client.complete_calls)})
    sp.sampling_prep.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out_dir = os.path.join(EVAL_DIR, "report")
    try:
        with _product_probe() as rec:
            _printed(report.main, ["--input_path", path, "--output_dir", out_dir,
                                   "--backend", "engine", "--model_name", name,
                                   "--aux_model_name", name] + SCRIPTED_FLAGS)
    finally:
        _unregister(name)
    row, = json.load(open(_newest(out_dir, "report_results_*.json"), encoding="utf-8"))
    assert "error" not in row, row
    assert (row["title"], row["plan"], row["sections"], row["report"]) == (
        dry.title, dry.plan, [s["name"] for s in dry.sections], dry.report), (row, dry)
    engine = rec["engines"][0]
    assert rec["engines"][1] is engine and engine.device.type == "cuda"
    samples = _samples([engine])
    assert sp.sampling_prep.launches == samples > 0, (sp.sampling_prep.launches, samples)
    res = {"title": row["title"], "sections": row["sections"],
           "requests": engine.stats["requests"], "samples": samples,
           "prefix_hits": engine.telemetry()["prefix_cache"]["hits"]}
    assert res["requests"] == len(rec_client.complete_calls), res
    log(f"[eval:report] title {row['title']!r}, sections {row['sections']}, "
        f"{res['requests']} engine requests, B5 launches {samples} (= samples)")
    del rec, engine
    return _part_done("report", t0, res)


def phase_eval_demo() -> dict:
    """The in-band demo (``build_demo_session("engine")`` +
    ``run_inband_agent``) on scripted policy and aux families on the card:
    the policy's first reply runs past ``<|end_search_query|>``; the events
    (text cut at the stop string, search, result, text, final) equal a dry
    run's, and the second policy call re-enters the first one's prefix."""
    import asyncio

    import torch

    from deepsearch_tts_tpu_torch.agents.websearch import WebSearchTool
    from deepsearch_tts_tpu_torch.cli import deep_search as ds
    from deepsearch_tts_tpu_torch.cli.demo import build_demo_session
    from deepsearch_tts_tpu_torch.demo.environment import Environment
    from deepsearch_tts_tpu_torch.demo.inband import run_inband_agent
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

    main_name, aux_name, tok = "script-demo-main", "script-demo-aux", ByteTokenizer()
    extra = ["--search_backend", "replay", "--replay_path",
             os.path.join(PRODUCT_DIR, "replay.json")] + SCRIPTED_FLAGS

    async def events(session):
        return [(e.kind, e.payload)
                async for e in run_inband_agent(DEMO_QUESTION, *session)]

    backend, fetcher = ds.make_search(ds.build_parser().parse_args(extra))
    main = _Recorder(complete_replies=[DEMO_SEARCH, DEMO_ANSWER])
    aux = _Recorder(complete_replies=DEMO_AUX)
    dry = asyncio.run(events((Environment(model_name=main_name, aux_model_name=aux_name,
                                          max_search_limit=10), main, aux,
                              WebSearchTool(backend, fetcher, aux))))
    assert not main.complete_replies and not aux.complete_replies
    (p1, _), (p2, _) = main.complete_calls
    _register_scripts({
        main_name: _token_script(tok, [(p1, DEMO_SEARCH + DEMO_PAST_STOP), (p2, DEMO_ANSWER)]),
        aux_name: _token_script(tok, aux.complete_calls)})
    sp.sampling_prep.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        with _product_probe() as rec:
            session = build_demo_session("engine", main_name, aux_name, max_search_calls=10,
                                         extra_args=extra)
            got = asyncio.run(events(session))
            ds.shutdown_engines(session[1], session[2])
    finally:
        _unregister(main_name, aux_name)
    engines = rec["engines"]
    assert [e.device.type for e in engines] == ["cuda", "cuda"], engines
    assert got == dry, (got, dry)
    assert [k for k, _ in got] == ["text", "search", "result", "text", "final"], got
    assert got[0] == ("text", DEMO_SEARCH) and got[-1] == ("final", "Paris"), got
    tel = engines[0].telemetry()
    hit = [(new, cached) for e, _, _, new, cached in rec["prefills"] if e is engines[0]]
    assert tel["requests"] == 2 and len(hit) == 2 and hit[1][1] > 0, (tel, hit)
    samples = _samples(engines)
    assert sp.sampling_prep.launches == samples > 0, (sp.sampling_prep.launches, samples)
    res = {"events": [k for k, _ in got], "cut_reply": got[0][1],
           "second_call_cached_tokens": hit[1][1], "second_call_new_tokens": hit[1][0],
           "prefix_hits": tel["prefix_cache"]["hits"], "samples": samples}
    log(f"[eval:demo] events {res['events']}, first reply cut at the stop string "
        f"({got[0][1]!r}), second policy call {hit[1][1]} tokens from the prefix cache + "
        f"{hit[1][0]} new, B5 launches {samples} (= samples)")
    del rec, engines, session
    return _part_done("demo", t0, res)


def phase_eval(card: str) -> dict:
    """The eval phase (after the product phase, whose solve rows and replay
    store it reuses): the judge at full width, then LCB, report and the
    demo on scripted families; each part's wall seconds and peak GiB."""
    t0 = time.time()
    out = {"judge": phase_eval_judge(card), "lcb": phase_eval_lcb(),
           "report": phase_eval_report(), "demo": phase_eval_demo()}
    out["wall_s"] = time.time() - t0
    log(f"[eval] phase {out['wall_s']:.2f} s | {card}")
    return out


def _post(url: str, payload: dict, timeout: float = 600.0) -> tuple[int, dict, float]:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


def _burst(chat, n: int, max_tokens: int, **sampler) -> list:
    """n concurrent chat requests (temperature 0.7 unless ``sampler`` says
    otherwise); returns their (status, body, seconds)."""
    results = [None] * n
    sampler = {"temperature": 0.7, **sampler}

    def worker(i):
        results[i] = chat(f"Burst {i}: write a long story.", max_tokens=max_tokens, **sampler)

    ths = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=600)
    for r in results:
        assert r is not None and r[0] == 200, r
    return results


def _profile_burst(chat, engine) -> float:
    """One more full-batch burst under torch.profiler: device time by kernel
    and the share of the window in which no kernel ran (returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _burst(chat, SLOTS, 32)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events)
    log(f"[profile] window {wall_us / 1e3:.1f} ms, kernels busy {busy / 1e3:.1f} ms, "
        f"device idle share {1 - busy / wall_us:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} calls  "
            f"{e.key[:90]}")
    spans = engine.telemetry()["spans"]
    log(f"[profile] engine spans {json.dumps(spans)}")
    return 1 - busy / wall_us


def _counters(model: str, int8: bool = False) -> dict:
    """The launch counters of ``model``'s decode path: name → wrapper (B5,
    and B3 + B4 for qwen3-8b, B3 + B7 + the grouped expert entries for
    qwen3-30b-a3b, B10's two entries + its int8 product for qwen3-32b, B8 +
    the grouped expert entries for the MLA model; ``int8`` qwen3-30b-a3b:
    the int8 grouped expert entries + the int8 product, and the bf16 grouped
    expert entries, which must stay at 0)."""
    from deepsearch_tts_tpu_torch.ops import fused_layer as fl
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp

    model = {MOE_SERVE: MOE_MODEL, I8_SERVE: I8_MODEL}.get(model, model)
    if int8 and model == MOE_MODEL:
        fns = [moe.grouped_gateup_i8, moe.grouped_down_i8, fl.int8_product,
               moe.grouped_gateup, moe.grouped_down]
        return {f.__name__: f for f in fns + [sp.sampling_prep]}
    fns = {MOE_MODEL: [fl.fused_qkv_stacked, fl.fused_out_router_stacked,
                       moe.grouped_gateup, moe.grouped_down],
           I8_MODEL: [fl.fused_qkv_stacked_i8, fl.fused_out_mlp_stacked_i8,
                      fl.int8_product],
           MLA_MODEL: [fl.fused_mlp_stacked, moe.grouped_gateup,
                       moe.grouped_down]}.get(model, [fl.fused_qkv_stacked,
                                                      fl.fused_out_mlp_stacked])
    return {f.__name__: f for f in fns + [sp.sampling_prep]}


def _zero(counters: dict) -> None:
    """Set every launch counter of ``counters`` (name → wrapper) to 0."""
    for f in counters.values():
        f.launches = 0
        for a in ("prefill_launches", "i8_launches"):
            if hasattr(f, a):
                setattr(f, a, 0)


def _check_launches(tag: str, engine, counters: dict, st0: dict, st1: dict,
                    idle=()) -> dict:
    """Read the counters after a phase and hold them to the phase's work:
    B3, B4/B7, B10, B8 (MLA: 3 dense MLPs + 2 shared experts), B1, B9, K1
    and K3 once per layer and decode (or verify) step, K2's paged mode and
    K3's prefill mode once per layer and prefill dispatch, each grouped
    expert entry
    once per MoE layer and forward (decode steps + prefill dispatches), B5
    once per sample, the int8 product at least once per forward (the
    lm_head; and the layer products of prefills of up to
    ``quant.INT8_PRODUCT_ROWS`` rows); the
    counters named in ``idle`` not at all."""
    L = engine.cfg.n_layers
    L_moe = L - getattr(engine.cfg, "first_k_dense", 0)   # MLA leads with dense layers
    steps, prefills, lanes = _steps(engine, st0, st1)
    launches = {n: f.launches for n, f in counters.items()}
    log(f"[{tag}] decode steps {steps}, prefill dispatches {prefills}, lane chunks "
        f"{lanes}, sample calls {steps + prefills + lanes}, launches {launches}")
    # the grouped expert entries count either kernel; of those, the prefill
    # kernel's apart (a long prompt's forward takes it)
    prefill = {n + "_prefill": counters[n].prefill_launches for n in launches
               if hasattr(counters[n], "prefill_launches") and n not in idle}
    for name, n in prefill.items():
        assert 0 <= n <= launches[name[:-len("_prefill")]], (name, n)
    if prefill:
        log(f"[{tag}] of which the grouped expert prefill kernel: {prefill}")
    for name, n in launches.items():
        if name in idle:
            assert n == 0, (name, n)
            continue
        if name == "int8_product":
            assert n >= steps + prefills > 0, (name, n, steps + prefills)
            continue
        want = (steps + prefills + lanes if name == "sampling_prep"
                else L_moe * (steps + prefills) if name.startswith("grouped_")
                else L * prefills if name in ("flash_attention_paged", "latent_prefill")
                else L * steps)
        assert n == want > 0, (name, n, want)
    return {**launches, **prefill}


def _steps(engine, st0: dict, st1: dict) -> tuple[int, int, int]:
    """(decode or verify steps, prefill dispatches, chunks that carried the
    prefill lane) between two stats snapshots: a chunk is
    ``decode_chunk_len`` steps, a trimmed one (``chunk_trim``) half that;
    each lane chunk samples its prompts' first tokens in one call."""
    d = {k: st1[k] - st0[k] for k in ("decode_steps", "prefill_dispatches", "trim_chunks",
                                      "lane_chunks")}
    chunk = engine.decode_chunk_len
    steps = d["decode_steps"] * chunk - d["trim_chunks"] * (chunk - engine._trim_chunk)
    return steps, d["prefill_dispatches"], d["lane_chunks"]


def _settled(engine) -> dict:
    """``engine``'s stats once no chunk is in flight and no injected prefill
    group waits: a request is answered when its chunk is read back, which
    may come before a pipelined chunk behind it is (that chunk's launches
    count at its dispatch). With every request answered, no chunk starts."""
    t0 = time.time()
    while engine._pending is not None or engine._inject_handles:
        assert time.time() - t0 < 120, "the engine did not settle"
        time.sleep(0.002)
    return dict(engine.stats)


def _pool_mib(engine):
    """The MiB the engine's graph pool holds (None where this PyTorch's
    memory snapshot does not name segment pools)."""
    import torch

    pool = tuple(engine._graph_pool or ())
    sizes = [s["total_size"] for s in torch.cuda.memory_snapshot()
             if "segment_pool_id" in s and tuple(s["segment_pool_id"]) == pool]
    return sum(sizes) / 2**20 if sizes else None


def _bucket_tokens(engine, P: int, s_cur) -> int:
    """The context a decode program of page bucket ``P`` / slot bucket
    ``s_cur`` reads, in tokens."""
    return s_cur if s_cur is not None else min(P * engine.page_size, engine.max_seq_len)


def _program_inputs(engine, key: tuple, seed: int, temperature: float) -> None:
    """Inputs for decode program ``key`` in ``engine``'s static buffers:
    rows at random lengths the key's context bucket covers with a chunk's
    advance to spare (row 0 at the longest, so the whole bucket is read),
    active over pages of their own (all rows but the last, or as many as
    the paged pool holds at this width; the rest inactive on page 0),
    random last tokens, one sampler setting (greedy at temperature 0, else
    the request defaults); a speculative engine's token history drawn from
    64 ids (so n-grams repeat); a lane key carries a 13-token prompt for
    the last row on its first step."""
    import torch

    P, s_cur, lane, _, _ = key
    bf, B, V, dev = engine._bufs, engine.max_slots, engine.cfg.vocab_size, engine.device
    g = torch.Generator().manual_seed(seed)
    top = _bucket_tokens(engine, P, s_cur) - engine._max_adv - 1
    lens = torch.randint(1, top, (B,), generator=g)
    lens[0] = top - 1
    n_tab = B if engine.cache_mode == "slot" else min(B, (engine.n_pages - 1) // P)
    assert n_tab >= 2 and (n_tab == B or not lane), (B, P, engine.n_pages)
    act = torch.arange(B) < min(n_tab, B - 1)
    bf.act.copy_(act)
    bf.lens.copy_(lens)
    bf.prompt_lens.copy_(lens)
    bf.last.copy_(torch.randint(0, V, (B,), generator=g))
    bf.min_tokens.zero_()
    sampled = temperature > 0
    bf.temperature.fill_(temperature)
    bf.top_k.fill_(20 if sampled else 0)
    bf.top_p.fill_(0.8 if sampled else 1.0)
    bf.min_p.fill_(0.05 if sampled else 0.0)
    bf.repetition_penalty.fill_(1.05 if sampled else 1.0)
    bf.inj_rows.fill_(B)
    if engine.cache_mode != "slot":
        tab = torch.zeros((B, P), dtype=torch.int64)
        tab[:n_tab] = 1 + torch.arange(n_tab * P).view(n_tab, P)
        bf.tables[:, :P].copy_(tab)
    if engine.hist is not None:
        engine.hist.copy_(torch.randint(0, 64, tuple(engine.hist.shape), generator=g))
    if lane:
        n = engine.prefill_lane - 3
        bf.ltok.copy_(torch.randint(0, V, tuple(bf.ltok.shape), generator=g))
        bf.lpos.fill_(-1)
        bf.lpos[0, :n] = torch.arange(n, device=dev)
        bf.ltab.zero_()
        if engine.cache_mode == "slot":
            bf.ltab[0, 0] = B - 1
        else:
            bf.ltab[0, :P] = bf.tables[B - 1, :P]
        bf.lrow.zero_()
        bf.lrow[0] = n - 1
        bf.act_slots.fill_(B)
        bf.act_slots[0] = B - 1
        bf.act_steps.zero_()


def _program_state(engine) -> list:
    """What a decode program writes: the seen mask (its spare row too), the
    token history, the carry, and the sampler's generator state."""
    bf = engine._bufs
    return [t.clone() for t in (engine._seen_ext, bf.last_ext, bf.lens)] + [
        engine.generator.get_state(),
        None if engine.hist is None else engine.hist.clone()]


def _program_restore(engine, st: list) -> None:
    bf = engine._bufs
    for t, v in zip((engine._seen_ext, bf.last_ext, bf.lens), st):
        t.copy_(v)
    engine.generator.set_state(st[3])
    if st[4] is not None:
        engine.hist.copy_(st[4])


def _program_ms(engine, st: list, run, n: int = 3) -> float:
    """Median wall ms of one chunk, ``run`` from state ``st`` each time."""
    import torch

    ts = []
    for _ in range(n):
        _program_restore(engine, st)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    return 1e3 * sorted(ts)[n // 2]


# the port's own kernels as the profiler names them (csrc/*.cu in an
# anonymous namespace; B5 by its Triton function's name)
_OWN_KERNEL = re.compile(
    r"::(decode_attention|decode_merge|decode_i8|decode_i8_plan|flash_attention|flash_paged_plan"
    r"|flash_paged_merge"
    r"|latent_attention|latent_prefill_plan|widen_kv_pages|rms_norm_rows"
    r"|gemm_partial|gemm_tc|qkv_epilogue|residual_epilogue|swiglu_epilogue|grouped_expert"
    r"|grouped_expert_tc|i8_stream|grouped_expert_i8|grouped_expert_i8_tc|quant_strip)[<(]"
    r"|^_prep_kernel\b")
# a kernel that each launch of these wrappers runs exactly once
# (csrc/fused_layer.cu run_qkv, run_out_mlp, run_mlp; ops/moe.py,
# ops/sampling_prep.py and the attention wrappers one launch a call)
_SIGNATURES = (
    ("B3", r"::qkv_epilogue\(", ("fused_qkv_stacked", "fused_qkv")),
    ("B4 / B8", r"::swiglu_epilogue\(",
     ("fused_out_mlp_stacked", "fused_mlp_stacked", "fused_mlp", "fused_out_mlp")),
    ("B5", r"^_prep_kernel\b", ("sampling_prep",)),
    ("grouped_expert", r"::grouped_expert(_tc)?<", ("grouped_gateup", "grouped_down")),
    ("grouped_expert_i8", r"::grouped_expert_i8(_tc)?<",
     ("grouped_gateup_i8", "grouped_down_i8")),
    ("K1", r"::decode_(attention|i8)<", ("slot_attention", "slot_window_attention",
                                         "pallas_paged_attention", "pallas_paged_decode",
                                         "pallas_paged_decode_clamp")),
    ("K1 int8", r"::decode_i8<",
     ("pallas_paged_attention_i8", "pallas_paged_decode_i8", "pallas_paged_decode_clamp_i8")),
    ("K1 int8 plan", r"::decode_i8_plan\(",
     ("pallas_paged_attention_i8", "pallas_paged_decode_i8", "pallas_paged_decode_clamp_i8")),
    ("K3", r"::latent_attention<", ("slot_attention_latent", "paged_attention_latent",
                                    "latent_prefill")),
    ("K2", r"::flash_attention<(false|\(bool\)0)>", ("flash_attention",)),
    ("K2 paged", r"::flash_attention<(true|\(bool\)1)>", ("flash_attention_paged",)),
    ("K2 paged int8", r"::widen_kv_pages\(", ("flash_attention_paged_i8",)),
    ("K2 paged plan", r"::flash_paged_plan\(", ("flash_attention_paged",)),
    ("K2 paged merge", r"::flash_paged_merge\(", ("paged_merge",)),
)
# i8_stream launches a call of B7's and B10's wrappers makes for each group
# of 64 rows (csrc/fused_layer.cu: B10's out-MLP runs its three products)
_I8_LAUNCHES = {"fused_out_router_stacked": 1, "fused_qkv_stacked_i8": 1,
                "fused_out_mlp_stacked_i8": 3, "int8_product": 1}


def _traced_kernels(run) -> tuple[dict, dict]:
    """``run()`` under torch.profiler (device activity only): (the port's
    own kernels the card ran, by profiler name, with their counts; the
    other device kernels' counts). A replayed graph's kernels are traced
    one by one. The profiler drops a kernel whose device timestamps it
    places outside its window (a run's first or last kernels), so the run
    sits 50 ms inside the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        run()
        torch.cuda.synchronize()
        time.sleep(0.05)
    own, other = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith(("Memcpy", "Memset")):
            continue
        (own if _OWN_KERNEL.search(e.key) else other)[e.key] = e.count
    return own, other


def _hold_counts_to_trace(tag: str, engine, key: tuple, st: list, prog,
                          kind: str = "programs") -> dict:
    """The launch counters against the card's own record: the body run
    eagerly and the program replayed, each from state ``st`` under
    torch.profiler. The replay runs the port's kernels the eager body ran,
    name by name and count by count, and every signature kernel
    (:data:`_SIGNATURES`, and on a decode program B7's and B10's
    ``i8_stream``, whose launches follow a product's rows) appears in the
    replay's trace exactly as often as its wrappers' counters moved over
    that replay. ``kind``: ``"programs"`` (decode) or ``"prefill"``. A trace can lose a record but never
    adds one: where the two traces differ, both runs are traced once more
    and each kernel counts at its most over the two traces of its run.
    Returns the signature counts."""
    from deepsearch_tts_tpu_torch.engine.program import launch_counters

    counted = launch_counters()

    def trace(run):
        _program_restore(engine, st)
        c0 = [getattr(f, a) for f, a in counted]
        own, other = _traced_kernels(run)
        # a wrapper's launches by its name, those of its int8 mode as name_i8
        return own, other, {f.__name__ + ("_i8" if a == "i8_launches" else ""): getattr(f, a) - c
                            for (f, a), c in zip(counted, c0)
                            if a in ("launches", "i8_launches")}

    runs = {"eager": [trace(prog.body)], "replay": [trace(prog)]}
    if runs["eager"][0][0] != runs["replay"][0][0]:
        for name, run in (("eager", prog.body), ("replay", prog)):
            runs[name].append(trace(run))
    merged = {}
    for name, ts in runs.items():
        assert all(t[2] == ts[0][2] for t in ts), (tag, key, name, [t[2] for t in ts])
        names = set().union(*(t[0] for t in ts))
        own = {k: max(t[0].get(k, 0) for t in ts) for k in names}
        merged[name] = own, max(sum(t[1].values()) for t in ts), ts[0][2]
    (e_own, e_other, e_delta), (r_own, r_other, r_delta) = merged["eager"], merged["replay"]
    assert r_own and r_own == e_own, (tag, key, e_own, r_own)
    assert r_delta == e_delta, (tag, key, e_delta, r_delta)
    sigs = list(_SIGNATURES)
    if kind == "programs" and any(r_delta.get(n) for n in _I8_LAUNCHES):
        # every product of a decode step takes the batch's rows (each row's
        # window under speculation)
        rows = engine.max_slots * (engine.spec_k + 1 if key[3] else 1)
        groups = -(-rows // 64)
        sigs.append(("B7 / B10", r"::i8_stream<",
                     tuple(n for n, k in _I8_LAUNCHES.items() for _ in range(k * groups))))
    held = {}
    for label, pat, names in sigs:
        traced = sum(n for k, n in r_own.items() if re.search(pat, k))
        counted_n = sum(r_delta.get(n, 0) for n in names)
        assert traced == counted_n, (tag, key, label, traced, counted_n, r_delta)
        if traced:
            held[label] = traced
    assert held.get("B5"), (tag, key, held)
    log(f"[{tag}-{kind}] {key}: the replay's trace holds the port's kernels the eager "
        f"body ran ({sum(r_own.values())} launches of {len(r_own)} kernels; other device "
        f"kernels {r_other} replayed, {e_other} eager; traced "
        f"{len(runs['eager'])} time(s) each), and the counters' launches equal the traced "
        f"signature kernels {held}")
    return held


def _latent_prefill_programs(tag: str, engine, programs: dict) -> None:
    """Every prefill program :func:`_check_prefill_programs` replayed on an
    MLA engine launched K3's prefill mode once a layer: its counter moved by
    ``n_layers`` over one replay, and the replay's trace holds as many K3
    launches (``latent_attention<``; a prefill runs no decode)."""
    L = engine.cfg.n_layers
    for key, r in programs["prefill"]["keys"].items():
        n = r["launches"].get("latent_prefill.launches", 0)
        assert n == L and r["traced"].get("K3") == L, (tag, key, n, r["traced"])
    log(f"[{tag}] K3's prefill mode: {L} launches a replayed prefill program, as many K3 "
        f"kernels in each replay's trace ({sorted(programs['prefill']['keys'])})")


@contextlib.contextmanager
def _mla_plain_attention(tag: str):
    """While the block runs, count ``LatentAttention``'s calls of the plain
    attention functions (``ops/attention.py``: the causal, masked and
    re-prefill attentions and the page gather) on CUDA tensors, through the
    module ``models/deepseek_v3.py`` calls them by; on exit there must be
    none (its decode goes to the kernels through ``paged_attention`` and
    ``slot_attention``, whose launches ``_check_launches`` holds)."""
    import types

    import torch

    from deepsearch_tts_tpu_torch.models import deepseek_v3 as ds

    real, calls = ds.attn_ops, {}

    def counted(name):
        fn = getattr(real, name)

        def call(*a, **k):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in a):
                calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call

    names = ("causal_attention", "masked_context_attention", "prefix_chunk_attention",
             "gather_kv_rows")
    ds.attn_ops = types.SimpleNamespace(**{**vars(real), **{n: counted(n) for n in names}})
    try:
        yield calls
    finally:
        ds.attn_ops = real
    assert not calls, (tag, "LatentAttention ran plain attention on the card", calls)
    log(f"[{tag}] LatentAttention's plain attention calls on the card: 0 ({', '.join(names)})")


def _check_programs(tag: str, engine) -> dict:
    """The decode-program layer of ``engine`` after its ``warmup()``: every
    program built is a captured CUDA graph. The narrowest bucket's program
    (a speculative engine's verify program; with a lane also its lane
    variant) is replayed and held to the eager body it captured, on copies
    of the same state and generator state: its tokens (and counts, the
    lane's first tokens), the carry, the seen mask and the history equal,
    greedy and seeded at temperature 0.7, and one replay moves the launch
    counters by what one eager run does. The widest warmed bucket's program
    is held the same way, greedy. On the greedy inputs of the narrowest and
    the widest, :func:`_hold_counts_to_trace` holds the counters to the
    kernels the profiler sees the replay run. Each is timed (ms a chunk,
    the replay against the eager body: median of 3, the widest once). Logs the number of programs, their
    capture seconds and the graph pool's MiB."""
    import torch

    from deepsearch_tts_tpu_torch.engine.program import launch_counters

    assert engine.telemetry()["decode_program"] == "graph", engine.decode_program
    progs = engine._programs
    assert progs and all(p.graph is not None for p in progs.values()), tag
    spec = engine.speculative is not None
    warmed = [v for v in engine._decode_variants() if (*v, False, spec, None) in progs]
    # the narrowest bucket with room for rows a chunk's advance from its end
    narrow = next(v for v in warmed if _bucket_tokens(engine, *v) > engine._max_adv + 9)
    keys = [((*narrow, False, spec, None), (0.0, 0.7))] + (
        [((*narrow, True, False, None), (0.0, 0.7))] if engine.prefill_lane else []) + (
        [((*warmed[-1], False, spec, None), (0.0,))] if warmed[-1] != narrow else [])
    pool = _pool_mib(engine)
    out = {"programs": len(progs), "capture_s": sum(p.capture_s for p in progs.values()),
           "pool_mib": pool, "chunks": {}}
    counted = launch_counters()
    names = [f"{f.__name__}.{a}" for f, a in counted]
    saved = _program_state(engine)
    with torch.no_grad():
        for key, temps in keys:
            prog = progs[key]
            for seed, temp in enumerate(temps):
                _program_inputs(engine, key, seed, temp)
                st = _program_state(engine)
                c0 = [getattr(f, a) for f, a in counted]
                want = {k: v.clone() for k, v in prog.body().items()}
                want_st = _program_state(engine)
                c1 = [getattr(f, a) for f, a in counted]
                _program_restore(engine, st)
                got = {k: v.clone() for k, v in prog().items()}
                got_st = _program_state(engine)
                c2 = [getattr(f, a) for f, a in counted]
                d_eager = {n: y - x for n, x, y in zip(names, c0, c1) if y != x}
                d_replay = {n: y - x for n, x, y in zip(names, c1, c2) if y != x}
                assert d_eager and d_eager == d_replay, (tag, key, d_eager, d_replay)
                for k in want:
                    assert torch.equal(want[k], got[k]), (tag, key, temp, k)
                for i in (0, 1, 2, 4):
                    assert (want_st[i] is None) == (got_st[i] is None)
                    assert want_st[i] is None or torch.equal(want_st[i], got_st[i]), (tag, key, i)
                if temp == 0.0:
                    greedy_st = st
            # the lane variant runs the narrow program's kernels and B5 once more
            traced = None if key[2] else _hold_counts_to_trace(tag, engine, key, greedy_st, prog)
            n = 3 if len(temps) > 1 else 1   # the wide bucket's chunk is long: timed once
            eager_ms = _program_ms(engine, greedy_st, prog.body, n)
            replay_ms = _program_ms(engine, greedy_st, prog, n)
            name = "x".join(str(k) for k in key)
            out["chunks"][name] = {"eager_ms": eager_ms, "replay_ms": replay_ms,
                                   "launches": d_replay, "traced": traced}
            log(f"[{tag}-programs] {key} (pages, slot_ctx, lane, spec, chunk_len): replay "
                f"equals the eager body ({'greedy and seeded' if len(temps) > 1 else 'greedy'}"
                f" tokens, carry, seen mask); a chunk of {engine.decode_chunk_len} steps "
                f"{replay_ms:.3f} ms replayed, {eager_ms:.3f} ms eager; launches a chunk "
                f"{d_replay}")
    _program_restore(engine, saved)
    # the static buffers go back to the host's state at the next dispatch
    bf, B = engine._bufs, engine.max_slots
    bf.act.zero_()
    bf.inj_rows.fill_(B)
    engine._dirty.update(range(B))
    log(f"[{tag}-programs] {len(progs)} decode programs captured in "
        f"{out['capture_s']:.2f} s, {len(engine._prefill_programs)} prefill programs in "
        f"{sum(p.capture_s for p in engine._prefill_programs.values()):.2f} s; graph pool "
        f"{'not measured' if pool is None else f'{pool:.1f} MiB'}")
    out["prefill"] = _check_prefill_programs(tag, engine)
    return out


# the sampler settings of a prefill check: greedy, and the request defaults
_SAMPLERS = {0.0: dict(temperature=0.0, top_k=0, top_p=1.0, min_p=0.0, repetition_penalty=1.0),
             0.7: dict(temperature=0.7, top_k=20, top_p=0.8, min_p=0.05,
                       repetition_penalty=1.05)}


def _prefill_inputs(engine, key: tuple, seed: int, temperature: float) -> list:
    """An admission group for prefill program ``key`` in ``engine``'s static
    prefill buffers (``Engine._upload_prefill``): ``Gp - 1`` of the idle
    engine's rows (one at ``Gp`` 1, so a wider key carries padding rows),
    each a prompt of random ids whose suffix fills the bucket to within a
    few tokens, on the non-fresh branch behind a cached prefix that takes
    the row to the end of the key's context (over pages of its own in the
    paged pool), one sampler setting. Returns what the group writes: each
    row's pages (paged) or (row, first, end) positions (slot)."""
    import torch

    bucket, Gp, fresh, _, _ = key
    width, W = engine._prefill_widths_of(key)
    G, ps, V = max(1, Gp - 1), engine.page_size, engine.cfg.vocab_size
    assert engine.cache_mode == "slot" or G * width < engine.n_pages, (key, engine.n_pages)
    g = torch.Generator().manual_seed(seed)
    grp, written = [], []
    for i in range(G):
        s = engine.slots[i]
        n_suffix = max(1, min(bucket, W, engine.max_seq_len - 1) - 3 * i)
        total = n_suffix if fresh else max(n_suffix, W - 1 - i)
        cached = total - n_suffix
        ids = torch.randint(0, V, (total,), generator=g).tolist()
        if engine.cache_mode == "slot":
            written.append((s.idx, cached, total))
        else:
            pages = list(range(1 + i * width, 1 + (i + 1) * width))
            engine.page_tables[s.idx, :width] = pages
            written.append(pages[cached // ps: -(-total // ps)])
        for f, v in _SAMPLERS[temperature].items():
            engine.samp_host[f][s.idx] = v
        engine.min_tokens[s.idx] = 0
        grp.append({"slot": s, "suffix": ids[cached:], "cached_len": cached, "prompt": ids})
    engine._upload_prefill(key, grp)
    return written


def _written_kv(engine, written: list) -> list:
    """Copies of the pool rows a prefill group writes (:func:`_prefill_inputs`),
    its int8 KV's scales too; MLA's one-page dummy v pool is left out."""
    import torch

    pools = [engine.k_pages] + [t for t in (engine.v_pages, engine.k_scales, engine.v_scales)
                                if t is not None and t.shape[1] == engine.k_pages.shape[1]]
    if engine.cache_mode == "slot":
        return [p[:, r, a:b].clone() for p in pools for r, a, b in written]
    idx = torch.tensor(sorted({q for pages in written for q in pages}), device=engine.device)
    return [p[:, idx] for p in pools]


def _check_prefill_programs(tag: str, engine) -> dict:
    """The prefill programs of ``engine`` after its ``warmup()``: every one
    built is a captured CUDA graph. The narrowest and the widest warmed key
    (by tokens, then page width) are each replayed and held to the eager
    body it captured, on an admission group of the idle engine's rows
    (:func:`_prefill_inputs`) from the same state and generator state:
    first tokens greedy and seeded at temperature 0.7, the KV the group
    writes bit for bit, the seen mask and the token history, and one replay
    moves the launch counters by what one eager run does. On each,
    :func:`_hold_counts_to_trace` holds the counters to the kernels the
    profiler sees the replay run, and the replay and the eager body are
    timed (ms a prefill: the narrowest key's median of 3, the widest's
    greedy pair itself, whose prefill takes seconds). The host rows the
    groups used are restored. Logs the programs, their capture seconds and
    the keys."""
    import torch

    from deepsearch_tts_tpu_torch.engine.program import launch_counters

    assert engine.telemetry()["prefill_program"] == "graph", engine.telemetry()
    progs = engine._prefill_programs
    assert progs and all(p.graph is not None for p in progs.values()), tag
    order = sorted(progs, key=lambda k: (k[0] * k[1], k[4] or 0))
    out = {"programs": len(progs), "capture_s": sum(p.capture_s for p in progs.values()),
           "keys": {}}
    counted = launch_counters()
    names = [f"{f.__name__}.{a}" for f, a in counted]
    host = (engine.page_tables.copy(), {k: v.copy() for k, v in engine.samp_host.items()},
            engine.min_tokens.copy())
    saved = _program_state(engine)
    with torch.no_grad():
        for key in dict.fromkeys((order[0], order[-1])):
            prog = progs[key]
            for seed, temp in enumerate(_SAMPLERS):
                written = _prefill_inputs(engine, key, seed, temp)
                st = _program_state(engine)
                c0 = [getattr(f, a) for f, a in counted]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = prog.body()["first"].clone()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                want_kv, want_st = _written_kv(engine, written), _program_state(engine)
                c1 = [getattr(f, a) for f, a in counted]
                _program_restore(engine, st)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                got = prog()["first"].clone()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                got_kv, got_st = _written_kv(engine, written), _program_state(engine)
                c2 = [getattr(f, a) for f, a in counted]
                d_eager = {n: y - x for n, x, y in zip(names, c0, c1) if y != x}
                d_replay = {n: y - x for n, x, y in zip(names, c1, c2) if y != x}
                assert d_eager and d_eager == d_replay, (tag, key, d_eager, d_replay)
                # the group's rows: a padding row attends over nothing, so its
                # sample (and the spare seen row it marks) follows the pool's
                # stale contents, which the eager run rewrote
                G = len(written)
                assert torch.equal(want[:G], got[:G]), (tag, key, temp, want, got)
                assert all(torch.equal(a, b) for a, b in zip(want_kv, got_kv)), (tag, key, temp)
                for i in (0, 4):   # the seen mask, the token history
                    assert want_st[i] is None or torch.equal(want_st[i][:engine.max_slots],
                                                             got_st[i][:engine.max_slots]), (
                        tag, key, temp, i)
                if temp == 0.0:
                    greedy_st, eager_ms, replay_ms = st, 1e3 * (t1 - t0), 1e3 * (t3 - t2)
            traced = _hold_counts_to_trace(tag, engine, key, greedy_st, prog, "prefill")
            if key == order[0]:
                eager_ms = _program_ms(engine, greedy_st, prog.body)
                replay_ms = _program_ms(engine, greedy_st, prog)
            rows = max(1, key[1] - 1)
            out["keys"]["x".join(str(k) for k in key)] = {
                "rows": rows, "eager_ms": eager_ms, "replay_ms": replay_ms,
                "launches": d_replay, "traced": traced}
            log(f"[{tag}-prefill] {key} (bucket, rows, fresh, ring, pages): replay equals "
                f"the eager body (greedy and seeded first tokens, the written KV bit for "
                f"bit, seen mask, history); a prefill of {rows} row(s) {replay_ms:.3f} ms "
                f"replayed, {eager_ms:.3f} ms eager; launches a prefill {d_replay}")
    _program_restore(engine, saved)
    engine.page_tables[:], engine.min_tokens[:] = host[0], host[2]
    for k, v in host[1].items():
        engine.samp_host[k][:] = v
    engine._dirty.update(range(engine.max_slots))
    log(f"[{tag}-prefill] {len(progs)} prefill programs captured in {out['capture_s']:.2f} s: "
        f"{sorted(progs, key=lambda k: (k[0], k[1], k[4] or 0))}")
    return out


def _register_moe_serve() -> None:
    """qwen3-30b-a3b's published widths, ``MOE_SERVE_LAYERS`` of its 48
    layers, registered under ``MOE_SERVE``."""
    from deepsearch_tts_tpu_torch.engine.weights import convert_qwen3_moe
    from deepsearch_tts_tpu_torch.models import qwen3_moe, registry

    cfg = dataclasses.replace(qwen3_moe.QWEN3_MOE_CONFIGS[MOE_MODEL], n_layers=MOE_SERVE_LAYERS)
    registry.register(MOE_SERVE, cfg, qwen3_moe.forward, convert_qwen3_moe)


def _register_i8_serve() -> None:
    """qwen3-32b's published widths, ``I8_SERVE_LAYERS`` of its 64 layers,
    registered under ``I8_SERVE``."""
    from deepsearch_tts_tpu_torch.engine.weights import convert_qwen3_dense
    from deepsearch_tts_tpu_torch.models import qwen3, registry

    cfg = dataclasses.replace(qwen3.QWEN3_CONFIGS[I8_MODEL], n_layers=I8_SERVE_LAYERS)
    registry.register(I8_SERVE, cfg, qwen3.forward, convert_qwen3_dense)


def _register_mla() -> None:
    """deepseek-v3's published widths, 5 of its 61 layers, registered under
    ``MLA_MODEL`` (the package's registry gains no entry of its own)."""
    from deepsearch_tts_tpu_torch.engine.weights import convert_deepseek_v3
    from deepsearch_tts_tpu_torch.models import deepseek_v3, registry

    mla_cfg = dataclasses.replace(deepseek_v3.DEEPSEEK_V3_CONFIGS["deepseek-v3"],
                                  n_layers=MLA_LAYERS)
    registry.register(MLA_MODEL, mla_cfg, deepseek_v3.forward, convert_deepseek_v3)


# the programs phase's engines: (model, Engine arguments); the paged ones
# at the serve phases' 64-token pages
PROGRAM_ENGINES = (
    ("qwen3-8b", dict(prefill_lane=LANE, page_size=64, n_pages=1024)),   # the CLI defaults
    ("qwen3-8b", dict(cache_mode="slot", prefill_lane=LANE)),
    ("qwen3-8b", dict(cache_mode="slot", **SPEC_KW)),
    ("qwen3-8b", dict(attn_impl="pallas", enable_prefix_cache=False, page_size=64,
                      n_pages=1024)),
    (MOE_MODEL, dict(prefill_lane=LANE, page_size=64, n_pages=1024)),
    (MOE_MODEL, dict(quantize="int8", prefill_lane=LANE, page_size=64, n_pages=1024)),
    (I8_MODEL, dict(quantize="int8", kv_quantize="int8", page_size=64, n_pages=1024)),
    (MLA_MODEL, dict(cache_mode="slot")),
)


def phase_programs(card: str) -> dict:
    """``--programs-only``: the engines of ``PROGRAM_ENGINES`` built on
    random weights from seed 0 (one model's weights shared by its engines),
    each warmed to ``max_ctx=512`` (the decode programs, the graph pool's
    MiB read, then the prefill programs of ``prompt_lens=(64,)``) and put
    through :func:`_check_programs`, then released."""
    import torch

    _register_mla()
    out, params, held = {}, None, None
    for model, kw in PROGRAM_ENGINES:
        if held != (model, kw.get("quantize")):
            params = None
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.time()
        engine = _engine(params, model=model, seed=0, **kw)
        params, held = engine.params, (model, kw.get("quantize"))
        engine.warmup(prompt_lens=(), max_ctx=512)
        pool0 = _pool_mib(engine)
        engine.warmup(prompt_lens=(64,), decode=False, max_ctx=512)
        tag = f"{model}-{'-'.join(f'{k}={v}' for k, v in kw.items() if k not in ('page_size', 'n_pages'))}"
        log(f"[programs] {tag}: built and warmed in {time.time() - t0:.1f} s; graph pool "
            f"{pool0} MiB after the decode programs, {_pool_mib(engine)} MiB after the "
            f"prefill programs too")
        out[tag] = _check_programs(tag, engine)
        out[tag]["pool_mib_decode"] = pool0
        _release(engine)
        del engine
    return out


# the prefill programs the serve phases' requests reach on the paged cache
# (64-token pages) past the CLI's own ``--warmup 64`` (bucket 64 in groups
# of 1, 4 and 16 at every page width, and every decode program), one
# warmup() each: (prompt_lens, group_sizes, max_ctx). The raw completion
# and the lane check's long request (24 and 20 tokens); the multi-turn's
# first turn (350 tokens) and its follow-up (403 tokens, 83 past the 320
# cached: bucket 128, 8 pages); the long prompt (3044 tokens, 48 pages)
SERVE_PREFILLS = (((32,), (1,), 32), ((128,), (1,), 403), ((512,), (1,), 350),
                  ((CTX,), (1,), 3044))


def _warm_serve(tag: str, engine) -> dict:
    """A serve phase's warmup on top of the CLI's (``--warmup 64``, which
    ``build_engine`` ran): logs the programs it built, their capture
    seconds and the graph pool's MiB, then warms :data:`SERVE_PREFILLS`."""
    progs = list(engine._programs.values()) + list(engine._prefill_programs.values())
    cli = {"decode_programs": len(engine._programs),
           "prefill_programs": len(engine._prefill_programs),
           "capture_s": sum(p.capture_s for p in progs), "pool_mib": _pool_mib(engine)}
    for lens, groups, ctx in SERVE_PREFILLS:
        engine.warmup(prompt_lens=lens, group_sizes=groups, decode=False, max_ctx=ctx)
    cli["extra_prefill_programs"] = len(engine._prefill_programs) - cli["prefill_programs"]
    log(f"[{tag}] the CLI's warmup (--warmup 64) built {cli['decode_programs']} decode and "
        f"{cli['prefill_programs']} prefill programs in {cli['capture_s']:.2f} s of capture, "
        f"graph pool {cli['pool_mib']} MiB; {cli['extra_prefill_programs']} prefill programs "
        f"more for this phase's longer prompts, pool {_pool_mib(engine)} MiB")
    return cli


def phase_serve(card: str, model: str = "qwen3-8b", profile: bool = False,
                tag: str = "serve", **quant_kw) -> tuple[dict, object]:
    """Serve ``model`` over HTTP through the port's own construction:
    ``cli/serve.py``'s ``build_engine``, or with ``quant_kw`` (``quantize``,
    ``kv_quantize``, ``prefill_lane``: ``Engine`` arguments only, as in
    JAX) the same ``Engine`` construction with them. With ``quantize`` B12's
    counter is zeroed before the build and must count one launch per
    quantized matrix. Every engine runs the fused decode layers but the
    int8 MoE one, which JAX's gate leaves unfused."""
    import torch

    from deepsearch_tts_tpu_torch.cli.serve import build_engine, build_parser
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops import quant

    args = build_parser().parse_args([
        "--model", model, "--device", "cuda", "--seed", "0",
        "--max_slots", str(SLOTS), "--page_size", "64", "--pages", "1024",
        "--max_seq_len", "4096", "--decode_chunk", "8", "--warmup", "64"]
        # the CLI's default lane; MLA has none (in JAX too)
        + (["--prefill_lane", "0"] if model == MLA_MODEL else []))
    torch.cuda.reset_peak_memory_stats()
    quant.quantize_int8.launches = 0
    t0 = time.time()
    if quant_kw:
        engine = _engine(None, model=model, seed=args.seed, page_size=args.page_size,
                         n_pages=args.pages, **quant_kw)
        engine.warmup(prompt_lens=(args.warmup,))   # the CLI's warmup
    else:
        engine = build_engine(args)
    cli_warmup = _warm_serve(tag, engine)
    torch.cuda.synchronize()
    out: dict = {"build_s": time.time() - t0,
                 "allocated_gib": torch.cuda.memory_allocated() / 2**30,
                 "cli_warmup": cli_warmup}
    log(f"[{tag}] engine built (random {model} weights, warmup) in "
        f"{out['build_s']:.1f} s; layer_fusion={engine.layer_fusion}; "
        f"memory allocated {out['allocated_gib']:.2f} GiB")
    int8_moe = bool(quant_kw.get("quantize")) and hasattr(engine.cfg, "n_experts")
    if engine.layer_fusion == int8_moe:
        raise AssertionError(f"the {model} engine must {'not ' * int8_moe}run the fused "
                             f"decode layers")
    out["programs"] = _check_programs(tag, engine)
    if quant_kw.get("quantize"):
        # every QUANT_KEYS matrix of the packed tree: wqkv, wo, w_gateup and
        # w_down of each layer (and of each expert), and the untied lm_head
        want = sum(v["q"][..., 0, 0].numel() for v in
                   list(engine.params["layers"].values()) + [engine.params.get("lm_head")]
                   if quant.is_quantized(v))
        out["quantize_launches"] = quant.quantize_int8.launches
        log(f"[{tag}] B12 quantize_int8 launches at build {quant.quantize_int8.launches} "
            f"(matrices {want}); KV pools {engine.k_pages.dtype}, scales "
            f"{None if engine.k_scales is None else engine.k_scales.dtype}")
        assert quant.quantize_int8.launches == want, (quant.quantize_int8.launches, want)

    counters = _counters(model, int8=int8_moe)
    idle = ("grouped_gateup", "grouped_down") if int8_moe else ()
    # attention: on CUDA attn_impl resolves to "pallas": K2's paged mode
    # once a layer and prefill, K1 once a layer and decode step, so no layer
    # of either attends through the plain gather; with int8 KV the same
    # counts through their int8 modes (and none through the bf16 ones);
    # MLA's decode takes K3 through B6's entry, its prefills K3's prefill
    # mode (``latent_prefill``) once a layer and prefill
    paged_pallas = engine.attn_impl == "pallas" and not engine.latent_cache
    kv_int8 = bool(quant_kw.get("kv_quantize"))
    assert engine.attn_impl == "pallas", (tag, engine.attn_impl)
    if engine.latent_cache:
        counters["paged_attention_latent"] = pa.paged_attention_latent
        counters["latent_prefill"] = pa.latent_prefill
        _latent_prefill_programs(tag, engine, out["programs"])
    counters["flash_attention_paged"] = fa.flash_attention_paged
    counters["pallas_paged_attention"] = pa.pallas_paged_attention
    if not paged_pallas:
        idle += ("flash_attention_paged", "pallas_paged_attention")
    try:
        with _serve_http(engine) as base:
            # counters are zeroed right before the main path runs
            _zero(counters)
            st0 = dict(engine.stats)

            def chat(content, **kw):
                payload = {"messages": [{"role": "user", "content": content}], **kw}
                return _post(f"{base}/chat/completions", payload)

            # (a) time to first token: single one-token requests, nothing else
            # running (client-side request latency: HTTP + prefill + first sample)
            ttfts = []
            for i in range(5):
                code, body, dt = chat(f"Time to first token, please ({i}).", max_tokens=1)
                assert code == 200 and body["usage"]["completion_tokens"] == 1, body
                ttfts.append(dt)
            out["ttft_s"] = sorted(ttfts)[2]
            out["ttft_max_s"] = max(ttfts)

            # (b) four concurrent chat completions, default sampler
            results = [None] * 4

            def worker(i):
                results[i] = chat(f"Request {i}: name three rivers of Europe.",
                                  max_tokens=48)

            ths = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            for r in results:
                assert r is not None and r[0] == 200, r
                u = r[1]["usage"]
                assert 1 <= u["completion_tokens"] <= 48 and u["prompt_tokens"] > 0, u
            log(f"[{tag}] 4 concurrent chat: completion tokens "
                f"{[r[1]['usage']['completion_tokens'] for r in results]}")

            # (c) one greedy request twice: identical text (prompt under one
            # page, so both runs take the same path)
            greedy = dict(max_tokens=24, temperature=0.0, repetition_penalty=1.0)
            r1 = chat("Greedy: count to five.", **greedy)
            r2 = chat("Greedy: count to five.", **greedy)
            assert r1[0] == 200 and r2[0] == 200
            t1 = r1[1]["choices"][0]["message"]["content"]
            t2 = r2[1]["choices"][0]["message"]["content"]
            assert t1 == t2, (t1, t2)
            assert r1[1]["usage"]["completion_tokens"] == r2[1]["usage"]["completion_tokens"]

            # (d) min_tokens budget forcing
            r = chat("Budget: think for a while.", max_tokens=40, min_tokens=32)
            assert r[0] == 200 and r[1]["usage"]["completion_tokens"] >= 32, r[1]["usage"]

            # (e) multi-turn follow-up must reuse the cached conversation prefix
            msgs = [{"role": "system", "content": "You are a careful search assistant. " * 8},
                    {"role": "user", "content": "Which river flows through Vienna?"}]
            r = _post(f"{base}/chat/completions", {"messages": msgs, "max_tokens": 16})
            assert r[0] == 200
            msgs += [{"role": "assistant", "content": "The Danube."},
                     {"role": "user", "content": "And through Budapest?"}]
            r = _post(f"{base}/chat/completions", {"messages": msgs, "max_tokens": 16})
            cached = r[1]["usage"]["prompt_tokens_details"]["cached_tokens"]
            assert r[0] == 200 and cached > 0, r[1]["usage"]
            log(f"[{tag}] multi-turn follow-up: prompt_tokens "
                f"{r[1]['usage']['prompt_tokens']} cached_tokens {cached}")

            # (f) /v1/completions
            r = _post(f"{base}/completions", {"prompt": "The capital of France is",
                                              "max_tokens": 16})
            assert r[0] == 200 and r[1]["usage"]["completion_tokens"] >= 1, r[1]
            assert isinstance(r[1]["choices"][0]["text"], str)

            # (g) a long prompt (~3000 tokens): prefill attention in query blocks
            r = chat(LONG_TEXT, max_tokens=8)
            u = r[1]["usage"]
            assert r[0] == 200 and u["prompt_tokens"] > 2900 and u["completion_tokens"] >= 1, u
            out["long_prompt_tokens"], out["long_prompt_s"] = u["prompt_tokens"], r[2]
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            log(f"[{tag}] long prompt: {u['prompt_tokens']} prompt tokens answered "
                f"in {r[2] * 1000:.1f} ms; peak memory allocated {out['peak_gib']:.2f} GiB")

            # (h) a full batch: max_slots concurrent requests for decode tok/s
            d0 = _settled(engine)
            tb = time.perf_counter()
            results = _burst(chat, SLOTS, 64)
            wall = time.perf_counter() - tb
            d1 = _settled(engine)
            out["burst_decode_tok_s"] = ((d1["decode_tokens"] - d0["decode_tokens"])
                                         / (d1["decode_time_s"] - d0["decode_time_s"]))
            out["burst_step_ms"] = 1e3 * (d1["decode_time_s"] - d0["decode_time_s"]) / (
                (d1["decode_steps"] - d0["decode_steps"]) * engine.decode_chunk_len)
            out["burst_wall_s"] = wall
            out["burst_tokens"] = sum(r[1]["usage"]["completion_tokens"] for r in results)
            out["burst_pipelined_chunks"] = d1["pipelined_chunks"] - d0["pipelined_chunks"]
            out["burst_chunks"] = d1["decode_steps"] - d0["decode_steps"]
            if profile:
                out["idle_share"] = _profile_burst(chat, engine)
            if engine.prefill_lane:
                out["lane"] = _lane_check(tag, engine, base, counters,
                                          teacher=model not in (MOE_MODEL, MOE_SERVE))

            st1 = _settled(engine)
            out["post_warmup_builds"] = st1["post_warmup_builds"]
            out["pipelined_chunks"] = st1["pipelined_chunks"] - st0["pipelined_chunks"]
            out["injected_groups"] = st1["injected_groups"] - st0["injected_groups"]
            log(f"[{tag}] decode programs: {engine.telemetry()['decode_program']}; "
                f"{out['pipelined_chunks']} chunks pipelined of "
                f"{st1['decode_steps'] - st0['decode_steps']} (the full batch: "
                f"{out['burst_pipelined_chunks']} of {out['burst_chunks']}), "
                f"{out['injected_groups']} prefill groups injected, post-warmup builds "
                f"{out['post_warmup_builds']}; prefill programs "
                f"{engine.telemetry()['prefill_program']}, groups "
                f"{st1.get('prefill_group_hist')}")
            # the warmup covers every program the phase's requests reach
            assert out["post_warmup_builds"] == 0, out["post_warmup_builds"]
            out["launches"] = _check_launches(tag, engine, counters, st0, st1, idle)
            i8 = {"decode_attention_i8": pa.pallas_paged_attention.i8_launches,
                  "flash_attention_paged_i8": fa.flash_attention_paged.i8_launches}
            base = {"decode_attention_i8": "pallas_paged_attention",
                    "flash_attention_paged_i8": "flash_attention_paged"}
            want_i8 = {n: out["launches"][b] if kv_int8 else 0 for n, b in base.items()}
            assert i8 == want_i8, (tag, i8, want_i8)
            out["launches"].update(i8)
            log(f"[{tag}] attn_impl={engine.attn_impl}: K2 paged "
                f"{fa.flash_attention_paged.launches} launches, K1 "
                f"{pa.pallas_paged_attention.launches}" + (
                    f" (of which K2's int8 paged mode {i8['flash_attention_paged_i8']}, K1's "
                    f"int8 mode {i8['decode_attention_i8']})" if kv_int8 else "") + (
                    " (once a layer and prefill, once a layer and decode step: no plain "
                    "gather)" if paged_pallas else ""))
            out["steps"] = dict(zip(("decode", "prefill", "lane"), _steps(engine, st0, st1)))
            out["decode_tok_s"] = ((st1["decode_tokens"] - st0["decode_tokens"])
                                   / (st1["decode_time_s"] - st0["decode_time_s"]))
            log(f"[{tag}] {card} | TTFT median of 5 {out['ttft_s'] * 1000:.1f} ms "
                f"(max {out['ttft_max_s'] * 1000:.1f}) | decode "
                f"{out['decode_tok_s']:.1f} tok/s over the whole phase | full batch "
                f"of {SLOTS}: {out['burst_decode_tok_s']:.1f} tok/s decode "
                f"({out['burst_step_ms']:.2f} ms per decode step), "
                f"{out['burst_tokens']} tokens in {out['burst_wall_s']:.2f} s")
    finally:
        engine.shutdown()
    return out, engine


class _RouteReplay:
    """MLA's expert choices on the serving path, replayed in its reference.

    Group-limited top-k routing is discontinuous: where two experts' (or two
    groups') scores lie within the rounding noise of the two paths — a
    near-tie, common on random weights — the paths pick other experts, and
    the logits part by far more than the numerics under test. ``record()``
    keeps the expert ids of each ``route_v3`` call of the serving forwards;
    ``replay()`` routes the reference's rows to the same experts, with
    weights from the reference's own scores, and counts the rows whose own
    choice would have differed."""

    def __init__(self, cfg):
        from deepsearch_tts_tpu_torch.models import deepseek_v3

        self.mod, self.route = deepseek_v3, deepseek_v3.route_v3
        self.n_moe = cfg.n_layers - cfg.first_k_dense
        self.calls: list = []
        self.differ = self.rows = 0

    @contextlib.contextmanager
    def _patched(self, fn):
        self.mod.route_v3 = fn
        try:
            yield
        finally:
            self.mod.route_v3 = self.route

    def record(self):
        def route(x, router_w, bias, cfg):
            w, ids = self.route(x, router_w, bias, cfg)
            self.calls.append(ids)
            return w, ids

        return self._patched(route)

    def replay(self):
        """The reference runs one ``route_v3`` call per MoE layer over all
        positions; layer j's rows are the serving calls of layer j, in
        order (the prefill's rows, then one row a decode step)."""
        import torch

        from deepsearch_tts_tpu_torch.models.common import matmul_f32

        layers = iter(range(self.n_moe))

        def route(x, router_w, bias, cfg):
            ids = torch.cat(self.calls[next(layers)::self.n_moe])
            _, own = self.route(x, router_w, bias, cfg)
            self.differ += int((own.sort(-1).values != ids.sort(-1).values).any(-1).sum())
            self.rows += ids.shape[0]
            w = torch.gather(torch.sigmoid(matmul_f32(x, router_w)), 1, ids)
            return w / w.sum(-1, keepdim=True).clamp(min=1e-9) * cfg.routed_scaling_factor, ids

        return self._patched(route)


def _hold_to_reference(tag: str, label: str, got, want, free=None,
                       ref: str = "no-cache forward") -> None:
    """Serving logits ``got`` against the reference's ``want`` (one row a
    position; ``ref`` names it): min cosine > 0.99 and argmax agreement >=
    0.75. ``free``: the same reference without the routing replay, logged
    beside it."""
    import torch

    assert got.shape == want.shape and torch.isfinite(got).all(), (got.shape, want.shape)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    msg = (f"[{tag}] {label} logits vs {ref}: max_abs_err "
           f"{(got - want).abs().max().item():.4f}, min cosine {cos.min().item():.5f} "
           f"(bound > 0.99), argmax agreement {agree:.2f} (bound >= 0.75)")
    if free is not None:
        cf = torch.nn.functional.cosine_similarity(got, free, dim=-1)
        msg += (f" | routed on its own (not held): min cosine {cf.min().item():.5f}, "
                f"argmax agreement {(got.argmax(-1) == free.argmax(-1)).float().mean().item():.2f}")
    log(msg)
    assert cos.min().item() > 0.99, cos
    assert agree >= 0.75, agree


@contextlib.contextmanager
def _blocked_drops():
    """Tally, while the block runs, the expert-sorted rows the int8 expert
    FFN takes and those it drops (past an expert's capacity): yields
    ``[rows, dropped]``."""
    from deepsearch_tts_tpu_torch.ops import moe

    inner, tally = moe._expert_ffn_blocked, [0, 0]

    def counted(x_sorted, w_gate, w_up, w_down, offsets, plain=False, n_exp=None):
        cap = moe.expert_capacity(x_sorted.shape[0], n_exp or offsets.shape[0] - 1)
        tally[0] += x_sorted.shape[0]
        tally[1] += int((offsets[1:] - offsets[:-1] - cap).clamp(min=0).sum())
        return inner(x_sorted, w_gate, w_up, w_down, offsets, plain, n_exp)

    moe._expert_ffn_blocked = counted
    try:
        yield tally
    finally:
        moe._expert_ffn_blocked = inner


def phase_reference(engine, tag: str = "reference", t0: int = 16, steps: int = 8,
                    same_path: bool = False, **plain_kw) -> None:
    """Paged prefill of ``t0`` tokens + ``steps`` fused decode steps (the
    serving branches, on the engine's ``attn_impl``: K2's paged mode and K1
    where it resolves to ``"pallas"``) vs the plain no-cache forward, on the served weights,
    into pools like the engine's (its page size on the paged cache, 64
    keys otherwise; int8 with scales under int8 KV).
    ``plain_kw`` keeps the reference off the kernels the no-cache forward
    would otherwise run (the MoE family's grouped expert kernel, the int8
    product). ``same_path``: the reference is instead the same serving calls
    on those plain versions. int8 experts drop rows past an expert's
    capacity (JAX's rule), and which rows depends on the rows a forward
    holds: a 24-token forward can drop what a decode step of one token
    keeps, so the no-cache forward is the reference only where no row can
    drop (at most 8 tokens: an expert takes one row a token, cap >= 8); the
    rows each path dropped are logged."""
    import torch

    from deepsearch_tts_tpu_torch.engine.kvcache import init_kv_pages, init_kv_scales

    cfg, dev = engine.cfg, engine.device
    T0, T = t0, t0 + steps
    assert T <= 64, T
    ps = engine.page_size if engine.cache_mode == "paged" else 64
    n = -(-T // ps)                             # pages 1 .. n of the pools
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None]
    replay = _RouteReplay(cfg) if getattr(cfg, "latent_cache", False) else None

    def serve(**kw_plain):
        kp, vp = init_kv_pages(cfg.n_layers, 1 + n, ps, cfg.n_kv_heads, cfg.head_dim,
                               dtype=engine.k_pages.dtype, device=dev)
        kw = dict(k_pages=kp, v_pages=vp, page_table=torch.arange(1, 1 + n, device=dev)[None],
                  impl=engine.attn_impl, **kw_plain)
        if engine.k_scales is not None:
            kw["k_scales"], kw["v_scales"] = init_kv_scales(cfg.n_layers, 1 + n, ps,
                                                            cfg.n_kv_heads, device=dev)
        out = [engine.forward(engine.params, cfg, toks[:, :T0], pos[:, :T0],
                              seq_lens=torch.tensor([T0], device=dev),
                              logits_indices=torch.tensor([T0 - 1], device=dev), **kw)[0][:, 0]]
        for t in range(T0, T):
            out.append(engine.forward(
                engine.params, cfg, toks[:, t:t + 1], pos[:, t:t + 1],
                seq_lens=torch.tensor([t + 1], device=dev), fused_decode=True, **kw)[0][:, 0])
        return torch.cat(out)                   # positions T0-1 .. T-1

    with torch.no_grad(), _blocked_drops() as served, \
            replay.record() if replay else contextlib.nullcontext():
        got = serve()
    with torch.no_grad(), _blocked_drops() as whole:
        free, _ = engine.forward(engine.params, cfg, toks, pos, **plain_kw)
    free = ref = free[0, T0 - 1:]
    if replay:
        with torch.no_grad(), replay.replay():
            ref = engine.forward(engine.params, cfg, toks, pos, **plain_kw)[0][0, T0 - 1:]
        log(f"[{tag}] routing: the reference's own expert set differs from the "
            f"serving path's on {replay.differ} of {replay.rows} (position, MoE layer) "
            f"rows; it routes all rows as the serving path did")
    if served[0] or whole[0]:
        log(f"[{tag}] int8 expert rows past capacity: serving path {served[1]} of "
            f"{served[0]}, no-cache forward over {T} tokens {whole[1]} of {whole[0]}")
    assert got.shape == (T - T0 + 1, cfg.vocab_size), got.shape
    # bf16 through 5-64 layers: the two paths round q/k/v at different
    # points (the fused kernels keep q/k in float32 until after norm and
    # rope); under int8 KV the serving path also attends over int8 keys and
    # values (one scale per token and head) where the reference keeps bf16
    if same_path:
        with torch.no_grad(), _blocked_drops() as plain:
            ref = serve(**plain_kw)
        log(f"[{tag}] the plain serving calls: {plain[1]} of {plain[0]} rows past capacity")
        _hold_to_reference(tag, "serving-path", got, ref,
                           ref="same serving calls on the plain versions")
    else:
        _hold_to_reference(tag, "serving-path", got, ref, free if replay else None)


# ------------------------------------------------------- training and LoRA

# the train phase: full SFT of qwen3-4b at its published widths (36 layers,
# E=2560, F=9728, 32/8 heads, V=151936; tied embeddings): ~8 GB of bf16
# params, 8 GB of grads and 16 GB of bf16 Adam moments (qwen3-8b would need
# ~64 GB before activations); one fixed seeded batch, the loss on its
# second half (a prompt / completion split); lr >= 1e-4, as bf16 params and
# moments round updates near 1e-5 away
TRAIN_MODEL, TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = "qwen3-4b", 2, 512, 5, 3e-4
TRAIN_DIR = os.path.join(HERE, "build", "train_smoke")
# the moe-train phase: qwen3-30b-a3b's published widths cut in depth only
# (48 -> 2 layers, registered here under its own name): 2 x 511 tokens x
# top-8 = 8176 expert rows over 128 experts, so the forward takes the
# prefill form of the grouped expert kernel
MOE_TRAIN_MODEL, MOE_TRAIN_LAYERS = "qwen3-30b-a3b-2-layers", 2
# the lora phase: a rank-16 adapter on every LORA_KEYS matrix of qwen3-8b,
# B drawn N(0, LORA_B_STD) from its own generator (B = 0 would change nothing)
LORA_RANK, LORA_ALPHA, LORA_B_STD = 16, 32.0, 1e-2
LORA_PROMPT = "LoRA: name one river."   # under one 64-token page: nothing cached
# beyond the merge's own tensors, the load may allocate the cuBLAS
# workspace of the server thread's first product (32 MiB at torch's
# default on this card) and the allocator's rounding
LORA_SLACK = 2**26


def _train_batch(vocab: int):
    """One fixed batch from seed 0: tokens [TRAIN_B, TRAIN_T], the loss
    mask on the second half of each row."""
    import numpy as np

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (TRAIN_B, TRAIN_T)).astype(np.int32)
    mask = np.zeros((TRAIN_B, TRAIN_T), np.float32)
    mask[:, TRAIN_T // 2:] = 1.0
    return tokens, mask


def _tree_bits_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_bits_equal(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
            and bool((a.view(_int_dtype(a)) == b.view(_int_dtype(b))).all()))


def _int_dtype(t):
    """The integer dtype of ``t``'s width, to compare tensors bit for bit."""
    import torch

    return {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]


def phase_train(card: str) -> dict:
    """Full SFT of qwen3-4b through ``train/trainer.train_loop`` (random
    bf16 weights from seed 0, ``TRAIN_STEPS`` steps of B=2, T=512 on one
    fixed batch): finite losses and grad norms, the last loss below the
    first; the eval step on the trained params equals the next train
    step's loss on them (that step timed); the checkpoint written and read
    back bit for bit; then an ``Engine`` on the trained weights serves
    greedy requests through B3 / B4 / B5 (counters zeroed before) and its
    serving logits are held to the no-cache forward."""
    import torch

    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest
    from deepsearch_tts_tpu_torch.models.registry import get_model
    from deepsearch_tts_tpu_torch.train import trainer
    from deepsearch_tts_tpu_torch.train.checkpoint import restore_params, save_params

    fam = get_model(TRAIN_MODEL)
    tokens, mask = _train_batch(fam.config.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    stamps = []

    def stamp(rec):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log(f"[train] {rec}")

    t0 = time.perf_counter()
    state, history = trainer.train_loop(
        TRAIN_MODEL, None, iter([(tokens, mask)] * TRAIN_STEPS), total_steps=TRAIN_STEPS,
        learning_rate=TRAIN_LR, log_every=1, seed=0, log=stamp, device="cuda")
    loop_s = time.perf_counter() - t0
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    assert len(history) == TRAIN_STEPS, history
    assert all(math.isfinite(x) for x in losses + norms), history
    assert losses[-1] < losses[0], losses
    # the eval step on the trained params, then one more train step on the
    # same params: the same loss
    eval_fn = trainer.make_eval_step(fam.forward, fam.config)
    step_fn = trainer.make_train_step(
        fam.forward, fam.config, trainer.make_optimizer(TRAIN_LR, TRAIN_STEPS))
    ev = float(eval_fn(state.params, tokens, mask))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, metrics = step_fn(state, tokens, mask)
    nxt = float(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1)
    loop_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] {card} | {TRAIN_MODEL} full SFT, B={TRAIN_B} T={TRAIN_T}, lr {TRAIN_LR}: "
        f"losses {losses}, grad norms {norms}; eval loss on the trained params {ev!r}, "
        f"the next train step's loss {nxt!r}; step {step_ms:.1f} ms (loop steps 2-"
        f"{TRAIN_STEPS}: {', '.join(f'{m:.1f}' for m in loop_ms)} ms, each with its "
        f"host read of the loss), loop {loop_s:.1f} s with init; peak memory {peak:.2f} GiB")
    assert abs(ev - nxt) <= 1e-6 * abs(nxt), (ev, nxt)
    # the checkpoint: write, read back onto the card, bit for bit
    del metrics
    state = state._replace(opt_state=None)
    _free()
    t2 = time.perf_counter()
    path = save_params(TRAIN_DIR, state.params, step=TRAIN_STEPS + 1)
    write_s = time.perf_counter() - t2
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 2**30
    t3 = time.perf_counter()
    back = restore_params(path, like=state.params)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t3
    same = _tree_bits_equal(back, state.params)
    log(f"[train] checkpoint {size:.2f} GiB written in {write_s:.2f} s, read back onto "
        f"the card in {read_s:.2f} s; bit-equal: {same}")
    assert same
    del back
    import shutil

    shutil.rmtree(TRAIN_DIR)
    _free()
    # the trained weights served: B3 / B4 / B5, logits against the no-cache forward
    engine = _engine(state.params, model=TRAIN_MODEL, page_size=64, n_pages=256)
    counters = _counters(TRAIN_MODEL)
    assert engine.layer_fusion
    _zero(counters)
    st0 = dict(engine.stats)
    prompt = engine.tokenizer.encode("Trained: name three rivers of Europe.")
    futs = engine.submit_many([GenerationRequest(prompt_ids=prompt + [i], max_tokens=24,
                                                 **GREEDY) for i in range(4)])
    outs = [f.result(timeout=600) for f in futs]
    st1 = _settled(engine)
    launches = _check_launches("train-serve", engine, counters, st0, st1)
    assert all(o.completion_tokens >= 1 for o in outs), [o.completion_tokens for o in outs]
    phase_reference(engine, tag="train-reference")
    engine.shutdown()
    del engine, state
    _free()
    return {"losses": losses, "grad_norms": norms, "eval_loss": ev, "next_loss": nxt,
            "step_ms": step_ms, "loop_step_ms": loop_ms, "peak_gib": peak,
            "ckpt_gib": size, "ckpt_write_s": write_s, "ckpt_read_s": read_s,
            "serve_launches": launches}


@contextlib.contextmanager
def _routed_rows():
    """Record, while the block runs, each MoE layer's expert of every
    (token, top-k) assignment (what ``moe.group_offsets`` counts): yields
    the list."""
    from deepsearch_tts_tpu_torch.ops import moe

    inner, seen = moe.group_offsets, []

    def recorded(flat_e, n_exp):
        seen.append(flat_e.cpu())
        return inner(flat_e, n_exp)

    moe.group_offsets = recorded
    try:
        yield seen
    finally:
        moe.group_offsets = inner


def phase_moe_train(card: str) -> dict:
    """One training step of Qwen3-MoE at qwen3-30b-a3b's widths, 2 layers:
    the gradients through the grouped expert kernel (its prefill form,
    ``prefill_launches`` must move) are non-zero on every expert that got
    rows the loss reaches (in the last layer, rows of positions whose next
    token is in the loss mask; in the first, every row, through attention)
    and zero on the others, non-zero on the router, and equal the gradients
    of the same step with the plain expert versions (``plain_experts``)
    within ``BF16_RTOL`` of each leaf's norm; then an optimizer step."""
    import functools

    import torch

    from deepsearch_tts_tpu_torch.engine.weights import convert_qwen3_moe, init_params
    from deepsearch_tts_tpu_torch.models import qwen3_moe, registry
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.train import trainer

    cfg = dataclasses.replace(qwen3_moe.QWEN3_MOE_CONFIGS[MOE_MODEL], n_layers=MOE_TRAIN_LAYERS)
    registry.register(MOE_TRAIN_MODEL, cfg, qwen3_moe.forward, convert_qwen3_moe)
    fam = registry.get_model(MOE_TRAIN_MODEL)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(fam, device="cuda", seed=0)
    gib = sum(t.numel() * t.element_size() for t in trainer._leaves(params)) / 2**30
    tokens, mask = _train_batch(cfg.vocab_size)
    counters = {f.__name__: f for f in (moe.grouped_gateup, moe.grouped_down)}
    _zero(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _routed_rows() as assigned:
        loss_k, g_k = trainer.loss_and_grads(fam.forward, cfg, params, tokens, mask)
    torch.cuda.synchronize()
    grad_ms = 1e3 * (time.perf_counter() - t0)
    launches = {n: (f.launches, f.prefill_launches) for n, f in counters.items()}
    # each path timed on its second call (the first builds cuBLAS plans and
    # loads kernels)
    t1 = time.perf_counter()
    trainer.loss_and_grads(fam.forward, cfg, params, tokens, mask)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(2):
        t3 = time.perf_counter()
        loss_p, g_p = trainer.loss_and_grads(
            functools.partial(fam.forward, plain_experts=True), cfg, params, tokens, mask)
        torch.cuda.synchronize()
    plain_ms, first_ms, grad_ms = (1e3 * (time.perf_counter() - t3), grad_ms,
                                   1e3 * (t2 - t1))
    # an assignment's rows reach the loss in the last layer only where the
    # token's next one is in the loss mask
    live = torch.from_numpy(mask[:, 1:].reshape(-1) > 0).repeat_interleave(cfg.top_k)
    rows = [torch.bincount(e, minlength=cfg.n_experts) for e in assigned]
    reached = rows[:-1] + [torch.bincount(assigned[-1][live], minlength=cfg.n_experts)]
    log(f"[moe-train] {MOE_TRAIN_MODEL}: {gib:.2f} GiB of params, loss {float(loss_k)!r} "
        f"(plain experts {float(loss_p)!r}), loss and grads {grad_ms:.1f} ms (plain experts "
        f"{plain_ms:.1f} ms; the first call {first_ms:.1f} ms); grouped expert launches (all, "
        f"prefill form) of the first call {launches}; expert "
        f"rows a layer {[int(r.sum()) for r in rows]}")
    assert len(rows) == MOE_TRAIN_LAYERS and all(int(r.sum()) == 8 * TRAIN_B * (TRAIN_T - 1)
                                                  for r in rows), rows
    for name, (n, n_prefill) in launches.items():
        assert n == n_prefill == MOE_TRAIN_LAYERS, (name, n, n_prefill)
    lp = g_k["layers"]
    for layer, r in enumerate(reached):
        got = r > 0
        for key in ("w_gateup", "w_down"):
            nz = lp[key][layer].flatten(1).abs().amax(1).cpu() > 0
            assert torch.equal(nz, got), (key, layer, int(nz.sum()), int(got.sum()))
        assert float(lp["router"][layer].abs().max()) > 0, layer
    errs = {}
    for key in sorted(lp):
        a, b = lp[key].float(), g_p["layers"][key].float()
        errs[key] = float((a - b).norm() / b.norm().clamp(min=1e-30))
    for key in ("embed", "final_norm", "lm_head"):
        a, b = g_k[key].float(), g_p[key].float()
        errs[key] = float((a - b).norm() / b.norm().clamp(min=1e-30))
    log(f"[moe-train] every expert with rows the loss reaches (layer 0: "
        f"{int((reached[0] > 0).sum())}, layer 1: {int((reached[1] > 0).sum())} of "
        f"{int((rows[1] > 0).sum())} with rows; {cfg.n_experts} experts) has non-zero "
        f"gate|up and down gradients, the others zero; router gradients non-zero; kernel vs plain "
        f"gradients, relative to each leaf's norm: {json.dumps(errs)} (bound {BF16_RTOL})")
    assert all(e <= BF16_RTOL for e in errs.values()), errs
    del g_k, g_p
    _free()
    opt = trainer.make_optimizer(1e-4)
    state = trainer.TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
    step_fn = trainer.make_train_step(fam.forward, cfg, opt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, metrics = step_fn(state, tokens, mask)
    loss = float(metrics["loss"])
    step_ms = 1e3 * (time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert math.isfinite(loss) and math.isfinite(float(metrics["grad_norm"])), metrics
    log(f"[moe-train] {card} | one optimizer step {step_ms:.1f} ms, loss {loss!r}, grad "
        f"norm {float(metrics['grad_norm'])!r}; peak memory {peak:.2f} GiB")
    del state, params
    _free()
    return {"params_gib": gib, "loss": float(loss_k), "plain_loss": float(loss_p),
            "grad_ms": grad_ms, "first_grad_ms": first_ms, "plain_grad_ms": plain_ms,
            "step_ms": step_ms, "peak_gib": peak,
            "grouped_launches": launches, "grad_rel_err": errs}


def _fingerprint(t) -> int:
    """The sum of a bf16 stack's 16-bit words, one layer at a time (a
    change of any element changes it but for a collision)."""
    import torch

    return sum(int(m.view(torch.int16).sum(dtype=torch.int64)) for m in t)


def _merged_ulps(new, old, ad, cols: slice) -> int:
    """The most bf16 ulps by which columns ``cols`` of a merged leaf differ
    from the plain per-leaf float32 merge (``train/lora.apply_lora``) of the
    old leaf, one layer at a time."""
    import torch

    from deepsearch_tts_tpu_torch.train.lora import apply_lora

    worst = 0
    for layer in range(new.shape[0]):
        one = {k: (v[layer:layer + 1] if isinstance(v, torch.Tensor) else v)
               for k, v in ad.items()}
        ref = apply_lora({"w": old[layer:layer + 1][..., cols]}, {"w": one})["w"]
        got = new[layer:layer + 1][..., cols]
        worst = max(worst, int((got.view(torch.int16).int()
                                - ref.view(torch.int16).int()).abs().max()))
    return worst


def phase_lora(card: str, params: dict) -> dict:
    """Hot-load a rank-16 adapter into a fresh qwen3-8b engine with the CLI's
    defaults (paged, prefix cache, the lane of 16) through ``POST
    /v1/load_lora_adapter`` on its ``OpenAIServer``: the merged leaves equal
    the plain per-leaf float32 merge within 1 bf16 ulp; the memory the load
    allocates stays within one new copy of the merged leaves, the adapter
    and two float32 column blocks of one matrix (``train/lora.merge_lora``'s
    scratch); a fresh prompt's greedy output changes; B3 / B4 / B5 serve the
    merged weights; its serving logits agree with the no-cache forward on
    them; a second engine on the same tree keeps the old weights and
    output."""
    import torch

    from deepsearch_tts_tpu_torch.engine.weights import unpack_matmul_params
    from deepsearch_tts_tpu_torch.train.checkpoint import save_params
    from deepsearch_tts_tpu_torch.train.lora import _PACKED, _packed_widths, init_lora

    eng = _engine(params, page_size=64, n_pages=256, prefill_lane=LANE)
    sib = _engine(params, page_size=64, n_pages=64)
    cfg = eng.cfg
    old = dict(eng.params["layers"])
    sums = {k: _fingerprint(t) for k, t in old.items()}
    lora = init_lora(unpack_matmul_params(params, cfg), rank=LORA_RANK, alpha=LORA_ALPHA,
                     seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    ads = {k: v for k, v in lora["layers"].items() if v is not None}
    for ad in ads.values():
        ad["b"] = (torch.randn(ad["b"].shape, generator=gen, device="cuda")
                   * LORA_B_STD).to(ad["b"].dtype)
    ad_bytes = sum(t.numel() * t.element_size() for ad in ads.values()
                   for t in (ad["a"], ad["b"]))
    path = save_params(os.path.join(HERE, "build", "lora_smoke"), lora)
    counters = _counters("qwen3-8b")
    greedy = dict(max_tokens=16, **GREEDY)
    try:
        with _serve_http(eng) as base:
            def chat(content):
                return _chat_text(base, content, **greedy)

            before = chat(LORA_PROMPT)
            torch.cuda.synchronize()
            base_alloc = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            code, body, load_s = _post(f"{base}/load_lora_adapter",
                                       {"lora_name": "smoke", "lora_path": path})
            assert code == 200 and body["status"] == "ok", body
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base_alloc
            new = eng.params["layers"]
            merged = [k for k in new if new[k] is not old[k]]
            new_bytes = sum(new[k].numel() * new[k].element_size() for k in merged)
            widths = [(new[k].shape[-2], n) for k in merged
                      for n in (_packed_widths(k, new[k], cfg) if k in _PACKED
                                else [new[k].shape[-1]])]
            # the merge's scratch: one column block's float32 W and delta,
            # and the block's A [K, r] and B [r, n] widened to float32
            block = max(4 * (2 * kd * n + LORA_RANK * (kd + n)) for kd, n in widths)
            bound = new_bytes + ad_bytes + block + LORA_SLACK
            log(f"[lora] {card} | adapter (rank {LORA_RANK}, {ad_bytes / 2**20:.1f} MiB, "
                f"{len(ads)} leaves) loaded over HTTP in {load_s:.3f} s; merged leaves "
                f"{merged} ({new_bytes / 2**30:.3f} GiB new); peak allocated during the load "
                f"{peak / 2**20:.1f} MiB above the engine's, bound {bound / 2**20:.1f} MiB "
                f"(the new leaves + the adapter + the merge's float32 scratch of "
                f"{block / 2**20:.1f} MiB + {LORA_SLACK / 2**20:.0f} MiB)")
            assert sorted(merged) == ["w_down", "w_gateup", "wo", "wqkv"], merged
            assert peak <= bound, (peak, bound)
            ulps = {}
            for k in merged:
                names = _PACKED.get(k, (k,))
                widths = (_packed_widths(k, new[k], cfg) if k in _PACKED
                          else [new[k].shape[-1]])
                c0 = 0
                for name, n in zip(names, widths):
                    ulps[name] = _merged_ulps(new[k], old[k], ads[name], slice(c0, c0 + n))
                    c0 += n
            log(f"[lora] merged leaves vs the plain per-leaf float32 merge: most bf16 "
                f"ulps apart {ulps} (bound 1)")
            assert max(ulps.values()) <= 1, ulps
            _zero(counters)
            st0 = dict(eng.stats)
            after = chat(LORA_PROMPT)
            more = [chat(f"LoRA {i}: name one lake.") for i in range(3)]
            st1 = _settled(eng)
            launches = _check_launches("lora", eng, counters, st0, st1)
    finally:
        eng.shutdown()
    try:
        with _serve_http(sib) as base:
            out_sib = _chat_text(base, LORA_PROMPT, **greedy)
    finally:
        sib.shutdown()
    sib_same = (all(sib.params["layers"][k] is old[k] for k in old)
                and {k: _fingerprint(t) for k, t in sib.params["layers"].items()} == sums)
    log(f"[lora] greedy output of a fresh prompt before the load {before!r}, after "
        f"{after!r}; the sibling engine on the same tree: weights unchanged {sib_same}, "
        f"output {out_sib!r}; {len(more)} more requests served")
    assert after != before, (before, after)
    assert sib_same and out_sib == before, (sib_same, out_sib, before)
    phase_reference(eng, tag="lora-reference")
    del eng, sib, new, old
    _free()
    return {"load_s": load_s, "peak_mib": peak / 2**20, "bound_mib": bound / 2**20,
            "merged_gib": new_bytes / 2**30, "ulps": ulps, "launches": launches}


def _chat_text(base: str, content: str, **kw) -> str:
    """The reply to one user message over HTTP at the ``/v1`` URL ``base``."""
    code, body, _ = _post(f"{base}/chat/completions",
                          {"messages": [{"role": "user", "content": content}], **kw})
    assert code == 200, body
    return body["choices"][0]["message"]["content"]


# ------------------------------------------------------------------ parallel

# the parallel phase: ranks as processes of their own
# (parallel/launch.run_ranks; torchrun for the CLI): NCCL with a card a rank,
# gloo with both ranks on one card (NCCL refuses two ranks on one device;
# the collectives then stage through host memory, parallel/collectives.py)
PAR_RANKS = 2
# qwen3-8b at full width and depth over tp=2 (16 / 4 local heads), its long
# fresh prompt (bucket 4096) held to the reference through ring attention and
# Ulysses, and the prompt the scheduler's sequence-parallel gate routes
# (bucket 2048, the gate's least)
PAR_DENSE, PAR_LONG, PAR_RING, PAR_ROUTED = "qwen3-8b", 4000, 2048, 2040
# the teacher-forced probe: a prefill of T0 tokens, then one decode step a
# token, held to the tp=1 no-cache forward on the same seed-0 weights
PAR_T0, PAR_STEPS = 16, 8
# qwen3-30b-a3b's widths at 2 of its 48 layers over ep=2 (64 experts a rank),
# and a prompt long enough for the prefill form of the grouped expert kernel
PAR_MOE, PAR_MOE_LAYERS, PAR_MOE_LONG = "qwen3-30b-a3b-2-layers", 2, 3000
PAR_BURST, PAR_BURST_TOKENS = SLOTS, 16
PAR_TIMEOUT_S = 600.0            # the parent's deadline for the ranks
PAR_COLLECTIVE_S = 180.0         # a rank's collective timeout
PAR_CLI_TIMEOUT_S = 300.0        # torchrun ... cli.serve --tp 2: start and answer


def _par_register() -> None:
    """qwen3-30b-a3b cut to PAR_MOE_LAYERS layers, under its own name."""
    from deepsearch_tts_tpu_torch.models import qwen3_moe, registry

    cfg = dataclasses.replace(qwen3_moe.QWEN3_MOE_CONFIGS[MOE_MODEL], n_layers=PAR_MOE_LAYERS)
    registry.register(PAR_MOE, cfg, qwen3_moe.forward, logical_axes=qwen3_moe.logical_axes)


def _par_reference(model: str, toks, long_toks=None, **kw):
    """The tp=1 no-cache forward over the whole seed-0 weights (drawn here,
    freed after): logits at the probe's positions T0-1 .. T-1, and at the
    long prompt's last position."""
    import torch

    from deepsearch_tts_tpu_torch.engine.weights import init_params
    from deepsearch_tts_tpu_torch.models.registry import get_model

    fam = get_model(model)
    dev = toks.device
    full = init_params(fam, device=dev, seed=0)
    with torch.no_grad():
        ref = fam.forward(full, fam.config, toks, torch.arange(toks.shape[1], device=dev)[None],
                          **kw)[0][0, PAR_T0 - 1:]
        long_ref = None
        if long_toks is not None:
            n = long_toks.shape[1]
            long_ref = fam.forward(full, fam.config, long_toks,
                                   torch.arange(n, device=dev)[None],
                                   logits_indices=torch.tensor([n - 1], device=dev), **kw)[0][:, 0]
    del full
    _free()
    return ref, long_ref


def _tree_gib(tree) -> float:
    """GiB of a param tree's tensors."""
    if isinstance(tree, dict):
        return sum(_tree_gib(v) for v in tree.values())
    return tree.numel() * tree.element_size() / 2**30


def _par_probe(eng, toks, table):
    """The serving path's logits at the probe's positions, straight through
    the sharded engine's forward (its pools, page table ``table``), on every
    rank: a prefill of T0 tokens, then one T=1 decode step a token."""
    import torch

    dev = eng.device
    T0, T = PAR_T0, PAR_T0 + PAR_STEPS
    pos = torch.arange(T, device=dev)[None]

    def t(v):
        return torch.tensor(v, device=dev)

    # a slot decode step runs every slot row (B == rows); the rows past the
    # first are padding (position -1, length 0)
    B = eng.max_slots if eng.cache_mode == "slot" else 1
    with torch.no_grad():
        out = [eng._forward(toks[:, :T0], pos[:, :T0], table, t([T0]),
                            logits_indices=t([T0 - 1]), fresh=eng.fresh_prefill)[0][:, 0]]
        for i in range(T0, T):
            tk = torch.zeros((B, 1), dtype=torch.int64, device=dev)
            ps = torch.full((B, 1), -1, dtype=torch.int64, device=dev)
            lens = torch.zeros((B,), dtype=torch.int64, device=dev)
            tk[0], ps[0], lens[0] = toks[0, i], i, i + 1
            tables = table.expand(B, -1) if B > 1 else table
            out.append(eng._forward(tk, ps, tables, lens,
                                    slot_ctx=eng._slot_bucket(i + 1))[0][:1, 0])
    return torch.cat(out)


def _par_long(eng, long_toks, seq_parallel):
    """A fresh prefill of the long prompt (padded to its bucket) through the
    paged engine's forward, its pages 1.., ``seq_parallel`` ("ring",
    "ulysses" or None: K2 at the local heads): the last position's logits
    and the rank's wall seconds."""
    import torch

    dev, n = eng.device, long_toks.shape[1]
    T = eng._bucket(n)
    toks = torch.zeros((1, T), dtype=torch.int64, device=dev)
    toks[:, :n] = long_toks
    pos = torch.full((1, T), -1, dtype=torch.int64, device=dev)
    pos[0, :n] = torch.arange(n, device=dev)
    table = torch.arange(1, eng._page_bucket(n) + 1, device=dev)[None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = eng._forward(toks, pos, table, torch.tensor([n], device=dev),
                              logits_indices=torch.tensor([n - 1], device=dev), fresh=True,
                              seq_parallel=seq_parallel)[0][:, 0]
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0


def _par_segment(rank: int, eng, work) -> dict:
    """One serving segment under the mesh: rank 0 runs ``work(eng)`` (its
    requests) and shuts the engine's scheduler down; the other ranks follow
    it until then. Each rank reports its greedy tokens (rank 0's requests,
    a follower's copies, in submission order), its decode steps, prefill
    dispatches and the segment's wall seconds."""
    st0 = dict(eng.stats)
    eng.mirrored = []
    t0 = time.perf_counter()
    if rank == 0:
        try:
            out = work(eng)
        finally:
            eng.shutdown()
    else:
        eng.follow()
        out = {"tokens": [f.result(timeout=60).token_ids for f in eng.mirrored]}
    steps, prefills, lanes = _steps(eng, st0, eng.stats)
    dt = eng.stats["decode_time_s"] - st0["decode_time_s"]
    out.update(steps=steps, prefills=prefills, lanes=lanes, wall_s=time.perf_counter() - t0,
               ms_per_step=1e3 * dt / max(steps, 1))
    return out


def _par_requests(eng, prompts, max_tokens: int, **sampler) -> dict:
    """Rank 0: ``prompts`` submitted together, each to ``max_tokens`` tokens;
    their tokens and the client-clock seconds."""
    from deepsearch_tts_tpu_torch.engine.engine import GenerationRequest

    sampler = {**GREEDY, **sampler}
    t0 = time.perf_counter()
    futs = eng.submit_many([GenerationRequest(prompt_ids=list(p), max_tokens=max_tokens,
                                              **sampler) for p in prompts])
    res = [f.result(timeout=600) for f in futs]
    return {"tokens": [r.token_ids for r in res], "seconds": time.perf_counter() - t0}


def _par_burst_prompts(eng) -> list:
    return [eng.tokenizer.encode(f"Burst {i}: write a long story.") for i in range(PAR_BURST)]


def _par_dense(rank: int, mesh) -> dict:
    """qwen3-8b over tp=2: the slot engine (K1 at 16 / 4 local heads, B5)
    and the paged ``attn_impl="pallas"`` engine without a prefix cache
    (B2 and B6 at the local heads, B5), each held to the tp=1 no-cache
    forward (teacher-forced probe); the paged engine's long fresh prompt
    through ring attention and Ulysses (K2 inside), by the forward and by
    the scheduler's gate (``ring_prefill_len``)."""
    import torch

    from deepsearch_tts_tpu_torch.engine.engine import Engine
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(1)
    V = 151936
    toks = torch.randint(0, V, (1, PAR_T0 + PAR_STEPS), generator=gen, device=dev)
    long_toks = torch.randint(0, V, (1, PAR_LONG), generator=gen, device=dev)
    ref = long_ref = None
    if rank == 0:
        ref, long_ref = _par_reference(PAR_DENSE, toks, long_toks)
    res: dict = {}
    tok = ByteTokenizer()

    # slot engine: K1 at the local heads, B5 on the all-gathered logits;
    # its build's peak beside the rank's share of the weights (each matrix
    # is cut to the rank's block as it is drawn)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine(PAR_DENSE, tok, device=dev, mesh=mesh, cache_mode="slot", max_slots=SLOTS,
                 max_seq_len=CTX, decode_chunk_len=8, prefill_lane=0, seed=0)
    res["slot_build_s"] = time.perf_counter() - t0
    res["build_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    res["weights_gib"] = _tree_gib(eng.params)
    assert eng.attn_impl == "pallas" and not eng.layer_fusion, (eng.attn_impl, eng.layer_fusion)
    assert eng.fcfg.n_heads == 16 and eng.fcfg.n_kv_heads == 4, eng.fcfg
    got = _par_probe(eng, toks, torch.zeros((1, 1), dtype=torch.int64, device=dev))
    if rank == 0:
        _hold_to_reference("parallel", "tp=2 slot serving-path (K1)", got, ref)
    counters = {"slot_attention": sa.slot_attention, "sampling_prep": sp.sampling_prep}
    _zero(counters)
    burst = _par_segment(rank, eng, lambda e: _par_requests(e, _par_burst_prompts(e),
                                                            PAR_BURST_TOKENS))
    L = eng.cfg.n_layers
    launches = {n: f.launches for n, f in counters.items()}
    assert launches["slot_attention"] == L * burst["steps"] > 0, (launches, burst)
    assert launches["sampling_prep"] == burst["steps"] + burst["prefills"], (launches, burst)
    res["slot"] = {**burst, "launches": launches}
    _release(eng)
    del eng
    _free()

    # paged engine, attn_impl="pallas", no prefix cache: fresh prefill on K2,
    # T=1 decode on B6; the long prompt sequence-parallel past PAR_RING
    t0 = time.perf_counter()
    eng = Engine(PAR_DENSE, tok, device=dev, mesh=mesh, attn_impl="pallas",
                 enable_prefix_cache=False, ring_prefill_len=PAR_RING, page_size=64,
                 n_pages=1024, max_slots=SLOTS, max_seq_len=CTX, decode_chunk_len=8,
                 prefill_lane=0, seed=0)
    res["paged_build_s"] = time.perf_counter() - t0
    got = _par_probe(eng, toks, torch.ones((1, 1), dtype=torch.int64, device=dev))
    if rank == 0:
        _hold_to_reference("parallel", "tp=2 paged pallas serving-path (K2, B6)", got, ref)
    long = {}
    for how in ("ring", "ulysses"):
        fa.flash_attention.launches = 0
        logits, secs = _par_long(eng, long_toks, how)
        long[how] = {"s": secs, "k2_launches": fa.flash_attention.launches}
        if rank == 0:
            _hold_to_reference("parallel", f"tp=2 {PAR_LONG}-token fresh prefill ({how})",
                               logits, long_ref)
    # Ulysses runs K2 at the local heads over the whole sequence; ring
    # attention's blocks are plain torch (JAX's are XLA einsum)
    assert long["ulysses"]["k2_launches"] == L and long["ring"]["k2_launches"] == 0, long
    res["long_forward"] = long
    routed = long_toks[0, :PAR_ROUTED].tolist()
    counters = {"pallas_paged_attention": pa.pallas_paged_attention,
                "flash_attention": fa.flash_attention, "sampling_prep": sp.sampling_prep}
    _zero(counters)
    sp0 = eng.sp_prefills

    def work(e):
        out = _par_requests(e, _par_burst_prompts(e), PAR_BURST_TOKENS)
        long_req = _par_requests(e, [routed], 4)
        out["tokens"] += long_req["tokens"]
        out["long_s"] = long_req["seconds"]
        return out

    burst = _par_segment(rank, eng, work)
    launches = {n: f.launches for n, f in counters.items()}
    assert eng.sp_prefills - sp0 == 1, (eng.sp_prefills, sp0)
    assert launches["pallas_paged_attention"] == L * burst["steps"] > 0, (launches, burst)
    # every burst prefill is fresh and short (K2); the long one ring (no K2)
    assert launches["flash_attention"] == L * (burst["prefills"] - 1) > 0, (launches, burst)
    assert launches["sampling_prep"] == burst["steps"] + burst["prefills"], (launches, burst)
    res["paged"] = {**burst, "launches": launches}
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    _release(eng)
    del eng
    _free()
    return res


def _par_moe(rank: int) -> dict:
    """qwen3-30b-a3b's widths at 2 layers over ep=2: each rank's 64 experts
    through the grouped expert kernels (decode and, on a long prompt, the
    prefill form), held to the ep=1 no-cache forward on the plain experts."""
    import torch

    from deepsearch_tts_tpu_torch.engine.engine import Engine
    from deepsearch_tts_tpu_torch.engine.tokenizer import ByteTokenizer
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import sampling_prep as sp
    from deepsearch_tts_tpu_torch.parallel.mesh import make_mesh

    _par_register()
    mesh = make_mesh(ep=PAR_RANKS, device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, 151936, (1, PAR_T0 + PAR_STEPS), generator=gen, device=dev)
    ref = None
    if rank == 0:
        ref, _ = _par_reference(PAR_MOE, toks, plain_experts=True)
    t0 = time.perf_counter()
    eng = Engine(PAR_MOE, ByteTokenizer(), device=dev, mesh=mesh, page_size=64, n_pages=1024,
                 max_slots=SLOTS, max_seq_len=CTX, decode_chunk_len=8, prefill_lane=0, seed=0)
    build_s = time.perf_counter() - t0
    assert eng.params["layers"]["w_gate"].shape[1] == M_NE // PAR_RANKS, \
        eng.params["layers"]["w_gate"].shape
    got = _par_probe(eng, toks, torch.ones((1, 1), dtype=torch.int64, device=dev))
    if rank == 0:
        _hold_to_reference("parallel", "ep=2 qwen3-30b-a3b (2 layers) serving-path", got, ref)
    counters = {"grouped_gateup": moe.grouped_gateup, "grouped_down": moe.grouped_down,
                "sampling_prep": sp.sampling_prep}
    _zero(counters)
    long_prompt = torch.randint(0, 151936, (PAR_MOE_LONG,), generator=gen, device=dev).tolist()

    def work(e):
        out = _par_requests(e, _par_burst_prompts(e), PAR_BURST_TOKENS)
        long_req = _par_requests(e, [long_prompt], 4)
        out["tokens"] += long_req["tokens"]
        out["long_s"] = long_req["seconds"]
        return out

    burst = _par_segment(rank, eng, work)
    launches = {n: f.launches for n, f in counters.items()}
    launches.update({n + "_prefill": counters[n].prefill_launches
                     for n in ("grouped_gateup", "grouped_down")})
    L = eng.cfg.n_layers
    for n in ("grouped_gateup", "grouped_down"):
        assert launches[n] == L * (burst["steps"] + burst["prefills"]) > 0, (launches, burst)
        assert launches[n + "_prefill"] >= L, launches   # the long prompt at least
    assert launches["sampling_prep"] == burst["steps"] + burst["prefills"], (launches, burst)
    out = {**burst, "launches": launches, "build_s": build_s,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    _release(eng)
    return out


def _par_local_kernels(gen) -> dict:
    """The kernels the mesh path runs, each against its plain version at
    the local shape the mesh gives it (at the kernel phases' tolerances):
    qwen3-8b over tp=2 holds 16 q and 4 kv heads a rank (K1 on the slot
    pool, B6 on the paged pool, K2 on a fresh prefill, at the burst's and
    the long prompt's lengths: Ulysses runs K2 at the local heads over the
    whole sequence), and qwen3-30b-a3b over ep=2 runs the grouped expert
    kernels over a rank's 64 experts (the decode form on a burst step's
    rows, the prefill form on the long prompt's)."""
    import torch

    from deepsearch_tts_tpu_torch.ops import flash_attention as fa
    from deepsearch_tts_tpu_torch.ops import moe
    from deepsearch_tts_tpu_torch.ops import paged_attention as pa
    from deepsearch_tts_tpu_torch.ops import slot_attention as sa

    dev, bf = torch.device("cuda"), torch.bfloat16
    h, kv = H // PAR_RANKS, KV // PAR_RANKS
    res: dict = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def attn(*a, **k):
        _check_kernel(res, *a, rtol=ATTN_RTOL, atol=ATTN_ATOL, rms_frac=ATTN_RMS_FRAC, **k)

    L = 2
    kp, vp = rnd(L * SLOTS, CTX, kv, D), rnd(L * SLOTS, CTX, kv, D)
    q = rnd(SLOTS, h, D)
    lim = torch.tensor(LIMITS, device=dev)
    for layer in range(L):
        attn("slot_attention", f"tp=2 h={h} kv={kv} B={SLOTS} layer={layer}",
             lambda: sa.slot_attention(q, kp, vp, lim, layer, n_rows=SLOTS, slot_ctx=CTX),
             lambda: sa.slot_attention_plain(q, kp, vp, lim, layer, n_rows=SLOTS,
                                             slot_ctx=CTX))
    del kp, vp
    ps, P = 64, CTX // 64
    NP = 1 + SLOTS * P
    kpg, vpg = rnd(NP, ps, kv, D), rnd(NP, ps, kv, D)
    kpg[0], vpg[0] = 0, 0
    seq = torch.tensor(SEQS, device=dev)
    perm = torch.randperm(NP - 1, generator=gen, device=dev)[: SLOTS * P].view(SLOTS, P)
    table = torch.where(torch.arange(P, device=dev)[None] < ((seq + ps - 1) // ps)[:, None],
                        perm + 1, 0)
    q1 = rnd(SLOTS, 1, h, D)
    attn("pallas_paged_attention", f"tp=2 h={h} kv={kv} B={SLOTS} T=1 ps={ps}",
         lambda: pa.pallas_paged_attention(q1, kpg, vpg, table, seq, (seq - 1)[:, None]),
         lambda: pa.pallas_paged_attention_plain(q1, kpg, vpg, table, seq, (seq - 1)[:, None]))
    del kpg, vpg
    for T in (32, PAR_ROUTED, 4096):   # a burst prompt, the routed one, the long bucket
        qf, kf, vf = rnd(1, T, h, D), rnd(1, T, kv, D), rnd(1, T, kv, D)
        attn("flash_attention", f"tp=2 h={h} kv={kv} B=1 T={T}",
             lambda: fa.flash_attention(qf, kf, vf),
             lambda: fa.flash_attention_plain(qf, kf, vf))
    del qf, kf, vf

    ne = M_NE // PAR_RANKS
    wgu = rnd(ne, M_E, 2 * M_F, scale=M_E ** -0.5)
    wd = rnd(ne, M_F, M_E, scale=M_F ** -0.5)
    for T in (SLOTS, PAR_MOE_LONG):
        # the rows of T tokens' top-k routed to this rank's experts
        _, top_e = moe.route_topk(torch.randn((T, M_NE), generator=gen, device=dev), M_TOPK)
        flat_e = top_e.reshape(-1)
        flat_e = flat_e[flat_e < ne]
        order = torch.argsort(flat_e, stable=True)
        offsets = moe.group_offsets(flat_e, ne)
        xs = rnd(flat_e.numel(), M_E)[order]
        form = "prefill" if moe.grouped_prefill(flat_e.numel(), ne, M_E, M_F) else "decode"
        label = f"ep=2 {ne} experts T={T} ({flat_e.numel()} rows, {form})"
        hh = moe.grouped_gateup_plain(xs, wgu, None, offsets)
        _check_kernel(res, "grouped_gateup", label,
                      lambda: moe.grouped_gateup(xs, wgu, None, offsets),
                      lambda: moe.grouped_gateup_plain(xs, wgu, None, offsets),
                      rtol=BF16_RTOL, atol=BF16_ATOL)
        _check_kernel(res, "grouped_down", label, lambda: moe.grouped_down(hh, wd, offsets),
                      lambda: moe.grouped_down_plain(hh, wd, offsets),
                      rtol=BF16_RTOL, atol=BF16_ATOL)
        res.setdefault("forms", []).append(form)
    assert res["forms"] == ["decode", "prefill"], res["forms"]
    del wgu, wd
    _free()
    return {k: v["err"] for k, v in res.items() if isinstance(v, dict)}


def _parallel_rank(rank: int) -> dict:
    """One rank of the parallel phase (run by ``run_ranks``)."""
    import torch
    import torch.distributed as dist

    from deepsearch_tts_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dense = _par_dense(rank, make_mesh(tp=PAR_RANKS, device_type="cuda"))
    # the caching allocator's reserved-but-unallocated bytes at the peak
    # (parallel/plan.py's reserve, beside the CUDA context)
    dense["slack_gib"] = (torch.cuda.max_memory_reserved()
                          - torch.cuda.max_memory_allocated()) / 2**30
    torch.cuda.reset_peak_memory_stats()
    moe_res = _par_moe(rank)
    return {"rank": rank, "device": str(torch.cuda.current_device()),
            "backend": dist.get_backend(), "dense": dense, "moe": moe_res,
            "wall_s": time.perf_counter() - t0}


def _torchrun_rank0(agent: int) -> int:
    """The pid of torchrun's rank-0 worker: the agent's child whose
    environment holds RANK=0."""
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != agent:
                continue
            with open(f"/proc/{pid}/environ", "rb") as f:
                if b"RANK=0" in f.read().split(b"\0"):
                    return int(pid)
        except (OSError, ValueError, IndexError):
            continue
    raise AssertionError(f"no rank-0 worker under torchrun (pid {agent})")


def _par_cli(card: str) -> dict:
    """``torchrun --nproc_per_node 2 -m deepsearch_tts_tpu_torch.cli.serve
    --model qwen3-8b --tp 2``: one chat request over HTTP to rank 0, then
    SIGTERM to rank 0 alone, whose engine stops every rank; each rank must
    exit 0, and so torchrun. The process group is killed if it outlives
    its deadline."""
    import signal

    from deepsearch_tts_tpu_torch.parallel.launch import free_port

    port, master = free_port(), free_port()
    log_path = os.path.join(HERE, "build", "parallel_cli.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(PAR_RANKS),
           "--master_addr", "127.0.0.1", "--master_port", str(master),
           "-m", "deepsearch_tts_tpu_torch.cli.serve", "--model", PAR_DENSE,
           "--tp", str(PAR_RANKS), "--port", str(port), "--pages", "512", "--max_slots", "8",
           "--max_seq_len", "2048"]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=out, stderr=subprocess.STDOUT, env=env,
                                start_new_session=True)
    base = f"http://127.0.0.1:{port}/v1"
    try:
        deadline = t0 + PAR_CLI_TIMEOUT_S
        while True:
            assert proc.poll() is None, f"torchrun exited with {proc.returncode}"
            assert time.perf_counter() < deadline, "cli.serve --tp 2 did not start in time"
            try:
                with urllib.request.urlopen(base + "/models", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(1.0)
        ready_s = time.perf_counter() - t0
        status, body, secs = _post(base + "/chat/completions", {
            "model": PAR_DENSE, "messages": [{"role": "user", "content": "Name one river."}],
            "max_tokens": 8, **GREEDY}, timeout=PAR_CLI_TIMEOUT_S)
        text = body["choices"][0]["message"]["content"]
        assert status == 200 and 1 <= body["usage"]["completion_tokens"] <= 8, (status, body)
        # SIGTERM to rank 0: its server stops and its engine's stop reaches
        # the other ranks, which leave their follow loop; torchrun exits 0
        # only if every rank did
        os.kill(_torchrun_rank0(proc.pid), signal.SIGTERM)
        rc = proc.wait(timeout=60)
        assert rc == 0, f"torchrun ... cli.serve --tp 2 exited with {rc}"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        try:   # no rank outlives the phase
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        with open(log_path) as f:
            for line in f.read().splitlines()[-8:]:
                log(f"[parallel-cli] {line}")
    return {"ready_s": ready_s, "request_s": secs, "text_chars": len(text), "exit": rc}


def phase_parallel(card: str) -> dict:
    """The parallel layer on the card: PAR_RANKS ranks, each a
    process; qwen3-8b over tp=2 and qwen3-30b-a3b's widths (2 layers) over
    ep=2 (:func:`_parallel_rank`), the ranks' greedy tokens held equal, then
    ``cli/serve.py --tp 2`` under torchrun answering one HTTP request."""
    import torch

    from deepsearch_tts_tpu_torch.parallel.distributed import backend_for
    from deepsearch_tts_tpu_torch.parallel.launch import run_ranks

    cards = torch.cuda.device_count()
    backend = backend_for("cuda", PAR_RANKS)
    not_run = ["dp > 1 (Engine(mesh=) refuses it, ROADMAP.md C)",
               "4-card meshes (tp=4, ep=2 x tp=2: the CPU tests run them)",
               "int8 under a mesh (the CPU tests run it)",
               "sharded training and the pipeline (the CPU tests hold them to JAX's)"]
    if backend == "gloo":
        not_run.insert(0, f"NCCL ({cards} card: both ranks on cuda:0 over gloo, the "
                          f"collectives staged through host memory; this measures "
                          f"correctness and local-shape kernels, not NCCL speed)")
    local_kernels = _par_local_kernels(torch.Generator(device="cuda").manual_seed(7))
    t0 = time.perf_counter()
    ranks = run_ranks(_parallel_rank, PAR_RANKS, device_type="cuda",
                      timeout_s=PAR_TIMEOUT_S, collective_timeout_s=PAR_COLLECTIVE_S)
    ranks_s = time.perf_counter() - t0
    # every rank sampled the same tokens from the same all-gathered logits
    for seg in (("dense", "slot"), ("dense", "paged"), ("moe",)):
        runs = []
        for r in ranks:
            node = r
            for k in seg:
                node = node[k]
            runs.append(node["tokens"])
        assert all(t == runs[0] for t in runs), (seg, runs)
        assert runs[0] and all(len(t) > 0 for t in runs[0]), (seg, runs[0])
    for r in ranks:
        d, m = r["dense"], r["moe"]
        log(f"[parallel] rank {r['rank']} ({r['backend']}, cuda:{r['device']}): qwen3-8b tp=2 "
            f"slot {d['slot']['ms_per_step']:.2f} ms a step ({d['slot']['steps']} steps, "
            f"launches {d['slot']['launches']}), paged pallas "
            f"{d['paged']['ms_per_step']:.2f} ms a step (launches {d['paged']['launches']}), "
            f"long prefill {PAR_LONG} tokens: forward ring "
            f"{d['long_forward']['ring']['s']:.3f} s, ulysses "
            f"{d['long_forward']['ulysses']['s']:.3f} s; "
            f"peak {d['peak_gib']:.2f} GiB (allocator slack {d['slack_gib']:.2f} GiB; the "
            f"slot build's {d['build_peak_gib']:.2f} GiB beside {d['weights_gib']:.2f} GiB "
            f"of weights) | "
            f"qwen3-30b-a3b 2 layers ep=2 "
            f"{m['ms_per_step']:.2f} ms a step, launches {m['launches']}, peak "
            f"{m['peak_gib']:.2f} GiB | {r['wall_s']:.1f} s")
    cli = _par_cli(card)
    log(f"[parallel] cli.serve --tp 2 under torchrun: ready in {cli['ready_s']:.1f} s, one "
        f"request {cli['request_s']:.3f} s, exit {cli['exit']}")
    r0 = ranks[0]
    return {"backend": ranks[0]["backend"], "cards": cards, "ranks": PAR_RANKS,
            "not_run": not_run, "ranks_s": ranks_s,
            "per_rank": [{"rank": r["rank"], "peak_gib_dense": r["dense"]["peak_gib"],
                          "build_peak_gib_dense": r["dense"]["build_peak_gib"],
                          "weights_gib_dense": r["dense"]["weights_gib"],
                          "slack_gib_dense": r["dense"]["slack_gib"],
                          "peak_gib_moe": r["moe"]["peak_gib"],
                          "slot_ms_per_step": r["dense"]["slot"]["ms_per_step"],
                          "paged_ms_per_step": r["dense"]["paged"]["ms_per_step"],
                          "moe_ms_per_step": r["moe"]["ms_per_step"]} for r in ranks],
            "launches": {"slot": r0["dense"]["slot"]["launches"],
                         "paged": r0["dense"]["paged"]["launches"],
                         "moe": r0["moe"]["launches"]},
            "long_forward_s": {k: v["s"] for k, v in r0["dense"]["long_forward"].items()},
            "long_request_s": {"ring": r0["dense"]["paged"]["long_s"]},
            "burst_s": {"slot": r0["dense"]["slot"]["seconds"],
                        "paged": r0["dense"]["paged"]["seconds"],
                        "moe": r0["moe"]["seconds"]},
            "local_kernels_err": local_kernels, "memory": ENV_MEMORY, "cli": cli,
            "card": card}


def _mla_phases(card: str, profile: bool) -> dict:
    """Phases 21-23 on one set of weights, then their release: deepseek-v3's
    published widths, 5 of its 61 layers, registered here under a name of
    its own (the package's registry gains none)."""
    import torch

    _register_mla()
    with _mla_plain_attention("mla"):
        mla_serve, engine = phase_serve(card, model=MLA_MODEL, profile=profile, tag="mla")
    phase_reference(engine, tag="mla-reference", plain_experts=True)
    params = _release(engine)
    del engine
    with _mla_plain_attention("mla-slot"):
        mla_slot = phase_slot_serve(card, params, model=MLA_MODEL, tag="mla-slot")
    with _mla_plain_attention("mla-pallas"):
        mla_pallas = phase_mla_pallas(card, params)
    phase_attention_reference(params, MLA_MODEL, tag="mla-attention-reference",
                              plain_experts=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = _held_gib()
    log(f"[release] MLA engines and weights released: {held:.3f} GiB still allocated")
    assert held < 1.0, held
    return {"mla_serve": mla_serve, "mla_slot": mla_slot, "mla_pallas": mla_pallas}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="add a full-batch burst under torch.profiler to the "
                         "qwen3-8b serve, slot serve and speculative serve "
                         "phases and the qwen3-30b-a3b serve phase (device "
                         "time by kernel, idle share)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build and the kernel checks (prints "
                         "the kernel results, not the final line)")
    ap.add_argument("--product-only", action="store_true",
                    help="only the build, the product phase and the eval phase "
                         "(prints their line, not the final line)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="only the build and the parallel phase (prints its line, "
                         "not the final line)")
    ap.add_argument("--programs-only", action="store_true",
                    help="only the build and the programs phase (eight engines' decode "
                         "and prefill programs, replay against eager; prints its line, "
                         "not the final line)")
    ap.add_argument("--mla-only", action="store_true",
                    help="only the build, the MLA kernel phase and the MLA serve phases "
                         "(prints their line, not the final line)")
    ap.add_argument("--train-only", action="store_true",
                    help="only the build and the train, moe-train and lora phases "
                         "(the last on random qwen3-8b weights; prints their line, "
                         "not the final line)")
    opts = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "deepsearch_tts_tpu_torch")):
        raise SystemExit("chip_smoke: deepsearch_tts_tpu_torch/ not found next to "
                         "this script — run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    _LAP_T[0] = time.time()
    card = phase_env()
    phase_build()
    _lap("build")
    if opts.product_only:
        product = _product_phases(card)
        print(json.dumps({"product": product, "eval": phase_eval(card), "card": card}))
        return 0
    if opts.parallel_only:
        print(json.dumps({"parallel": phase_parallel(card), "card": card}))
        return 0
    if opts.programs_only:
        print(json.dumps({"programs": phase_programs(card), "card": card}))
        return 0
    if opts.train_only:
        from deepsearch_tts_tpu_torch.engine.weights import init_params
        from deepsearch_tts_tpu_torch.models.registry import get_model

        train, moe_train = phase_train(card), phase_moe_train(card)
        lora = phase_lora(card, init_params(get_model("qwen3-8b"), device="cuda", seed=0))
        print(json.dumps({"train": train, "moe_train": moe_train, "lora": lora, "card": card}))
        return 0
    if opts.mla_only:
        mla_res, mla_kernels = phase_mla_kernels(torch.Generator(device="cuda").manual_seed(0))
        _free()
        print(json.dumps({"kernels": mla_res, "mla_kernels": mla_kernels,
                          **_mla_phases(card, opts.profile), "card": card}))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = phase_kernels(gen)
    res.update(phase_attention_kernels(gen))
    k1_b1 = res.pop("slot_attention_b1")
    k1_b64 = res.pop("slot_attention_b64")
    k2_paged = res.pop("flash_attention_paged_shapes")
    k1_i8 = res.pop("decode_attention_i8_shapes")
    k2_paged_i8 = res.pop("flash_attention_paged_i8_shapes")
    b11_res, b11_launches = phase_one_layer_kernels(gen)
    res.update(b11_res)
    moe_res = phase_moe_kernels(gen)
    g8 = moe_res.pop("g8")
    res.update(moe_res)
    res.update(phase_int8_kernels(gen))
    b12_shapes = res.pop("b12_shapes")
    mla_res, mla_kernels = phase_mla_kernels(gen)
    res.update(mla_res)
    moe_i8_res, moe_i8_shapes = phase_moe_i8_kernels()
    res.update(moe_i8_res)
    _free()
    _lap("kernels")
    if opts.kernels_only:
        print(json.dumps({"kernels": res, "g8": g8, "mla_kernels": mla_kernels,
                          "k1_b1": k1_b1, "k1_b64": k1_b64, "k2_paged": k2_paged,
                          "k1_i8": k1_i8, "k2_paged_i8": k2_paged_i8,
                          "b11_launches": b11_launches,
                          "b12_shapes": b12_shapes, "moe_i8_shapes": moe_i8_shapes,
                          "past_64": PAST_64, "card": card}))
        return 0
    serve, engine = phase_serve(card, profile=opts.profile)
    phase_reference(engine)
    params = _release(engine)
    _lap("serve")
    slot = phase_slot_serve(card, params, profile=opts.profile, b1_tokens=128, lane=True)
    spec = phase_slot_serve(card, params, tag="spec", spec=True, b1_tokens=128,
                            b1_plain_ms=slot["b1_ms_per_token"], profile=opts.profile)
    phase_spec_reference(params)
    _lap("slot, spec")
    pallas = phase_pallas_serve(card, params, serve["long_prompt_s"])
    phase_attention_reference(params)
    trim = phase_trim(params)
    _lap("pallas, trim")
    lora = phase_lora(card, params)
    _lap("lora")

    # the qwen3-30b-a3b phases need the card to themselves
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    held = _held_gib()
    log(f"[release] qwen3-8b engines and weights released: {held:.3f} GiB still allocated")
    assert held < 1.0, held
    wide = phase_wide(card)
    _lap("wide")
    # training, on a card that holds nothing else
    train, moe_train = phase_train(card), phase_moe_train(card)
    _lap("train")
    held = _held_gib()
    log(f"[release] training phases released: {held:.3f} GiB still allocated")
    assert held < 1.0, held
    # the product path, on a card that holds nothing else
    product = _product_phases(card)
    for name in ("fused_qkv_stacked", "fused_out_mlp_stacked"):
        res[name]["err"] = max(res[name]["err"], product["aux_width_err"][name])
    _lap("product")
    evaluation = phase_eval(card)
    _lap("eval")
    _register_moe_serve()
    moe_serve, engine = phase_serve(card, model=MOE_SERVE, profile=opts.profile, tag="moe")
    phase_reference(engine, plain_experts=True)
    params = _release(engine)
    del engine
    moe_slot = phase_slot_serve(card, params, model=MOE_SERVE, tag="moe-slot")
    moe_spec = phase_moe_spec(card, params)
    phase_spec_reference(params, MOE_SERVE, tag="moe-spec-reference", plain_experts=True)
    _lap("moe")

    # the qwen3-32b int8 phase needs the card to itself too
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = _held_gib()
    log(f"[release] qwen3-30b-a3b engines and weights released: {held:.3f} GiB still "
        f"allocated")
    assert held < 1.0, held
    # qwen3-30b-a3b with int8 weights, the routed experts included: the bf16
    # engine's settings (paged, prefix cache, the lane of 16), unfused as in
    # JAX; its experts on the int8 grouped expert kernel, 2 launches a layer
    i8_moe_serve, engine = phase_serve(card, model=MOE_SERVE, profile=opts.profile,
                                       tag="moe-int8", quantize="int8", prefill_lane=LANE)
    steps, prefills, _ = (i8_moe_serve["steps"][k] for k in ("decode", "prefill", "lane"))
    log(f"[moe-int8] int8 grouped expert launches: "
        f"{i8_moe_serve['launches']['grouped_gateup_i8']} gate|up + "
        f"{i8_moe_serve['launches']['grouped_down_i8']} down over {steps} decode steps and "
        f"{prefills} prefill forwards ({2 * engine.cfg.n_layers} a forward), of which the "
        f"prefill form {i8_moe_serve['launches']['grouped_gateup_i8_prefill']} + "
        f"{i8_moe_serve['launches']['grouped_down_i8_prefill']}; bf16 grouped "
        f"expert launches {i8_moe_serve['launches']['grouped_gateup']} + "
        f"{i8_moe_serve['launches']['grouped_down']}; B12 at build "
        f"{i8_moe_serve['quantize_launches']}")
    # at 8 tokens no expert row can drop: held to the no-cache forward; at
    # 16 + 8, where the 24-token forward drops rows a decode step keeps, to
    # the same serving calls on the plain versions
    phase_reference(engine, tag="moe-int8-reference", t0=4, steps=4, plain_int8=True)
    phase_reference(engine, tag="moe-int8-reference", same_path=True, plain_int8=True)
    params = _release(engine)
    _lap("moe-int8")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    held = _held_gib()
    log(f"[release] qwen3-30b-a3b int8 engine and weights released: {held:.3f} GiB still "
        f"allocated")
    assert held < 1.0, held
    _register_i8_serve()
    i8_serve, engine = phase_serve(card, model=I8_SERVE, profile=opts.profile, tag="int8",
                                   quantize="int8", kv_quantize="int8")
    # a 48-row prefill: int8_matmul's kernel at its MT=4 instance
    phase_reference(engine, tag="int8-reference", t0=48, plain_int8=True)
    params = _release(engine)
    del engine
    i8_lane = phase_int8_lane(params)
    _lap("int8")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = _held_gib()
    log(f"[release] qwen3-32b int8 engine and weights released: {held:.3f} GiB still "
        f"allocated")
    assert held < 1.0, held

    mla = _mla_phases(card, opts.profile)
    mla_serve, mla_slot, mla_pallas = mla["mla_serve"], mla["mla_slot"], mla["mla_pallas"]
    _lap("mla")
    # the parallel layer: ranks of their own on the card, which holds nothing else
    parallel = phase_parallel(card)
    _lap("parallel")

    b11_path = {"launches": b11_launches}   # B11's own path (no serving path runs it)
    src = "deepsearch_tts_tpu_torch/ops/"
    jsrc = "deepsearch_tts_tpu/ops/"
    attn = src + "csrc/attention.cu"
    fused = src + "csrc/fused_layer.cu"
    ragged = jsrc + "moe.py:81 _expert_ffn_ragged (lax.ragged_dot)"
    blocked = jsrc + "moe.py:56 _expert_ffn_blocked (XLA batched int8 dot_general)"
    # name: (route, source, TPU kernel it replaces, the run whose launches count)
    meta = {
        "fused_qkv_stacked": ("cuda", fused, jsrc + "fused_layer.py:244", serve),
        "fused_out_mlp_stacked": ("cuda", fused, jsrc + "fused_layer.py:356", serve),
        "fused_out_router_stacked": ("cuda", fused, jsrc + "fused_layer.py:818",
                                     moe_serve),
        "grouped_gateup": ("cuda", fused, ragged, moe_serve),
        "grouped_down": ("cuda", fused, ragged, moe_serve),
        "grouped_gateup_prefill": ("cuda", fused, ragged, moe_serve),
        "grouped_down_prefill": ("cuda", fused, ragged, moe_serve),
        "sampling_prep": ("triton", src + "sampling_prep.py",
                          jsrc + "sampling_prep.py:30", serve),
        "slot_attention": ("cuda", attn, jsrc + "slot_attention.py:110", slot),
        "slot_window_attention": ("cuda", attn, jsrc + "slot_attention.py:123 _slot_window_body",
                                  spec),
        "pallas_paged_attention": ("cuda", attn, jsrc + "paged_attention.py:49", pallas),
        "pallas_paged_decode": ("cuda", attn, jsrc + "paged_attention.py:117", pallas),
        "pallas_paged_decode_clamp": ("cuda", attn, jsrc + "paged_attention.py:239",
                                      pallas),
        "flash_attention": ("cuda", attn, jsrc + "flash_attention.py:27", pallas),
        "flash_attention_paged": ("cuda", attn, jsrc + "attention.py:167 prefix_chunk_attention "
                                  "(XLA)", serve),
        "decode_attention_i8": ("cuda", attn, jsrc + "attention.py:122 paged_attention's int8 "
                                "branch, T = 1 (XLA)", i8_serve),
        "flash_attention_paged_i8": ("cuda", attn, jsrc + "attention.py:122 paged_attention's "
                                     "int8 branch, T > 1 (XLA)", i8_serve),
        "fused_qkv_stacked_i8": ("cuda", fused, jsrc + "fused_layer.py:568", i8_serve),
        "fused_out_mlp_stacked_i8": ("cuda", fused, jsrc + "fused_layer.py:669", i8_serve),
        "int8_product": ("cuda", fused, jsrc + "quant.py:68 int8_matmul (XLA dot_general)",
                         i8_serve),
        "quantize_int8": ("cuda", src + "csrc/quant.cu", jsrc + "quant.py:24", i8_serve),
        "grouped_gateup_i8": ("cuda", src + "csrc/moe_i8.cu", blocked, i8_moe_serve),
        "grouped_down_i8": ("cuda", src + "csrc/moe_i8.cu", blocked, i8_moe_serve),
        "grouped_gateup_i8_prefill": ("cuda", src + "csrc/moe_i8.cu", blocked, i8_moe_serve),
        "grouped_down_i8_prefill": ("cuda", src + "csrc/moe_i8.cu", blocked, i8_moe_serve),
        "fused_mlp_stacked": ("cuda", fused, jsrc + "fused_layer.py:468", mla_serve),
        "fused_mlp": ("cuda", fused, jsrc + "fused_layer.py:112", b11_path),
        "fused_qkv": ("cuda", fused, jsrc + "fused_layer.py:150", b11_path),
        "fused_out_mlp": ("cuda", fused, jsrc + "fused_layer.py:975", b11_path),
        "slot_attention_latent": ("cuda", attn, jsrc + "slot_attention.py:116 "
                                  "_slot_attn_kernel_shared (D = 576)", mla_slot),
        "paged_attention_latent": ("cuda", attn, jsrc + "paged_attention.py:49 _paged_kernel "
                                   "(v = k, D = 576)", mla_pallas),
        "latent_prefill": ("cuda", attn, jsrc + "attention.py:167 prefix_chunk_attention "
                           "(XLA), D = 576", mla_serve),
    }
    i8_serve["launches"]["quantize_int8"] = i8_serve["quantize_launches"]
    # the decode kernel's: all but the prefill form's
    for run, n in ((moe_serve, "grouped_gateup"), (moe_serve, "grouped_down"),
                   (i8_moe_serve, "grouped_gateup_i8"), (i8_moe_serve, "grouped_down_i8")):
        run["launches"][n] -= run["launches"][n + "_prefill"]
    kernels = [{"name": n, "route": r, "source": s, "replaces": rep,
                "launches": run["launches"][n],
                "max_abs_err": res[n]["err"], "ms": res[n]["ms"],
                "plain_ms": res[n]["plain_ms"], "bound_ms": res[n]["bound_ms"],
                "bound_by": res[n]["bound_by"], "library_ms": res[n]["library_ms"]}
               for n, (r, s, rep, run) in meta.items()]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    assert not idle, f"kernels no run of their path launched: {idle}"
    runs = {"serve": serve, "slot_serve": slot, "spec_serve": spec, "pallas_serve": pallas,
            "moe_serve": moe_serve, "moe_slot": moe_slot, "moe_spec": moe_spec,
            "int8_serve": i8_serve, "moe_int8_serve": i8_moe_serve,
            "mla_serve": mla_serve, "mla_slot": mla_slot,
            "mla_pallas": mla_pallas, "int8_lane": i8_lane, "trim": trim,
            "train": train, "moe_train": moe_train, "lora": lora}
    log(card)   # the card's name and power limit again, beside the result lines
    print(json.dumps({**{name: {k: v for k, v in run.items() if k != "launches"}
                         for name, run in runs.items()},
                      "g8": g8, "mla_kernels": mla_kernels, "k1_b1": k1_b1, "k1_b64": k1_b64,
                      "k2_paged": k2_paged, "k1_i8": k1_i8, "k2_paged_i8": k2_paged_i8,
                      "wide": wide, "b12_shapes": b12_shapes,
                      "moe_i8_shapes": moe_i8_shapes, "past_64": PAST_64, "phase_s": _LAPS,
                      "card": card}))
    print(json.dumps({"product": product, "card": card}))
    print(json.dumps({"eval": evaluation, "card": card}))
    print(json.dumps({"parallel": parallel, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
