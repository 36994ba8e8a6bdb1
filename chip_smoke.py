"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. Builds the hand-written kernels from ``src/repro_torch/**/csrc`` (one
   ``nvcc`` per source, in parallel) and prints each one's registers and
   spills; for ``decode_paged``, ``flash_decode``, ``flash_prefill`` and
   the four weight-stream kernels (``qkv_rope_paged``,
   ``oproj_ffn_swiglu``, ``qkv_rope``, ``ffn_swiglu``) one line per kernel
   instantiation (head_dim, and the paged decode's query tile; pass, lanes
   and column group)
   with its registers, spills and dynamic shared memory, failing on a
   spill or on wgmma instructions that ptxas serialised.
2. Kernel phase at the samba-coe-expert-7b widths (B = 8 lanes, bf16): the
   paged kernels at ragged positions 1..512 straddling blocks with one
   inactive lane (``decode_paged`` also with every lane at 512, held row by
   row to both its plain versions, the masked softmax and its own chunked
   arithmetic, with two chunk faults planted in the latter that the row
   check must catch), the dense-cache kernels at length 4096 in a 4096-position
   cache (``ffn_swiglu`` in both forms; ``flash_decode`` also row by row
   against its own chunked arithmetic, with the same two chunk faults
   planted there), the node's three kernels at one
   rank's shapes of the expert at TP 2 (``decode_paged`` at 16 heads,
   ``qkv_rope_paged`` at 16 / 16 heads, ``ffn_swiglu(residual=False)`` at
   F 5504); then the prefill kernels:
   ``flash_prefill`` at the expert's prefill (8 x 2048 tokens, 32 heads,
   dh 128, causal), at the sequential prefill's (B 1, S 64 / 160 / 256) and
   at RecurrentGemma-9B's (4 x 3000 tokens, 16 q heads on 1 kv head, dh
   256, window 2048), ``lru_scan`` at (4, 3000, 4096) f32; then the dense
   variants' shapes: granite-8b's three paged kernels (32 q on 8 kv heads,
   F 14336), ``qkv_rope_paged`` rotating half of each head at chatglm3-6b's
   widths (two faults planted in its plain version: RoPE dropped, the whole
   head rotated) and ``flash_prefill`` at 8 x 2048 tokens, dh 128, at G 5,
   12 and 16; ``decode_paged`` and ``flash_decode`` at each GQA group
   outside 1/2/4/8 that a config has (5, 6, 12, 16 at dh 128; 16 at dh 256,
   RecurrentGemma's), each also row by row against its chunked plain
   version (``flash_decode`` with the two chunk faults planted); then
   ``flash_prefill`` at Mixtral-8x7B's heads (32 q on 8 kv heads, dh 128)
   at its generate prefill (2 x 4608 tokens, window 4096) and at its paged
   drain's (B 1, S 64 / 160 / 256, causal); then
   ``flash_prefill`` at DeepSeek-V2-Lite's MLA prefill (4 x 2048 tokens,
   16 heads, q / k of 192, v of 128, causal), with the scale of v's width
   planted in its plain version besides the causal edge, and the kernels
   SDPA runs for it named; then ``flash_prefill`` not causal at
   Whisper-small's three attention shapes (8 lanes, 12 heads of 64): the
   encoder's 1500 frames, and the cross-attention of 448 and of 4 decoder
   tokens over them (Sk apart from Sq), each with the keys past the last
   whole 64-key tile dropped in its plain version.
   Each kernel against its plain PyTorch version on the same inputs, timed
   with CUDA events (the 50 MB L2 flushed before every launch), beside the
   plain version and one PyTorch library call computing the same function
   (none for ``lru_scan``: no single PyTorch call computes a linear
   recurrence); each ``flash_prefill`` row also prints its TFLOP/s, its
   share of the bound and SDPA's time beside it; the four weight-stream
   kernels their largest row relative L2 error, achieved TB/s and, from
   the profiler, each of their passes' device time; the two QKV rows also
   a planted fault (RoPE dropped in the plain version) that their check
   must catch.
3. Monarch phase, the FFT-conv showcase of the paper's Fig. 3-4 and Table
   I: ``monarch_fused`` and ``monarch_conv_fused`` against their plain
   versions at the 1M-point shape (16, 1024, 1024) bf16, max-abs and row
   by row, beside the cuBLAS chain, with faults planted in the plain
   versions that the row check must catch; then the showcase's entry point
   (``repro_torch.launch.monarch_fftconv``: the Table I ledger, both
   kernels against their plain versions and the conv timed as kernels, one
   plain expression and op by op, at (16, 1024, 1024) and (16, 256, 256)),
   each ``monarch`` / ``monarch_conv`` call launching its kernel once; and
   one conv call's device time by launch.
4. Serve phase at full width (L = 32, D = 4096): three experts in pinned host
   memory, an HBM weight cache for two, 16 requests through the
   continuous-batching engine with the fused backend. Every request must
   finish with 32 tokens, the KV pool must be clean, every paged kernel must
   have launched once per layer per decode round (and no other kernel: the
   packed prefill's attention is plain, as in JAX), and one decode step's
   logits must match the plain reference body run in f32 on the same pool
   state; the run also prints what faults planted in one layer read against
   it. Then one step's device time by kernel, from the profiler, and in how
   many of its layers the o-proj pass started before ``decode_paged``
   ended (programmatic launch). TTFT p50 / p99 are read from the done
   requests, beside the ``serve.ttft_s`` histogram's P² estimates.
4b. Serve-modes phase on the same pinned experts: a fresh composition
   (HBM cache of two) behind ``ServingEngine(scheduler="run_to_completion",
   prefill_mode="sequential")`` with its own metrics registry, after
   ``warmup()``, with tracing on, a watchdog sampling and the metrics
   server on a free localhost port, serving the same 16 requests. Each
   admission prefills its prompt alone (``flash_prefill`` once per layer:
   32 x 16 launches) and every paged kernel launches once per layer per
   decode round. Checks the outputs, a clean pool inside its HBM budget,
   the lifecycle phases of every request against its wall time, no
   watchdog anomaly, one ``/metrics`` scrape, a valid trace with one
   request lane per request, and one prompt's first-token logits from the
   sequential (kernel) and the packed (plain) prefill against each other
   and against the f32 plain forward; prints tok/s, TTFT, the phases'
   p50s, the prefill spans' share of the drain and ``flash_prefill``'s
   device time a launch at 64-256-token prompts.
4c. Tenancy phase on two of the pinned experts (an HBM cache of both):
   12 multi-turn sessions (70 % open with one of two 96-token system
   prompts; 1-3 turns of 8-24 fresh tokens; 16 new tokens a turn) replayed
   through a ``prefix_sharing=True`` engine and an unshared one, after a
   primer that warms the prefix index; then the shared engine behind
   ``StreamingFrontend`` with a paid and a free tenant. Checks every
   request, prefix hits, each second turn adopting its history, the primed
   blocks' bytes unchanged while decoding lanes share them, each paged
   kernel once per layer per decode round and none inside a suffix
   prefill, no block in use after ``release_shared()``, streamed tokens
   equal to the outputs, and shared against unshared streams equal up to
   bf16 near ties (the two chosen tokens' f32 logits within
   ``DENSE_PREFILL_LOGIT_TOL_REL`` of the largest). Prints the share of
   prompt tokens whose prefill was skipped, ``cow_splits``, TTFT p50 / p99
   and tok/s of both engines.
4d. Speculative phase: expert e0 the target, ``SpeculativeDecode`` with
   gamma 4 on 8 requests of 64-256 prompt and 32 new tokens, with a
   self-draft and with a 4-layer draft cut from e0: each paged kernel
   launches gamma x the draft's layers a round (the verify is the plain
   body), the draft pool ends clean, the streams equal the greedy drain's
   up to decode near ties (``LOGIT_TOL_REL``); prints acceptance, tokens a
   target call and tok/s against greedy. Then the standalone
   ``SpeculativeDecoder`` at B 1 against dense greedy, with the dense
   kernels' launches (once per draft layer a draft step).
5. Dense decode phase on one of those experts: ``prefill`` of 8 lanes x 2048
   tokens into a 4096-position cache (``flash_prefill`` once per layer), its
   first lane's last-token logits against the plain ``forward`` run in f32 a
   layer at a time, 16 greedy steps of 32 ``decoder_layer_step``s (each
   dense kernel once per layer per step), one step's logits against the
   plain ``decode_step`` run in f32 a layer at a time, that step with
   ``PerfOptions.decode_cache_carry`` on bit-equal to off (logits and the
   whole cache), two planted faults, and one step's device time by
   kernel.
6. Generate phase: ``CompositionOfExperts.generate`` over the same three
   experts (their pinned store, an HBM cache of two) with an ``LMRouter`` on
   the expert backbone: 8 prompts of 128 tokens, 16 new tokens each; the
   router and every group's prefill through ``flash_prefill``.
6b. Node phase: ``RDUNode`` over the same three experts (their pinned
   store), a 2 x 2 topology of sockets sharing the card, each group's HBM
   share one expert and a 2.2 GB KV carve, the fused backend, the serve
   phase's 16 requests; then one prefill group and one decode group
   (disaggregated). Every request finishes, no pool leaks, the budgets hold
   after every step, each of ``qkv_rope_paged``, ``decode_paged`` and
   ``ffn_swiglu(residual=False)`` launches 2 ranks x 32 layers x decode
   rounds (nothing else), the decode group runs no prefill forward, and
   the streams equal the single-device engine's (and the disaggregated the
   colocated's) up to prefill near ties (``DENSE_PREFILL_LOGIT_TOL_REL``).
   Prints tok/s, TTFT p50 / p99, each group's decode rounds, ms a round
   and switches.
6c. Expert-tier phase: two experts written to a ``MmapFileStore`` in a
   temporary directory (removed at the end) and quantized into an
   ``Int8BlockQuantizedStore(64)`` on the card, each behind an engine whose
   HBM cache holds one expert: the lazy and eager mmap drains' streams
   equal the pinned store's, the int8 drain's equal a pinned store's of the
   dequantized trees, exactly; prints each switch's ``store_read`` and
   ``h2d`` seconds, ``stored_bytes / nbytes`` and the dequantization time.
   Then a dirty 64 MiB mutable entry evicted, reactivated and dropped must
   write back its exact bytes (``bytes_copied_back``, the ``writeback``
   ledger edge).
6d. Variants phase, after the experts' store is released, one config at
   a time, each released before the next: granite-8b at full width and
   depth (36 layers, 16.5 GB bf16) as one expert behind the default
   (fused) engine, the serve phase's 16 requests: each paged kernel once
   per layer per decode round, one step's logits against the plain body in
   f32 (``GRANITE_LOGIT_TOL_REL``) with four faults planted in one layer,
   the step's device time by kernel; then chatglm3-6b, starcoder2-3b,
   qwen2-vl-2b (all layers) and qwen2.5-32b (8 of its 64 layers, full
   width), which the kernels refuse, behind an engine that names the plain
   body (``XlaPagedBackend``) with sequential prefill: 8 requests of
   64-256 prompt and 16 new tokens, ``flash_prefill`` once per layer a
   prompt at each config's G, and one prompt's prefill logits against the
   plain forward in f32 (``VARIANT_PREFILL_LOGIT_TOL_REL``).
6e. Mixtral phase: Mixtral-8x7B cut to 8 of its 32 layers at full width
   (23.7 GB bf16), one expert made on the card and kept in pinned host
   memory, an HBM cache of one. ``generate`` on 2 prompts of 4608 tokens
   past the 4096-position window (the ring wraps), 16 new tokens:
   ``flash_prefill`` once per layer; the prefill's logits against the
   plain f32 forward over both rows on the bf16 path's routing (the same
   capacity drops), every token that routes apart a near tie of the f32
   gates (``MIXTRAL_ROUTE_TIE_TOL_REL``), the router's logits the f32
   product on the path's own hidden states (``MIXTRAL_ROUTER_TOL_REL``);
   one decode step past the wrap
   against the teacher-forced windowed f32 forward at capacity_factor
   16. Then, at window 0, ``VARIANTS``' 8 requests on the plain paged
   body with sequential prefill (``flash_prefill`` 8 x 8 launches, no
   other kernel), one prompt's ``prefill_kv`` logits against the f32
   forward on its routing, a router planted in bf16 that one of that
   prompt's checks must catch, and a paged step's device time and idle
   share.
6f. DeepSeek phase: deepseek-v2-lite-16b (MLA: latent KV cache, absorbed
   decode; a dense head layer, then 26 layers of 64 experts top-6 and 2
   shared) at full width and depth (27 layers, 31.4 GB bf16), one expert
   made on the card and kept in pinned host memory, an HBM cache of one.
   ``generate`` on 4 prompts of 2048 tokens, 32 new: ``flash_prefill``
   once per layer (dk 192, dv 128) and no other kernel. The prefill's
   logits against the plain f32 forward over the same four rows on the
   bf16 path's routing, its attention at the model's own inputs against
   the plain version row by row in every layer, the router's logits the
   f32 product; one absorbed decode step against the teacher-forced f32
   forward over S + 1 at capacity_factor 16; a planted fault (the
   prefill's kernel at scale 1/sqrt(dv)) that a check must catch; the
   latent cache's bytes and a decode step's device time and idle share.
6g. Whisper phase: whisper-small at full width and depth (12 + 12
   layers, 0.48 GB bf16) through the model API: 8 lanes of 1500 seeded
   frame embeddings, a 4-token prompt, ``prefill`` (``flash_prefill`` 36
   times: 12 encoder, 12 decoder self, 12 cross at Sq 4) and 59 greedy
   ``decode_step``s (no kernel: plain attention, as JAX's XLA); then a
   teacher-forced ``forward`` over 448 target tokens (36 launches, the
   cross-attention at Sq 448). The prefill's and the steps' logits
   against the f32 plain forward over the tokens fed back, the forward's
   against its f32 plain forward; each attention at the model's inputs
   against the plain version row by row; the cross-attention's keys cut
   at 1472 of 1500 (planted) caught there. Prints encode ms, prefill s,
   tok/s and a step's host wall against device busy.
6h. xLSTM phase: xlstm-1.3b at full width and depth (48 blocks, 3.97 GB
   bf16) as the one expert of ``CompositionOfExperts(HashRouter(1))``:
   ``generate`` on 4 prompts of 2048 tokens, 32 new (no kernel: JAX
   computes both recurrences in XLA), its prefill timed apart. Random
   weights make the 48 blocks chaotic, so each block is held at the
   model's inputs instead of the end-to-end logits: the prefill again,
   every block against the same block in f32 and every chunkwise mLSTM
   core against its parallel form in f64 (512 positions), the first also
   against the step recurrence in f32; 31 decode steps from its state,
   every block teacher-forced (the block in f32 over the steps' inputs
   as one chunk from its state before them). A
   fault is planted for each check and must fail it: the first block's
   core in bf16; the conv window and the sLSTM state not carried. Then
   ``PerfOptions.mlstm_bf16``: the first group's 7 mLSTM blocks at the
   prefill's shape, each against the block in f32, and the chunkwise core
   timed with the field on and off. Prints the recurrent state's bytes a
   lane, prefill s, tok/s and a step's host wall against device busy.
6i. Training phase: samba-coe-expert-7b at full width cut to 8 of its 32
   layers (1.881 B params; AdamW's 12 bytes a parameter put the whole
   model past the card), 6 steps of the port's train step on one
   repeated SyntheticLM batch of 4 x 2048, remat on: each step launches
   the LSE form of ``flash_prefill`` twice a layer and
   ``flash_prefill_bwd`` once a layer, and nothing else. The first loss
   against the plain f32 forward, every leaf's gradient finite and
   non-zero, the loss falling, each layer's attention backward at the
   model's inputs (tapped from ``FlashAttention``) against
   ``attention_bwd_ref`` in f32, with two faults planted in the reference
   (the diagonal tile's causal mask skipped, di taken as 0) that the check
   must catch; then a checkpoint of one full-width layer's state (5.57 GB)
   written to a temporary directory, restored bit-equal, and two steps
   from it against two from the live state. Prints step seconds,
   tokens/s, peak memory, AdamW's ms, the device's idle share and the
   model flops' share of 989 TFLOP/s. The kernel rows before it hold
   ``flash_prefill_bwd`` at that shape and at Mixtral's (G 4, window 4096,
   B 2 x 4608) and the LSE form against its plain version, beside SDPA's
   backward and forward.
6i′. Family-training phase: recurrentgemma-9b (one (rec, rec, attn)
   group, B 2 x 3000), deepseek-v2-lite-16b (3 layers, B 4 x 2048) and
   whisper-small (uncut, 8 x 1500 frames, 448 tokens) at full width, 3
   remat steps each through ``stepfn.make_train_step``: the first loss
   against the plain f32 forward, every leaf's gradient finite and
   non-zero, the launches ``stepfn.kernel_launches`` counts on every step
   (and each attention kernel's launches equal to its calls, which give
   each backward row its launches by shape), each attention and
   ``lru_scan`` backward at the model's inputs against its f32 plain
   version, the worst layer against the plain formulas at the kernels'
   bf16 rounding points, and planted faults (di as 0, the window edge off
   by one, da from h_t, a padding key past Sk unmasked) caught. Prints
   step seconds, tokens/s, model flops' share of 989 TFLOP/s, peak memory
   and the profiled step's idle share. The kernel rows before it hold the
   backward at these shapes and ``lru_scan_bwd`` at (4, 3000, 4096).
6j. Distribution phase: the 7B expert at full width through the mesh
   builders. (a) 4 of its 32 layers on a (1, 1) mesh under NCCL in this
   process: two train steps (batch 4 x 2048) whose losses, grad norms and
   params are bit-equal to the single-device step's, launching the LSE
   form and the backward as it does; a prefill of 4 x 512 and 8 greedy
   decode steps bit-equal to ``prefill`` / ``decode_step``. (b) 2 layers,
   two spawned ranks sharing the card over gloo (NCCL takes one rank a
   card): two steps on a (1, 2) TP mesh (the first loss and grad norm
   against the 1 x 1 step), the state saved whole and restored onto a (2,
   1) DP mesh bit for bit, one DP step; each rank's ``flash_prefill[lse]``
   and ``flash_prefill_bwd`` launches above zero; the collectives each
   rank issued, by name. (a′) recurrentgemma-9b (one (rec, rec, attn)
   group), xlstm-1.3b (one group of 8 blocks) and whisper-small (2
   encoder and 2 decoder layers) at full width on the (1, 1) NCCL mesh:
   two train steps, a prefill and 4 greedy decode steps each, bit-equal to
   the single-device steps, ``lru_scan`` / ``lru_scan_bwd`` and the
   attention kernels run through ``local_map`` with their launch counts
   printed.
6k. Dry-run phase (``launch.dryrun``, fake tensors on a fake group): the
   CLI on mixtral-8x7b x decode_32k, single pod, ``--correct``, its status
   and terms printed; then the training phase's own step (the 7B cut to 8
   layers, B 4 x 2048, remat) traced on a fake (1, 1) group: its flops,
   bytes and terms (the H100's data-sheet constants, modelled, not
   measured) beside the step time the training phase measured, and its
   kernel calls equal to the 5ᴸ / 5ᴮ rows' launches a step (a gate); then
   DeepSeek-V2-Lite's train_4k cell (one layer unit, the fake single pod)
   with ``PerfOptions.moe_dispatch_constraint`` off and on: collective
   bytes by kind, which must differ, and the MoE buffers pinned by expert
   over 'model' with the field on. The serve phase prints ``core.fusion``'s predicted kernels for one decode
   step beside the launches it counted (a line, not a gate).
7. RecurrentGemma phase, after the experts' store is released:
   recurrentgemma-9b at full width and depth (38 layers, 10.4 G parameters,
   bf16) as the one expert of a ``CompositionOfExperts(HashRouter(1))`` on
   a pinned host store with an HBM cache of one expert; ``generate`` on 4
   prompts of 3000 tokens (past the 2048-position window), 16 new tokens,
   twice: 12 ``flash_prefill`` and 26 ``lru_scan`` launches per call; the
   first lane's prefill logits against the plain f32 composition.
7b. Examples phase: the user-facing examples (``examples/*_torch.py``),
   each ``main`` in this process at its own sizes. quickstart: the reduced
   expert's forward and prefill launch ``flash_prefill`` once a layer each
   (the decode steps are plain), the forward's logits against the plain
   f32 forward of the same weights (``DENSE_PREFILL_LOGIT_TOL_REL``).
   coe_serving three times (the defaults: 6 experts behind an HBM cache of
   2.5, 24 requests, 4 slots; the run-to-completion scheduler on the int8
   store; the mmap store with one expert's worth of KV reserve and a
   trace): every request served, the pool clean, evictions, each paged
   kernel once a layer a decode round, switches / misses / decode rounds /
   allocs equal to the same run on the CPU, the trace valid. train_expert
   (8 layers, d 512, B 8 x 256): a straight run of 120 steps, and one that
   loses its last checkpoint and resumes from step 100; the two final
   checkpoints and states bit-equal, every loss finite, the LSE form and
   the backward launched as ``stepfn.kernel_launches`` counts. The kernel
   rows before it hold the paged kernels, ``flash_prefill``, its LSE form
   and its backward at these shapes.
8. Prints the kernel table as one JSON line, the card's name and power
   limit, and ends with ``{"ok": true, "device": {...}}``.

Exits non-zero without a card, and on any failure. Weights are random,
drawn from a fixed seed.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak, same source
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores, same source
SERVE = dict(n_experts=3, hbm_experts=2.0, requests=16, prompt_lens=(64, 256),
             new_tokens=32, n_slots=8, block_size=16, max_len=512,
             tagged_fraction=0.5, seed=0)
# One decode step's fused logits against the plain reference body run in f32
# on the same pool state (the same bf16 weights and pool, upcast). The
# kernels round to bf16 at their outputs, which put the fused path 0.0888
# max-abs (1.6 % relative L2) from it at a largest logit of 6.16 on the H100
# runs; the limit, 1.8 % of the largest logit (0.111 there), is 1.25x that.
# Faults planted in one of the 32 layers read 0.123-0.191 (one head zeroed,
# RoPE dropped, the newest token left out), a skipped FFN 1.76: a fault in
# one layer sits just above bf16 noise end to end, so the run prints what
# each planted fault reads; the per-kernel checks above hold each kernel to
# two bf16 units in the last place.
LOGIT_TOL_REL = 0.018
FAULT_LAYER = 15

KERNELS = {
    "decode_paged": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/decode_paged.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:195"),
    "qkv_rope_paged": dict(
        source="src/repro_torch/kernels/fused_decode/csrc/qkv_rope_paged.cu",
        replaces="src/repro/kernels/fused_decode/kernel.py:128"),
    "oproj_ffn_swiglu": dict(
        source="src/repro_torch/kernels/fused_decode/csrc/oproj_ffn_swiglu.cu",
        replaces="src/repro/kernels/fused_decode/kernel.py:263"),
    "qkv_rope": dict(
        source="src/repro_torch/kernels/fused_decode/csrc/qkv_rope.cu",
        replaces="src/repro/kernels/fused_decode/kernel.py:71"),
    "flash_decode": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/decode.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:248"),
    "ffn_swiglu": dict(
        source="src/repro_torch/kernels/fused_decode/csrc/ffn_swiglu.cu",
        replaces="src/repro/kernels/fused_decode/kernel.py:202"),
    "flash_prefill": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/prefill.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:81"),
    # the backward of flash_prefill's forward (JAX's XLA derives it from
    # layers.attention; no Pallas kernel of its own)
    "flash_prefill_bwd": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/prefill_bwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:81"),
    "lru_scan": dict(
        source="src/repro_torch/kernels/lru_scan/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan/kernel.py:41"),
    # the backward of lru_scan's recurrence (JAX's XLA derives it from
    # models/rglru.py's associative_scan; no Pallas kernel of its own)
    "lru_scan_bwd": dict(
        source="src/repro_torch/kernels/lru_scan/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan/kernel.py:41"),
    "monarch_fused": dict(
        source="src/repro_torch/kernels/monarch_fft/csrc/monarch.cu",
        replaces="src/repro/kernels/monarch_fft/kernel.py:37"),
    "monarch_conv_fused": dict(
        source="src/repro_torch/kernels/monarch_fft/csrc/monarch_conv.cu",
        replaces="src/repro/kernels/monarch_fft/kernel.py:77"),
}
PAGED_KERNELS = ("decode_paged", "qkv_rope_paged", "oproj_ffn_swiglu")
DENSE_KERNELS = ("qkv_rope", "flash_decode", "ffn_swiglu")
# the kernel-table row of flash_prefill at RecurrentGemma's widths
RG_PREFILL_ROW = "flash_prefill[window=2048]"
# the kernel-table row of decode_paged with every lane at 512 positions
FULL_PAGED_ROW = "decode_paged[len1=512x8]"
# the dense-cache decode path: 8 lanes prefilled with 2048-token prompts into
# a 4096-position cache, then greedy steps of 32 decoder_layer_steps each
DENSE = dict(lanes=8, prompt_len=2048, max_len=4096, steps=16, seed=2)
# One dense step's logits (kernels, bf16) against the port's plain
# decode_step run in f32 on the same cache, a layer at a time. The H100 run
# read 0.1515 max-abs (2.5 % relative L2) at a largest logit of 5.607, i.e.
# 2.70 % of it; the limit is 1.25x that. Faults planted in one of the 32
# layers read 0.14-0.16 there, inside the noise: with random weights the
# attention over ~2065 positions is near uniform, so a lost position or a
# lost rotation in one layer moves the logits little. The per-kernel checks
# hold each kernel to two bf16 units in the last place.
DENSE_LOGIT_TOL_REL = 0.034
# The dense prefill's last-token logits (first lane, kernels, bf16) against
# the port's plain forward run in f32 a layer at a time (quadratic
# attention, the same bf16 weights upcast). The H100 run read 0.1632
# max-abs (3.3 % relative L2) at a largest logit of 4.683, i.e. 3.48 % of
# it; the limit is 1.25x that.
DENSE_PREFILL_LOGIT_TOL_REL = 0.044
# flash_prefill against its plain version, row by row: the largest
# relative L2 error of one query row's output (its dh values), on top of
# the max-abs check every bf16 row takes. The max-abs limit is set by the
# early rows, whose output is a few values of v (|o| up to ~4), and sits
# near the ~0.04 of a row that averages ~2000 keys; the row check holds
# every row to its own scale. The H100 run read 0.0051 (expert shape) and
# 0.0048 (RG shape) against the limit. An off-by-one at the causal or the
# window edge (one key too many or too few) must read above it: the phase
# plants those in the plain version and fails if the check misses one;
# they read 0.40-2.16 there.
PREFILL_ROW_REL_L2 = 2.0 ** -6
# the weight-stream kernels (qkv_rope_paged, oproj_ffn_swiglu, qkv_rope,
# ffn_swiglu) against their plain versions, row by row: both sum in f32 and
# round each output to bf16 once, so a row differs by at most two units in
# the last place of each value, 2^-7 of its norm.
STREAM_ROW_REL_L2 = 2.0 ** -7
# decode_paged against its plain versions, row by row (each head's dh
# values): all three sum in f32 from the same bf16 inputs, in other orders,
# and round each output to bf16 once. A chunk's partial dropped, or the
# position at each chunk's start left out, planted in the split plain
# version, must read above it.
DECODE_ROW_REL_L2 = 2.0 ** -7
# recurrentgemma-9b behind CompositionOfExperts.generate: 4 prompts of 3000
# tokens, past the 2048-position window so the ring's roll is not the
# identity ((3000 - 2048) % 2048 = 952)
RG = dict(prompts=4, prompt_len=3000, new_tokens=16, seed=5)
# The RG prefill's last-token logits (first lane, kernels, bf16) against the
# plain f32 composition (quadratic attention, doubling-scan recurrence),
# one group of three layers upcast at a time. The H100 run read 0.1551
# max-abs (3.4 % relative L2) at a largest logit of 4.479, i.e. 3.46 % of
# it; the limit is 1.25x that.
RG_LOGIT_TOL_REL = 0.044
# CompositionOfExperts.generate over the serve phase's experts with an
# LMRouter on the expert backbone
GEN = dict(prompts=8, prompt_len=128, new_tokens=16, hbm_experts=2.0, seed=3)
# the Monarch kernels' rows at the paper's 1M-point shape, bf16
MONARCH = dict(shape=(16, 1024, 1024), seed=7)
# multi-turn sessions (JAX benchmarks/run.py::bench_sweep_tenancy's trace):
# 12 sessions on two experts, 70 % opening with one of two 96-token system
# prompts, 1-3 turns of 8-24 fresh user tokens, 16 new tokens a turn
TENANCY = dict(sessions=12, shared_share=0.7, sys_len=96, user=(8, 24),
               new_tokens=16, n_slots=8, block_size=16, max_len=512,
               hbm_experts=2.0, seed=7)
# speculative decoding with expert e0 the target: 8 requests of 64-256
# prompt and 32 new tokens, gamma 4, a self-draft and a 4-layer draft cut
# from e0; the standalone decoder at B 1 on a 128-token prompt
SPEC = dict(requests=8, prompt_lens=(64, 256), new_tokens=32, gamma=4,
            draft_layers=4, n_slots=8, block_size=16, max_len=512,
            hbm_experts=2.0, decoder_prompt=128, seed=11)
# the node: a 2 x 2 topology of sockets sharing the card, each group's HBM
# share one expert's weights and a KV carve of 2.2 GB (262 blocks of 16)
NODE = dict(tp=2, groups=2, hbm_experts=1.0, kv_reserve=2_200_000_000)
# the expert tier: two experts behind an HBM cache of one; 8 requests of
# 64-256 prompt and 32 new tokens, tagged alternately; int8 blocks of 64; a
# 64 MiB f32 mutable state for the write-back check
TIER = dict(experts=2, requests=8, prompt_lens=(64, 256), new_tokens=32,
            n_slots=8, block_size=16, max_len=512, int8_block=64,
            state_mb=64, seed=13)
# flash_prefill at the sequential prefill's shape (B 1, the expert's heads)
B1_PREFILL_LENGTHS = (64, 160, 256)
B1_PREFILL_ROW = "flash_prefill[B=1,S=256]"
# The dense variants, one expert each, after the expert tier: granite-8b on
# the fused kernels (the serve phase's 16 requests), the four the kernels
# refuse on the plain paged body with sequential prefill (flash_prefill on
# every prompt): 8 requests of 64-256 prompt and 16 new tokens.
VARIANTS = dict(requests=8, prompt_lens=(64, 256), new_tokens=16, n_slots=8,
                block_size=16, max_len=512, seed=17)
# the plain-body configs and the layers each runs (None: all of them):
# qwen2.5-32b is 65.5 GB of bf16 weights whole; 8 of its 64 layers, at full
# width, keep the pinned host copy, the card's cache and the phase's time
# in bounds
PLAIN_VARIANTS = {"chatglm3-6b": None, "starcoder2-3b": None,
                  "qwen2-vl-2b": None, "qwen2.5-32b": 8}
# granite-8b's fused decode step against the plain body in f32, set as the
# serve phase's limit was: the first H100 run read 0.0987 max-abs (1.75 %
# relative L2) at a largest logit of 5.747, i.e. 1.72 % of it; the limit
# is 1.25x that. Faults planted in one of the 36 layers read 2.3-3.6 % of
# it (a skipped FFN 36 %), just above.
GRANITE_LOGIT_TOL_REL = 0.0215
# each plain-body variant's prefill (flash_prefill and the bf16 plain
# body) last-token logits against the plain forward in f32: 1.25x what the
# first H100 run read, of the largest logit (a 175-token prompt): 3.48 %,
# 0.96 %, 1.48 % and 1.98 % (8 layers). The tied heads' logits are large
# (|logits|max 350-400): the token table is drawn at unit scale.
VARIANT_PREFILL_LOGIT_TOL_REL = {"chatglm3-6b": 0.0435,
                                 "starcoder2-3b": 0.0120,
                                 "qwen2-vl-2b": 0.0185, "qwen2.5-32b": 0.0248}
# the kernel-table rows at the variants' shapes: granite-8b's paged step;
# qkv_rope_paged rotating half of each head at chatglm3-6b's widths (its
# biases aside; its launches are those of the partial rotation's own count,
# which no served path makes); flash_prefill at each plain-body variant's
# GQA group at the sequential prefill's shapes (B 1, S 64 / 160 / 256), the
# table keeping S 256, and at the dense phase's 8 x 2048 tokens (a check at
# length, logged but no row of the table: no path runs that shape)
GRANITE_ROWS = {"decode_paged": "decode_paged[granite-8b,G=4]",
                "qkv_rope_paged": "qkv_rope_paged[granite-8b,heads=32/8]",
                "oproj_ffn_swiglu": "oproj_ffn_swiglu[granite-8b,F=14336]"}
ROPE_FRAC_ROW = "qkv_rope_paged[chatglm3-6b,rope_frac=0.5]"
PARTIAL_ROPE = "qkv_rope_paged[partial_rope]"    # its launch-count name
# both decode kernels at each GQA group outside 1/2/4/8 that a config has
# (the four plain-body variants at dh 128, RecurrentGemma's 16 q heads on
# one kv head of 256): decode_paged at the variants' drain (8 lanes at
# paged_inputs' ragged lengths up to 512, VARIANTS' pool of blocks of 16),
# flash_decode at 8 lanes of a 2048-position cache. No path launches them
# there (the variants run the plain body, RG decodes plain): their
# launches are the variants' drains' counts, 0
GROUP_DECODE_ARCHS = ("qwen2.5-32b", "qwen2-vl-2b", "starcoder2-3b",
                      "chatglm3-6b", "recurrentgemma-9b")
GROUP_DENSE = dict(lanes=8, length=2048)
VARIANT_PREFILL_ROWS = {
    "qwen2.5-32b": "flash_prefill[qwen2.5-32b,G=5,B=1,S=256]",
    "qwen2-vl-2b": "flash_prefill[qwen2-vl-2b,G=6,B=1,S=256]",
    "starcoder2-3b": "flash_prefill[starcoder2-3b,G=12,B=1,S=256]",
    "chatglm3-6b": "flash_prefill[chatglm3-6b,G=16,B=1,S=256]"}
# Mixtral-8x7B (moe): 8 of its 32 layers at full width (D 4096, 32 q on 8
# kv heads of 128, 8 experts top-2 of F 14336, vocab 32000), 23.7 GB of
# bf16 where the whole model is 93.4 GB. generate runs 2 prompts of 4608
# tokens past the 4096-position window (the ring wraps at 4096) and 16 new
# tokens; the paged engine, at window 0 (both packages' paged runners
# refuse a window; every position of its requests lies inside 4096, so the
# attention is the same), VARIANTS' 8 requests with sequential prefill.
MIXTRAL = dict(layers=8, prompts=2, prompt_len=4608, new_tokens=16, seed=19)
MIXTRAL_ROW = "flash_prefill[mixtral-8x7b,G=4,B=2,S=4608,window=4096]"
# flash_prefill at the paged drain's sequential prefill (B 1, causal, G 4),
# each of B1_PREFILL_LENGTHS held, the table keeping S 256
MIXTRAL_B1_ROW = "flash_prefill[mixtral-8x7b,G=4,B=1,S=256]"
# generate's prefill (flash_prefill at window 4096, the bf16 MoE at cf
# 1.25) last-token logits, both rows, against the plain forward in f32
# over the same two rows (T 9216 in both, so the same capacity) on the
# bf16 path's routing (``routes_forced``: a near-tie flip moves which
# assignments an expert drops, most often the last token's: the first H100
# run's paged prefill read 0.3236 of the largest logit on the reference's
# own routing, its last token dropped at layer 7 in f32 only, and 0.0114
# on the bf16 path's); one decode step past the wrap against the
# teacher-forced windowed forward in f32, on a copy at capacity_factor 16
# (a step counts 2 tokens, a forward 4609 a row: with no drops each
# token's FFN is its own, as JAX's tests/test_arch_smoke.py holds the
# ring); the paged engine's prefill_kv of one prompt against the f32
# forward on its routing. Each limit is 1.25x the first H100 reading, of
# the largest logit: 0.0117, 0.0103 and 0.0114.
MIXTRAL_PREFILL_LOGIT_TOL_REL = 0.0146
MIXTRAL_STEP_LOGIT_TOL_REL = 0.0129
MIXTRAL_PAGED_LOGIT_TOL_REL = 0.0143
# where the bf16 path and its f32 reference (on the bf16 path's routing)
# pick different experts for a token, the f32 gate of the reference's last
# chosen expert against the f32 gate of the expert the bf16 path took
# instead: their gap, of the token's largest gate, is a near tie within
# this limit, 1.25x the first H100 reading (0.0320, layer 7 of the
# generate prefill; 0.0087 in the paged prefill)
MIXTRAL_ROUTE_TIE_TOL_REL = 0.040
# the bf16 path's router logits against ``xt.float() @ router`` in f32 on
# the same hidden states, of their largest, layer by layer: the config
# states an f32 router, so the two are the same product. A router planted
# in bf16 (``router_in_bf16``) must exceed this; the forced reference
# would take the choices it flips as its own, and route_ties reads only
# how near a tie each flip was.
MIXTRAL_ROUTER_TOL_REL = 1e-4
# DeepSeek-V2-Lite (mla_moe) at full width and depth: 27 layers (a dense
# head layer of F 10944, then 26 of 64 experts top-6 of F 1408 and 2
# shared), D 2048, 16 heads, MLA with kv_lora_rank 512, q / k of 192 (128
# nope + 64 rope), v of 128; 31.4 GB of bf16. generate runs 4 prompts of
# 2048 tokens and 32 new tokens.
DEEPSEEK = dict(prompts=4, prompt_len=2048, new_tokens=32, seed=23)
DEEPSEEK_ROW = "flash_prefill[deepseek-v2-lite,dk=192,dv=128,B=4,S=2048]"
# generate's prefill (flash_prefill at dk 192, dv 128; the bf16 MoE at cf
# 1.25, C 960 of T 8192) last-token logits, all four rows, against the
# plain forward in f32 over the same rows on the bf16 path's routing
# (``routes_forced``); one absorbed decode step against the teacher-forced
# f32 forward over S + 1 (K / V expanded), at capacity_factor 16 (a step
# counts 4 tokens, C 1 at cf 1.25: it drops, and the forward would not).
# Each limit is 1.25x the first H100 reading, of the largest logit: 0.0247
# and 0.0462 (the step: bf16 rounds the absorbed q and the latent context,
# and 10 of its 104 (token, layer)s route apart at near ties). A fault in
# the prefill's attention sits inside that noise end to end (the kernel
# planted at scale 1/sqrt(dv) read 0.0230): random weights attend almost
# uniformly over 2048 positions, and attention is a small part of the
# residual stream. So the phase also holds each layer's attention, at the
# model's own inputs, to the plain version row by row (PREFILL_ROW_REL_L2:
# 0.0055 read, the planted scale 0.0999).
DEEPSEEK_PREFILL_LOGIT_TOL_REL = 0.0309
DEEPSEEK_STEP_LOGIT_TOL_REL = 0.0578
# The step's logits cannot see a fault in its attention either, so the
# phase holds each layer's absorbed latent context (``_mla_decode_context``,
# the per-head (B, H, dv) before W_O) at the model's inputs against the f32
# expanded form over the same positions (``mla_context_expanded``: K / V
# expanded per head from c_kv, as the prefill attends), row by row, at the
# prefill attention's limit: the first H100 reading was 0.0036 (the bf16
# absorbed q, probabilities and latent context), the scores planted at
# 1/sqrt(nope) 0.058, which the step's logits did not catch (0.0458).
DEEPSEEK_CTX_ROW_REL_L2 = PREFILL_ROW_REL_L2
# a routing flip of the bf16 path against its f32 reference (route_ties)
# within this share of the token's largest gate: 1.25x the first H100
# reading (0.0628, layer 25 of the prefill, where 18,684 of 212,992 (token,
# layer)s part: top-6 of 64 gates of ~0.05 leaves many near ties)
DEEPSEEK_ROUTE_TIE_TOL_REL = 0.0785
# Whisper-small (encdec) at full width and depth: 12 encoder and 12
# decoder layers, D 768, 12 heads of 64, vocab 51865, 0.48 GB of bf16; the
# audio frontend a stub (1500 seeded frame embeddings a lane). 8 lanes, a
# 4-token decoder prompt, 60 greedy tokens (prefill, then decode_step);
# then a teacher-forced forward over 448 target tokens (Whisper's longest).
WHISPER = dict(lanes=8, prompt_len=4, new_tokens=60, target_len=448,
               seed=29)
# flash_prefill at Whisper's three attention shapes: the encoder's
# self-attention (not causal, S 1500), the cross-attention of the
# teacher-forced forward (Sq 448 over Sk 1500) and of the prefill (Sq 4)
WHISPER_ROWS = {"enc": "flash_prefill[whisper-small,B=8,S=1500,not causal]",
                "cross": "flash_prefill[whisper-small,B=8,Sq=448,Sk=1500]",
                "cross4": "flash_prefill[whisper-small,B=8,Sq=4,Sk=1500]"}
# The prefill's last logits, the 59 decode steps' and the teacher-forced
# forward's over 448 tokens (kernels, bf16) against the plain forward in f32
# (the same bf16 weights upcast) on the same tokens, of the largest logit
# (the tied head's logits reach 330-370): 1.25x the first H100 reading,
# 0.0047, 0.0056 and 0.0053. A fault in one attention hides under these (the
# keys cut at 1472 move one cross-attention by 0.019 a row), so each
# attention is also held at the model's inputs (attention_checked).
WHISPER_PREFILL_LOGIT_TOL_REL = 0.0059
WHISPER_STEP_LOGIT_TOL_REL = 0.0070
WHISPER_FORWARD_LOGIT_TOL_REL = 0.0066
# xLSTM-1.3B at full width and depth: 48 blocks (6 groups of 7 mLSTM and 1
# sLSTM), D 2048, 4 mLSTM heads of 1024, vocab 50304, 3.97 GB of bf16, the
# one expert of CompositionOfExperts(HashRouter(1)); generate on 4 prompts
# of 2048 tokens, 32 new. The chunkwise-against-step check: every mLSTM
# core of the prefill over its first 512 positions (two chunks of 256).
XLSTM = dict(prompts=4, prompt_len=2048, new_tokens=32, check_len=512,
             seed=31)
# With random weights the 48 blocks amplify a perturbation ~1.17x each
# (CPU trials at D 512: 1e-3 at the input reads 0.029 after 16 blocks), so
# the bf16 path's end-to-end logits part from the f32 forward by tens of
# per cent of the largest (0.44 on the first H100 run) and no end-to-end
# limit could see a fault: each block is held instead, at the model's own
# bf16 inputs and state. In the prefill, every block's update (y - x) and
# new state (mLSTM C and n; sLSTM h, c, n, m) against the same block in
# f32 (weights, input and state upcast): relative L2 over the whole
# tensor; 1.25x the widest first H100 reading (0.0220; the states read at
# most 0.0079). This reference cannot see the chunkwise core's precision
# (it differs from the model by q / k / v's bf16 rounding already: the
# first block with its core's products in bf16 reads 0.0117, inside the
# 0.0165 the blocks read), so each core is also held against its f64
# parallel form (XLSTM_CHUNK_REL_TOL).
XLSTM_BLOCK_TOL_REL = 0.0276
# Each block's outputs over the 31 decode steps and its state after them,
# at the model's inputs, against the same block in f32 run over the steps'
# inputs as one chunk from its state before them (the blocks
# teacher-forced: the state carried from the prefill and from step to step
# is held at full width): 1.25x the first H100 reading (an mLSTM update,
# 0.01656; sLSTM 0.01524, states <= 0.0073). The planted carry faults
# (the conv window, the sLSTM state dropped) read 1.26 and 0.38.
XLSTM_TF_TOL_REL = 0.0207
# Each chunkwise mLSTM pass of the prefill, at the model's own q / k / v
# and gates, over its first check_len positions (two chunks of 256)
# against its parallel form in f64 from the same inputs: h's largest row
# relative L2 error and C's relative L2 error (JAX's tests/test_substrate.py
# holds the chunkwise pass against the step recurrence at rtol 1e-3, as
# here; the teacher-forced check holds the model's steps against the
# chunkwise pass); the first core also against the f32 step recurrence
# itself. The H100 reads 2.6e-5 / 3.9e-6 (the step recurrence 1.0e-5 /
# 2.5e-6), the first block's core planted in bf16 (autocast) 9.9e-3.
XLSTM_CHUNK_REL_TOL = 1e-3
# Training: samba-coe-expert-7b at full width cut to 8 of its 32 layers
# (AdamW holds 12 bytes a parameter: the 6.739 B params need 80.9 GB before
# an activation; 8 layers are 1.881 B params, 22.6 GB of state), one
# repeated SyntheticLM batch of 4 x 2048, remat on, 6 steps at
# launch/train.py's schedule (warmup max(2, steps // 10), decay steps, lr
# 3e-4). The checkpoint round trip cuts the same width to 1 layer (0.464 B
# params, a 5.57 GB write).
TRAIN = dict(arch="samba-coe-expert-7b", layers=8, batch=4, seq=2048,
             steps=6, lr=3e-4, seed=29, ckpt_layers=1, ckpt_steps=2)
# Each layer's attention backward at the model's inputs (q, k, v, dO
# tapped from FlashAttention in the first step) against attention_bwd_ref
# in f32: the relative L2 error of dq, dk and dv, the largest over the 8
# layers. The kernel rounds p and ds to bf16 for its products and its
# outputs to bf16 (the outputs' rounding alone reads ~1.6e-3). The H100
# read 2.40e-3-2.435e-3 in the 8 layers under a provisional 2^-6; the
# limit is 1.25x the largest. The kernel rows hold random inputs to it too
# (2.46e-3). Planted in the reference, each must read above it: the causal
# mask skipped on each 64-row diagonal tile (read 1.008), and di taken as
# 0 (0.429).
TRAIN_BWD_REL_L2 = 3.05e-3
# The first step's loss (bf16, kernels) against the plain forward in f32
# (the same bf16 weights upcast, quadratic attention) on the same batch,
# relative: the H100 read 9.46e-6 (random weights keep the logits near
# uniform, so the loss sits near ln 32000 in both); the limit is 1.25x.
TRAIN_LOSS_TOL_REL = 1.2e-5
# The loss two steps after a checkpoint round trip against the
# uninterrupted run's, relative: the restored state is bit-equal, the
# forward deterministic, but the embedding's backward sums with atomics.
TRAIN_RESUME_TOL_REL = 1e-3
TRAIN_BWD_ROW = "flash_prefill_bwd[B=4,S=2048,G=1,causal]"
TRAIN_BWD_GQA_ROW = "flash_prefill_bwd[mixtral-8x7b,G=4,B=2,S=4608,window=4096]"
TRAIN_LSE_ROW = "flash_prefill[lse,B=4,S=2048]"
# Family training: each family the training phase leaves out at full
# width, its state freed before the next: recurrentgemma-9b cut to one
# (rec, rec, attn) group of its 38 layers at B 2 x 3000 (past the 2048
# window, a ragged last tile), deepseek-v2-lite-16b cut to 3 of its 27
# layers (the dense first layer and two MoE layers) at B 4 x 2048,
# whisper-small uncut (8 x 1500 stub frames, a 448-token teacher-forced
# decoder). ``steps`` steps of make_train_step with remat, AdamW at
# ``lr`` (warmup 2, decay ``steps``), one SyntheticLM batch repeated.
FAMILY_TRAIN = {
    "recurrentgemma-9b": dict(layers=3, batch=2, seq=3000, seed=37),
    "deepseek-v2-lite-16b": dict(layers=3, batch=4, seq=2048, seed=41),
    "whisper-small": dict(layers=None, batch=8, seq=448, seed=43),
}
FAMILY_STEPS, FAMILY_LR = 3, 3e-4
# The first loss (bf16, kernels) against the plain f32 forward on the same
# batch, relative: the H100 read 1.41e-5 (RG), 1.25e-5 (DeepSeek) and
# 1.79e-4 (Whisper, whose random weights give a loss of ~288); each limit
# is 1.5x its reading.
FAMILY_LOSS_TOL_REL = {"recurrentgemma-9b": 2.1e-5,
                       "deepseek-v2-lite-16b": 1.9e-5,
                       "whisper-small": 2.7e-4}
# Each attention backward at the model's inputs against attention_bwd_ref
# in f32: the largest relative L2 of dq, dk, dv (on a windowed layer also
# over the rows the window's edge cuts: dq's rows past W, dk's / dv's keys
# before S - W). RG and DeepSeek read 2.42e-3-2.43e-3, as random inputs do
# (the kernels round p, ds and their outputs to bf16); Whisper's layers
# read 2.9e-3 at its first encoder layer, rising with depth to 9.8e-3 in
# the decoder: its residual stream gives the keys a common direction,
# which cancels in dq = sum_j ds_ij k_j (sum_j ds_ij = 0), so ds's bf16
# rounding weighs more; the plain formulas at the kernel's rounding
# points read 9.86e-3 there. Each limit is 1.25x the largest reading.
# Planted, each must read above it: di taken as 0 (0.41-0.42), RG's window
# edge off by one (2.09e-2).
FAMILY_BWD_REL_L2 = {"recurrentgemma-9b": 3.05e-3,
                     "deepseek-v2-lite-16b": 3.05e-3,
                     "whisper-small": 1.25e-2}
# Each family's worst layer is also held to the plain formulas at the
# kernels' bf16 rounding points (``attention_bwd_masked(..., rounded=
# True)``): the kernel's largest relative L2 against the f32 formulas at
# most this factor times theirs, so the limits above stay tied to the
# rounding the design specifies, not to one run's reading.
FAMILY_ROUNDING_RATIO = 1.25
# each lru_scan backward against lru_scan_bwd_ref in f32 (relative L2 of
# da, db): both f32, the H100 read 4.7e-8
FAMILY_LRU_REL_L2 = 1e-5
# the backward's kernel rows at the families' training shapes, and the
# recurrence's backward at RecurrentGemma's prefill shape (4, 3000, 4096)
FAMILY_BWD_ROWS = {
    "rg": "flash_prefill_bwd[recurrentgemma-9b,G=16,B=2,S=3000,"
          "window=2048,d=256]",
    "mla": "flash_prefill_bwd[deepseek-v2-lite,dk=192,dv=128,B=4,S=2048]",
    "enc": "flash_prefill_bwd[whisper-small,B=8,S=1500,full]",
    "cross": "flash_prefill_bwd[whisper-small,B=8,Sq=448,Sk=1500,full]",
}
LRU_BWD_ROW = "lru_scan_bwd"
# Distribution phase: the 7B expert at full width through the mesh
# builders (distributed/stepfn.py). (a) a (1, 1) mesh under NCCL in this
# process, ``layers_nccl`` of the 32 layers: two train steps bit-equal to
# the single-device step's, then a prefill of ``prefill`` tokens and
# ``decode_steps`` greedy steps bit-equal to ``prefill`` / ``decode_step``.
# (b) two spawned ranks sharing the card over gloo (NCCL refuses two ranks
# on one device), ``layers_gloo`` layers, the default layout (Megatron-SP
# residual, the loss on the gathered logits): two steps on a (1, 2) TP
# mesh, the state saved, restored onto a (2, 1) DP mesh, one step; each
# step's loss and grad norm and the params after the TP steps and after the
# DP step held against the 1 x 1 step's on the same weights and batch
# (``loss_tol``, ``gnorm_tol``; worst leaf relative L2 ``param_tol``), and
# a planted fault (both DP ranks on data shard 0's half of the batch) must
# part by more than ``param_tol``. Gloo on CUDA tensors takes the
# all-reduce, reduce-scatter and the process-group all-gather, but DTensor's
# functional all-gather ends the process (tools/gloo_cuda_collectives.py),
# so (b)'s ranks serve that op by the process group's
# (``gather_through_process_group``). The limits are about 4x the H100's
# first readings on this layout (loss 6.1e-6, grad norm 1.16e-5 relative at
# worst over the three steps) and 2x for the params (5.1e-3: bf16 Adam
# updates whose near-zero gradients flip sign with the reduction order);
# the planted faults read 1.41 (shards swapped) and 3.5e-2 / loss 1.3e-3
# (half the batch).
DIST = dict(arch="samba-coe-expert-7b", layers_nccl=4, layers_gloo=2,
            batch=4, seq=2048, steps=2, prefill=(4, 512), decode_steps=8,
            lr=3e-4, seed=31, timeout=600,
            loss_tol=2.5e-5, gnorm_tol=5e-5, param_tol=1e-2)
# The families distribution (a′) adds at full width on its (1, 1) NCCL
# mesh, each cut in depth only: RecurrentGemma to one (rec, rec, attn)
# group, xLSTM to one group of slstm_every blocks (its sLSTM steps once a
# position: 512 of them), Whisper to 2 encoder and 2 decoder layers; two
# train steps, a prefill of (lanes, tokens) and 4 decode steps each.
DIST_FAMILIES = {
    "recurrentgemma-9b": dict(cut=dict(n_layers=3), batch=2, seq=2048,
                              prefill=(2, 512)),
    "xlstm-1.3b": dict(cut=dict(n_layers=8), batch=2, seq=512,
                       prefill=(2, 256)),
    "whisper-small": dict(cut=dict(n_layers=2, n_encoder_layers=2), batch=4,
                          seq=448, prefill=(4, 64)),
}
DIST_FAMILY_DECODE = 4
# The dry-run phase: the CLI's cell, and a limit on each of its two
# subprocesses (each builds a fake group and traces on fake tensors).
DRYRUN = dict(arch="mixtral-8x7b", cell="decode_32k", timeout=300)
# what a phase measured that a later one prints beside its own
MEASURED = {}


def prefill_widths(c):
    """(dk, dv) of config ``c``'s prefill attention: its head_dim twice,
    or MLA's q / k of nope + rope and v of ``v_head_dim``."""
    if c.family == "mla_moe":
        return c.qk_nope_dim + c.qk_rope_dim, c.v_head_dim
    return c.head_dim, c.head_dim


def prefill_shapes():
    """(config name, B, S, windowed) of every ``flash_prefill`` shape the
    kernel phases hold against the plain version, causal, local at the
    config's window where ``windowed``; ``tools/prefill_timing.py`` times
    them."""
    def b1(arch):
        return [(arch, 1, S, False) for S in B1_PREFILL_LENGTHS]
    lanes, prompt = DENSE["lanes"], DENSE["prompt_len"]
    out = [("samba-coe-expert-7b", lanes, prompt, False),
           ("recurrentgemma-9b", RG["prompts"], RG["prompt_len"], True)]
    out += b1("samba-coe-expert-7b")
    for arch in VARIANT_PREFILL_ROWS:
        out += [(arch, lanes, prompt, False)] + b1(arch)
    out += [("mixtral-8x7b", MIXTRAL["prompts"], MIXTRAL["prompt_len"],
             True)] + b1("mixtral-8x7b")
    out.append(("deepseek-v2-lite-16b", DEEPSEEK["prompts"],
                DEEPSEEK["prompt_len"], False))
    return out


def _log(msg):
    print(msg, flush=True)


def time_ms(fn, flush, reps, read=False):
    """Mean device time of ``fn`` over ``reps`` launches, each after the L2
    cache was overwritten, after two warm-up calls. A spin kernel ahead of
    each launch keeps the card busy while the host enqueues ``fn``, so the
    events bracket device work only, not the wrapper's host overhead. The
    flush writes ``flush`` (128 MB), so ``fn`` also pays the write-back of
    the ~50 MB of dirty lines it evicts; with ``read`` it reads ``flush``
    instead and finds the L2 holding clean lines, as on the serving path,
    where the kernel ahead streams weights."""
    fn()
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)         # ~1 ms of device time
        if read:
            flush.max()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def warm_card(dev, seconds=2.0):
    """Keep the card busy with bf16 products for ``seconds`` before the
    first timed row. The card idles through the build; in one run the
    first row timed after it (``decode_paged``, row 1) read 0.0810 ms
    where its read-flushed time read 0.0199 and the same kernel in
    ``tools/decode_timing.py``, later in that call, 0.0215."""
    a = torch.randn((4096, 4096), device=dev).to(torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(16):
            a @ a
        torch.cuda.synchronize()


# the paged decode kernel's (dh, query tile) instantiations
DECODE_TILES = [(str(dh), str(g)) for dh in (32, 64, 128, 256)
                for g in (1, 2, 4, 8)]


def build_kernels():
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention.ops import PREFILL_WIDTHS
    t0 = time.perf_counter()
    logs = rt.build()
    _log(f"built {len(logs)} kernel libraries in "
         f"{time.perf_counter() - t0:.1f}s (sm_90a)")
    prefill_smem = rt.bind("flash_prefill", "flash_prefill_smem_bytes",
                           [rt.I, rt.I])
    passes = ("OprojPass", "GateUpPass", "DownPass")
    lanes = ("8", "16")
    for name, log in logs.items():
        if name == "decode_paged":
            paged_smem = rt.bind(name, "decode_paged_smem_bytes",
                                 [rt.I, rt.I])
            entry_build_report(
                name, log, r"decode_split_kernelILi(\d+)ELi(\d+)E",
                DECODE_TILES, lambda k: f"decode_paged[dh={k[0]} tile={k[1]}]",
                lambda k: paged_smem(int(k[0]), int(k[1])))
        elif name == "flash_decode":
            dense_smem = rt.bind(name, "flash_decode_smem_bytes", [rt.I])
            # cp.async through L2 only (b0) or allocating in L1 (b1)
            entry_build_report(
                name, log, r"decode_group_kernelILi(\d+)ELb([01])E",
                [(str(dh), l1) for dh in (32, 64, 128, 256) for l1 in "01"],
                lambda k: f"flash_decode[dh={k[0]}"
                + (" l1" if k[1] == "1" else "") + "]",
                lambda k: dense_smem(int(k[0])))
        elif name == "flash_prefill":
            # each (dk, dv) four times: causal / windowed (b0 b0), FULL
            # (b1 b0), and their LSE forms (the training forward)
            entry_build_report(
                name, log,
                r"prefill_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])E",
                [(str(dk), str(dv), full, lse) for dk, dv in PREFILL_WIDTHS
                 for lse in "01" for full in "01"],
                lambda k: (f"flash_prefill[dh={k[0]}" if k[0] == k[1]
                           else f"flash_prefill[dk={k[0]} dv={k[1]}")
                + (" full" if k[2] == "1" else "")
                + (" lse" if k[3] == "1" else "") + "]",
                lambda k: prefill_smem(int(k[0]), int(k[1])))
        elif name == "flash_prefill_bwd":
            # the row statistics, the warp-specialised dK/dV/dQ kernels
            # (wgmma, TMA rings): bwd_kernel (square b0, FULL b1) and dq's
            # rounding at d 32 / 64 / 128, wide_kernel, its dq rounding
            # and its head groups' sum at d 256 and (192, 128): registers,
            # no spill, no serialised wgmma
            bwd_smem = rt.bind(name, "flash_prefill_bwd_smem_bytes",
                               [rt.I, rt.I])
            wide = [(str(dk), str(dv)) for dk, dv in PREFILL_WIDTHS
                    if dk == 192 or dk == 256]
            wg = [str(dk) for dk, dv in PREFILL_WIDTHS
                  if (str(dk), str(dv)) not in wide]
            stat = sorted({str(dv) for _, dv in PREFILL_WIDTHS}, key=int)
            entry_build_report(
                name, log,
                r"(stat_kernel|dq_out_kernel|wide_dq_kernel)ILi(\d+)E|"
                r"(bwd_kernel)ILi(\d+)ELb([01])E|"
                r"(wide_kernel|wide_sum_kernel)ILi(\d+)ELi(\d+)E",
                [("stat_kernel", d) for d in stat]
                + [("dq_out_kernel", d) for d in wg]
                + [("bwd_kernel", d, f) for d in wg for f in "01"]
                + [("wide_dq_kernel", dk) for dk, _ in wide]
                + [(kn, dk, dv) for kn in ("wide_kernel", "wide_sum_kernel")
                   for dk, dv in wide],
                lambda k: f"flash_prefill_bwd[{k[0]} d={k[1]}"
                + (" full" if k[0] == "bwd_kernel" and k[2] == "1" else "")
                + (f" dv={k[2]}" if k[0].startswith("wide_") and len(k) == 3
                   else "") + "]",
                lambda k: bwd_smem(int(k[1]), int(k[1])) if k[0] ==
                "bwd_kernel" else bwd_smem(int(k[1]), int(k[2]))
                if k[0] == "wide_kernel" else 0)
        elif name in ("oproj_ffn_swiglu", "ffn_swiglu"):
            stream_smem = rt.bind(name, "stream_smem_bytes", [rt.I, rt.I])
            first = ("OprojPass" if name == "oproj_ffn_swiglu"
                     else "rms_prep_kernel")
            entry_build_report(
                name, log, r"(OprojPass|GateUpPass|DownPass|rms_prep_kernel)"
                           r"ILi(\d+)E",
                [(p, nl) for p in (first, *passes[1:]) for nl in lanes],
                lambda k: f"{name}[{k[0]} NL={k[1]}]",
                lambda k: stream_smem(passes.index(k[0]), int(k[1]))
                if k[0] in passes else 0)
        elif name in ("qkv_rope_paged", "qkv_rope"):
            qkv_smem = rt.bind(name, "qkv_smem_bytes", [rt.I, rt.I])
            entry_build_report(
                name, log, r"(rms_prep_kernel)ILi(\d+)E|"
                           r"(QkvPass)ILi(\d+)ELi(\d+)E",
                [("rms_prep_kernel", nl) for nl in lanes]
                + [("QkvPass", nl, tw) for nl in lanes for tw in ("2", "4")],
                lambda k: f"{name}[{k[0]} NL={k[1]}" + (
                    "]" if len(k) == 2 else
                    f" dh={'256' if k[2] == '4' else '32-128'}]"),
                lambda k: qkv_smem(int(k[1]), int(k[2])) if len(k) == 3
                else 0)
        elif name in ("monarch_fused", "monarch_conv_fused"):
            monarch_build_report(name, log)
        else:
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
            _log(f"  {name}: " + " | ".join(regs[:6]))


# Shapes whose plans between them pick every Monarch kernel instantiation
# (tests/test_torch_monarch_kernels_gpu.py): the build report prints each
# instantiation's shared memory at the first of them that picks it
MONARCH_PLAN_SHAPES = {
    "monarch_fused": ((16, 1024, 1024), (16, 256, 256), (2, 128, 2048),
                      (1, 128, 1664), (1, 64, 4096), (1, 64, 5888)),
    "monarch_conv_fused": ((16, 1024, 1024), (16, 256, 256), (4, 1024, 1024),
                           (2, 128, 2048), (1, 128, 2304), (16, 640, 256),
                           (8, 512, 2048), (8, 512, 2304), (4, 2048, 256),
                           (4, 1664, 256), (2, 4096, 256), (2, 5888, 128))}


def monarch_launches(name, B, N1, N2):
    """The CUDA kernels one call of Monarch library ``name`` launches at
    (B, N1, N2) on this card, as [(kernel, plan or None, the launch's (B,
    N1, N2))]."""
    from repro_torch.kernels.monarch_fft.ops import (card_limits,
                                                     monarch_conv_plan,
                                                     monarch_plan)
    sms, smem = card_limits(name, torch.cuda.current_device())
    if name == "monarch_fused":
        return [("monarch_kernel", monarch_plan(B, N1, N2, smem),
                 (B, N1, N2))]
    first, second = monarch_conv_plan(B, N1, N2, sms, smem)
    if second is None:
        return [("conv_front_kernel", first, (B, N1, N2)),
                ("conv_back_kernel", None, (B, N1, N2))]
    return [("conv_forward_kernel", first, (B, N1, N2)),
            ("conv_inverse_kernel", second, (B, N2, N1))]


def monarch_build_report(name, log):
    """The Monarch libraries' build report: one line per kernel
    instantiation (kernel, BM, the phase-1 slab: 1 or all the chunk pairs
    the accumulators hold), the conv's back GEMM one line, failing as
    ``entry_build_report`` does, and also where ``MONARCH_PLAN_SHAPES``
    leave an instantiation unpicked on this card. The
    shared memory is the library's own sum at the first of those shapes
    that picks the instantiation (the back GEMM's is fixed)."""
    from repro_torch.kernels import runtime as rt
    conv = name == "monarch_conv_fused"
    if conv:
        smem_fn = rt.bind(name, "monarch_conv_smem_bytes", [rt.I] * 4)
    else:
        bytes_fn = rt.bind(name, "monarch_smem_bytes", [rt.I] * 3)
        smem_fn = lambda bm, stages, n2, front: bytes_fn(bm, stages, n2)
    picked = {}
    for shape in MONARCH_PLAN_SHAPES[name]:
        for kernel, p, (_, _, n2) in monarch_launches(name, *shape):
            if p is None:
                picked.setdefault((kernel,), (smem_fn(0, 0, 0, 0), None))
            else:
                front = kernel == "conv_front_kernel"
                picked.setdefault(
                    (kernel, str(p.bm), str(p.chunks)),
                    (smem_fn(p.bm, p.stages, n2, front),
                     f"at {shape}: {p.stages} stages"))

    def label(k):
        if len(k) == 1:
            return f"{name}[{k[0]}]"
        return f"{name}[{k[0]} BM={k[1]} slab={k[2]}; {picked[k][1]}]"

    entry_build_report(
        name, log,
        r"(monarch_kernel|conv_front_kernel|conv_forward_kernel|"
        r"conv_inverse_kernel)ILi(\d+)ELi(\d+)E|(conv_back_kernel)E",
        sorted(picked), label, lambda k: picked[k][0])


def entry_build_report(name, log, entry_re, want, label, smem):
    """Library ``name``'s ``-Xptxas -v`` report, one line per entry function
    whose mangled name matches ``entry_re`` (its matched groups are the
    key): registers at entry (setmaxnreg may move them later), spills and
    ``smem(key)`` bytes of dynamic shared memory. Fails on a spill, on a
    key of ``want`` without a report, or on a warning that ptxas
    serialised the wgmma instructions."""
    import re
    serialised = [ln.strip() for ln in log.splitlines()
                  if "wgmma" in ln and "serialized" in ln]
    if serialised:
        raise AssertionError(f"{name}: " + " | ".join(serialised))
    report, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(entry_re, m.group(1))
            key = tuple(g for g in k.groups() if g) if k else None
        elif key is not None and ("spill" in ln or "Used" in ln):
            report.setdefault(key, []).append(
                ln.split("info    :")[-1].strip())
    if sorted(report) != sorted(want):
        raise AssertionError(f"{name}: no build report for each of {want} "
                             f"in:\n{log}")
    for key, lines in sorted(report.items()):
        _log(f"  {label(key)}: " + " | ".join(lines)
             + f" | {smem(key)} bytes dynamic shared memory")
        if not any(" 0 bytes spill stores, 0 bytes spill loads" in ln
                   for ln in lines):
            raise AssertionError(f"{label(key)} spills: {lines}")


def row_rel_l2(got, want):
    """The largest ||got - want|| / ||want|| over the rows of the last
    axis."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


def kernel_row(name, kern, plain, lib, nbytes, flops, flush, *,
               kernel=None, rel_tol=2.0 ** -7, peak=BF16_FLOPS_PER_S,
               row_tol=None):
    """Holds kernel ``name`` (the row's name; ``kernel`` names the kernel
    where a row is one of several shapes) against its plain version on the
    same inputs, times the kernel, the plain version and the library call
    (``lib`` None where there is none), and returns its row of the kernel
    table. The default tolerance is for bf16 outputs: both accumulate in f32
    and round to bf16 once, two units in the last place of the largest
    output. With ``row_tol`` every row of the last axis is also held to
    that relative L2 error (``row_rel_l2``)."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, tol, row_err = 0.0, 0.0, 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = max(err, float((g.float() - w.float()).abs().max()))
        tol = max(tol, rel_tol * max(1.0, float(w.float().abs().max())))
        if row_tol is not None:
            row_err = max(row_err, row_rel_l2(g, w))
    del got, want
    if not err <= tol:
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > "
                             f"tolerance {tol}")
    if row_tol is not None:
        if not row_err <= row_tol:
            raise AssertionError(f"{name}: a row's relative L2 error "
                                 f"{row_err} > {row_tol}")
        _log(f"kernel {name}: largest row relative L2 error {row_err:.3e} "
             f"(tol {row_tol:.3e})")
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    r = dict(
        name=name, route="cuda", **KERNELS[kernel or name],
        max_abs_err=err, max_err=err, tol=tol,
        **({} if row_tol is None else dict(row_rel_l2=row_err,
                                           row_tol=row_tol)),
        ms=time_ms(kern, flush, 50), plain_ms=time_ms(plain, flush, 10),
        ms_read_flushed=time_ms(kern, flush, 50, read=True),
        library_ms=None if lib is None else time_ms(lib, flush, 20),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops)
    r["kernel_ms"] = r["ms"]
    r["bound_us"] = r["bound_ms"] * 1e3
    lib_s = "none" if lib is None else f"{r['library_ms']:.4f}ms"
    _log(f"kernel {name}: max_err={err:.3e} (tol {tol:.3e}) "
         f"kernel={r['ms']:.4f}ms (read-flushed {r['ms_read_flushed']:.4f}ms) "
         f"plain={r['plain_ms']:.4f}ms "
         f"library={lib_s} bound={r['bound_ms']:.4f}ms "
         f"({r['bound_by']}, {nbytes} B, {flops} flops)")
    return r


# the launches of one call of each weight-stream kernel, in order (kernel
# names)
STREAM_PASSES = {
    "qkv_rope_paged": ("rms_prep_kernel", "QkvPass"),
    "oproj_ffn_swiglu": ("OprojPass", "GateUpPass", "DownPass"),
    "qkv_rope": ("rms_prep_kernel", "QkvPass"),
    "ffn_swiglu": ("rms_prep_kernel", "GateUpPass", "DownPass")}


def pass_times(name, row, fn, flush, n=10):
    """Where one call of weight-stream kernel ``name`` spends its device
    time, from the profiler's kernel events over ``n`` calls (the L2
    flushed before each): each pass's own span, and how far it moves the
    call's end (its end minus the previous pass's end; the first pass from
    its start).
    With programmatic launch a pass starts while the one ahead drains, so
    the spans overlap; the moves add up to the call's span. Prints them
    beside the row's achieved TB/s and adds both to ``row``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    passes = STREAM_PASSES[name]
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            torch.cuda._sleep(2_000_000)
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    spans = {p: sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA and p in e.name)
             for p in passes}
    row["tb_per_s"] = row["bytes"] / (row["ms"] * 1e-3) / 1e12
    head = (f"kernel {name}: {row['tb_per_s']:.3f} TB/s of "
            f"{HBM_BYTES_PER_S / 1e12:.2f}")
    if any(len(v) != n for v in spans.values()):
        _log(f"{head}; device time per pass not measured (the profiler "
             f"gave {[len(v) for v in spans.values()]} launches of "
             f"{list(passes)} for {n} calls)")
        return
    # call c's passes are the c-th launch of each
    t = np.array([spans[p] for p in passes])          # (pass, call, 2)
    own = (t[:, :, 1] - t[:, :, 0]).mean(axis=1)
    ends = np.concatenate([t[:1, :, 0], t[:, :, 1]])  # first start, ends
    moves = np.diff(ends, axis=0).mean(axis=1)
    row["pass_ms"] = {p: dict(own=o / 1e3, moves=m / 1e3)
                      for p, o, m in zip(passes, own, moves)}
    _log(f"{head}; device span {moves.sum() / 1e3:.4f} ms by pass (own span"
         f" / moves the end): " + "; ".join(
             f"{p} {o / 1e3:.4f} / {m / 1e3:.4f} ms"
             for p, o, m in zip(passes, own, moves)))


def rope_fault_caught(name, got, plain_fault):
    """The row check of a QKV kernel must catch a fault planted in its plain
    version: RoPE dropped (every position 0). Fails where it does not."""
    torch.cuda.synchronize()
    err = max(row_rel_l2(g, w) for g, w in zip(
        got if isinstance(got, tuple) else (got,),
        plain_fault if isinstance(plain_fault, tuple) else (plain_fault,)))
    caught = err > STREAM_ROW_REL_L2
    _log(f"kernel {name}: planted fault rope_dropped (in the plain version) "
         f"reads a row relative L2 error of {err:.3e} -> "
         f"{'caught' if caught else 'NOT caught'} at {STREAM_ROW_REL_L2:.3e}")
    if not caught:
        raise AssertionError(f"{name}: the row check missed a planted fault")


def split_faults_caught(name, got, inputs, chunk, lane, p_dtype=None):
    """Row ``name`` of a split decode kernel: its output ``got`` against
    its split plain version (``inputs``, the kernel's scores, values and
    valid positions, in chunks of ``chunk`` merged in chunk order; p
    rounded to ``p_dtype`` where given) row by row, within
    DECODE_ROW_REL_L2; then two faults planted in that plain version must
    read above it: lane ``lane``'s second chunk's partial dropped, and the
    position at the start of every chunk but the first left out. Fails
    where a check does not hold."""
    from repro_torch.kernels.flash_attention.ref import (merge_partials,
                                                         split_partials)
    s, vc, valid = inputs
    m, l, acc = split_partials(s, vc, valid, chunk, p_dtype)

    def merged(m, l, acc):
        return merge_partials(m, l, acc).reshape(got.shape).to(got.dtype)

    err = row_rel_l2(got, merged(m, l, acc))
    _log(f"kernel {name}: against the split plain version (chunk {chunk})"
         f" largest row relative L2 error {err:.3e} (tol "
         f"{DECODE_ROW_REL_L2:.3e})")
    if not err <= DECODE_ROW_REL_L2:
        raise AssertionError(f"{name}: a row's relative L2 error "
                             f"{err} against the split plain version")
    m, l, acc = m.clone(), l.clone(), acc.clone()
    m[lane, :, :, 1], l[lane, :, :, 1], acc[lane, :, :, 1] = \
        float("-inf"), 0.0, 0.0
    edge = valid.clone()
    edge[:, chunk::chunk] = False
    for fault, want in (("chunk_dropped", merged(m, l, acc)),
                        ("chunk_edge_dropped",
                         merged(*split_partials(s, vc, edge, chunk,
                                                p_dtype)))):
        f_err = row_rel_l2(got, want)
        caught = f_err > DECODE_ROW_REL_L2
        _log(f"kernel {name}: planted fault {fault} (in the split "
             f"plain version) reads a row relative L2 error of {f_err:.3e} "
             f"-> {'caught' if caught else 'NOT caught'} at "
             f"{DECODE_ROW_REL_L2:.3e}")
        if not caught:
            raise AssertionError(f"{name}: the row check missed a planted "
                                 f"fault ({fault})")


def paged_split_check(name, got, q, kp, vp, tables, len1):
    """``split_faults_caught`` for a ``decode_paged`` row: chunks of
    ``split_chunk()``, the longest lane's chunk dropped."""
    from repro_torch.kernels.flash_attention.ops import split_chunk
    from repro_torch.kernels.flash_attention.ref import split_inputs
    split_faults_caught(name, got, split_inputs(q, kp, vp, tables, len1),
                        split_chunk(), int(len1.argmax()))


def dense_split_check(name, got, q, kc, vc, length):
    """``split_faults_caught`` for a ``flash_decode`` row: chunks of
    ``decode_plan``'s for this call on this card, p rounded to the cache's
    dtype, lane 0's chunk dropped. Where the plan takes one chunk a pair,
    the row is held to that chunk first and the faults are planted at
    chunks of half the positions. Returns the plan."""
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention.ops import (DECODE_STAGE,
                                                         decode_plan)
    from repro_torch.kernels.flash_attention.ref import (dense_split_inputs,
                                                         decode_split_ref)
    B, Hq, dh = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    L = min(length, S)
    plan = decode_plan(B, Hkv, Hq // Hkv, dh, L,
                       rt.device_sms(q.device.index))
    chunk = plan.chunk
    if plan.chunks == 1:
        err = row_rel_l2(got, decode_split_ref(q, kc, vc, length, chunk))
        _log(f"kernel {name}: against the split plain version (one chunk "
             f"of {chunk}) largest row relative L2 error {err:.3e} (tol "
             f"{DECODE_ROW_REL_L2:.3e})")
        if not err <= DECODE_ROW_REL_L2:
            raise AssertionError(f"{name}: a row's relative L2 error "
                                 f"{err} against the split plain version")
        chunk = -(-(-(-L // 2)) // DECODE_STAGE) * DECODE_STAGE
    split_faults_caught(name, got, dense_split_inputs(q, kc, vc, length),
                        chunk, 0, vc.dtype)
    return plan


def paged_inputs(cfg, dev, B=8, seed=1, block=None, max_len=None,
                 len1=(1, 15, 16, 1, 17, 255, 300, 512)):
    """The paged kernels' inputs at ``cfg``'s widths, bf16: B lanes at the
    ragged positions ``len1`` straddling blocks of the serve phase's pool
    (or of ``block`` x ``max_len``), lane 3 inactive (its table all
    scratch), weights scaled by 1 / sqrt(fan-in)."""
    from types import SimpleNamespace
    bf = torch.bfloat16
    D, Hq, Hkv, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    block = block or SERVE["block_size"]
    maxb = (max_len or SERVE["max_len"]) // block
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    rows = B * maxb + 1
    t = SimpleNamespace(B=B, block=block, maxb=maxb, x=rnd(B, D),
                        q=rnd(B, Hq, dh), kp=rnd(rows, block, Hkv, dh),
                        vp=rnd(rows, block, Hkv, dh))
    t.perm = torch.randperm(rows - 1, generator=gen, device=dev)
    t.tables = t.perm[:B * maxb].reshape(B, maxb).to(torch.int32)
    t.tables[3] = rows - 1                               # inactive lane
    t.len1_host = list(len1)
    t.len1 = torch.tensor(t.len1_host, dtype=torch.int32, device=dev)
    t.pos = t.len1 - 1
    t.scale = (1.0 + 0.1 * rnd(D).float()).to(bf)
    t.wq, t.wk, t.wv = (rnd(D, Hq, dh, scale=D ** -0.5),
                        rnd(D, Hkv, dh, scale=D ** -0.5),
                        rnd(D, Hkv, dh, scale=D ** -0.5))
    t.attn = rnd(B, Hq * dh)
    t.wo = rnd(Hq * dh, D, scale=(Hq * dh) ** -0.5)
    t.wg, t.wu = rnd(D, F, scale=D ** -0.5), rnd(D, F, scale=D ** -0.5)
    t.wd = rnd(F, D, scale=F ** -0.5)
    return t


def paged_cases(cfg, t, rope_frac=1.0):
    """``{kernel: (kernel call, plain version, library call)}`` of the
    paged step's kernels (and the TP body's ``ffn_swiglu(residual=False)``)
    on ``paged_inputs``' ``t``, ``qkv_rope_paged`` rotating ``rope_frac``
    of a head."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention.ops import decode_paged
    from repro_torch.kernels.flash_attention.ref import decode_paged_ref
    from repro_torch.kernels.fused_decode.ops import (ffn_swiglu,
                                                      oproj_ffn_swiglu,
                                                      qkv_rope_paged)
    from repro_torch.kernels.fused_decode.ref import (ffn_swiglu_ref,
                                                      oproj_ffn_swiglu_ref,
                                                      qkv_rope_paged_ref,
                                                      rope_inv_freq)
    bf = torch.bfloat16
    B, D, Hq, Hkv, dh = (t.B, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim)
    inv = torch.as_tensor(rope_inv_freq(dh, cfg.rope_theta, rope_frac),
                          device=t.x.device)
    qkv = (t.x, t.scale, t.wq, t.wk, t.wv)
    ffn = (t.x, t.scale, t.wg, t.wu, t.wd)
    epi = (t.x, t.attn, t.wo, t.scale, t.wg, t.wu, t.wd)

    def lib_qkv():
        xn = (Fn.rms_norm(t.x.float(), (D,), eps=1e-6)
              * t.scale.float()).to(bf)
        return [torch.matmul(xn, w.reshape(D, -1)) for w in qkv[2:]]

    def lib_epilogue():
        y = t.x + t.attn @ t.wo
        yn = Fn.rms_norm(y, (D,), weight=t.scale, eps=1e-6)
        return y + (Fn.silu(yn @ t.wg) * (yn @ t.wu)) @ t.wd

    def lib_ffn():
        xn = Fn.rms_norm(t.x, (D,), weight=t.scale, eps=1e-6)
        return (Fn.silu(xn @ t.wg) * (xn @ t.wu)) @ t.wd

    return {
        "decode_paged": (
            lambda: decode_paged(t.q, t.kp, t.vp, t.tables, t.len1),
            lambda: decode_paged_ref(t.q, t.kp, t.vp, t.tables, t.len1),
            lambda: lib_decode_paged(t, t.tables, t.len1)),
        "qkv_rope_paged": (
            lambda: qkv_rope_paged(*qkv, t.pos, theta=cfg.rope_theta,
                                   rope_frac=rope_frac),
            lambda: qkv_rope_paged_ref(*qkv, t.pos, inv), lib_qkv),
        "oproj_ffn_swiglu": (lambda: oproj_ffn_swiglu(*epi),
                             lambda: oproj_ffn_swiglu_ref(*epi),
                             lib_epilogue),
        "ffn_swiglu[residual=False]": (
            lambda: ffn_swiglu(*ffn, residual=False),
            lambda: ffn_swiglu_ref(*ffn, residual=False), lib_ffn),
    }


def lib_decode_paged(t, tables, len1):
    """SDPA over the lanes' gathered blocks of ``paged_inputs``' pool,
    masked to ``len1``: the one library call beside ``decode_paged``."""
    import torch.nn.functional as Fn
    B, Hq, dh = t.q.shape
    Hkv, S = t.kp.shape[2], t.maxb * t.block
    kc = t.kp[tables.long()].reshape(B, S, Hkv, dh).transpose(1, 2)
    vc = t.vp[tables.long()].reshape(B, S, Hkv, dh).transpose(1, 2)
    mask = (torch.arange(S, device=t.q.device)[None, :] < len1[:, None])
    return Fn.scaled_dot_product_attention(
        t.q[:, :, None], kc, vc, attn_mask=mask[:, None, None, :],
        enable_gqa=Hq != Hkv)


def paged_rows(cfg, dev, names, seed, rope_frac=1.0, **shape):
    """Kernel rows of the paged kernels at ``cfg``'s widths: ``names`` maps
    each kernel of ``paged_cases`` to its row's name; ``shape`` goes to
    ``paged_inputs``. Returns (rows, the inputs, the cases)."""
    from repro_torch.serving.backends import (dense_kernel_flops,
                                              dense_kernel_hbm_bytes,
                                              kernel_flops, kernel_hbm_bytes)
    t = paged_inputs(cfg, dev, seed=seed, **shape)
    cases = paged_cases(cfg, t, rope_frac)
    nbytes = kernel_hbm_bytes(cfg, t.B, t.len1_host, t.maxb)
    flops = kernel_flops(cfg, t.B, t.len1_host)
    partial = "ffn_swiglu[residual=False]"
    nbytes[partial] = dense_kernel_hbm_bytes(cfg, t.B, 1)["ffn_swiglu"]
    flops[partial] = dense_kernel_flops(cfg, t.B, 1)["ffn_swiglu"]
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {row: kernel_row(row, *cases[k], nbytes[k], flops[k], flush,
                            kernel=k.split("[")[0],
                            row_tol=DECODE_ROW_REL_L2 if k == "decode_paged"
                            else STREAM_ROW_REL_L2)
            for k, row in names.items()}
    del flush
    return rows, t, cases


def kernel_phase(cfg, dev, B=8):
    """Each kernel against its plain version at the config's widths."""
    from repro_torch.kernels.flash_attention.ops import decode_paged
    from repro_torch.kernels.flash_attention.ref import decode_paged_ref
    from repro_torch.kernels.fused_decode.ref import (qkv_rope_paged_ref,
                                                      rope_inv_freq)
    from repro_torch.serving.backends import kernel_flops, kernel_hbm_bytes

    rows_out, t, cases = paged_rows(cfg, dev, {k: k for k in PAGED_KERNELS},
                                    seed=1)
    q, kp, vp, maxb, block = t.q, t.kp, t.vp, t.maxb, t.block
    paged_split_check("decode_paged",
                      decode_paged(q, kp, vp, t.tables, t.len1),
                      q, kp, vp, t.tables, t.len1)
    # every lane at 512 positions, on rows of its own
    full = t.perm[:B * maxb].reshape(B, maxb).to(torch.int32)
    len1_full = torch.full((B,), maxb * block, dtype=torch.int32, device=dev)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows_out[FULL_PAGED_ROW] = kernel_row(
        FULL_PAGED_ROW, lambda: decode_paged(q, kp, vp, full, len1_full),
        lambda: decode_paged_ref(q, kp, vp, full, len1_full),
        lambda: lib_decode_paged(t, full, len1_full),
        kernel_hbm_bytes(cfg, B, [maxb * block] * B, maxb)["decode_paged"],
        kernel_flops(cfg, B, [maxb * block] * B)["decode_paged"], flush,
        kernel="decode_paged", row_tol=DECODE_ROW_REL_L2)
    paged_split_check(FULL_PAGED_ROW,
                      decode_paged(q, kp, vp, full, len1_full), q, kp, vp,
                      full, len1_full)
    for name in ("qkv_rope_paged", "oproj_ffn_swiglu"):
        pass_times(name, rows_out[name], cases[name][0], flush)
    inv = torch.as_tensor(rope_inv_freq(cfg.head_dim, cfg.rope_theta),
                          device=dev)
    got = cases["qkv_rope_paged"][0]()
    rope_fault_caught("qkv_rope_paged", got, qkv_rope_paged_ref(
        t.x, t.scale, t.wq, t.wk, t.wv, torch.zeros_like(t.pos), inv))
    del flush
    return rows_out


def dense_kernel_phase(cfg, dev, B=8):
    """The dense-cache decode kernels against their plain versions at the
    config's widths: ``flash_decode`` at length 4096 in a 4096-position
    cache (8 lanes x 32 kv heads), also row by row against its chunked
    plain version with two chunk faults planted there, ``qkv_rope`` at
    position 4095, ``ffn_swiglu`` in both forms (the row times the
    residual form)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention.ops import decode
    from repro_torch.kernels.flash_attention.ref import decode_attention_ref
    from repro_torch.kernels.fused_decode.ops import ffn_swiglu, qkv_rope
    from repro_torch.kernels.fused_decode.ref import (ffn_swiglu_ref,
                                                      qkv_rope_ref,
                                                      rope_inv_freq)
    from repro_torch.serving.backends import (dense_kernel_flops,
                                              dense_kernel_hbm_bytes)

    bf = torch.bfloat16
    D, Hq, Hkv, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    H, S = Hq + 2 * Hkv, DENSE["max_len"]
    length, pos = S, S - 1
    gen = torch.Generator(device=dev).manual_seed(4)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    x = rnd(B, D)
    q = rnd(B, Hq, dh)
    kc, vc = rnd(B, S, Hkv, dh), rnd(B, S, Hkv, dh)
    scale = (1.0 + 0.1 * rnd(D).float()).to(bf)
    w_qkv = rnd(D, H * dh, scale=D ** -0.5)
    wg, wu = rnd(D, F, scale=D ** -0.5), rnd(D, F, scale=D ** -0.5)
    wd = rnd(F, D, scale=F ** -0.5)
    qkw = dict(n_q=Hq, n_kv=Hkv, dh=dh, theta=cfg.rope_theta)
    ang = pos * torch.as_tensor(rope_inv_freq(dh, cfg.rope_theta),
                                device=dev)
    cos, sin = torch.cos(ang).to(bf), torch.sin(ang).to(bf)
    mask = torch.arange(S, device=dev)[None, None, None, :] < length
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def lib_qkv():
        xn = (Fn.rms_norm(x.float(), (D,), eps=1e-6) * scale.float()).to(bf)
        y = torch.matmul(xn, w_qkv).reshape(B, H, dh)
        qk, v = y[:, :Hq + Hkv], y[:, Hq + Hkv:]
        y1, y2 = qk[..., :dh // 2], qk[..., dh // 2:]
        return torch.cat([torch.cat([y1 * cos - y2 * sin,
                                     y2 * cos + y1 * sin], -1), v], 1)

    def lib_decode():
        return Fn.scaled_dot_product_attention(
            q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=Hq != Hkv)

    def lib_ffn():
        xn = Fn.rms_norm(x, (D,), weight=scale, eps=1e-6)
        return x + (Fn.silu(xn @ wg) * (xn @ wu)) @ wd

    ffn_args = (x, scale, wg, wu, wd)
    cases = {
        "qkv_rope": (lambda: qkv_rope(x, scale, w_qkv, pos, **qkw),
                     lambda: qkv_rope_ref(x, scale, w_qkv, pos, **qkw),
                     lib_qkv),
        "flash_decode": (lambda: decode(q, kc, vc, length),
                         lambda: decode_attention_ref(q, kc, vc, length),
                         lib_decode),
        "ffn_swiglu": (lambda: ffn_swiglu(*ffn_args),
                       lambda: ffn_swiglu_ref(*ffn_args), lib_ffn),
    }
    nbytes = dense_kernel_hbm_bytes(cfg, B, length)
    flops = dense_kernel_flops(cfg, B, length)
    rows = {name: kernel_row(name, *fns, nbytes[name], flops[name], flush,
                             row_tol=STREAM_ROW_REL_L2
                             if name in STREAM_PASSES else DECODE_ROW_REL_L2)
            for name, fns in cases.items()}
    plan = dense_split_check("flash_decode", cases["flash_decode"][0](), q,
                             kc, vc, length)
    rows["flash_decode"]["plan"] = plan._asdict()
    for name in ("qkv_rope", "ffn_swiglu"):
        pass_times(name, rows[name], cases[name][0], flush)
    rope_fault_caught("qkv_rope", cases["qkv_rope"][0](),
                      qkv_rope_ref(x, scale, w_qkv, 0, **qkw))
    # the tensor-parallel partial form, held to the same tolerance
    got = ffn_swiglu(*ffn_args, residual=False)
    want = ffn_swiglu_ref(*ffn_args, residual=False)
    err = float((got.float() - want.float()).abs().max())
    tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
    if not (torch.isfinite(got.float()).all() and err <= tol):
        raise AssertionError(f"ffn_swiglu(residual=False): max |kernel - "
                             f"plain| = {err} > tolerance {tol}")
    rows["ffn_swiglu"]["partial_form_max_abs_err"] = err
    _log(f"kernel ffn_swiglu(residual=False): max_err={err:.3e} "
         f"(tol {tol:.3e})")
    del flush
    return rows


# the node's kernel rows: one rank's shapes of the 7B expert at TP 2
NODE_ROWS = {"decode_paged": "decode_paged[tp=2,heads=16]",
             "qkv_rope_paged": "qkv_rope_paged[tp=2,heads=16/16]",
             "ffn_swiglu[residual=False]": "ffn_swiglu[residual=False,F=5504]"}
# the kernels the node's fused TP body launches, each once a rank and layer
NODE_KERNELS = ("qkv_rope_paged", "decode_paged",
                "ffn_swiglu[residual=False]")


def node_kernel_phase(cfg, dev, tp=2):
    """The three kernels of the node's fused TP body at one rank's shapes of
    the expert at TP ``tp``, against their plain versions: ``decode_paged``
    and ``qkv_rope_paged`` at the rank's heads (ragged lanes 1..512, as the
    serve rows), ``ffn_swiglu(residual=False)`` at the rank's FFN shard."""
    import dataclasses
    shard = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                                n_kv_heads=cfg.n_kv_heads // tp,
                                d_ff=cfg.d_ff // tp)
    return paged_rows(shard, dev, NODE_ROWS, seed=6)[0]


def kernels_of(fn, n=3):
    """The CUDA kernels ``n`` calls of ``fn`` run, by name, from the
    profiler's device events (host and device activity traced, as
    ``step_breakdown`` traces them: a trace of device activity alone came
    back empty on one H100 run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0})


def prefill_row(row, c, B, S, window, gen, flush):
    """``flash_prefill`` at ``c``'s heads on (B, S) random bf16 q / k / v,
    causal (and ``window`` > 0: local), against its plain version row by
    row, beside SDPA; off-by-one masks planted in the plain version must
    fail the row check, and at MLA's widths (q / k of nope + rope, v of
    ``v_head_dim``) the scale of v's width in place of k's. Returns the
    kernel-table row."""
    import math

    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_cost)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import naive_attention
    dev = flush.device
    Hq, Hkv = c.n_heads, c.n_kv_heads
    dk, dv = prefill_widths(c)
    q, k, v = (torch.randn((B, S, h, d), generator=gen, device=dev)
               .to(torch.bfloat16) for h, d in ((Hq, dk), (Hkv, dk),
                                                (Hkv, dv)))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        i = torch.arange(S, device=dev)
        band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

        def lib():
            return Fn.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=Hq != Hkv)
    else:
        def lib():
            return Fn.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=Hq != Hkv)
    cost = attention_cost(B, S, S, Hq, Hkv, dk, dv, True, window)
    r = kernel_row(
        row, lambda: attention(q, k, v, causal=True, window=window),
        lambda: attention_ref(q, k, v, causal=True, window=window), lib,
        cost.bytes, cost.flops, flush, kernel="flash_prefill",
        row_tol=PREFILL_ROW_REL_L2)
    _log(f"kernel {row}: {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s, "
         f"{r['bound_ms'] / r['ms']:.3f} of the bound; SDPA "
         f"{r['library_ms']:.4f} ms ({r['library_ms'] / r['ms']:.3f}x "
         "the kernel's time)")
    if dk != dv:
        r["library_kernels"] = kernels_of(lib)
        _log(f"kernel {row}: SDPA at dk {dk}, dv {dv} runs "
             f"{r['library_kernels']}")
    # off-by-one masks, planted in the plain version: each must fail the
    # row check against the true plain output
    want = attention_ref(q, k, v, causal=True, window=window)
    mutants = {"causal edge +1": (q, dict(window=window, q_offset=1))}
    if window:
        mutants["window edge +1"] = (q, dict(window=window + 1))
        mutants["window edge -1"] = (q, dict(window=window - 1))
    if dk != dv:
        mutants["scale 1/sqrt(dv)"] = (q.float() * math.sqrt(dk / dv),
                                       dict(window=window))
    for label, (qm, kw) in mutants.items():
        m_err = row_rel_l2(naive_attention(qm, k, v, causal=True, **kw),
                           want)
        _log(f"kernel {row}: planted {label}: row relative L2 error "
             f"{m_err:.3e} "
             f"{'caught' if m_err > PREFILL_ROW_REL_L2 else 'NOT caught'}")
        if not m_err > PREFILL_ROW_REL_L2:
            raise AssertionError(f"{row}: the row check misses a planted "
                                 f"{label}")
    del q, k, v, qt, kt, vt, want
    torch.cuda.empty_cache()
    return r


def prefill_kernel_phase(cfg, rg_cfg, dev):
    """The prefill kernels against their plain versions at the main paths'
    shapes: ``flash_prefill`` at the dense phase's prefill (8 x 2048 tokens
    at the expert's widths, causal) and at the RG phase's (4 x 3000 tokens,
    RecurrentGemma's local attention), ``lru_scan`` at the RG phase's
    recurrence (4 x 3000 x d_rnn, f32, coefficients in (0, 1) as
    ``_lru_coeffs`` makes them)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_cost)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.lru_scan.ops import lru_scan, lru_scan_cost
    from repro_torch.kernels.lru_scan.ref import lru_scan_ref

    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {
        "flash_prefill": prefill_row("flash_prefill", cfg, DENSE["lanes"],
                                     DENSE["prompt_len"], 0, gen, flush),
        RG_PREFILL_ROW: prefill_row(RG_PREFILL_ROW, rg_cfg, RG["prompts"],
                                    RG["prompt_len"], rg_cfg.sliding_window,
                                    gen, flush),
    }
    # the sequential prefill's shapes: one prompt at a time, the expert's 32
    # heads; each length held row by row and timed beside the plain version
    # and SDPA (is_causal); the table keeps the longest
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for S in B1_PREFILL_LENGTHS:
        q, k, v = (torch.randn((1, S, h, dh), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        cost = attention_cost(1, S, S, Hq, Hkv, dh, dh)
        r = kernel_row(
            f"flash_prefill[B=1,S={S}]",
            lambda: attention(q, k, v, causal=True),
            lambda: attention_ref(q, k, v, causal=True),
            lambda: Fn.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=Hq != Hkv),
            cost.bytes, cost.flops, flush, kernel="flash_prefill",
            row_tol=PREFILL_ROW_REL_L2)
        if r["name"] == B1_PREFILL_ROW:
            rows[B1_PREFILL_ROW] = r
        del q, k, v, qt, kt, vt
    B, S, D = RG["prompts"], RG["prompt_len"], rg_cfg.d_rnn
    a = torch.rand((B, S, D), generator=gen, device=dev)
    b = torch.randn((B, S, D), generator=gen, device=dev)
    # f32 in both, summed in other orders (a sequential walk, a doubling
    # scan): 1e-5 of the largest |h| (CPU trials at S = 3000: 5e-7)
    cost = lru_scan_cost(B, S, D)
    rows["lru_scan"] = kernel_row(
        "lru_scan", lambda: lru_scan(a, b), lambda: lru_scan_ref(a, b), None,
        cost.bytes, cost.flops, flush, rel_tol=1e-5, peak=F32_FLOPS_PER_S)
    del a, b, flush
    return rows


def monarch_faults(m_args, c_args):
    """``{label: (function, planted plain output)}``: faults planted in the
    plain versions of the Monarch kernels, each of which the row check
    against the true plain output must catch."""
    from repro_torch.kernels.monarch_fft import ref
    x, w0, tw, w1 = m_args
    filt, w0i, twi, w1i = c_args
    blk = w0.clone()
    blk[:64] = 0                              # one 64-row N1 block

    def last_k_skipped(w):
        w = w.clone()
        w[:, -64:] = 0
        return w

    def untransposed(x, w0, tw, w1):          # a where a^T belongs
        a = ref._mm(w0, x) * tw.float()
        return ref._mm(w1, a.to(w1.dtype)).to(x.dtype)

    def conv(first, *c):
        return ref.monarch_ref(first * c[0], *c[1:])

    ones = torch.ones_like
    return {
        "twiddle dropped": ("monarch", ref.monarch_ref(x, w0, ones(tw), w1)),
        "a^T replaced by a": ("monarch", untransposed(*m_args)),
        "N1 block zeroed": ("monarch", ref.monarch_ref(x, blk, tw, w1)),
        "last K tile skipped": ("monarch", ref.monarch_ref(
            x, w0, tw, last_k_skipped(w1))),
        "conv twiddle dropped": ("monarch_conv", conv(
            ref.monarch_ref(x, w0, tw, w1), filt, w0i, ones(twi), w1i)),
        "conv filter dropped": ("monarch_conv", conv(
            ref.monarch_ref(x, w0, tw, w1), ones(filt), w0i, twi, w1i)),
        "conv a^T replaced by a": ("monarch_conv", conv(
            untransposed(*m_args), *c_args)),
        "conv N1 block zeroed": ("monarch_conv", conv(
            ref.monarch_ref(x, blk, tw, w1), *c_args)),
        "conv last K tile skipped": ("monarch_conv", conv(
            ref.monarch_ref(x, w0, tw, w1), filt, w0i, twi,
            last_k_skipped(w1i))),
    }


def monarch_kernel_phase(dev):
    """The Monarch kernels against their plain versions at the paper's
    1M-point shape (16, 1024, 1024) bf16, each also row by row, beside the
    cuBLAS chain (``torch.matmul`` for each product, the twiddle, transpose
    and filter as tensor ops); then faults planted in the plain versions,
    each of which the row check must catch; then the conv's two forms
    (``monarch_conv_forms``)."""
    from repro_torch.kernels.monarch_fft import ref
    from repro_torch.kernels.monarch_fft.ops import (monarch, monarch_conv,
                                                     monarch_conv_flops_bytes,
                                                     monarch_flops_bytes)
    from repro_torch.launch import monarch_fftconv as M

    B, N1, N2 = MONARCH["shape"]
    m_args, c_args = M.make_inputs(B, N1, N2, dev, MONARCH["seed"])
    filt, w0i, twi, w1i = c_args
    args = m_args + c_args
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def lib_monarch(x, w0, tw, w1):
        return torch.matmul(w1, (torch.matmul(w0, x) * tw).transpose(1, 2))

    def lib_conv():
        return lib_monarch(lib_monarch(*m_args) * filt, w0i, twi, w1i)

    fl, nb = monarch_flops_bytes(B, N1, N2)
    rows = {"monarch_fused": kernel_row(
        "monarch_fused", lambda: monarch(*m_args),
        lambda: ref.monarch_ref(*m_args), lambda: lib_monarch(*m_args), nb,
        fl, flush, rel_tol=M.MAX_ABS_REL, row_tol=M.ROW_REL_L2)}
    monarch_rates("monarch_fused", rows["monarch_fused"],
                  lambda: lib_monarch(*m_args), flush)
    fl, nb = monarch_conv_flops_bytes(B, N1, N2)
    rows["monarch_conv_fused"] = kernel_row(
        "monarch_conv_fused", lambda: monarch_conv(*args),
        lambda: ref.monarch_conv_ref(*args), lib_conv, nb, fl, flush,
        rel_tol=M.MAX_ABS_REL, row_tol=M.ROW_REL_L2)
    monarch_rates("monarch_conv_fused", rows["monarch_conv_fused"], lib_conv,
                  flush)
    want = {"monarch": ref.monarch_ref(*m_args),
            "monarch_conv": ref.monarch_conv_ref(*args)}
    for label, (fn, planted) in monarch_faults(m_args, c_args).items():
        m_err = row_rel_l2(planted, want[fn])
        _log(f"kernel {fn}: planted {label}: row relative L2 error "
             f"{m_err:.3e} "
             f"{'caught' if m_err > M.ROW_REL_L2 else 'NOT caught'}")
        if not m_err > M.ROW_REL_L2:
            raise AssertionError(f"{fn}: the row check misses a planted "
                                 f"{label}")
    del m_args, c_args, args, want
    monarch_conv_forms(dev, flush)
    return rows


def monarch_rates(name, row, chain, flush):
    """A Monarch row's TFLOP/s and share of its bound, beside the cuBLAS
    chain's time read-flushed too (measured, added to ``row``); logged with
    the plans at ``MONARCH``'s shape and the L2 reads ``ops.monarch_l2_bytes``
    models for them (a model of the plan, not a measurement)."""
    from repro_torch.kernels.monarch_fft import ops
    conv = name == "monarch_conv_fused"
    B, N1, N2 = MONARCH["shape"]
    launches = monarch_launches(name, B, N1, N2)
    plan = (ops.monarch_conv_plan(B, N1, N2, *ops.card_limits(
        name, torch.cuda.current_device())) if conv else launches[0][1])
    l2 = ops.monarch_l2_bytes(B, N1, N2, plan, conv=conv)
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    row["library_ms_read_flushed"] = time_ms(chain, flush, 20, read=True)
    _log(f"kernel {name}: {row['tflops']:.1f} TFLOP/s, "
         f"{row['bound_ms'] / row['ms']:.3f} of the bound; "
         + ", ".join(f"{k} BM {p.bm} {p.stages} stages slab {p.chunks}"
                     for k, p, _ in launches if p)
         + "; L2 reads a call modelled " + ", ".join(
             f"{k} {v / 1e9:.3f} GB" for k, v in l2.items())
         + f"; kernel {row['ms']:.4f} ms (read-flushed "
         f"{row['ms_read_flushed']:.4f}) against the chain's "
         f"{row['library_ms']:.4f} ms (read-flushed "
         f"{row['library_ms_read_flushed']:.4f})")


# Shapes at which both forms of the conv are timed: the showcase's two, and
# one grid past one wave of its front launch (144 CTAs)
MONARCH_FORM_SHAPES = ((16, 256, 256), (18, 256, 256), (16, 1024, 1024))


def monarch_conv_forms(dev, flush):
    """The conv in both its forms at ``MONARCH_FORM_SHAPES``: one front
    launch and the back GEMM, and two passes, each through the C entry
    (no launch counted), held to the plain version and timed; what
    ``monarch_conv_plan``'s choice between them (the front where its grid
    fits one wave) costs or saves. Returns {shape: {form: ms}}."""
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.monarch_fft import ops, ref
    from repro_torch.launch import monarch_fftconv as M
    name = "monarch_conv_fused"
    fn = rt.bind(name, "monarch_conv_bf16", ops._CONV_ARGS)
    sms, smem = ops.card_limits(name, torch.cuda.current_device())
    out = {}
    for B, N1, N2 in MONARCH_FORM_SHAPES:
        m_args, c_args = M.make_inputs(B, N1, N2, dev, MONARCH["seed"])
        args = m_args + c_args
        want = ref.monarch_conv_ref(*args)
        scratch = torch.empty((B, N2, N1), dtype=torch.bfloat16, device=dev)
        z = torch.empty_like(args[0])
        forms = {"front+back": (ops.monarch_plan(B, N1, N2, smem, conv=True),
                                None),
                 "two passes": (ops.monarch_plan(B, N1, N2, smem),
                                ops.monarch_plan(B, N2, N1, smem))}
        picked = ops.monarch_conv_plan(B, N1, N2, sms, smem)
        out[(B, N1, N2)] = {}
        for form, (first, second) in forms.items():
            def run():
                rt.check_launch(name, fn(
                    *(t.data_ptr() for t in args), scratch.data_ptr(),
                    z.data_ptr(), B, N1, N2, *first[:3],
                    *(second or (0, 0, 0))[:3], rt.stream_ptr(z)))
            run()
            torch.cuda.synchronize()
            err = float((z.float() - want.float()).abs().max())
            tol = M.MAX_ABS_REL * max(1.0, float(want.float().abs().max()))
            row = row_rel_l2(z, want)
            if not (err <= tol and row <= M.ROW_REL_L2):
                raise AssertionError(f"{name} {form} at {(B, N1, N2)}: max "
                                     f"|err| {err} (tol {tol}), row "
                                     f"relative L2 {row}")
            out[(B, N1, N2)][form] = time_ms(run, flush, 20)
        _log(f"kernel {name} at {(B, N1, N2)}: front+back "
             f"{out[(B, N1, N2)]['front+back']:.4f} ms "
             f"({forms['front+back'][0].ctas} front CTAs on {sms} SMs), two "
             f"passes {out[(B, N1, N2)]['two passes']:.4f} ms; the plan "
             f"takes {'two passes' if picked[1] else 'front+back'}")
    return out


def monarch_phase(dev):
    """The Monarch showcase through its entry point, ``python -m
    repro_torch.launch.monarch_fftconv`` (``main``: the Table I ledger,
    then both kernels against their plain versions and the FFT-conv timed
    three ways at (16, 1024, 1024) and (16, 256, 256), on the card). Every
    ``ops.monarch`` call must launch ``monarch_fused`` once and every
    ``ops.monarch_conv`` call ``monarch_conv_fused`` once (its two CUDA
    kernels), and nothing else may launch; then where one conv call's time
    goes at both shapes. Returns the launch counts."""
    import repro_torch.kernels.monarch_fft.ops as mops
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch import monarch_fftconv as M

    calls = {"monarch": 0, "monarch_conv": 0}
    real = {name: getattr(mops, name) for name in calls}

    def counted(name):
        def call(*args):
            calls[name] += 1
            return real[name](*args)
        return call

    for name in calls:
        setattr(mops, name, counted(name))
    try:
        torch.cuda.synchronize()
        rt.reset_launches()
        t0 = time.perf_counter()
        results = M.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rt.launch_counts()
    finally:
        for name in calls:
            setattr(mops, name, real[name])
    check_launches("monarch showcase", launches,
                   {"monarch_fused": calls["monarch"],
                    "monarch_conv_fused": calls["monarch_conv"]})
    if len(results) != len(M.TABLE1_SHAPES):
        raise AssertionError(f"monarch showcase: {len(results)} results")
    _log(f"monarch: showcase at {[r['shape'] for r in results]} in "
         f"{wall:.1f}s; {calls['monarch']} monarch and "
         f"{calls['monarch_conv']} monarch_conv calls, launches "
         f"monarch_fused={launches['monarch_fused']} "
         f"monarch_conv_fused={launches['monarch_conv_fused']}")
    # where one conv call's time goes: its two launches, and the host
    for shape in M.TABLE1_SHAPES:
        m_args, c_args = M.make_inputs(*shape, dev, MONARCH["seed"])
        step_breakdown(lambda: mops.monarch_conv(*m_args, *c_args),
                       f"monarch_conv {shape}")
    return launches


@contextlib.contextmanager
def fault_planted(name, fault):
    """Within the block, the kernel wrapper ``name`` runs ``fault(real,
    *args)`` for layer ``FAULT_LAYER``'s call and is itself for the others
    (``fused_paged_extend`` and ``decoder_layer_step`` look the wrappers up
    on every call). Nothing in the port is edited."""
    import repro_torch.kernels.flash_attention.ops as attn_ops
    import repro_torch.kernels.fused_decode.ops as fused_ops
    module = attn_ops if name == "decode_paged" else fused_ops
    real, calls = getattr(module, name), [0]

    def wrapped(*args, **kw):
        layer, calls[0] = calls[0], calls[0] + 1
        return fault(real, *args, **kw) if layer == FAULT_LAYER \
            else real(*args, **kw)
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def plain_prefill():
    """Within the block, prefill attention is the quadratic oracle and the
    RG-LRU recurrence the doubling scan, whatever the device: the f32
    references run the model's own code with the plain versions where the
    kernels would run (they take bf16 / f32 only). Nothing in the port is
    edited."""
    import repro_torch.kernels.lru_scan.ops as lru_ops
    from repro_torch.kernels.lru_scan.ref import lru_scan_ref
    from repro_torch.models import layers as L
    real = L.attention, lru_ops.lru_scan
    L.attention = L.naive_attention
    lru_ops.lru_scan = lru_scan_ref
    try:
        yield
    finally:
        L.attention, lru_ops.lru_scan = real


def check_launches(label, launches, want):
    """Every kernel launched exactly ``want.get(name, 0)`` times."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")


def logits_check(label, got, ref, tol_rel):
    """Max |got - ref| within ``tol_rel`` of the largest reference logit;
    prints the reading either way."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: logits not finite")
    err = float((got - ref).abs().max())
    rel = float((got - ref).norm() / ref.norm())
    top = float(ref.abs().max())
    tol = tol_rel * top
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    _log(f"{label}: max_abs_err={err:.4f} (tol {tol:.4f}, "
         f"{err / top:.4f} of |logits|max={top:.3f}) rel_l2={rel:.5f} "
         f"argmax_agree={agree:.3f}")
    if not err <= tol:
        raise AssertionError(f"{label}: logits differ by {err} > {tol}")


def planted_faults(cfg):
    """``{label: (kernel wrapper, fault)}`` for ``fault_planted``."""

    def rope_dropped(real, x, scale, wq, wk, wv, pos, **kw):
        return real(x, scale, wq, wk, wv, torch.zeros_like(pos), **kw)

    def head_zeroed(real, q, kp, vp, tables, len1):
        out = real(q, kp, vp, tables, len1)
        out[:, cfg.n_heads // 2] = 0
        return out

    def newest_token_skipped(real, q, kp, vp, tables, len1):
        return real(q, kp, vp, tables, torch.clamp(len1 - 1, min=1))

    def ffn_skipped(real, x, attn, wo, scale, wg, wu, wd):
        return real(x, attn, wo, scale, wg, wu, torch.zeros_like(wd))

    return {
        "rope_dropped": ("qkv_rope_paged", rope_dropped),
        "head_zeroed": ("decode_paged", head_zeroed),
        "newest_token_skipped": ("decode_paged", newest_token_skipped),
        "ffn_skipped": ("oproj_ffn_swiglu", ffn_skipped),
    }


def ttft_line(done, registry):
    """TTFT p50 / p95 / p99 read exactly from the done requests, beside the
    ``serve.ttft_s`` histogram's P² estimates."""
    ttft = np.asarray([r.first_token_s - r.arrival_s for r in done])
    h = registry.histogram("serve.ttft_s")
    return (f"TTFT p50={np.percentile(ttft, 50):.4f}s "
            f"p95={np.percentile(ttft, 95):.4f}s "
            f"p99={np.percentile(ttft, 99):.4f}s (serve.ttft_s P2: "
            f"p50={h.quantile(0.5):.4f}s p99={h.quantile(0.99):.4f}s, "
            f"count {h.count})")


def served_ok(label, done, n, new_tokens, cfg, engine):
    """Every one of the ``n`` requests done with ``new_tokens`` tokens in
    the vocabulary, and the engine's KV pool consistent and empty."""
    if len(done) != n:
        raise AssertionError(f"{label}: {len(done)} of {n} requests done")
    for r in done:
        if r.output is None or len(r.output) != new_tokens:
            raise AssertionError(f"{label}: request {r.rid}: output "
                                 f"{r.output}")
        if not ((r.output >= 0) & (r.output < cfg.vocab_size)).all():
            raise AssertionError(f"{label}: request {r.rid}: token out of "
                                 "vocabulary")
    problems = engine.pool.check_invariants()
    if problems or engine.pool.stats.blocks_in_use:
        raise AssertionError(f"{label}: KV pool: {problems}, "
                             f"{engine.pool.stats.blocks_in_use} leaked")


def fused_step_check(label, cfg, dev, engine, params, tol_rel):
    """One decode step of ``engine``'s fused runner against the plain
    reference body run in f32 on the same pool state (the same bf16
    weights and pool, upcast): its slots prefilled with random prompts of
    1-119 tokens, one lane inactive. Max |fused - f32| within ``tol_rel`` of
    the largest logit; where the two argmaxes differ, the f32 logits of
    both tokens within it of each other (a near tie). Then each fault of
    ``planted_faults``, planted in one layer, must exceed the limit. Returns (the step on clones of
    the pool, for timing; the prefilled request ids)."""
    from repro_torch.bridge import tree_map
    from repro_torch.serving import xla_paged_extend
    n_slots = engine.n_slots
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rs.randint(1, 120, size=n_slots)]
    rids = list(range(10_000, 10_000 + n_slots))
    for i in range(0, len(prompts), 4):
        chunk = rids[i:i + 4]
        res = engine.prefill_runner(params, prompts[i:i + 4])
        engine.prefill_runner.scatter_into(engine.pool, res, chunk,
                                           extra_tokens=[1] * len(chunk))
    tables = torch.as_tensor(np.stack([engine.pool.padded_table(
        r, engine.max_blocks) for r in rids]), device=dev)
    lengths = torch.as_tensor([engine.pool.length(r) for r in rids],
                              dtype=torch.int32, device=dev)
    active = torch.ones(n_slots, dtype=torch.bool, device=dev)
    active[3] = False
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, (n_slots, 1)),
                           device=dev)
    scratch = engine.pool.scratch_index
    state = (engine.pool.k, engine.pool.v)

    def fused_step():
        return engine.runner.extend(params, *(t.clone() for t in state),
                                    tables, lengths, active, toks)[0]

    lf = fused_step()
    lr, _, _ = xla_paged_extend(cfg, params, *(t.clone() for t in state),
                                tables, lengths, active, toks, scratch)
    # the same plain body in f32, the check's reference
    l32, _, _ = xla_paged_extend(cfg, tree_map(lambda t: t.float(), params),
                                 *(t.float() for t in state), tables, lengths,
                                 active, toks, scratch)
    lf, lr, l32 = (t[active].float()[:, 0] for t in (lf, lr, l32))
    if not torch.isfinite(lf).all():
        raise AssertionError(f"{label}: fused logits not finite")
    top = float(l32.abs().max())
    tol = tol_rel * top

    def gap(logits, ref):
        return (float((logits - ref).abs().max()),
                float((logits - ref).norm() / ref.norm()))

    err, rel = gap(lf, l32)
    a, b = lf.argmax(-1), l32.argmax(-1)
    ties = (l32.gather(1, b[:, None]) - l32.gather(1, a[:, None])).abs()
    _log(f"{label} reference check: fused vs f32 plain body max_abs_err="
         f"{err:.4f} (tol {tol:.4f}, {err / top:.4f} of |logits|max="
         f"{top:.3f}) rel_l2={rel:.5f} argmax_agree="
         f"{float((a == b).float().mean()):.3f} (largest f32 gap where they "
         f"differ {float(ties.max()) / top:.4f}); bf16 plain body vs f32: "
         "max_abs_err=%.4f rel_l2=%.5f" % gap(lr, l32))
    if not (err <= tol and float(ties.max()) <= tol):
        raise AssertionError(f"{label}: fused vs f32 reference logits differ "
                             f"by {err} > {tol}, or an argmax that is no "
                             "near tie")
    for fault, (name, fn) in planted_faults(cfg).items():
        with fault_planted(name, fn):
            lx = fused_step()[active].float()[:, 0]
        f_err, f_rel = gap(lx, l32)
        _log(f"{label}: planted fault {fault} (layer {FAULT_LAYER}): "
             f"max_abs_err={f_err:.4f} rel_l2={f_rel:.5f} -> "
             f"{'caught' if f_err > tol else 'NOT caught'} at tol {tol:.4f}")
        if not f_err > tol:
            raise AssertionError(f"{label}: the step check misses a fault "
                                 f"planted in one layer ({fault})")
    del l32
    kc, vc = (t.clone() for t in state)
    return (lambda: engine.runner.extend(params, kc, vc, tables, lengths,
                                         active, toks)), rids


def serve_phase(cfg, dev):
    """The port's main path: the engine serving full-width experts."""
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.serve import build_coe, make_requests
    from repro_torch.serving import ServingEngine

    s = SERVE
    t0 = time.perf_counter()
    coe, nbytes = build_coe(cfg, s["n_experts"], s["hbm_experts"], s["seed"],
                            dev)
    torch.cuda.empty_cache()
    _log(f"built {s['n_experts']} experts of {nbytes / 1e9:.2f} GB each in "
         f"pinned host memory in {time.perf_counter() - t0:.1f}s")
    engine = ServingEngine(coe, cfg, max_len=s["max_len"],
                           n_slots=s["n_slots"], block_size=s["block_size"],
                           device=dev)
    reqs, n_tagged = make_requests(s["requests"], cfg.vocab_size,
                                   s["prompt_lens"], s["new_tokens"],
                                   coe.expert_names(), s["tagged_fraction"],
                                   s["seed"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rt.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    st = engine.stats
    served_ok("serve", done, s["requests"], s["new_tokens"], cfg, engine)
    check_launches(f"serve ({cfg.n_layers} layers x {st.decode_rounds} "
                   "decode rounds)", launches,
                   {k: cfg.n_layers * st.decode_rounds
                    for k in PAGED_KERNELS})
    cs = coe.cache.stats
    if cs.evictions < 1 or st.switches < 1:
        raise AssertionError(f"no evicting switch: {cs.as_dict()}")
    _log(f"serve: {len(done)} requests, {st.tokens_out} tokens in {wall:.3f}s "
         f"= {st.tokens_out / wall:.2f} tok/s; {n_tagged} tagged, "
         f"{len(done) - n_tagged} routed")
    _log(f"serve: {ttft_line(done, st.registry)}; {st.decode_rounds} decode "
         f"rounds ({st.exec_s / st.decode_rounds * 1e3:.3f} ms a round, "
         f"host wall with its argmax read), occupancy "
         f"{st.mean_occupancy:.3f}; switches={st.switches} "
         f"evictions={cs.evictions} prefetch_hits={cs.prefetch_hits} "
         f"switch_stall_s={cs.switch_seconds:.4f} "
         f"(engine switch_s={st.switch_s:.4f}, prefill_s={st.prefill_s:.4f}, "
         f"decode_s={st.exec_s:.4f})")
    _log(f"serve: peak device memory {peak / 2 ** 30:.2f} GiB; launches "
         f"{launches}")
    from repro_torch.core.fusion import backend_prediction
    pred = backend_prediction(cfg, s["n_slots"], s["max_len"], "fused")
    _log(f"serve: core.fusion predicts {pred['predicted_kernels']} kernels "
         f"for one fused decode step ({cfg.n_layers} layers x 4 fused groups "
         f"+ the embedding and the head, {s['n_slots']} lanes at context "
         f"{s['max_len']}); the engine launched "
         f"{sum(launches[k] for k in PAGED_KERNELS) // st.decode_rounds} "
         f"a round ({len(PAGED_KERNELS)} kernels a layer: oproj_ffn_swiglu "
         "runs both oproj_residual and ffn_fused)")

    params = coe.cache.activate(coe.expert_names()[0])
    step, rids = fused_step_check("serve", cfg, dev, engine, params,
                                  LOGIT_TOL_REL)
    # where one decode step's time goes: host wall per step without the
    # profiler, device time per kernel name with it
    label = f"decode step ({s['n_slots']} lanes, {cfg.n_layers} layers)"
    step_breakdown(step, label)
    step_under(step, label, ("decode_split_kernel", "OprojPass"))
    del step
    for r in rids:
        engine.pool.free(r)
    coe.cache.close()
    return (launches, coe.store, coe.expert_names(),
            st.exec_s / st.decode_rounds, {r.rid: r for r in done})


def prefill_times(prefill, lengths, reps=3):
    """For each prompt length S: the host wall of one warm ``prefill(S)``
    (synchronized) and, from the profiler's kernel events, the device ms a
    ``flash_prefill`` launch inside it takes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for S in lengths:
        prefill(S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            prefill(S)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                prefill(S)
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and "prefill_kernel" in e.name]
        out[S] = (wall_ms, float(np.mean(us)) / 1e3 if us else None, len(us))
    return out


def serve_modes_phase(cfg, dev, store, names, continuous_round_s):
    """The engine's other modes at full width, on the serve phase's pinned
    store: a fresh composition with an HBM cache of two experts behind
    ``ServingEngine(scheduler="run_to_completion",
    prefill_mode="sequential")`` with its own registry, ``warmup()``,
    tracing on, a watchdog sampling and the metrics server on a free
    localhost port; the serve phase's 16 requests. Each admission prefills
    its prompt alone through ``prefill_kv`` (``flash_prefill`` once per
    layer). Returns the launch counts of the drain."""
    import urllib.request

    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.serve import make_requests
    from repro_torch.obs import (FlightRecorder, MetricsRegistry, Watchdog,
                                 serve_metrics, trace)
    from repro_torch.obs.lifecycle import PHASES, phase_record
    from repro_torch.obs.trace import Tracer, validate_chrome_trace
    from repro_torch.serving import (PackedPrefillRunner, ServingEngine,
                                     default_buckets)

    s = SERVE
    nL = cfg.n_layers
    reg = MetricsRegistry()
    coe = CompositionOfExperts(HashRouter(len(names)), None,
                               int(s["hbm_experts"] * store.nbytes(names[0])),
                               store=store, device=dev, registry=reg)
    for n in names:
        coe.register(ExpertHandle(n, cfg))        # already in the store
    engine = ServingEngine(coe, cfg, max_len=s["max_len"],
                           n_slots=s["n_slots"], block_size=s["block_size"],
                           scheduler="run_to_completion",
                           prefill_mode="sequential", device=dev,
                           registry=reg)
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    if not engine.warmed or engine.pool.stats.blocks_in_use:
        raise AssertionError("serve modes: warmup left the pool in use")
    server = serve_metrics(reg, port=0, ready_check=lambda: engine.warmed,
                           debug=engine.debug_providers())
    wd = Watchdog([engine], registry=reg, interval_s=0.05,
                  recorder=FlightRecorder())
    old_tracer = trace.set_tracer(Tracer(buffer_size=1 << 18))
    reqs, _ = make_requests(s["requests"], cfg.vocab_size, s["prompt_lens"],
                            s["new_tokens"], names, s["tagged_fraction"],
                            s["seed"])
    try:
        trace.enable()
        wd.start()
        torch.cuda.synchronize()
        rt.reset_launches()
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        done = engine.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rt.launch_counts()
        trace.disable()
        wd.stop()
        wd.check_now()                   # one pass on the drained engine
        doc = trace.get_tracer().to_chrome_trace()
        with urllib.request.urlopen(f"{server.url}/metrics",
                                    timeout=10) as resp:
            scrape = resp.read().decode()
    finally:
        trace.disable()
        trace.set_tracer(old_tracer)
        wd.stop()
        server.stop()

    st = engine.stats
    if len(done) != s["requests"]:
        raise AssertionError(f"serve modes: {len(done)} of {s['requests']} "
                             "requests done")
    for r in done:
        if r.output is None or len(r.output) != s["new_tokens"]:
            raise AssertionError(f"serve modes: request {r.rid}: output "
                                 f"{r.output}")
        if not ((r.output >= 0) & (r.output < cfg.vocab_size)).all():
            raise AssertionError(f"serve modes: request {r.rid}: token out "
                                 "of vocabulary")
    problems = engine.pool.check_invariants()
    if problems or engine.pool.stats.blocks_in_use:
        raise AssertionError(f"serve modes: KV pool {problems}, "
                             f"{engine.pool.stats.blocks_in_use} leaked")
    if not engine.hbm_in_budget():
        raise AssertionError("serve modes: HBM tier over budget")
    want = {"flash_prefill": nL * s["requests"]}
    want.update({k: nL * st.decode_rounds for k in PAGED_KERNELS})
    check_launches("serve modes", launches, want)
    worst = max(abs(sum(phase_record(r)["phases"][p] for p in PHASES)
                    - (r.done_s - r.arrival_s)) for r in done)
    if not worst <= 1e-6:
        raise AssertionError(f"serve modes: lifecycle phases miss the wall "
                             f"time by {worst} s")
    snap = reg.snapshot()
    anomalies = {k: v for k, v in snap.items() if k.startswith("obs.anomaly")}
    if anomalies or wd.checks_run < 2:
        raise AssertionError(f"serve modes: watchdog anomalies {anomalies} "
                             f"in {wd.checks_run} checks")
    for series in ("serve_ttft_s", "kv_blocks_in_use", "switch_hits"):
        if series not in scrape:
            raise AssertionError(f"serve modes: /metrics lacks {series}")
    problems = validate_chrome_trace(doc)
    evs = doc["traceEvents"]
    lanes = [e["id"] for e in evs
             if e["ph"] == "b" and e["name"] == "request"]
    if problems or sorted(lanes) != sorted(r.rid for r in done):
        raise AssertionError(f"serve modes: trace {problems[:3]}, request "
                             f"lanes {sorted(lanes)}")
    prefill_s = sum(e["dur"] for e in evs
                    if e["ph"] == "X" and e["name"] == "prefill") / 1e6
    n_out = sum(len(r.output) for r in done)
    phases = "; ".join(f"{p} {snap[f'serve.phase_seconds:p50{{phase={p}}}']:.4f}"
                       for p in PHASES)
    _log(f"serve modes (run_to_completion, sequential prefill): "
         f"{len(done)} requests, {n_out} tokens in {wall:.3f}s = "
         f"{n_out / wall:.2f} tok/s; {ttft_line(done, reg)}; "
         f"{st.decode_rounds} decode rounds, switches={st.switches}; "
         f"warmup() {warm_s:.3f}s")
    _log(f"serve modes: serve.phase_seconds p50: {phases} s; prefill spans "
         f"{prefill_s:.3f}s = {prefill_s / wall:.3f} of the drain's wall; "
         f"a decode round {st.exec_s / st.decode_rounds * 1e3:.3f} ms (host "
         f"wall with its argmax read; continuous serve phase "
         f"{continuous_round_s * 1e3:.3f} ms); watchdog {wd.checks_run} "
         f"checks, no anomaly; /metrics scraped ({len(scrape)} bytes); "
         f"trace valid, {len(lanes)} request lanes, {len(evs)} events")
    _log(f"serve modes: launches {launches}")

    # flash_prefill against its plain version at the serving shapes (B 1,
    # 32 heads of 128, causal), row by row
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rs = np.random.RandomState(s["seed"])
    for S in (1, 64, 160, 256):
        q, k, v = (torch.as_tensor(rs.standard_normal((1, S, cfg.n_heads,
                                                       cfg.head_dim)),
                                   dtype=torch.float32,
                                   device=dev).to(torch.bfloat16)
                   for _ in range(3))
        got = attention(q, k, v, causal=True)
        row = row_rel_l2(got, attention_ref(q, k, v, causal=True))
        if not (torch.isfinite(got.float()).all()
                and row <= PREFILL_ROW_REL_L2):
            raise AssertionError(f"serve modes: flash_prefill at (1, {S}) "
                                 f"row relative L2 error {row}")
        _log(f"serve modes: flash_prefill at (1, {S}, {cfg.n_heads}, "
             f"{cfg.head_dim}): largest row relative L2 error {row:.3e} "
             f"(tol {PREFILL_ROW_REL_L2:.3e})")

    # one prompt's first-token logits: sequential prefill (flash_prefill),
    # the same forward with plain attention, and the packed prefill (plain
    # attention), each against the plain forward in f32 (one layer's
    # weights upcast at a time), to the dense prefill's limit. On the H100
    # the three bf16 paths read 3.2-3.5 % of the largest logit from the f32
    # forward and 3.3 % from each other (a 236-token prompt): the kernel's
    # path is no farther from f32 than the plain ones; the kernel itself is
    # held row by row above. LOGIT_TOL_REL (1.8 %) is a decode step's limit,
    # on a pool both sides share; a whole bf16 prefill does not meet it.
    params = coe.cache.activate(names[0])
    prompt = reqs[0].tokens
    toks = torch.as_tensor(prompt[None], device=dev).long()
    rt.reset_launches()
    l_seq = engine.runner.prefill_kv(params, toks)[0]
    torch.cuda.synchronize()
    check_launches("serve modes prefill_kv", rt.launch_counts(),
                   {"flash_prefill": nL})
    with plain_prefill():
        l_plain = engine.runner.prefill_kv(params, toks)[0]
    packed = PackedPrefillRunner(cfg, buckets=default_buckets(s["max_len"]),
                                 max_segments=s["n_slots"])
    l_pack = packed(params, [prompt]).logits[0]
    l32 = plain_logits_f32(cfg, params, prompt, dev)
    label = f"serve modes prefill of one {len(prompt)}-token prompt"
    top = float(l32.float().abs().max())
    for name, a, b in (("sequential (flash_prefill) vs sequential, plain "
                        "attention", l_seq, l_plain),
                       ("sequential (flash_prefill) vs packed (plain)",
                        l_seq, l_pack)):
        err = float((a.float() - b.float()).abs().max())
        _log(f"{label}: {name}: max_abs_err={err:.4f} ({err / top:.4f} of "
             f"|logits|max={top:.3f}), both bf16, a reading")
    logits_check(f"{label}: sequential (flash_prefill) vs f32 plain forward",
                 l_seq, l32, DENSE_PREFILL_LOGIT_TOL_REL)
    logits_check(f"{label}: sequential, plain attention vs f32 plain "
                 "forward", l_plain, l32, DENSE_PREFILL_LOGIT_TOL_REL)
    logits_check(f"{label}: packed (plain) vs f32 plain forward",
                 l_pack, l32, DENSE_PREFILL_LOGIT_TOL_REL)
    del l32

    # a warm sequential prefill's wall and flash_prefill's device time a
    # launch at the serving prompt lengths
    per = prefill_times(lambda S: engine.runner.prefill_kv(
        params, torch.as_tensor(rs.randint(0, cfg.vocab_size, (1, S)),
                                device=dev)), (64, 160, 256))
    _log("serve modes: a warm prefill_kv (host wall, synchronized) and "
         "flash_prefill's device ms a launch (B 1, 32 heads, dh 128, "
         "causal): " + "; ".join(
             f"S {S} prefill {wall:.2f} ms, flash_prefill "
             + (f"{ms:.4f} ms ({n} launches)" if ms is not None
                else "not measured (the profiler saw no kernel)")
             for S, (wall, ms, n) in per.items()))
    coe.cache.close()
    return launches


def plain_logits_f32(cfg, params, tokens, dev):
    """Last-position logits (V,) of the plain forward over ``tokens`` run in
    f32 (the bf16 weights upcast one layer at a time, quadratic
    attention)."""
    return plain_last_logits_f32(cfg, params, np.asarray(tokens)[None],
                                 dev)[0]


def plain_last_logits_f32(cfg, params, tokens, dev):
    """Last-position logits (B, V) of the plain forward over ``tokens`` (B,
    S) in one batch, run in f32 (the bf16 weights upcast one layer at a
    time, quadratic attention; an MoE layer's capacity counts the B * S
    tokens; DeepSeek's dense head layers first, MLA expanded as the
    prefill runs it)."""
    from repro_torch.bridge import tree_map
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    f32 = lambda tree: tree_map(lambda t: t.float(), tree)
    toks = torch.as_tensor(np.asarray(tokens), device=dev).long()
    with torch.no_grad(), plain_prefill():
        h = T.embed_tokens(cfg, params, toks).float()
        positions = torch.arange(toks.shape[1], device=dev)[None].expand(
            toks.shape)
        for _, _, lp, moe in T.layers_in_order(cfg, params):
            h, _ = T._layer(cfg, f32(lp), h, positions, moe)
        h = L.apply_norm(cfg, f32(params["final_norm"]), h[:, -1:])
        head = {k: params[k] for k in ("embed", "lm_head") if k in params}
        return T.unembed(cfg, f32(head), h)[:, 0]


@contextlib.contextmanager
def routes_recorded():
    """Within the block, every MoE routing (``layers.moe_route``, one call a
    layer) appends its (router logits (T, E) f32, chosen experts (T, K),
    the logits' max-abs gap to ``xt.float() @ router`` in f32 over the
    same hidden states, of that product's largest, a 0-d tensor) to the
    list the block receives, for ``router_check``. Nothing in the port is
    edited."""
    from repro_torch.models import layers as L
    real, calls = L.moe_route, []

    def recording(cfg, router, xt):
        out = real(cfg, router, xt)
        lg, f32 = out[0].float(), xt.float() @ router.float()
        calls.append((lg, out[2],
                      (lg - f32).abs().max() / f32.abs().max()))
        return out
    L.moe_route = recording
    try:
        yield calls
    finally:
        L.moe_route = real


@contextlib.contextmanager
def routes_forced(routes):
    """Within the block, the i-th MoE routing takes the experts of
    ``routes[i]`` (a bf16 path's, from ``routes_recorded``), weighted by
    its own f32 gates over them (renormalised, scaled, as
    ``layers.moe_route`` does), so an f32 reference makes the bf16 path's
    choices and hence its capacity drops: a routing flip at a near tie
    moves which assignments an expert drops past its capacity, most often
    the last tokens', whose logits the checks read. Its own unforced
    choices are appended to the list the block receives, one a layer,
    for ``route_ties``. Nothing in the port is edited."""
    from repro_torch.models import layers as L
    real, own, it = L.moe_route, [], iter(routes)

    def forced(cfg, router, xt):
        logits, _, top = real(cfg, router, xt)
        own.append((logits.float(), top))
        top16 = next(it)[1]
        w = torch.softmax(logits, dim=-1).gather(1, top16)
        if cfg.family == "moe":
            w = w / w.sum(-1, keepdim=True)
        return logits, w * cfg.routed_scale, top16
    L.moe_route = forced
    try:
        yield own
    finally:
        L.moe_route = real


def dropped(cfg, top):
    """(T, K) bool: which of the (token, choice) assignments ``top`` (T, K)
    an MoE layer drops past its experts' capacity (``layers.moe_apply``'s
    rule)."""
    from repro_torch.models import layers as L
    order, _, rank = L.moe_dispatch(cfg, top)
    out = torch.empty_like(rank, dtype=torch.bool)
    out[order] = rank >= L.moe_capacity(cfg, top.shape[0])
    return out.reshape(top.shape)


@contextlib.contextmanager
def router_in_bf16():
    """Within the block, ``layers.moe_route`` computes its router logits in
    bf16 (the hidden states and the router cast), the rest as it does: a
    planted fault for ``router_check``. Nothing in the port is edited."""
    from repro_torch.models import layers as L
    real = L.moe_route

    def bf16(cfg, router, xt):
        logits = (xt.to(torch.bfloat16) @ router.to(torch.bfloat16)).float()
        topw, topi = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k,
                                dim=-1)
        if cfg.family == "moe":
            topw = topw / topw.sum(-1, keepdim=True)
        return logits, topw * cfg.routed_scale, topi
    L.moe_route = bf16
    try:
        yield
    finally:
        L.moe_route = real


def router_check(label, got, tol_rel):
    """``got``: one routing a layer from ``routes_recorded``. Each layer's
    router logits within ``tol_rel`` (of the largest) of the f32 product
    on its own hidden states; prints the widest reading and returns it."""
    gaps = [float(g[2]) for g in got]
    worst = max(gaps)
    ok = worst <= tol_rel
    _log(f"{label}: router logits vs the f32 product on the same hidden "
         f"states: widest {worst:.3e} of the largest (layer "
         f"{gaps.index(worst)}; tol {tol_rel:.0e}) -> "
         f"{'f32' if ok else 'OUTSIDE the tolerance'}")
    if not ok:
        raise AssertionError(f"{label}: router logits part from f32 by "
                             f"{worst:.3e} > {tol_rel:.0e}")
    return worst


def raised(fn):
    """Whether ``fn()`` raises an AssertionError (a check that catches a
    planted fault)."""
    try:
        fn()
    except AssertionError:
        return True
    return False


def route_ties(label, got, ref, tol_rel, cfg=None):
    """``got`` / ``ref``: one (router logits, experts, ...) a layer from
    ``routes_recorded``, of a bf16 path and its f32 reference. Where the two
    route a token to different experts, the reference's f32 gates of its last
    chosen expert and of the expert the bf16 path took instead must lie
    within ``tol_rel`` of the token's largest gate (a near tie that bf16
    rounding may break either way). Prints how many tokens of each layer
    part and the widest gap and, given the ``cfg``, how many assignments
    the bf16 path dropped past each expert's capacity; returns the gap."""
    from repro_torch.models import layers as L
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} routings against "
                             f"{len(ref)}")
    parts, worst, where = [], 0.0, None
    for layer, (g, r) in enumerate(zip(got, ref)):
        top16, (lg32, top32) = g[1], r[:2]
        differ = (top16.sort(-1).values != top32.sort(-1).values).any(-1)
        parts.append(int(differ.sum()))
        if not parts[-1]:
            continue
        g32 = torch.softmax(lg32[differ], dim=-1)
        t16, t32 = top16[differ], top32[differ]
        last = g32.gather(1, t32).min(-1).values
        taken = (t16[:, :, None] != t32[:, None, :]).all(-1)   # not in ref
        alt = torch.where(taken, g32.gather(1, t16),
                          torch.zeros_like(last)[:, None]).max(-1).values
        gap = (last - alt) / g32.max(-1).values
        i = int(gap.argmax())
        if float(gap[i]) >= worst:
            worst = float(gap[i])
            where = (layer, float(last[i]), float(alt[i]))
    total = len(got[0][1]) if got else 0
    msg = (f"{label}: routing parts from the f32 reference in "
           f"{sum(parts)} of {total} x {len(got)} (token, layer)s "
           f"(by layer {parts})")
    if cfg is not None and got:
        drops = [int(dropped(cfg, g[1]).sum()) for g in got]
        msg += (f"; the bf16 path dropped {drops} assignments (C "
                f"{L.moe_capacity(cfg, total)})")
    if where is not None:
        ok = worst <= tol_rel
        msg += (f"; widest: layer {where[0]}, f32 gates {where[1]:.4f} / "
                f"{where[2]:.4f}, gap {worst:.4f} of the token's largest "
                f"gate (tol {tol_rel}) -> "
                f"{'a near tie' if ok else 'OUTSIDE the tolerance'}")
        _log(msg)
        if not ok:
            raise AssertionError(f"{label}: a token routes apart by "
                                 f"{worst:.4f} > {tol_rel}")
    else:
        _log(msg)
    return worst


def divergence_check(label, cfg, dev, pairs, tol_rel):
    """``pairs``: (rid, params, prompt, got, want) of two bf16 streams of the
    same request. Where they part, the two chosen tokens' logits, recomputed
    with the plain forward in f32 over the prompt and the common prefix,
    must lie within ``tol_rel`` of the largest logit of each other (a near
    tie that bf16 rounding may break either way). Prints every divergence;
    returns how many requests diverged."""
    n = 0
    for rid, params, prompt, got, want in pairs:
        diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
        if not len(diff):
            continue
        n += 1
        j = int(diff[0])
        a, b = int(got[j]), int(want[j])
        lg = plain_logits_f32(
            cfg, params, np.concatenate([prompt, got[:j]]), dev)
        gap, top = abs(float(lg[a] - lg[b])), float(lg.abs().max())
        ok = gap <= tol_rel * top
        _log(f"{label}: request {rid} parts at token {j} ({a} against {b}): "
             f"f32 logits {float(lg[a]):.4f} / {float(lg[b]):.4f}, gap "
             f"{gap / top:.4f} of |logits|max={top:.3f} (tol {tol_rel}) -> "
             f"{'a near tie' if ok else 'OUTSIDE the tolerance'}")
        if not ok:
            raise AssertionError(f"{label}: request {rid} diverges at token "
                                 f"{j} by {gap / top:.4f} > {tol_rel}")
    return n


def tenancy_trace(vocab):
    """The sessions of the tenancy phase (JAX ``bench_sweep_tenancy``'s
    shape): 70 % open with one of two system prompts, the rest with a
    private prompt of the same length; 1-3 turns, cycling; each turn adds
    fresh user tokens. Returns (system prompts, sessions)."""
    t = TENANCY
    rs = np.random.RandomState(t["seed"])
    sys_prompts = [rs.randint(1, vocab, (t["sys_len"],)).astype(np.int32)
                   for _ in range(2)]
    n_shared = int(round(t["shared_share"] * t["sessions"]))
    lo, hi = t["user"]
    sessions = []
    for s in range(t["sessions"]):
        turns = 1 + s % 3
        sessions.append({
            "sid": f"s{s}", "expert": s % 2, "turns": turns,
            "sys": (sys_prompts[s % 2] if s < n_shared else
                    rs.randint(1, vocab, (t["sys_len"],)).astype(np.int32)),
            "user": [rs.randint(1, vocab, (int(rs.randint(lo, hi + 1)),))
                     .astype(np.int32) for _ in range(turns)]})
    return sys_prompts, sessions


def tenancy_replay(eng, names, sys_prompts, sessions, sharing, nL):
    """A primer (one request per system prompt per expert, so the timed
    waves meet a warm index), then the sessions wave by wave, each turn
    re-sending the conversation so far. Checks the launch counts (each
    paged kernel once per layer per decode round, none inside a suffix
    prefill) and, under sharing, that the primed blocks keep their bytes
    while decoding lanes share them. Returns the run's record."""
    from repro_torch.kernels import runtime as rt
    from repro_torch.serving import Request

    t = TENANCY
    for j, sp in enumerate(sys_prompts):
        for e in range(2):
            eng.submit(Request(rid=900_000 + 2 * j + e, tokens=np.concatenate(
                [sp, np.asarray([j + 1], np.int32)]), max_new_tokens=2,
                expert=names[e]))
    eng.drain()
    hit0, cow0 = eng.stats.prefix_hit_tokens, eng.pool.stats.cow_splits
    rounds0, prefill0 = eng.stats.decode_rounds, eng.stats.prefill_s
    primed, seen = [], [0]
    if sharing:
        primed = sorted(e.block for e in eng.prefix_index._entries.values())
        before = [(eng.pool.k[:, b].clone(), eng.pool.v[:, b].clone())
                  for b in primed]
        suffix = []
        real = eng._prefill_suffix

        def counted(*a, **k):
            n0 = rt.launch_counts()
            real(*a, **k)
            n1 = rt.launch_counts()
            suffix.append(sum(n1[x] - n0[x] for x in n1))
        eng._prefill_suffix = counted

    def sample(req, tok):
        # on each emitted token: the most references a primed block holds
        seen[0] = max([seen[0]] + [eng.pool.refcount(b) for b in primed])

    history, reqs, prompts = {}, {}, {}
    torch.cuda.synchronize()
    rt.reset_launches()
    t0 = time.perf_counter()
    for w in range(max(s["turns"] for s in sessions)):
        wave = []
        for s in sessions:
            if s["turns"] <= w:
                continue
            p = np.concatenate([history.get(s["sid"], s["sys"]),
                                s["user"][w]])
            rid = w * 1000 + int(s["sid"][1:])
            wave.append((s, rid, p))
            prompts[rid] = (p, s["expert"])
            eng.submit(Request(rid=rid, tokens=p,
                               max_new_tokens=t["new_tokens"],
                               expert=names[s["expert"]],
                               session_id=s["sid"] if sharing else None,
                               on_token=sample))
        done = {r.rid: r for r in eng.drain()}
        for s, rid, p in wave:
            reqs[rid] = done[rid]
            history[s["sid"]] = np.concatenate(
                [p, done[rid].output]).astype(np.int32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rt.launch_counts()
    rounds = eng.stats.decode_rounds - rounds0
    label = f"tenancy ({'shared' if sharing else 'unshared'})"
    for r in reqs.values():
        if r.output is None or len(r.output) != t["new_tokens"] or not (
                (r.output >= 0) & (r.output < eng.cfg.vocab_size)).all():
            raise AssertionError(f"{label}: request {r.rid}: {r.output}")
    check_launches(label, launches, {k: nL * rounds for k in PAGED_KERNELS})
    rec = dict(wall=wall, rounds=rounds, reqs=reqs, prompts=prompts,
               prefill_s=eng.stats.prefill_s - prefill0,
               launches=launches, hit=eng.stats.prefix_hit_tokens - hit0,
               cow=eng.pool.stats.cow_splits - cow0,
               prompt_tokens=sum(len(p) for p, _ in prompts.values()),
               tokens=sum(len(r.output) for r in reqs.values()),
               ttft=np.asarray([r.first_token_s - r.arrival_s
                                for r in reqs.values()]))
    if sharing:
        eng._prefill_suffix = real
        if rec["hit"] <= 0 or not suffix or any(suffix):
            raise AssertionError(f"{label}: prefix hits {rec['hit']}, "
                                 f"launches inside the suffix prefills "
                                 f"{suffix}")
        for s in sessions:
            if s["turns"] < 2:
                continue
            i = int(s["sid"][1:])
            r1, r2 = reqs[i], reqs[1000 + i]
            if r2.prefix_hit_tokens < len(r1.tokens) + len(r1.output) - 1:
                raise AssertionError(
                    f"{label}: session {s['sid']}'s second turn adopted "
                    f"{r2.prefix_hit_tokens} of {len(r1.tokens)} + "
                    f"{len(r1.output)} tokens")
        if seen[0] < 2:
            raise AssertionError(f"{label}: no decoding lane shared a primed "
                                 "block")
        torch.cuda.synchronize()
        for b, (k, v) in zip(primed, before):
            if eng.pool.refcount(b) < 1 or not (
                    torch.equal(eng.pool.k[:, b], k)
                    and torch.equal(eng.pool.v[:, b], v)):
                raise AssertionError(f"{label}: shared block {b} changed")
        rec.update(primed=len(primed), most_refs=seen[0],
                   sessions=eng.debug_sessions())
        del before
    return rec


def tenancy_phase(cfg, dev, store, names):
    """Multi-turn sessions at full width on the serve phase's pinned store
    (two experts, an HBM cache of both): the trace replayed through a
    ``prefix_sharing=True`` engine and an unshared one (8 slots, block 16,
    packed admission, after ``warmup()``), then the shared engine once more
    behind ``StreamingFrontend`` with two tenants' quotas. Returns the
    shared drain's launch counts."""
    import threading

    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
    from repro_torch.kernels import runtime as rt
    from repro_torch.serving import (QuotaExceeded, ServingEngine,
                                     StreamingFrontend, TenantQuota)

    t = TENANCY
    nL = cfg.n_layers
    names = names[:2]
    sys_prompts, sessions = tenancy_trace(cfg.vocab_size)

    def engine(sharing):
        coe = CompositionOfExperts(HashRouter(2), None,
                                   int(t["hbm_experts"]
                                       * store.nbytes(names[0])),
                                   store=store, device=dev)
        for n in names:
            coe.register(ExpertHandle(n, cfg))
        eng = ServingEngine(coe, cfg, max_len=t["max_len"],
                            n_slots=t["n_slots"], block_size=t["block_size"],
                            prefix_sharing=sharing, device=dev)
        eng.warmup()
        return coe, eng

    coe, eng = engine(True)
    shared = tenancy_replay(eng, names, sys_prompts, sessions, True, nL)
    eng.release_shared()
    problems = eng.pool.check_invariants()
    if problems or eng.pool.stats.blocks_in_use:
        raise AssertionError(f"tenancy (shared): KV pool {problems}, "
                             f"{eng.pool.stats.blocks_in_use} leaked after "
                             "release_shared()")

    # the shared engine behind the front door: a paid tenant (up to n_slots
    # at once, priority 1) and a free one (2 at once); every session's first
    # turn, submitted together
    quotas = {"paid": TenantQuota(max_concurrent=t["n_slots"]),
              "free": TenantQuota(max_concurrent=2)}
    rounds0 = eng.stats.decode_rounds
    rt.reset_launches()
    fe = StreamingFrontend(eng, quotas=quotas)
    streams, rejected = [], 0
    t0 = time.perf_counter()
    try:
        for i, s in enumerate(sessions):
            tenant = "paid" if i % 2 == 0 else "free"
            try:
                streams.append(fe.submit(
                    np.concatenate([s["sys"], s["user"][0]]),
                    t["new_tokens"], tenant=tenant, session_id=f"fe{i}",
                    priority=1 if tenant == "paid" else 0))
            except QuotaExceeded:
                rejected += 1
        got = [[] for _ in streams]
        readers = [threading.Thread(target=lambda st=st, out=out:
                                    out.extend(st), daemon=True)
                   for st, out in zip(streams, got)]
        for r in readers:
            r.start()
        for r in readers:
            r.join(timeout=300)
        if any(r.is_alive() for r in readers) or not fe.join(timeout=300):
            raise AssertionError("tenancy frontend: a stream did not end")
    finally:
        fe.close()
    fe_wall = time.perf_counter() - t0
    fe_rounds = eng.stats.decode_rounds - rounds0
    check_launches("tenancy frontend", rt.launch_counts(),
                   {k: nL * fe_rounds for k in PAGED_KERNELS})
    for st, toks in zip(streams, got):
        if toks != [int(x) for x in st.request.output] or \
                len(toks) != t["new_tokens"]:
            raise AssertionError(f"tenancy frontend: request "
                                 f"{st.request.rid} streamed {toks}, output "
                                 f"{st.request.output}")
    if rejected < 1:
        raise AssertionError("tenancy frontend: the free tenant's quota "
                             "refused nothing")
    eng.release_shared()
    if eng.pool.stats.blocks_in_use or eng.pool.check_invariants():
        raise AssertionError("tenancy frontend: the pool leaked")
    fe_tokens, n_streams = sum(len(x) for x in got), len(streams)
    coe.cache.close()
    del coe, eng, fe, streams
    gc.collect()
    torch.cuda.empty_cache()

    coe, eng = engine(False)
    unshared = tenancy_replay(eng, names, sys_prompts, sessions, False, nL)
    if eng.pool.stats.blocks_in_use or eng.pool.check_invariants():
        raise AssertionError("tenancy (unshared): the pool leaked")
    # shared against unshared: the same prompts must give the same tokens
    # up to bf16 near ties; a session whose streams parted sends other
    # prompts from its next turn on, which are not compared
    params = {e: coe.cache.activate(names[e]) for e in (0, 1)}
    pairs, skipped = [], 0
    for rid, r in shared["reqs"].items():
        p, e = shared["prompts"][rid]
        if not np.array_equal(p, unshared["prompts"][rid][0]):
            skipped += 1
            continue
        pairs.append((rid, params[e], p, r.output,
                      unshared["reqs"][rid].output))
    n_div = divergence_check("tenancy shared vs unshared", cfg, dev, pairs,
                             DENSE_PREFILL_LOGIT_TOL_REL)
    del params
    coe.cache.close()

    def line(rec, mode):
        return (f"{mode}: {len(rec['reqs'])} requests, {rec['tokens']} "
                f"tokens in {rec['wall']:.3f}s = "
                f"{rec['tokens'] / rec['wall']:.2f} tok/s; TTFT "
                f"p50={np.percentile(rec['ttft'], 50):.4f}s "
                f"p99={np.percentile(rec['ttft'], 99):.4f}s; "
                f"{rec['rounds']} decode rounds; admission prefills "
                f"{rec['prefill_s']:.3f}s")
    _log(f"tenancy: {t['sessions']} sessions, {len(shared['reqs'])} turns, "
         f"{shared['prompt_tokens']} prompt tokens; " + line(shared, "shared")
         + "; " + line(unshared, "unshared"))
    _log(f"tenancy: prefill skipped for {shared['hit']} of "
         f"{shared['prompt_tokens']} prompt tokens = "
         f"{shared['hit'] / shared['prompt_tokens']:.3f}; cow_splits="
         f"{shared['cow']}; {shared['primed']} primed blocks unchanged, "
         f"shared by up to {shared['most_refs']} references while decoding; "
         f"second turns adopted their history; launches "
         f"{shared['launches']}, none inside a suffix prefill; "
         f"release_shared() left no block in use")
    _log(f"tenancy: retained at the end of the waves: "
         f"{len(shared['sessions']['sessions'])} sessions, "
         f"{shared['sessions']['bytes_retained'] / 2 ** 20:.1f} MiB, "
         f"{shared['sessions']['evictions']} evictions")
    _log(f"tenancy: shared against unshared: {len(pairs)} requests "
         f"compared, {n_div} parted (each a near tie), {skipped} not "
         f"compared (a session's earlier turn parted)")
    _log(f"tenancy frontend: {n_streams} streams ({rejected} rejected "
         f"at the door), {fe_tokens} tokens in {fe_wall:.3f}s = "
         f"{fe_tokens / fe_wall:.2f} tok/s; streamed tokens equal the "
         f"outputs; {fe_rounds} decode rounds")
    return shared["launches"]


def cut_layers(tree, n):
    """The first ``n`` decoder layers of a dense tree, with its embedding,
    final norm and unembedding (views, no copy)."""
    from repro_torch.bridge import tree_map
    return {**tree, "layers": tree_map(lambda t: t[:n], tree["layers"])}


def speculative_phase(cfg, dev, store, names):
    """``SpeculativeDecode`` on the engine at full width: expert e0 the
    target (an HBM cache of two experts), gamma 4, 8 requests of 64-256
    prompt and 32 new tokens, with a self-draft (e0 itself, another copy on
    the card) and a 4-layer draft cut from e0; then the standalone
    ``SpeculativeDecoder`` at B 1 against dense greedy. Returns the phase's
    ``flash_prefill`` launches (the drafts' prefills and the decoder's, all
    at B 1)."""
    import dataclasses

    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import get_model
    from repro_torch.serving import (ServingEngine, SpeculativeDecode,
                                     SpeculativeDecoder)

    sp = SPEC
    nL, target = cfg.n_layers, names[0]
    coe = CompositionOfExperts(HashRouter(1), None,
                               int(sp["hbm_experts"] * store.nbytes(target)),
                               store=store, device=dev)
    coe.register(ExpertHandle(target, cfg))

    def drain(policy):
        eng = ServingEngine(coe, cfg, max_len=sp["max_len"],
                            n_slots=sp["n_slots"],
                            block_size=sp["block_size"], policy=policy,
                            device=dev)
        eng.warmup()
        reqs, _ = make_requests(sp["requests"], cfg.vocab_size,
                                sp["prompt_lens"], sp["new_tokens"],
                                [target], 1.0, sp["seed"])
        torch.cuda.synchronize()
        rt.reset_launches()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done = {r.rid: r for r in eng.drain()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rt.launch_counts()
        if len(done) != sp["requests"] or any(
                len(r.output) != sp["new_tokens"] for r in done.values()):
            raise AssertionError("speculative: a request did not finish")
        if eng.pool.stats.blocks_in_use or eng.pool.check_invariants():
            raise AssertionError("speculative: the target pool leaked")
        return eng, done, wall, launches

    g_eng, greedy, g_wall, g_launches = drain(None)
    check_launches("speculative phase greedy drain", g_launches,
                   {k: nL * g_eng.stats.decode_rounds for k in PAGED_KERNELS})
    g_tps = sp["requests"] * sp["new_tokens"] / g_wall
    del g_eng
    params = coe.cache.activate(target)
    host = store.get(target)
    prefill_launches = 0
    for label, dcfg, tree in (
            ("self-draft", cfg, host),
            (f"{sp['draft_layers']}-layer draft",
             dataclasses.replace(cfg, n_layers=sp["draft_layers"]),
             cut_layers(host, sp["draft_layers"]))):
        spec = SpeculativeDecode(dcfg, tree, gamma=sp["gamma"])
        eng, done, wall, launches = drain(spec)
        rounds = eng.stats.decode_rounds
        want = {k: sp["gamma"] * dcfg.n_layers * rounds
                for k in PAGED_KERNELS}
        want["flash_prefill"] = dcfg.n_layers * sp["requests"]
        check_launches(f"speculative ({label})", launches, want)
        prefill_launches += launches["flash_prefill"]
        st = spec.stats
        if st.target_calls != rounds or st.draft_calls != sp["gamma"] * rounds:
            raise AssertionError(f"speculative ({label}): {st}")
        if spec.d_pool.stats.blocks_in_use or spec.d_pool.check_invariants():
            raise AssertionError(f"speculative ({label}): the draft pool "
                                 "leaked")
        n_div = divergence_check(
            f"speculative ({label}) vs greedy", cfg, dev,
            [(rid, params, r.tokens, r.output, greedy[rid].output)
             for rid, r in done.items()], LOGIT_TOL_REL)
        tps = sp["requests"] * sp["new_tokens"] / wall
        _log(f"speculative ({label}, gamma {sp['gamma']}): "
             f"{sp['requests']} requests x {sp['new_tokens']} tokens in "
             f"{wall:.3f}s = {tps:.2f} tok/s against greedy {g_tps:.2f} "
             f"({tps / g_tps:.3f}x); acceptance "
             f"{st.acceptance_rate:.3f}, {st.tokens_per_target_call:.3f} "
             f"tokens a target call (all lanes), {rounds} rounds ({wall / rounds * 1e3:.3f}"
             f" ms a round); {n_div} of {len(done)} streams part from "
             f"greedy (near ties); launches {launches}; draft pool clean")
        del spec, eng, done
        gc.collect()
        torch.cuda.empty_cache()
    del host

    # the standalone dense-cache decoder at B 1 against dense greedy
    dcfg = dataclasses.replace(cfg, n_layers=sp["draft_layers"])
    d_params = cut_layers(params, sp["draft_layers"])
    P, n = sp["decoder_prompt"], sp["new_tokens"]
    prompt = np.random.RandomState(sp["seed"]).randint(
        0, cfg.vocab_size, (1, P)).astype(np.int32)
    sd = SpeculativeDecoder(cfg, dcfg, gamma=sp["gamma"])
    torch.cuda.synchronize()
    rt.reset_launches()
    t0 = time.perf_counter()
    out = sd.generate(params, d_params, prompt, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rt.launch_counts()
    want = {k: dcfg.n_layers * sd.stats.draft_calls for k in DENSE_KERNELS}
    want["flash_prefill"] = nL + dcfg.n_layers
    check_launches("speculative decoder", launches, want)
    prefill_launches += launches["flash_prefill"]
    model = get_model(cfg)
    tt = torch.as_tensor(prompt, device=dev).long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": tt}, P + n + 8)
    tok = last.argmax(-1)
    ref = [int(tok[0])]
    for i in range(n - 1):
        lg, cache = model.decode_step(params, cache, tok[:, None], P + i)
        tok = lg.argmax(-1)
        ref.append(int(tok[0]))
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    del cache
    n_div = divergence_check("speculative decoder vs dense greedy", cfg, dev,
                             [(0, params, prompt[0], out[0], np.asarray(ref))],
                             LOGIT_TOL_REL)
    st = sd.stats
    _log(f"speculative decoder (B 1, {P}-token prompt, {n} tokens, "
         f"{dcfg.n_layers}-layer draft, gamma {sp['gamma']}): {wall:.3f}s = "
         f"{n / wall:.2f} tok/s against dense greedy {n / g_wall:.2f} "
         f"(plain decode_step); acceptance {st.acceptance_rate:.3f}, "
         f"{st.tokens_per_target_call:.3f} tokens a target call; "
         f"{'parts from greedy (a near tie)' if n_div else 'equals greedy'}; "
         f"launches {launches}")
    del params, d_params
    coe.cache.close()
    return prefill_launches


def busy_us(spans):
    """The length of the union of sorted (start, end) spans."""
    busy, reach = 0.0, -np.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return busy


def step_breakdown(step, label, n_steps=10):
    """Where one step's time goes: host wall per step without the profiler;
    with it, the device's busy time (the union of its kernels' spans: the
    FFN kernels' passes start before the pass ahead of them ends, so their
    spans overlap) and each kernel name's summed span (device-kernel events
    only; a pass's span includes its wait for the one ahead)."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n_steps * 1e3
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    # device events only: an aten op's own entry also carries the time of
    # the kernels it launched, which would count them twice
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev[e.key] = e.self_device_time_total / n_steps / 1e3
    dev_ms = busy_us(sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA)) / n_steps / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    if dev_ms > 0:
        _log(f"{label}: host wall {wall_ms:.3f} ms, device busy "
             f"{dev_ms:.3f} ms (idle share "
             f"{max(0.0, 1 - dev_ms / wall_ms):.3f}); by kernel: "
             + "; ".join(f"{k[:48]}={v:.3f}ms" for k, v in top))
    else:
        _log(f"{label}: host wall {wall_ms:.3f} ms; device time not "
             "measured (the profiler saw no device activity)")


def step_under(step, label, under, n_steps=10):
    """With the host ahead of the card (the steps enqueued behind a device
    sleep longer than their host time), each step's device span, and in how
    many launches of kernel ``under[0]`` the next ``under[1]`` launch
    started before it ended (programmatic launch), by how much (kernel-name
    parts)."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    first, then = under
    # device activity only: tracing the host's ops would slow it past the
    # sleep
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(n_steps * 40_000_000)     # ~20 ms a step
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "spin_kernel" not in e.name)
    if not evs:
        _log(f"{label}: host ahead: device time not measured (the profiler "
             "saw no device activity)")
        return
    span_us = max(b for _, b, _ in evs) - evs[0][0]
    busy = busy_us([(a, b) for a, b, _ in evs])
    starts = [a for a, _, n in evs if then in n]
    leads = []
    for a, b, n in evs:
        if first not in n:
            continue
        i = bisect.bisect_left(starts, a)
        if i < len(starts):
            leads.append(b - starts[i])
    n_under = sum(d > 0 for d in leads)
    med = float(np.median(leads)) if leads else float("nan")
    _log(f"{label}: host ahead: device span {span_us / n_steps / 1e3:.3f} "
         f"ms a step, busy {busy / span_us:.3f} of it (~0.97 with the gaps "
         f"between launches; well below, the host fell behind); {then} "
         f"started before {first} ended in "
         f"{n_under} of {len(leads)} launches (median lead {med:.2f} us)")


def dense_decode_phase(cfg, dev, params):
    """The dense-cache decode path on one full-width expert: the port's
    ``prefill`` of 8 lanes x 2048 tokens into a 4096-position cache, then
    greedy steps of 32 ``decoder_layer_step``s (the kernels ``qkv_rope``,
    ``decode``, ``ffn_swiglu``) plus embedding, final norm and unembedding.
    Checks the launch counts, finite logits, and one step's logits against
    the plain ``decode_step`` layer run in f32; prints what two planted
    faults read and where a step's time goes. Returns the launch counts."""
    from repro_torch.bridge import tree_map
    from repro_torch.distributed import ctx
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.fused_decode.ops import (decoder_layer_step,
                                                      layer_step_params)
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    d = DENSE
    B, P, nL = d["lanes"], d["prompt_len"], cfg.n_layers
    rs = np.random.RandomState(d["seed"])
    prompts = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, P)),
                              device=dev)
    f32 = lambda tree: tree_map(lambda t: t.float(), tree)
    torch.cuda.synchronize()
    rt.reset_launches()
    t0 = time.perf_counter()
    last, cache = T.prefill(cfg, params, prompts, d["max_len"])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = rt.launch_counts()
    check_launches("dense prefill", prefill_launches, {"flash_prefill": nL})
    t0 = time.perf_counter()
    layers = [layer_step_params(params, i) for i in range(nL)]  # once
    torch.cuda.synchronize()
    _log(f"dense: prefill of {B} x {P} tokens into a {d['max_len']}-position "
         f"cache in {prefill_s:.3f}s; "
         f"{prefill_launches['flash_prefill']} "
         f"flash_prefill launches; w_qkv of {nL} layers built in "
         f"{time.perf_counter() - t0:.3f}s")
    # the first lane's last-token logits against the plain forward in f32
    l32 = plain_logits_f32(cfg, params, prompts[0].cpu(), dev)[None]
    logits_check("dense prefill reference check: kernels vs f32 plain "
                 "forward", last[:1], l32, DENSE_PREFILL_LOGIT_TOL_REL)
    del l32
    step_breakdown(lambda: T.prefill(cfg, params, prompts, d["max_len"]),
                   f"dense prefill ({B} x {P} tokens, {nL} layers)",
                   n_steps=3)
    kw = dict(n_q=cfg.n_heads, n_kv=cfg.n_kv_heads, dh=cfg.head_dim,
              theta=cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]

    @torch.no_grad()
    def step(tok, pos):
        h = T.embed_tokens(cfg, params, tok)
        for i, p in enumerate(layers):
            h, _, _ = decoder_layer_step(h, p, kc[i], vc[i], pos, **kw)
        h = L.apply_norm(cfg, params["final_norm"], h)
        return T.unembed(cfg, params, h)

    tok = last.argmax(-1)
    rt.reset_launches()
    t0 = time.perf_counter()
    for t in range(d["steps"]):
        logits = step(tok, P + t)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rt.launch_counts()
    for name, n in launches.items():
        want = nL * d["steps"] if name in DENSE_KERNELS else 0
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected {want} "
                                 f"({nL} layers x {d['steps']} steps of "
                                 f"the dense kernels)")
    if not torch.isfinite(logits.float()).all():
        raise AssertionError("dense decode logits not finite")
    if not ((tok >= 0) & (tok < cfg.vocab_size)).all():
        raise AssertionError("dense decode token out of vocabulary")
    _log(f"dense: {d['steps']} steps of {B} lanes in {wall:.3f}s = "
         f"{B * d['steps'] / wall:.2f} tok/s; launches {launches}")

    # one step against the plain decode_step layer run in f32 on the same
    # cache, upcasting one layer's weights and cache at a time
    pos = P + d["steps"]
    S = d["max_len"]
    posv = torch.full((B, 1), pos, dtype=torch.long, device=dev)
    valid = (torch.arange(S, device=dev) < pos + 1)[None].expand(B, S)
    with torch.no_grad():
        h = T.embed_tokens(cfg, params, tok[:, None]).float()
        for i in range(nL):
            h, _ = T._decode_dense_layer(cfg, f32(T.layer_params(params, i)),
                                         h, kc[i].float(), vc[i].float(), pos,
                                         posv, valid)
        h = L.apply_norm(cfg, f32(params["final_norm"]), h)
        l32 = (h @ params["lm_head"].float())[:, 0]
    carried = {k: v.clone() for k, v in cache.items()}
    lb = T.decode_step(cfg, params, cache, tok[:, None], pos)[0].float()
    # PerfOptions.decode_cache_carry: the same step on a copy of the cache
    # with the field on gives the same bits, logits and the whole cache
    with ctx.perf_options(ctx.PerfOptions(decode_cache_carry=True)):
        lc = T.decode_step(cfg, params, carried, tok[:, None], pos)[0]
    same = torch.equal(lc.float(), lb) and all(
        torch.equal(carried[k], cache[k]) for k in cache)
    _log(f"dense: decode_step with PerfOptions.decode_cache_carry on, on a "
         f"copy of the cache: logits and the whole cache bit-equal to off: "
         f"{same}")
    if not same:
        raise AssertionError("dense: decode_cache_carry changed the step's "
                             "bits")
    del carried, lc
    lf = step(tok, pos).float()
    tol = DENSE_LOGIT_TOL_REL * float(l32.abs().max())

    def gap(lx):
        return (float((lx - l32).abs().max()),
                float((lx - l32).norm() / l32.norm()))

    err, rel = gap(lf)
    agree = float((lf.argmax(-1) == l32.argmax(-1)).float().mean())
    _log(f"dense reference check: kernels vs f32 plain decode_step "
         f"max_abs_err={err:.4f} (tol {tol:.4f}) rel_l2={rel:.5f} "
         f"argmax_agree={agree:.3f} |logits|max={float(l32.abs().max()):.3f}"
         "; bf16 plain decode_step vs f32: max_abs_err=%.4f rel_l2=%.5f"
         % gap(lb))
    if not err <= tol:
        raise AssertionError(f"dense kernels vs f32 reference logits differ "
                             f"by {err} > {tol}")
    faults = {
        "newest_position_skipped": ("decode", lambda real, q, k, v, n:
                                    real(q, k, v, n - 1)),
        "rope_dropped": ("qkv_rope", lambda real, x, sc, w, p, **k:
                         real(x, sc, w, 0, **k)),
    }
    for fault, (name, fn) in faults.items():
        with fault_planted(name, fn):
            f_err, f_rel = gap(step(tok, pos).float())
        _log(f"dense planted fault {fault} (layer {FAULT_LAYER}): "
             f"max_abs_err={f_err:.4f} rel_l2={f_rel:.5f} -> "
             f"{'caught' if f_err > tol else 'NOT caught'} at tol {tol:.4f}")
    del l32
    step_breakdown(lambda: step(tok, pos),
                   f"dense decode step ({B} lanes, {nL} layers, length "
                   f"{pos + 1})")
    del kc, vc, cache, layers
    return launches, prefill_launches


def generate_phase(cfg, dev, store, names):
    """``CompositionOfExperts.generate`` with an ``LMRouter`` on the expert
    backbone (resident on the card) over the experts in ``store``, with an
    HBM weight cache of two experts: 8 prompts of 128 tokens, 16 new tokens
    each, prefetching the next group's expert."""
    from repro_torch.core import CompositionOfExperts, ExpertHandle, LMRouter
    from repro_torch.kernels import runtime as rt

    g = GEN
    router = LMRouter(cfg, len(names))
    rparams = router.init(torch.Generator(device=dev).manual_seed(g["seed"]),
                          dev)
    nbytes = store.nbytes(names[0])
    coe = CompositionOfExperts(router, rparams,
                               int(g["hbm_experts"] * nbytes), store=store,
                               device=dev)
    for n in names:
        coe.register(ExpertHandle(n, cfg))        # already in the store
    toks = np.random.RandomState(g["seed"]).randint(
        0, cfg.vocab_size, (g["prompts"], g["prompt_len"])).astype(np.int32)
    # the first call meets every plain op's first launch; the second runs
    # the same prompts on a warm process, its groups' experts partly resident
    for run in ("first", "second"):
        cs0 = coe.cache.stats.as_dict()
        torch.cuda.synchronize()
        rt.reset_launches()
        t0 = time.perf_counter()
        res = coe.generate(toks, g["new_tokens"], prefetch_next=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hits, misses, pf = (getattr(coe.cache.stats, k) - cs0[k] for k in
                            ("hits", "misses", "prefetch_hits"))
        n_groups = len(np.unique(res.expert_of_prompt))
        # the router's backbone and each group's prefill: one flash_prefill
        # per layer; the decode steps are plain
        check_launches(f"generate ({run} call)", rt.launch_counts(),
                       {"flash_prefill": cfg.n_layers * (1 + n_groups)})
        if res.tokens.shape != (g["prompts"], g["new_tokens"]):
            raise AssertionError(f"generate: tokens {res.tokens.shape}")
        if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
            raise AssertionError("generate: token out of vocabulary")
        if hits + misses != n_groups:
            raise AssertionError(f"generate: hits {hits} + misses {misses} "
                                 f"!= {n_groups} groups")
        n_out = res.tokens.size
        _log(f"generate ({run} call): {g['prompts']} prompts x "
             f"{g['prompt_len']} tokens -> {n_out} tokens in {wall:.3f}s = "
             f"{n_out / wall:.2f} tok/s; experts "
             f"{np.bincount(res.expert_of_prompt, minlength=len(names))}, "
             f"{n_groups} groups, hits={hits} misses={misses} "
             f"prefetch_hits={pf}; switch_s={res.switch_seconds:.4f} "
             f"exec_s={res.exec_seconds:.4f} "
             f"route_s={res.route_seconds:.4f}; flash_prefill launches "
             f"{cfg.n_layers * (1 + n_groups)}")
    coe.cache.close()


def _node_drain(node, cfg, label, nL):
    """Submit the serve phase's trace to ``node`` and drain it, checking the
    HBM budgets after every step, every request's output, clean pools and
    the fused TP body's launches (each of its kernels ``tp`` x layers x
    decode rounds, nothing else). Returns (done by rid, wall, launches)."""
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.serve import make_requests

    s = SERVE
    reqs, _ = make_requests(s["requests"], cfg.vocab_size, s["prompt_lens"],
                            s["new_tokens"], node.expert_names(),
                            s["tagged_fraction"], s["seed"])
    torch.cuda.synchronize()
    rt.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        node.submit(r)
    done = []
    while node.has_work:
        done.extend(node.step())
        if not node.hbm_within_budget():
            raise AssertionError(f"{label}: a group left its HBM budget")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rt.launch_counts()
    if len(done) != s["requests"]:
        raise AssertionError(f"{label}: {len(done)} of {s['requests']} done")
    for r in done:
        if r.output is None or len(r.output) != s["new_tokens"]:
            raise AssertionError(f"{label}: request {r.rid}: {r.output}")
    pools = ([gs.engine.pool for gs in node.groups]
             + [w.pool for w in node.workers])
    for pool in pools:
        if pool.stats.blocks_in_use or pool.check_invariants():
            raise AssertionError(f"{label}: a pool leaked")
    rounds = sum(gs.engine.stats.decode_rounds for gs in node.groups)
    check_launches(label, launches,
                   {k: node.topology.tp * nL * rounds for k in NODE_KERNELS})
    st = node.stats()
    ttft = np.asarray([r.first_token_s - r.arrival_s for r in done])
    per = "; ".join(
        f"group {g['gid']}: {g['requests']} requests, {g['decode_rounds']} "
        f"rounds of {gs.engine.stats.exec_s / max(g['decode_rounds'], 1) * 1e3:.3f}"
        f" ms, switches={g['switches']} misses={g['cache_misses']}"
        for g, gs in zip(st.per_group, node.groups))
    pre = "".join(f"; prefill group {g['gid']}: {g['prefilled']} prefilled, "
                  f"misses={g['cache_misses']}" for g in st.prefill_groups)
    _log(f"{label}: {len(done)} requests, {st.tokens_out} tokens in "
         f"{wall:.3f}s = {st.tokens_out / wall:.2f} tok/s; TTFT "
         f"p50={np.percentile(ttft, 50):.4f}s p99={np.percentile(ttft, 99):.4f}"
         f"s; {per}{pre}; budgets held at every step; launches "
         f"{ {k: launches[k] for k in NODE_KERNELS} } = "
         f"{node.topology.tp} ranks x {nL} layers x {rounds} rounds")
    return {r.rid: r for r in done}, wall, launches


def tp_step_breakdown(cfg, dev, gs, B):
    """Where one fused TP step of group ``gs`` goes: ``B`` lanes of 1-119
    prompt tokens prefilled into its pool (one inactive lane), then the
    step's host wall and device time by kernel (``step_breakdown``)."""
    eng = gs.engine
    name = gs.coe.cache.expert_ids()[-1]
    params = gs.coe.cache.activate(name)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rs.randint(1, 120, size=B)]
    rids = list(range(20_000, 20_000 + B))
    for i in range(0, B, 4):
        chunk = rids[i:i + 4]
        res = eng.prefill_runner(params, prompts[i:i + 4])
        eng.prefill_runner.scatter_into(eng.pool, res, chunk,
                                        extra_tokens=[1] * len(chunk))
    tables = torch.as_tensor(np.stack([eng.pool.padded_table(
        r, eng.max_blocks) for r in rids]), device=dev)
    lengths = torch.as_tensor([eng.pool.length(r) for r in rids],
                              dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[3] = False
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, 1)), device=dev)
    step_breakdown(lambda: eng.runner.extend(params, eng.pool.k, eng.pool.v,
                                             tables, lengths, active, toks),
                   f"node TP step ({B} lanes, {eng.runner.tp} ranks x "
                   f"{cfg.n_layers} layers)")
    for r in rids:
        eng.pool.free(r)


def node_phase(cfg, dev, store, names, serve_out):
    """``RDUNode`` at full width on the serve phase's pinned store: a 2 x 2
    topology (four sockets sharing the card), each group's HBM share one
    expert and a KV carve, the fused backend, the serve phase's 16-request
    trace. Colocated, then with one prefill group and one decode group.
    Streams against the single-device engine's (``serve_out``) and the
    disaggregated against the colocated, up to prefill near ties. Returns
    the colocated drain's launch counts."""
    from repro_torch.bridge import tree_map
    from repro_torch.core import HashRouter
    from repro_torch.node import RDUNode, make_node_topology

    n, nL = NODE, cfg.n_layers
    t_phase = time.perf_counter()
    nbytes = store.nbytes(names[0])

    def build(prefill_groups):
        node = RDUNode(make_node_topology(n["tp"], n["groups"]), cfg,
                       HashRouter(len(names)), None,
                       group_hbm_bytes=int(n["hbm_experts"] * nbytes
                                           + n["kv_reserve"]),
                       group_kv_reserve_bytes=n["kv_reserve"], store=store,
                       prefill_groups=prefill_groups,
                       n_slots=SERVE["n_slots"],
                       block_size=SERVE["block_size"],
                       max_len=SERVE["max_len"])
        for name in names:
            node.register_expert(name, None)     # already in the store
        return node

    node = build(0)
    co, co_wall, launches = _node_drain(node, cfg, "node 2x2 colocated", nL)
    tp_step_breakdown(cfg, dev, node.groups[0], SERVE["n_slots"])
    node.close()
    del node
    gc.collect()
    torch.cuda.empty_cache()

    node = build(1)
    prefills = []
    for gs in node.groups:                  # a decode group never prefills
        for obj, attr in ((gs.engine.prefill_runner, "_fn"),
                          (gs.engine.runner, "prefill_kv")):
            real = getattr(obj, attr)
            setattr(obj, attr, lambda *a, real=real, **k:
                    prefills.append(1) or real(*a, **k))
    dis, dis_wall, _ = _node_drain(node, cfg, "node 2x2 disaggregated "
                                   "(1 prefill group, 1 decode group)", nL)
    handoffs = sum(m.value for m in node.registry.metrics()
                   if m.name == "node.kv_handoffs")
    hbytes = sum(m.value for m in node.registry.metrics()
                 if m.name == "node.kv_handoff_bytes")
    node.close()
    del node
    gc.collect()
    torch.cuda.empty_cache()
    if prefills or handoffs != SERVE["requests"]:
        raise AssertionError(f"node disaggregated: {len(prefills)} prefill "
                             f"forwards in a decode group, {handoffs} "
                             "handoffs")

    def compare(label, got, want):
        by_expert = {}
        for rid, r in got.items():
            if r.expert != want[rid].expert:
                raise AssertionError(f"{label}: request {rid} on "
                                     f"{r.expert}, not {want[rid].expert}")
            by_expert.setdefault(r.expert, []).append(rid)
        n_div = 0
        for name, rids in by_expert.items():
            if all(np.array_equal(got[i].output, want[i].output)
                   for i in rids):
                continue
            params = tree_map(lambda t: t.to(dev), store.get(name))
            n_div += divergence_check(
                label, cfg, dev, [(i, params, got[i].tokens, got[i].output,
                                   want[i].output) for i in rids],
                DENSE_PREFILL_LOGIT_TOL_REL)
            del params
            torch.cuda.empty_cache()
        return n_div

    n1 = compare("node colocated vs single device", co, serve_out)
    n2 = compare("node disaggregated vs colocated", dis, co)
    _log(f"node: streams against the single-device engine's: "
         f"{len(co)} compared, {n1} parted (each a near tie); "
         f"disaggregated against colocated: {n2} parted (each a near tie); "
         f"{int(handoffs)} handoffs of {hbytes / 2 ** 20:.1f} MiB, no "
         f"prefill forward in the decode group; phase "
         f"{time.perf_counter() - t_phase:.1f}s")
    return launches


def tier_phase(cfg, dev, store, names):
    """The expert tier at full width: two of the serve phase's experts in a
    ``MmapFileStore`` (under a temporary directory, removed at the end) and
    in an ``Int8BlockQuantizedStore``, each behind an engine whose HBM
    cache holds one expert, so every switch is a load. Streams must equal
    a host-store drain over the same bytes (the pinned store; the int8
    store's dequantized trees); then a dirty mutable entry's write-back.
    Frees the two experts from ``store`` once quantized."""
    import shutil
    import tempfile

    from repro_torch.bridge import tree_map
    from repro_torch.core import (CompositionOfExperts, ExpertHandle,
                                  HashRouter, HBMWeightCache)
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import ServingEngine
    from repro_torch.store import (HostMemoryStore, Int8BlockQuantizedStore,
                                   MmapFileStore)

    t = TIER
    t_phase = time.perf_counter()
    names = names[:t["experts"]]
    nbytes = store.nbytes(names[0])

    def drain(st, label):
        coe = CompositionOfExperts(HashRouter(len(names)), None, nbytes,
                                   store=st, device=dev)
        for name in names:
            coe.register(ExpertHandle(name, cfg))
        loads = []
        real = coe.cache._load_job

        def timed(expert_id):
            ld = real(expert_id)
            loads.append((expert_id, ld.read_s, ld.h2d_s))
            return ld
        coe.cache._load_job = timed
        eng = ServingEngine(coe, cfg, max_len=t["max_len"],
                            n_slots=t["n_slots"], block_size=t["block_size"],
                            device=dev)
        reqs, _ = make_requests(t["requests"], cfg.vocab_size,
                                t["prompt_lens"], t["new_tokens"], names,
                                1.0, t["seed"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cs = coe.cache.stats
        if (len(done) != t["requests"] or eng.pool.stats.blocks_in_use
                or any(len(r.output) != t["new_tokens"] for r in done)):
            raise AssertionError(f"tier {label}: drain incomplete or leaked")
        if cs.misses + cs.prefetch_hits != len(loads) or len(loads) < 2:
            raise AssertionError(f"tier {label}: {len(loads)} loads, "
                                 f"{cs.as_dict()}")
        _log(f"tier {label}: {len(done)} requests in {wall:.3f}s, "
             f"{cs.misses} misses, {cs.prefetch_hits} consumed prefetches; "
             + "; ".join(f"{e} store_read {r:.3f}s h2d {h:.3f}s"
                         for e, r, h in loads))
        coe.cache.close()
        del coe, eng
        gc.collect()
        torch.cuda.empty_cache()
        return {r.rid: r.output for r in done}

    def same(label, got, want):
        bad = [rid for rid in want if not np.array_equal(got[rid], want[rid])]
        if bad:
            raise AssertionError(f"tier {label}: streams differ in {bad}")

    # --- mmap: the same bytes on disk, read lazily and eagerly
    tmp = tempfile.mkdtemp(prefix="expert_tier_")
    try:
        t0 = time.perf_counter()
        mm = MmapFileStore(tmp)
        for name in names:
            mm.put(name, store.get(name))
        put_s = time.perf_counter() - t0
        _log(f"tier mmap: wrote {mm.total_stored_bytes() / 1e9:.2f} GB in "
             f"{put_s:.2f}s ({shutil.disk_usage(tmp).free / 1e9:.1f} GB "
             "left on the disk)")
        ref = drain(store, "host (pinned)")
        same("mmap lazy", drain(MmapFileStore(tmp), "mmap lazy"), ref)
        same("mmap eager", drain(MmapFileStore(tmp, eager=True),
                                 "mmap eager"), ref)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # --- int8 blocks, quantized on the card, dequantized on the host
    q = Int8BlockQuantizedStore(t["int8_block"])
    for name in names:
        q.put(name, tree_map(lambda x: x.to(dev), store.get(name)))
        torch.cuda.empty_cache()
    for name in names:
        store.delete(name)                  # the pinned copies go
    gc.collect()
    deq, dq_s = HostMemoryStore(), []
    for name in names:
        t0 = time.perf_counter()
        tree = q.get(name)
        dq_s.append(time.perf_counter() - t0)
        deq.put(name, tree)
        del tree
    _log(f"tier int8 (block {t['int8_block']}): stored_bytes / nbytes = "
         f"{q.stored_bytes(names[0])} / {q.nbytes(names[0])} = "
         f"{q.stored_bytes(names[0]) / q.nbytes(names[0]):.4f}; dequantization "
         f"on the host {', '.join(f'{x:.2f}s' for x in dq_s)} an expert")
    ref8 = drain(deq, "int8 reference (host store of int8_store.get)")
    del deq
    gc.collect()
    same("int8", drain(q, "int8"), ref8)
    del q
    gc.collect()

    # --- a dirty mutable entry: evicted, then dropped, written back exactly
    tmp = tempfile.mkdtemp(prefix="expert_tier_state_")
    try:
        gen = torch.Generator(device=dev).manual_seed(t["seed"])
        ms = MmapFileStore(tmp)
        for k in ("s0", "s1"):
            ms.put(k, {"m": torch.randn(t["state_mb"] * 2 ** 18,
                                        generator=gen, device=dev)})
        nb = ms.nbytes("s0")
        cache = HBMWeightCache(nb, ms, dev)
        x = cache.activate("s0", read_only=False)
        x["m"].add_(1.0)
        want = x["m"].cpu()
        cache.mark_dirty("s0")
        cache.activate("s1")                 # evicts s0: written back
        ok1 = (cache.stats.bytes_copied_back == nb
               and torch.equal(ms.get("s0")["m"], want))
        y = cache.activate("s0", read_only=False)   # evicts s1: elided
        y["m"].mul_(2.0)
        want = y["m"].cpu()
        cache.mark_dirty("s0")
        cache.drop("s0")
        st, led = cache.stats, cache.ledger
        ok2 = (st.drops == 1 and st.bytes_copied_back == 2 * nb
               and led.bytes_moved("writeback") == 2 * nb
               and led.bytes_moved("elided") == nb
               and torch.equal(ms.get("s0")["m"], want))
        if not (ok1 and ok2):
            raise AssertionError(f"tier write-back: {st.as_dict()}, "
                                 f"{led.as_dict()}")
        _log(f"tier write-back: a dirty {nb / 2 ** 20:.0f} MiB entry evicted "
             f"then dropped wrote back {st.bytes_copied_back} bytes "
             f"(writeback edge {led.bytes_moved('writeback')} B in "
             f"{led.seconds('writeback'):.3f}s, elided "
             f"{led.bytes_moved('elided')} B), re-read exactly; phase "
             f"{time.perf_counter() - t_phase:.1f}s")
        cache.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rg_phase(cfg, dev):
    """recurrentgemma-9b at full width and depth behind
    ``CompositionOfExperts.generate``: random bf16 weights from a fixed seed
    made on the card, moved into a pinned host store, activated into an HBM
    cache of one expert. Two ``generate`` calls on 4 prompts of 3000 tokens
    with 16 new tokens: each prefill launches ``flash_prefill`` once per
    attention layer (12) and ``lru_scan`` once per rec layer (26); the decode
    steps are plain. Then the prefill and the decode alone on the resident
    weights, timed, and the first lane's prefill logits against the plain
    f32 composition. Returns the first call's launch counts."""
    from repro_torch.bridge import tree_bytes, tree_map
    from repro_torch.core import (CompositionOfExperts, ExpertHandle,
                                  HashRouter)
    from repro_torch.kernels import runtime as rt
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as R
    from repro_torch.store import HostMemoryStore

    r = RG
    G, tail = R._group_counts(cfg)
    n_rec = G * R._n_rec(cfg) + tail
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(r["seed"]),
                        dev)
    nbytes = tree_bytes(params)
    coe = CompositionOfExperts(HashRouter(1), None, nbytes,
                               store=HostMemoryStore(), device=dev)
    coe.register(ExpertHandle(cfg.name, cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"rg: {cfg.name} ({cfg.n_layers} layers: {G} groups "
         f"{cfg.block_pattern} + {tail} rec, {nbytes / 1e9:.2f} GB bf16) "
         f"made and moved to pinned host memory in "
         f"{time.perf_counter() - t0:.1f}s; HBM cache of one expert")
    P, n_new, B = r["prompt_len"], r["new_tokens"], r["prompts"]
    toks = np.random.RandomState(r["seed"]).randint(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    first = None
    for run in ("first", "second"):
        cs0 = coe.cache.stats.as_dict()
        torch.cuda.synchronize()
        rt.reset_launches()
        t0 = time.perf_counter()
        res = coe.generate(toks, n_new, prefetch_next=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rt.launch_counts()
        first = first or launches
        check_launches(f"rg generate ({run} call)", launches,
                       {"flash_prefill": G, "lru_scan": n_rec})
        hits, misses = (getattr(coe.cache.stats, k) - cs0[k]
                        for k in ("hits", "misses"))
        if res.tokens.shape != (B, n_new):
            raise AssertionError(f"rg generate: tokens {res.tokens.shape}")
        if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
            raise AssertionError("rg generate: token out of vocabulary")
        if hits + misses != 1:
            raise AssertionError(f"rg generate: hits {hits} + misses "
                                 f"{misses} != 1 group")
        _log(f"rg generate ({run} call): {B} prompts x {P} tokens -> "
             f"{res.tokens.size} tokens in {wall:.3f}s = "
             f"{res.tokens.size / wall:.2f} tok/s; hits={hits} "
             f"misses={misses}; switch_s={res.switch_seconds:.4f} "
             f"exec_s={res.exec_seconds:.4f}; launches "
             f"flash_prefill={launches['flash_prefill']} "
             f"lru_scan={launches['lru_scan']}")

    # the prefill and the decode alone, on the resident weights
    params = coe.cache.activate(cfg.name)
    tt = torch.as_tensor(toks, device=dev).long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": tt}, P + n_new)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = last.argmax(-1)
    t0 = time.perf_counter()
    for t in range(n_new - 1):
        lg, cache = model.decode_step(params, cache, tok[:, None], P + t)
        tok = lg.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if cache["k"].shape[2] != cfg.sliding_window:
        raise AssertionError(f"rg: ring of {cache['k'].shape[2]} positions")
    _log(f"rg: prefill of {B} x {P} tokens in {prefill_s:.3f}s "
         f"({B * P / prefill_s:.0f} tok/s); {n_new - 1} decode steps in "
         f"{decode_s:.3f}s = {B * (n_new - 1) / decode_s:.2f} tok/s")
    step_breakdown(lambda: model.decode_step(params, cache, tok[:, None],
                                             P + n_new - 1),
                   f"rg decode step ({B} lanes, {cfg.n_layers} layers)")
    del cache
    step_breakdown(lambda: model.prefill(params, {"tokens": tt}, P + n_new),
                   f"rg prefill ({B} x {P} tokens, {cfg.n_layers} layers)",
                   n_steps=3)

    # the first lane against the plain f32 composition
    f32 = lambda tree: tree_map(lambda t: t.float(), tree)
    with torch.no_grad(), plain_prefill():
        h = params["embed"]["tok"][tt[:1]].float()
        positions = torch.arange(P, device=dev)[None]
        for g in range(G):
            h, _, _ = R._group_apply(cfg, f32(R._take(params["groups"], g)),
                                     h, positions)
        for i in range(tail):
            h, _ = R.rec_block(cfg, f32(R._take(params["tail_rec"], i)), h)
            h = R._mlp_block(cfg, f32(R._take(params["tail_mlp"], i)), h)
        h = L.apply_norm(cfg, f32(params["final_norm"]), h[:, -1:])
        l32 = (h @ params["lm_head"].float())[:, 0]
    logits_check("rg reference check: kernels vs f32 plain composition",
                 last[:1], l32, RG_LOGIT_TOL_REL)
    del h, l32, params
    coe.cache.close()
    return first


def variant_kernel_phase(dev):
    """The kernels at the dense variants' shapes against their plain
    versions: granite-8b's three paged kernels (32 q on 8 kv heads, F
    14336); ``qkv_rope_paged`` at chatglm3-6b's widths rotating half of
    each head, with two faults planted in its plain version (RoPE dropped,
    the whole head rotated) that its row check must catch; ``flash_prefill``
    with dh 128 at each plain-body variant's G (5, 6, 12, 16), at B 1 and S
    64 / 160 / 256 and at 8 x 2048 tokens, each with off-by-one masks
    planted in its plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_decode.ref import (qkv_rope_paged_ref,
                                                      rope_inv_freq)
    rows = paged_rows(get_config("granite-8b"), dev, GRANITE_ROWS,
                      seed=8)[0]
    glm = get_config("chatglm3-6b")
    frac_rows, t, cases = paged_rows(glm, dev,
                                     {"qkv_rope_paged": ROPE_FRAC_ROW},
                                     seed=9, rope_frac=glm.rope_fraction)
    rows.update(frac_rows)
    rows.update(group_decode_rows(dev))
    got = cases["qkv_rope_paged"][0]()
    args = (t.x, t.scale, t.wq, t.wk, t.wv)
    for fault, pos, frac in (("rope_dropped", torch.zeros_like(t.pos),
                              glm.rope_fraction),
                             ("whole_head_rotated", t.pos, 1.0)):
        inv = torch.as_tensor(rope_inv_freq(glm.head_dim, glm.rope_theta,
                                            frac), device=dev)
        want = qkv_rope_paged_ref(*args, pos, inv)
        err = max(row_rel_l2(g, w) for g, w in zip(got, want))
        caught = err > STREAM_ROW_REL_L2
        _log(f"kernel {ROPE_FRAC_ROW}: planted fault {fault} (in the plain "
             f"version) reads a row relative L2 error of {err:.3e} -> "
             f"{'caught' if caught else 'NOT caught'} at "
             f"{STREAM_ROW_REL_L2:.3e}")
        if not caught:
            raise AssertionError(f"{ROPE_FRAC_ROW}: the row check missed a "
                                 f"planted fault ({fault})")
    del t, cases, got
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for arch, row in VARIANT_PREFILL_ROWS.items():
        c, B, S = get_config(arch), DENSE["lanes"], DENSE["prompt_len"]
        G = c.n_heads // c.n_kv_heads
        prefill_row(f"flash_prefill[{arch},G={G},B={B},S={S}]", c, B, S, 0,
                    gen, flush)
        for S in B1_PREFILL_LENGTHS:
            r = prefill_row(f"flash_prefill[{arch},G={G},B=1,S={S}]", c, 1,
                            S, 0, gen, flush)
            if r["name"] == row:
                rows[row] = r
    del flush
    return rows


def group_decode_row_names(arch):
    from repro_torch.configs import get_config
    c = get_config(arch)
    G, B = c.n_heads // c.n_kv_heads, GROUP_DENSE["lanes"]
    return (f"decode_paged[{arch},G={G},dh={c.head_dim}]",
            f"flash_decode[{arch},G={G},dh={c.head_dim},B={B},"
            f"S={GROUP_DENSE['length']}]")


def group_decode_rows(dev):
    """Rows 1⁗ and 6′: ``decode_paged`` and ``flash_decode`` at each
    ``GROUP_DECODE_ARCHS`` config's heads, each against its plain version
    and its chunked plain version, row by row (``flash_decode`` also with
    two chunk faults planted there), beside SDPA with ``enable_gqa`` and a
    length mask. At these groups a ``decode_paged`` CTA serves one query
    (``decode_core.cuh``'s ``decode_tile``), a ``flash_decode`` CTA the
    whole group over a chunk of ``decode_plan``'s."""
    from types import SimpleNamespace

    import torch.nn.functional as Fn

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import (decode, decode_paged,
                                                         split_chunk)
    from repro_torch.kernels.flash_attention.ref import (
        decode_attention_ref, decode_paged_ref, decode_paged_split_ref)
    from repro_torch.serving.backends import (dense_kernel_flops,
                                              dense_kernel_hbm_bytes,
                                              kernel_flops, kernel_hbm_bytes)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    v, B, S = VARIANTS, GROUP_DENSE["lanes"], GROUP_DENSE["length"]
    len1 = (1, 15, 16, 1, 17, 255, 300, 512)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    rows = {}
    for arch in GROUP_DECODE_ARCHS:
        c = get_config(arch)
        Hq, Hkv, dh = c.n_heads, c.n_kv_heads, c.head_dim
        G = Hq // Hkv
        paged_name, dense_name = group_decode_row_names(arch)
        block, maxb = v["block_size"], v["max_len"] // v["block_size"]
        n_rows = B * maxb + 1
        t = SimpleNamespace(q=rnd(B, Hq, dh), kp=rnd(n_rows, block, Hkv, dh),
                            vp=rnd(n_rows, block, Hkv, dh), block=block,
                            maxb=maxb)
        tables = torch.randperm(n_rows - 1, generator=gen, device=dev)[
            :B * maxb].reshape(B, maxb).to(torch.int32)
        tables[3] = n_rows - 1                           # inactive lane
        lens = torch.tensor(len1, dtype=torch.int32, device=dev)
        args = (t.q, t.kp, t.vp, tables, lens)
        q, kc, vc = rnd(B, Hq, dh), rnd(B, S, Hkv, dh), rnd(B, S, Hkv, dh)
        mask = torch.ones((B, 1, 1, S), dtype=torch.bool, device=dev)

        def lib_dense(q=q, kc=kc, vc=vc, mask=mask):
            return Fn.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        rows[paged_name] = kernel_row(
            paged_name, lambda args=args: decode_paged(*args),
            lambda args=args: decode_paged_ref(*args),
            lambda t=t, tables=tables, lens=lens:
            lib_decode_paged(t, tables, lens),
            kernel_hbm_bytes(c, B, len1, maxb)["decode_paged"],
            kernel_flops(c, B, len1)["decode_paged"], flush,
            kernel="decode_paged", row_tol=DECODE_ROW_REL_L2)
        rows[dense_name] = kernel_row(
            dense_name, lambda q=q, kc=kc, vc=vc: decode(q, kc, vc, S),
            lambda q=q, kc=kc, vc=vc: decode_attention_ref(q, kc, vc, S),
            lib_dense, dense_kernel_hbm_bytes(c, B, S)["flash_decode"],
            dense_kernel_flops(c, B, S)["flash_decode"], flush,
            kernel="flash_decode", row_tol=DECODE_ROW_REL_L2)
        rows[dense_name]["plan"] = dense_split_check(
            dense_name, decode(q, kc, vc, S), q, kc, vc, S)._asdict()
        split = row_rel_l2(decode_paged(*args),
                           decode_paged_split_ref(*args, split_chunk()))
        if not split <= DECODE_ROW_REL_L2:
            raise AssertionError(f"{paged_name}: row relative L2 {split} "
                                 "against the chunked plain version")
        _log(f"kernel {paged_name}: row relative L2 against the chunked "
             f"plain version {split:.3e} (tol {DECODE_ROW_REL_L2:.3e})")
        del t, tables, q, kc, vc, args
    del flush
    return rows


def drain(engine, reqs):
    """Submit ``reqs``, drain, synchronize: (done, wall seconds, the
    kernels' launch counts over the drain)."""
    from repro_torch.kernels import runtime as rt
    torch.cuda.synchronize()
    rt.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.drain()
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0, rt.launch_counts()


def variant_expert(cfg, dev, seed):
    """A composition of one random expert of ``cfg`` (made on the card from
    ``seed``, kept in pinned host memory) with an HBM cache of one."""
    from repro_torch.launch.serve import build_coe
    t0 = time.perf_counter()
    coe, nbytes = build_coe(cfg, 1, 1.0, seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"variants: {cfg.name}: {cfg.n_layers} layers, D {cfg.d_model}, "
         f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of {cfg.head_dim}, F "
         f"{cfg.d_ff}, vocab {cfg.vocab_size}; {nbytes / 1e9:.2f} GB bf16 "
         f"made and moved to pinned host memory in "
         f"{time.perf_counter() - t0:.1f}s")
    return coe


def granite_phase(cfg, dev):
    """granite-8b at full width and depth on the fused kernels: the serve
    phase's 16 requests through the default engine at one expert (each
    paged kernel once per layer per decode round, nothing else), then one
    decode step's logits against the plain body in f32 and what faults
    planted in one layer read, and one step's device time by kernel.
    Returns the drain's launch counts."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import ServingEngine
    s = SERVE
    coe = variant_expert(cfg, dev, s["seed"])
    engine = ServingEngine(coe, cfg, max_len=s["max_len"],
                           n_slots=s["n_slots"], block_size=s["block_size"],
                           device=dev)
    reqs, _ = make_requests(s["requests"], cfg.vocab_size, s["prompt_lens"],
                            s["new_tokens"], coe.expert_names(),
                            s["tagged_fraction"], s["seed"])
    done, wall, launches = drain(engine, reqs)
    st = engine.stats
    label = f"variants: {cfg.name} (fused)"
    served_ok(label, done, s["requests"], s["new_tokens"], cfg, engine)
    check_launches(f"{label} ({cfg.n_layers} layers x {st.decode_rounds} "
                   "decode rounds)", launches,
                   {k: cfg.n_layers * st.decode_rounds
                    for k in PAGED_KERNELS})
    _log(f"{label}: {len(done)} requests, {st.tokens_out} tokens in "
         f"{wall:.3f}s = {st.tokens_out / wall:.2f} tok/s; "
         f"{ttft_line(done, st.registry)}; {st.decode_rounds} decode rounds "
         f"({st.exec_s / st.decode_rounds * 1e3:.3f} ms a round, host wall "
         f"with its argmax read); launches {launches}")
    params = coe.cache.activate(coe.expert_names()[0])
    step, rids = fused_step_check(label, cfg, dev, engine, params,
                                  GRANITE_LOGIT_TOL_REL)
    step_breakdown(step, f"{cfg.name} decode step ({s['n_slots']} lanes, "
                         f"{cfg.n_layers} layers)")
    del step, params
    for r in rids:
        engine.pool.free(r)
    coe.cache.close()
    return launches


def plain_variant_phase(cfg, dev, tol_rel):
    """A dense variant the kernels refuse, on the plain paged body it is
    served on (``XlaPagedBackend``, named by the caller), with sequential
    prefill: ``VARIANTS``' requests, ``flash_prefill`` once per layer a
    prompt and no other kernel; then one prompt's prefill (``prefill_kv``,
    ``flash_prefill``) last-token logits against the plain forward in f32.
    Returns the drain's launch counts."""
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import ServingEngine, XlaPagedBackend
    v = VARIANTS
    coe = variant_expert(cfg, dev, v["seed"])
    engine = ServingEngine(coe, cfg, backend=XlaPagedBackend(cfg),
                           prefill_mode="sequential", max_len=v["max_len"],
                           n_slots=v["n_slots"], block_size=v["block_size"],
                           device=dev)
    reqs, _ = make_requests(v["requests"], cfg.vocab_size, v["prompt_lens"],
                            v["new_tokens"], coe.expert_names(), 1.0,
                            v["seed"])
    done, wall, launches = drain(engine, reqs)
    st = engine.stats
    label = f"variants: {cfg.name} (plain body, sequential prefill)"
    served_ok(label, done, v["requests"], v["new_tokens"], cfg, engine)
    check_launches(label, launches,
                   {"flash_prefill": cfg.n_layers * v["requests"]})
    G = cfg.n_heads // cfg.n_kv_heads
    _log(f"{label}: {len(done)} requests, {st.tokens_out} tokens in "
         f"{wall:.3f}s = {st.tokens_out / wall:.2f} tok/s; "
         f"{ttft_line(done, st.registry)}; prefill_s={st.prefill_s:.3f} "
         f"{st.decode_rounds} decode rounds "
         f"({st.exec_s / st.decode_rounds * 1e3:.3f} ms a round); "
         f"flash_prefill at G {G}, dh {cfg.head_dim}: "
         f"{launches['flash_prefill']} launches")
    params = coe.cache.activate(coe.expert_names()[0])
    prompt = reqs[0].tokens
    rt.reset_launches()
    last = engine.runner.prefill_kv(
        params, torch.as_tensor(prompt[None], device=dev).long())[0]
    torch.cuda.synchronize()
    check_launches(f"{label} prefill_kv", rt.launch_counts(),
                   {"flash_prefill": cfg.n_layers})
    logits_check(f"{label}: prefill of one {len(prompt)}-token prompt "
                 "(flash_prefill) vs f32 plain forward", last,
                 plain_logits_f32(cfg, params, prompt, dev), tol_rel)
    del params, last
    coe.cache.close()
    return launches


def variants_phase(dev):
    """Each dense variant in turn, its expert released before the next:
    granite-8b on the fused kernels, then the four the kernels refuse on
    the plain body (qwen2.5-32b cut in depth). Returns ``{arch: launch
    counts}``."""
    import dataclasses

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    out = {"granite-8b": granite_phase(get_config("granite-8b"), dev)}
    for arch, layers in PLAIN_VARIANTS.items():
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        if layers is not None:
            _log(f"variants: {arch} cut to {layers} of its {cfg.n_layers} "
                 "layers, at full width")
            cfg = dataclasses.replace(cfg, n_layers=layers)
        out[arch] = plain_variant_phase(cfg, dev,
                                        VARIANT_PREFILL_LOGIT_TOL_REL[arch])
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"variants: phase {time.perf_counter() - t0:.1f}s")
    return out


def mixtral_kernel_row(dev):
    """``flash_prefill`` at Mixtral's heads (32 q on 8 kv heads of 128)
    against its plain version row by row with its off-by-one masks
    planted: at generate's prefill (B 2, S 4608, window 4096: a band past
    the window), beside SDPA with the band mask, and at the paged drain's
    sequential prefill (B 1, S 64 / 160 / 256, causal), beside SDPA."""
    from repro_torch.configs import get_config
    m = MIXTRAL
    gen = torch.Generator(device=dev).manual_seed(m["seed"])
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    c = get_config("mixtral-8x7b")
    rows = {MIXTRAL_ROW: prefill_row(MIXTRAL_ROW, c, m["prompts"],
                                     m["prompt_len"], c.sliding_window, gen,
                                     flush)}
    for S in B1_PREFILL_LENGTHS:
        r = prefill_row(f"flash_prefill[mixtral-8x7b,G=4,B=1,S={S}]", c, 1,
                        S, 0, gen, flush)
        if r["name"] == MIXTRAL_B1_ROW:
            rows[MIXTRAL_B1_ROW] = r
    del flush
    torch.cuda.empty_cache()
    return rows


def mixtral_generate(cfg, dev, coe):
    """Mixtral behind ``CompositionOfExperts.generate`` past its window,
    then the prefill and the decode alone (timed), the prefill's logits
    against the plain f32 forward over the same two rows, and one decode
    step past the ring's wrap against the teacher-forced windowed forward
    (both at capacity_factor 16). Returns generate's launch counts."""
    import dataclasses

    from repro_torch.kernels import runtime as rt
    from repro_torch.models import get_model
    m = MIXTRAL
    P, n_new, B = m["prompt_len"], m["new_tokens"], m["prompts"]
    W = cfg.sliding_window
    toks = np.random.RandomState(m["seed"]).randint(
        0, cfg.vocab_size, (B, P + 1)).astype(np.int32)
    torch.cuda.synchronize()
    rt.reset_launches()
    t0 = time.perf_counter()
    res = coe.generate(toks[:, :P], n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rt.launch_counts()
    check_launches("mixtral generate", launches,
                   {"flash_prefill": cfg.n_layers})
    if res.tokens.shape != (B, n_new):
        raise AssertionError(f"mixtral generate: tokens {res.tokens.shape}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError("mixtral generate: token out of vocabulary")
    _log(f"mixtral generate: {B} prompts x {P} tokens (window {W}) -> "
         f"{res.tokens.size} tokens in {wall:.3f}s = "
         f"{res.tokens.size / wall:.2f} tok/s; switch_s="
         f"{res.switch_seconds:.4f} exec_s={res.exec_seconds:.4f}; launches "
         f"flash_prefill={launches['flash_prefill']}")

    model = get_model(cfg)
    params = coe.cache.activate(cfg.name)
    tt = torch.as_tensor(toks[:, :P], device=dev).long()
    with routes_recorded() as got:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = model.prefill(params, {"tokens": tt}, P + n_new)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    ring = cache["k"].shape[2]
    ring_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    if ring != W:
        raise AssertionError(f"mixtral: ring of {ring} positions, not {W}")
    tok = last.argmax(-1)
    t0 = time.perf_counter()
    for t in range(n_new - 1):
        lg, cache = model.decode_step(params, cache, tok[:, None], P + t)
        tok = lg.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    _log(f"mixtral: prefill of {B} x {P} tokens in {prefill_s:.3f}s "
         f"({B * P / prefill_s:.0f} tok/s); {n_new - 1} decode steps past "
         f"the wrap in {decode_s:.3f}s = {decode_s / (n_new - 1) * 1e3:.2f} "
         f"ms a step, {B * (n_new - 1) / decode_s:.2f} tok/s; ring "
         f"{ring} positions, {ring_bytes / 1e6:.1f} MB (k + v, "
         f"{cfg.n_layers} layers)")
    step_breakdown(lambda: model.decode_step(params, cache, tok[:, None],
                                             P + n_new - 1),
                   f"mixtral decode step ({B} lanes, {cfg.n_layers} layers)")
    del cache
    with routes_forced(got) as ref:
        l32 = plain_last_logits_f32(cfg, params, toks[:, :P], dev)
    logits_check("mixtral prefill (flash_prefill, bf16 MoE at cf "
                 f"{cfg.capacity_factor}) vs f32 plain forward on its "
                 "routing, both rows", last, l32,
                 MIXTRAL_PREFILL_LOGIT_TOL_REL)
    router_check("mixtral prefill", got, MIXTRAL_ROUTER_TOL_REL)
    route_ties("mixtral prefill", got, ref, MIXTRAL_ROUTE_TIE_TOL_REL,
               cfg=cfg)
    del got, ref, l32

    # one step past the wrap against the teacher-forced windowed forward,
    # at capacity_factor 16: no assignment drops in either, so the step
    # (T 2) and the forward (T 4609 a row) compute the same function
    c16 = dataclasses.replace(cfg, capacity_factor=16.0)
    m16 = get_model(c16)
    _, cache = m16.prefill(params, {"tokens": tt}, P + 1)
    nxt = torch.as_tensor(toks[:, P:], device=dev).long()
    with routes_recorded() as got:
        lg, cache = m16.decode_step(params, cache, nxt, P)
    refs, ref_lg = [], []
    for b in range(B):
        with routes_recorded() as r:
            ref_lg.append(plain_last_logits_f32(c16, params, toks[b:b + 1],
                                                dev))
        refs.append(r)
    ref = [(torch.cat([r[i][0][-1:] for r in refs]),
            torch.cat([r[i][1][-1:] for r in refs]))
           for i in range(cfg.n_layers)]
    logits_check(f"mixtral decode step at position {P} (ring index "
                 f"{P % W}, cf 16) vs f32 teacher-forced windowed forward",
                 lg, torch.cat(ref_lg), MIXTRAL_STEP_LOGIT_TOL_REL)
    router_check("mixtral decode step", got, MIXTRAL_ROUTER_TOL_REL)
    route_ties("mixtral decode step", got, ref, MIXTRAL_ROUTE_TIE_TOL_REL,
               cfg=c16)
    del cache, params, got, ref, refs
    return launches


def mixtral_paged(cfg, dev, store, name):
    """Mixtral at window 0 on the plain paged body (``XlaPagedBackend``,
    named by the caller, as JAX's ``backend="xla"``) with sequential
    prefill and the default capacity: ``VARIANTS``' requests,
    ``flash_prefill`` once per layer a prompt and no other kernel; one
    prompt's ``prefill_kv`` logits against the plain f32 forward; one
    paged step's device time and idle share."""
    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import ServingEngine, XlaPagedBackend
    v = VARIANTS
    coe = CompositionOfExperts(HashRouter(1), None, store.nbytes(name),
                               store=store, device=dev)
    coe.register(ExpertHandle(name, cfg))           # already in the store
    engine = ServingEngine(coe, cfg, backend=XlaPagedBackend(cfg),
                           prefill_mode="sequential", max_len=v["max_len"],
                           n_slots=v["n_slots"], block_size=v["block_size"],
                           device=dev)
    reqs, _ = make_requests(v["requests"], cfg.vocab_size, v["prompt_lens"],
                            v["new_tokens"], coe.expert_names(), 1.0,
                            v["seed"])
    done, wall, launches = drain(engine, reqs)
    st = engine.stats
    label = (f"mixtral paged (plain body, sequential prefill, window 0, cf "
             f"{cfg.capacity_factor})")
    served_ok(label, done, v["requests"], v["new_tokens"], cfg, engine)
    check_launches(label, launches,
                   {"flash_prefill": cfg.n_layers * v["requests"]})
    _log(f"{label}: {len(done)} requests, {st.tokens_out} tokens in "
         f"{wall:.3f}s = {st.tokens_out / wall:.2f} tok/s; "
         f"{ttft_line(done, st.registry)}; prefill_s={st.prefill_s:.3f} "
         f"{st.decode_rounds} decode rounds "
         f"({st.exec_s / st.decode_rounds * 1e3:.3f} ms a round); "
         f"flash_prefill launches {launches['flash_prefill']}")
    params = coe.cache.activate(name)
    prompt = reqs[0].tokens
    rt.reset_launches()
    with routes_recorded() as got:
        last = engine.runner.prefill_kv(
            params, torch.as_tensor(prompt[None], device=dev).long())[0]
    torch.cuda.synchronize()
    check_launches(f"{label} prefill_kv", rt.launch_counts(),
                   {"flash_prefill": cfg.n_layers})
    with routes_forced(got) as ref:
        l32 = plain_logits_f32(cfg, params, prompt, dev)
    logits_check(f"{label}: prefill of one {len(prompt)}-token prompt "
                 "(flash_prefill) vs f32 plain forward on its routing",
                 last, l32, MIXTRAL_PAGED_LOGIT_TOL_REL)
    router_check(f"{label} prefill", got, MIXTRAL_ROUTER_TOL_REL)
    route_ties(f"{label} prefill", got, ref, MIXTRAL_ROUTE_TIE_TOL_REL,
               cfg=cfg)
    prefill_launches = launches["flash_prefill"] \
        + rt.launch_counts()["flash_prefill"]
    # a planted fault: the router's logits in bf16. The f32 reference,
    # forced to the faulty routing, takes its flips as its own; each check
    # reads it, and one of them must fail
    with router_in_bf16(), routes_recorded() as got_f:
        last_f = engine.runner.prefill_kv(
            params, torch.as_tensor(prompt[None], device=dev).long())[0]
    with routes_forced(got_f) as ref_f:
        l32_f = plain_logits_f32(cfg, params, prompt, dev)
    fault = f"{label}: planted bf16 router"
    caught = {
        "router_check": raised(lambda: router_check(
            fault, got_f, MIXTRAL_ROUTER_TOL_REL)),
        "route_ties": raised(lambda: route_ties(
            fault, got_f, ref_f, MIXTRAL_ROUTE_TIE_TOL_REL, cfg=cfg)),
        "logits_check": raised(lambda: logits_check(
            fault, last_f, l32_f, MIXTRAL_PAGED_LOGIT_TOL_REL))}
    _log(f"{fault}: caught by {[k for k, v in caught.items() if v]} of "
         f"{list(caught)}")
    if not any(caught.values()):
        raise AssertionError(f"{fault}: no check catches it")
    del got_f, ref_f, last_f, l32_f
    # one paged step of 8 lanes, each holding one of the requests' prompts
    pool, rids = engine.pool, list(range(20_000, 20_000 + v["n_slots"]))
    for rid, r in zip(rids, reqs):
        _, k, vv = engine.runner.prefill_kv(
            params, torch.as_tensor(r.tokens[None], device=dev).long())
        pool.open(rid)
        pool.append(rid, k, vv)
        pool.reserve(rid, 1)
    tables = torch.as_tensor(np.stack([pool.padded_table(
        r, engine.max_blocks) for r in rids]), device=dev)
    lengths = torch.as_tensor([pool.length(r) for r in rids],
                              dtype=torch.int32, device=dev)
    active = torch.ones(len(rids), dtype=torch.bool, device=dev)
    toks = torch.as_tensor([[int(r.tokens[-1])] for r in reqs[:len(rids)]],
                           device=dev)
    kc, vc = pool.k.clone(), pool.v.clone()
    step_breakdown(lambda: engine.runner.extend(params, kc, vc, tables,
                                                lengths, active, toks),
                   f"mixtral paged step ({len(rids)} lanes, "
                   f"{cfg.n_layers} layers, plain body)")
    del kc, vc, params, last, l32
    for r in rids:
        pool.free(r)
    coe.cache.close()
    return prefill_launches


def mixtral_phase(dev):
    """Mixtral-8x7B cut to 8 of its 32 layers at full width: one expert made
    on the card from a seed and kept in pinned host memory, behind
    ``generate`` (window 4096, HBM cache of one expert), then on the paged
    engine at window 0. Releases the expert at the end. Returns
    generate's launch counts."""
    import dataclasses

    from repro_torch.bridge import tree_bytes
    from repro_torch.configs import get_config
    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
    from repro_torch.models import get_model
    from repro_torch.store import HostMemoryStore
    m = MIXTRAL
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=m["layers"])
    t0 = time.perf_counter()
    params = get_model(cfg).init(
        torch.Generator(device=dev).manual_seed(m["seed"]), dev)
    nbytes = tree_bytes(params)
    store = HostMemoryStore()
    coe = CompositionOfExperts(HashRouter(1), None, nbytes, store=store,
                               device=dev)
    coe.register(ExpertHandle(cfg.name, cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"mixtral: {full.name} cut to {cfg.n_layers} of its "
         f"{full.n_layers} layers, at full width: D {cfg.d_model}, "
         f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of {cfg.head_dim}, "
         f"{cfg.n_experts} experts top-{cfg.top_k} of F {cfg.moe_d_ff}, "
         f"vocab {cfg.vocab_size}, window {cfg.sliding_window}; "
         f"{nbytes / 1e9:.2f} GB bf16 made and moved to pinned host memory "
         f"in {time.perf_counter() - t0:.1f}s")
    launches = mixtral_generate(cfg, dev, coe)
    coe.cache.close()
    gc.collect()
    torch.cuda.empty_cache()
    paged = mixtral_paged(dataclasses.replace(cfg, sliding_window=0), dev,
                          store, cfg.name)
    store.delete(cfg.name)
    del store, coe
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"mixtral: phase {time.perf_counter() - t0:.1f}s")
    return launches["flash_prefill"], paged


def deepseek_kernel_row(dev):
    """``flash_prefill`` at DeepSeek-V2-Lite's MLA prefill (B 4, S 2048, 16
    q on 16 kv heads, q / k of 192, v of 128, causal) against its plain
    version row by row, beside SDPA (is_causal), with the causal edge and
    the scale 1/sqrt(dv) planted in the plain version."""
    from repro_torch.configs import get_config
    d = DEEPSEEK
    gen = torch.Generator(device=dev).manual_seed(d["seed"])
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    r = prefill_row(DEEPSEEK_ROW, get_config("deepseek-v2-lite-16b"),
                    d["prompts"], d["prompt_len"], 0, gen, flush)
    del flush
    torch.cuda.empty_cache()
    return {DEEPSEEK_ROW: r}


@contextlib.contextmanager
def attention_checked():
    """Within the block, every prefill attention (``layers.attention``,
    one call a layer) is also computed by the plain version on the same
    inputs, and the largest row relative L2 error of the call's output
    against it is appended to the list the block receives. Nothing in the
    port is edited."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L
    real, errs = L.attention, []

    def checked(q, k, v, **kw):
        out = real(q, k, v, **kw)
        errs.append(row_rel_l2(out, attention_ref(q, k, v, **kw)))
        return out
    L.attention = checked
    try:
        yield errs
    finally:
        L.attention = real


@contextlib.contextmanager
def prefill_scale_planted(dk, dv):
    """Within the block, the prefill's attention runs the kernel at scale
    1/sqrt(dv) in place of 1/sqrt(dk) (q multiplied by sqrt(dk / dv) on its
    way in): a planted fault. Nothing in the port is edited."""
    import math

    from repro_torch.models import layers as L
    real = L.attention
    L.attention = lambda q, k, v, **kw: real(q * math.sqrt(dk / dv), k, v,
                                             **kw)
    try:
        yield
    finally:
        L.attention = real


def attention_check(label, errs, tol=PREFILL_ROW_REL_L2,
                    what="prefill attention at the model's inputs vs the "
                    "plain version"):
    """``errs``: one reading a layer from ``attention_checked`` (or
    ``decode_context_checked``, ``what`` saying so). Each within ``tol``;
    prints the widest."""
    worst = max(errs)
    _log(f"{label}: {what}, {len(errs)} layers: widest row relative L2 "
         f"error {worst:.3e} (layer {errs.index(worst)}; tol {tol:.3e})")
    if not worst <= tol:
        raise AssertionError(f"{label}: a layer's attention parts from its "
                             f"reference by {worst:.3e} > {tol:.3e}")


def mla_context_expanded(cfg, p, h, ckv_cache, krope_cache, pos):
    """The per-head context (B,H,dv) of the normed h (B,1,D) at ``pos``,
    in f32 and in the expanded form ``_mla_attn`` attends: K (nope + rope)
    and V per head from the latent entries, over the layer caches' first
    ``pos`` entries and this token's c_kv and k_rope, computed here (the
    absorbed step's own write is not read)."""
    import math

    from repro_torch.models import layers as L
    nope, rope, lora = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    hf = h[:, 0].float()                                       # (B,D)
    posv = torch.full((hf.shape[0], 1), pos, dtype=torch.long,
                      device=h.device)
    q = torch.einsum("bd,dhk->bhk", hf, p["wq"].float())
    q_rope = L.apply_rope(cfg, q[:, None, :, nope:], posv)[:, 0]
    ckv_full = hf @ p["w_dkv"].float()
    c_new = L.rms_norm(ckv_full[:, :lora], p["kv_norm"]["scale"].float())
    kr_new = L.apply_rope(cfg, ckv_full[:, None, None, lora:], posv)[:, 0, 0]
    c = torch.cat([ckv_cache[:, :pos].float(), c_new[:, None]], 1)
    kr = torch.cat([krope_cache[:, :pos].float(), kr_new[:, None]], 1)
    k_nope = torch.einsum("bsc,chk->bshk", c, p["w_uk"].float())
    v = torch.einsum("bsc,chv->bshv", c, p["w_uv"].float())
    s = (torch.einsum("bhk,bshk->bhs", q[..., :nope], k_nope)
         + torch.einsum("bhr,bsr->bhs", q_rope, kr))
    w = torch.softmax(s / math.sqrt(nope + rope), dim=-1)
    return torch.einsum("bhs,bshv->bhv", w, v)


@contextlib.contextmanager
def decode_context_checked():
    """Within the block, every absorbed MLA decode (``_mla_decode_context``,
    one call a layer) is also computed by ``mla_context_expanded`` on the
    same inputs, and the largest row relative L2 error of its per-head
    context against that is appended to the list the block receives.
    Nothing in the port is edited."""
    from repro_torch.models import transformer as T
    real, errs = T._mla_decode_context, []

    def checked(cfg, p, h, ckv_cache, krope_cache, pos):
        out = real(cfg, p, h, ckv_cache, krope_cache, pos)
        errs.append(row_rel_l2(out, mla_context_expanded(
            cfg, p, h, ckv_cache, krope_cache, pos)))
        return out
    T._mla_decode_context = checked
    try:
        yield errs
    finally:
        T._mla_decode_context = real


@contextlib.contextmanager
def decode_scale_planted(dk, nope):
    """Within the block, the absorbed decode scores at 1/sqrt(nope) in
    place of 1/sqrt(dk) (W_Q multiplied by sqrt(dk / nope) on its way in):
    a planted fault. Nothing in the port is edited."""
    import math

    from repro_torch.models import transformer as T
    real, c = T._mla_decode_context, math.sqrt(dk / nope)
    T._mla_decode_context = lambda cfg, p, *a: real(
        cfg, {**p, "wq": p["wq"] * c}, *a)
    try:
        yield
    finally:
        T._mla_decode_context = real


def deepseek_generate(cfg, dev, coe):
    """DeepSeek behind ``CompositionOfExperts.generate``, then the prefill
    and the decode alone (timed), the prefill's logits against the plain
    f32 forward over the same rows and its attention layer by layer
    against the plain version, one absorbed decode step against the
    teacher-forced f32 forward (at capacity_factor 16), and the prefill's
    kernel planted at scale 1/sqrt(dv). Returns generate's launch
    counts."""
    import dataclasses

    from repro_torch.kernels import runtime as rt
    from repro_torch.models import get_model
    d = DEEPSEEK
    P, n_new, B = d["prompt_len"], d["new_tokens"], d["prompts"]
    toks = np.random.RandomState(d["seed"]).randint(
        0, cfg.vocab_size, (B, P + 1)).astype(np.int32)
    torch.cuda.synchronize()
    rt.reset_launches()
    t0 = time.perf_counter()
    res = coe.generate(toks[:, :P], n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rt.launch_counts()
    check_launches("deepseek generate", launches,
                   {"flash_prefill": cfg.n_layers})
    if res.tokens.shape != (B, n_new):
        raise AssertionError(f"deepseek generate: tokens {res.tokens.shape}")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError("deepseek generate: token out of vocabulary")
    _log(f"deepseek generate: {B} prompts x {P} tokens -> "
         f"{res.tokens.size} tokens in {wall:.3f}s = "
         f"{res.tokens.size / wall:.2f} tok/s; switch_s="
         f"{res.switch_seconds:.4f} exec_s={res.exec_seconds:.4f}; launches "
         f"flash_prefill={launches['flash_prefill']}, no other kernel")

    model = get_model(cfg)
    params = coe.cache.activate(cfg.name)
    tt = torch.as_tensor(toks[:, :P], device=dev).long()
    with routes_recorded() as got:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = model.prefill(params, {"tokens": tt}, P + n_new)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    tok = last.argmax(-1)
    t0 = time.perf_counter()
    for t in range(n_new - 1):
        lg, cache = model.decode_step(params, cache, tok[:, None], P + t)
        tok = lg.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    _log(f"deepseek: prefill of {B} x {P} tokens in {prefill_s:.3f}s "
         f"({B * P / prefill_s:.0f} tok/s); {n_new - 1} absorbed decode "
         f"steps in {decode_s:.3f}s = {decode_s / (n_new - 1) * 1e3:.2f} ms "
         f"a step, {B * (n_new - 1) / decode_s:.2f} tok/s; latent cache "
         f"{cache_bytes / 1e9:.4f} GB (c_kv {cfg.kv_lora_rank} + k_rope "
         f"{cfg.qk_rope_dim} a position, {cfg.n_layers} layers, "
         f"{B} x {P + n_new} positions)")
    step_breakdown(lambda: model.decode_step(params, cache, tok[:, None],
                                             P + n_new - 1),
                   f"deepseek decode step ({B} lanes, {cfg.n_layers} "
                   "layers)")
    del cache
    with routes_forced(got) as ref:
        l32 = plain_last_logits_f32(cfg, params, toks[:, :P], dev)
    label = (f"deepseek prefill (flash_prefill at dk 192, dv 128; bf16 MoE "
             f"at cf {cfg.capacity_factor}) vs f32 plain forward on its "
             "routing, all rows")
    logits_check(label, last, l32, DEEPSEEK_PREFILL_LOGIT_TOL_REL)
    router_check("deepseek prefill", got, MIXTRAL_ROUTER_TOL_REL)
    route_ties("deepseek prefill", got, ref, DEEPSEEK_ROUTE_TIE_TOL_REL,
               cfg=cfg)
    with attention_checked() as errs:
        model.prefill(params, {"tokens": tt}, P)
    attention_check("deepseek prefill", errs)
    # a planted fault: the prefill's kernel at scale 1/sqrt(dv); the f32
    # reference, forced to the faulty path's routing, stays unplanted
    dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    with prefill_scale_planted(dk, dv), routes_recorded() as got_f:
        last_f, _ = model.prefill(params, {"tokens": tt}, P)
    with routes_forced(got_f):
        l32_f = plain_last_logits_f32(cfg, params, toks[:, :P], dev)
    with prefill_scale_planted(dk, dv), attention_checked() as errs_f:
        model.prefill(params, {"tokens": tt}, P)
    fault = "deepseek prefill: planted scale 1/sqrt(dv)"
    caught = {
        "logits_check": raised(lambda: logits_check(
            fault, last_f, l32_f, DEEPSEEK_PREFILL_LOGIT_TOL_REL)),
        "attention_check": raised(lambda: attention_check(fault, errs_f))}
    _log(f"{fault}: caught by {[k for k, v in caught.items() if v]} of "
         f"{list(caught)}")
    if not any(caught.values()):
        raise AssertionError(f"{fault}: no check catches it")
    del got, ref, l32, got_f, last_f, l32_f

    # one absorbed step against the teacher-forced f32 forward over S + 1,
    # at capacity_factor 16: no assignment drops in either, so the step
    # (T 4) and the forward (T 2049 a row) compute the same function
    c16 = dataclasses.replace(cfg, capacity_factor=16.0)
    m16 = get_model(c16)
    _, cache = m16.prefill(params, {"tokens": tt}, P + 1)
    nxt = torch.as_tensor(toks[:, P:], device=dev).long()
    with routes_recorded() as got, decode_context_checked() as errs:
        lg, cache = m16.decode_step(params, cache, nxt, P)
    # a planted fault: the absorbed scores at 1/sqrt(nope), the step run
    # again on the same cache (each layer rewrites its entry at P)
    with decode_scale_planted(dk, cfg.qk_nope_dim), \
            decode_context_checked() as errs_f:
        lg_f, cache = m16.decode_step(params, cache, nxt, P)
    del cache
    refs, ref_lg = [], []
    for b in range(B):
        with routes_recorded() as r:
            ref_lg.append(plain_last_logits_f32(c16, params, toks[b:b + 1],
                                                dev))
        refs.append(r)
    ref = [(torch.cat([r[i][0][-1:] for r in refs]),
            torch.cat([r[i][1][-1:] for r in refs]))
           for i in range(len(got))]
    logits_check(f"deepseek absorbed decode step at position {P} (cf 16) "
                 "vs f32 teacher-forced expanded forward", lg,
                 torch.cat(ref_lg), DEEPSEEK_STEP_LOGIT_TOL_REL)
    router_check("deepseek decode step", got, MIXTRAL_ROUTER_TOL_REL)
    route_ties("deepseek decode step", got, ref, DEEPSEEK_ROUTE_TIE_TOL_REL,
               cfg=c16)
    what = ("absorbed latent context at the model's inputs vs the f32 "
            "expanded form")
    attention_check("deepseek decode step", errs, DEEPSEEK_CTX_ROW_REL_L2,
                    what)
    fault = "deepseek decode step: planted scale 1/sqrt(nope)"
    caught = {
        "logits_check": raised(lambda: logits_check(
            fault, lg_f, torch.cat(ref_lg), DEEPSEEK_STEP_LOGIT_TOL_REL)),
        "context_check": raised(lambda: attention_check(
            fault, errs_f, DEEPSEEK_CTX_ROW_REL_L2, what))}
    _log(f"{fault}: caught by {[k for k, v in caught.items() if v]} of "
         f"{list(caught)}")
    if not caught["context_check"]:
        raise AssertionError(f"{fault}: the context check misses it")
    del params, got, ref, refs, lg_f
    return launches


def release_pinned():
    """Hand the pinned host blocks that PyTorch's caching host allocator
    keeps after their tensors are freed back to the system. It rounds each
    pinned allocation up to a power of two and keeps it for reuse, so the
    earlier phases' experts hold host memory past their release, and
    DeepSeek's 31.4 GB take 55.5 GB of blocks (its three stacked expert
    weights, 9.6 GB each, 16 GiB blocks). Returns whether this PyTorch
    offers the call."""
    gc.collect()
    fn = getattr(torch._C, "_host_emptyCache", None)
    if fn is not None:
        fn()
    return fn is not None


def deepseek_phase(dev):
    """DeepSeek-V2-Lite at full width and depth: one expert made on the
    card from a seed and kept in pinned host memory, behind ``generate``
    (an HBM cache of one expert). Releases the expert at the end. Returns
    generate's ``flash_prefill`` launches."""
    from repro_torch.bridge import tree_bytes
    from repro_torch.configs import get_config
    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
    from repro_torch.models import get_model
    from repro_torch.store import HostMemoryStore
    cfg = get_config("deepseek-v2-lite-16b")
    if not release_pinned():
        _log("deepseek: this PyTorch cannot release cached pinned blocks")
    t0 = time.perf_counter()
    params = get_model(cfg).init(
        torch.Generator(device=dev).manual_seed(DEEPSEEK["seed"]), dev)
    nbytes = tree_bytes(params)
    store = HostMemoryStore()
    coe = CompositionOfExperts(HashRouter(1), None, nbytes, store=store,
                               device=dev)
    coe.register(ExpertHandle(cfg.name, cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"deepseek: {cfg.name} at full width and depth: {cfg.n_layers} "
         f"layers ({cfg.first_dense_layers} dense of F {cfg.d_ff}, then "
         f"{cfg.n_experts} experts top-{cfg.top_k} of F {cfg.moe_d_ff} and "
         f"{cfg.n_shared_experts} shared), D {cfg.d_model}, {cfg.n_heads} "
         f"heads, MLA rank {cfg.kv_lora_rank}, q / k "
         f"{cfg.qk_nope_dim}+{cfg.qk_rope_dim}, v {cfg.v_head_dim}, vocab "
         f"{cfg.vocab_size}; {nbytes / 1e9:.2f} GB bf16 made and moved to "
         f"pinned host memory in {time.perf_counter() - t0:.1f}s")
    launches = deepseek_generate(cfg, dev, coe)
    coe.cache.close()
    store.delete(cfg.name)
    del store, coe
    release_pinned()
    torch.cuda.empty_cache()
    _log(f"deepseek: phase {time.perf_counter() - t0:.1f}s")
    return launches["flash_prefill"]


def whisper_row(row, c, B, Sq, Sk, gen, flush):
    """``flash_prefill`` at Whisper's heads on random bf16 q (B, Sq) and k
    / v (B, Sk), not causal, against its plain version row by row, beside
    SDPA; the keys past the last whole 64-key tile dropped in the plain
    version (the tail fault) must fail the row check. Returns the
    kernel-table row."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention.ops import (attention,
                                                         attention_cost)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev = flush.device
    H, dh = c.n_heads, c.head_dim
    q = torch.randn((B, Sq, H, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((B, Sk, H, dh), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops, nbytes = attention_cost(B, Sq, Sk, H, H, dh, dh, causal=False)
    r = kernel_row(
        row, lambda: attention(q, k, v, causal=False),
        lambda: attention_ref(q, k, v, causal=False),
        lambda: Fn.scaled_dot_product_attention(qt, kt, vt), nbytes, flops,
        flush, kernel="flash_prefill", row_tol=PREFILL_ROW_REL_L2)
    _log(f"kernel {row}: {flops / r['ms'] / 1e9:.1f} TFLOP/s, "
         f"{r['bound_ms'] / r['ms']:.3f} of the bound; SDPA "
         f"{r['library_ms']:.4f} ms ({r['library_ms'] / r['ms']:.3f}x "
         "the kernel's time)")
    cut = Sk // 64 * 64
    m_err = row_rel_l2(attention_ref(q, k[:, :cut], v[:, :cut],
                                     causal=False),
                       attention_ref(q, k, v, causal=False))
    _log(f"kernel {row}: planted keys cut at {cut} of {Sk}: row relative "
         f"L2 error {m_err:.3e} "
         f"{'caught' if m_err > PREFILL_ROW_REL_L2 else 'NOT caught'}")
    if not m_err > PREFILL_ROW_REL_L2:
        raise AssertionError(f"{row}: the row check misses the keys cut "
                             f"at {cut}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return r


def whisper_kernel_rows(dev):
    """``flash_prefill`` at Whisper-small's three attention shapes (8
    lanes, 12 heads of 64): the encoder (S 1500), the teacher-forced
    cross-attention (Sq 448, Sk 1500) and the prefill's (Sq 4)."""
    from repro_torch.configs import get_config
    w, c = WHISPER, get_config("whisper-small")
    gen = torch.Generator(device=dev).manual_seed(w["seed"])
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    B, Se = w["lanes"], c.encoder_seq
    rows = {WHISPER_ROWS[key]: whisper_row(WHISPER_ROWS[key], c, B, Sq, Se,
                                           gen, flush)
            for key, Sq in (("enc", Se), ("cross", w["target_len"]),
                            ("cross4", w["prompt_len"]))}
    del flush
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def attention_shapes():
    """Within the block, every prefill attention (``layers.attention``)
    appends its (Sq, Sk, causal) to the list the block receives. Nothing
    in the port is edited."""
    from repro_torch.models import layers as L
    real, shapes = L.attention, []

    def recorded(q, k, v, **kw):
        shapes.append((q.shape[1], k.shape[1], bool(kw.get("causal", True))))
        return real(q, k, v, **kw)
    L.attention = recorded
    try:
        yield shapes
    finally:
        L.attention = real


@contextlib.contextmanager
def cross_tail_planted(cut):
    """Within the block, every cross-attention (a ``layers.attention`` call
    whose keys outnumber or fall short of its queries) attends only its
    first ``cut`` keys: a planted fault. Nothing in the port is edited."""
    from repro_torch.models import layers as L
    real = L.attention

    def planted(q, k, v, **kw):
        if k.shape[1] != q.shape[1]:
            k, v = k[:, :cut], v[:, :cut]
        return real(q, k, v, **kw)
    L.attention = planted
    try:
        yield
    finally:
        L.attention = real


def whisper_greedy(model, params, batch, n_new):
    """``prefill`` of ``batch`` (frames and a decoder prompt), then ``n_new
    - 1`` greedy ``decode_step``s. Returns (the logits of each chosen
    token (B, n_new, V): the prefill's last, then each step's; the tokens
    (B, n_new))."""
    B, P = batch["tokens"].shape
    last, cache = model.prefill(params, batch, P + n_new)
    tok = last.argmax(-1)
    logits, toks = [last], [tok]
    for t in range(n_new - 1):
        lg, cache = model.decode_step(params, cache, tok[:, None], P + t)
        tok = lg.argmax(-1)
        logits.append(lg)
        toks.append(tok)
    return torch.stack(logits, 1), torch.stack(toks, 1)


def plain_f32_forward(cfg, params, batch):
    """The family's ``forward`` in f32: the bf16 weights upcast, prefill
    attention the quadratic oracle."""
    from repro_torch.bridge import tree_map
    from repro_torch.models import get_model
    with torch.no_grad(), plain_prefill():
        return get_model(cfg).forward(
            tree_map(lambda t: t.float(), params), batch)


def whisper_phase(dev):
    """Whisper-small at full width and depth through the model API: 8
    lanes of 1500 seeded frame embeddings, a 4-token prompt, ``prefill``
    (``flash_prefill`` once per attention: 12 encoder, 12 decoder self, 12
    cross at Sq 4) and 59 greedy ``decode_step``s (plain attention, as
    JAX's XLA: no kernel); then a teacher-forced ``forward`` over 448
    target tokens (36 more: the cross-attention at Sq 448). Checks the
    prefill's and the steps' logits against the f32 plain forward over the
    tokens fed back, the forward's against its f32 plain forward, each
    attention at the model's inputs against the plain version in both,
    and the cross-attention's keys cut at 1472 of 1500 (planted) caught
    there. Returns {row name: launches}."""
    from repro_torch.bridge import tree_bytes
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime as rt
    from repro_torch.models import encdec as E
    from repro_torch.models import get_model
    w = WHISPER
    cfg = get_config("whisper-small")
    model = get_model(cfg)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(w["seed"])
    params = model.init(gen, dev)
    B, P, n_new, Se = w["lanes"], w["prompt_len"], w["new_tokens"], \
        cfg.encoder_seq
    enc = torch.randn((B, Se, cfg.d_model), generator=gen, device=dev)
    rs = np.random.RandomState(w["seed"])
    prompt = torch.as_tensor(rs.randint(0, cfg.vocab_size, (B, P)),
                             device=dev).long()
    target = torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                        (B, w["target_len"])),
                             device=dev).long()
    batch = {"enc_embeds": enc, "tokens": prompt}
    _log(f"whisper: {cfg.name} at full width and depth: "
         f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, D "
         f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, vocab "
         f"{cfg.vocab_size}; {tree_bytes(params) / 1e9:.3f} GB bf16; {B} "
         f"lanes of {Se} frame embeddings (the frontend a stub)")
    whisper_greedy(model, params, batch, 2)            # warm-up
    torch.cuda.synchronize()

    # the main path: prefill and greedy steps, launches counted
    rt.reset_launches()
    with attention_shapes() as shapes:
        t0 = time.perf_counter()
        steps, out = whisper_greedy(model, params, batch, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = rt.launch_counts()
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    check_launches("whisper prefill + decode", launches,
                   {"flash_prefill": n_attn})
    if len(shapes) != n_attn:
        raise AssertionError(f"whisper: {len(shapes)} attention calls")
    if out.shape != (B, n_new) or not ((out >= 0)
                                       & (out < cfg.vocab_size)).all():
        raise AssertionError(f"whisper: tokens {tuple(out.shape)} or out of "
                             "vocabulary")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(5):
        E.encode(cfg, params, enc)
    ev[1].record()
    torch.cuda.synchronize()
    enc_ms = ev[0].elapsed_time(ev[1]) / 5
    t0 = time.perf_counter()
    _, cache = model.prefill(params, batch, P + n_new)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    _log(f"whisper: encode {enc_ms:.3f} ms ({B} x {Se} frames, device "
         f"time); prefill {prefill_s:.4f}s; prefill + {n_new - 1} decode "
         f"steps {wall:.3f}s = {B * n_new / wall:.2f} tok/s; launches "
         f"flash_prefill={launches['flash_prefill']} (encoder "
         f"{cfg.n_encoder_layers}, decoder self {cfg.n_layers}, cross "
         f"{cfg.n_layers}), no other kernel")
    tok = out[:, -1:]
    step_breakdown(lambda: model.decode_step(params, cache, tok, P + n_new
                                             - 1),
                   f"whisper decode step ({B} lanes, {cfg.n_layers} decoder "
                   f"layers, cross over {Se} frames)")
    del cache

    # the prefill and the steps against the f32 plain forward over the
    # prompt and the tokens fed back
    ref = plain_f32_forward(cfg, params, {
        "enc_embeds": enc, "tokens": torch.cat([prompt, out[:, :-1]], 1)})
    logits_check("whisper prefill (flash_prefill) vs f32 plain forward, "
                 "last prompt position", steps[:, 0], ref[:, P - 1],
                 WHISPER_PREFILL_LOGIT_TOL_REL)
    logits_check(f"whisper {n_new - 1} decode steps vs f32 teacher-forced "
                 "plain forward", steps[:, 1:], ref[:, P:],
                 WHISPER_STEP_LOGIT_TOL_REL)
    del ref, steps
    with attention_checked() as errs:
        model.prefill(params, batch, P + n_new)
    attention_check("whisper prefill", errs)
    cut = Se // 64 * 64
    fault = f"whisper prefill: planted cross-attention keys cut at {cut}"
    with cross_tail_planted(cut), attention_checked() as errs_f:
        model.prefill(params, batch, P + n_new)
    if not raised(lambda: attention_check(fault, errs_f)):
        raise AssertionError(f"{fault}: the attention check misses it")
    _log(f"{fault}: caught by the attention check")

    # the teacher-forced forward over Whisper's longest target
    tb = {"enc_embeds": enc, "tokens": target}
    model.forward(params, tb)
    torch.cuda.synchronize()
    rt.reset_launches()
    with attention_shapes() as f_shapes:
        t0 = time.perf_counter()
        lg = model.forward(params, tb)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    f_launches = rt.launch_counts()
    check_launches("whisper teacher-forced forward", f_launches,
                   {"flash_prefill": n_attn})
    _log(f"whisper: teacher-forced forward over {B} x {w['target_len']} "
         f"tokens in {fwd_s:.4f}s; launches "
         f"flash_prefill={f_launches['flash_prefill']}")
    logits_check(f"whisper teacher-forced forward ({w['target_len']} "
                 "tokens) vs f32 plain forward, every position", lg,
                 plain_f32_forward(cfg, params, tb),
                 WHISPER_FORWARD_LOGIT_TOL_REL)
    del lg
    with attention_checked() as errs:
        model.forward(params, tb)
    attention_check("whisper teacher-forced forward", errs)
    shapes = shapes + f_shapes
    counts = {WHISPER_ROWS["enc"]: shapes.count((Se, Se, False)),
              WHISPER_ROWS["cross"]: shapes.count((w["target_len"], Se,
                                                   False)),
              WHISPER_ROWS["cross4"]: shapes.count((P, Se, False))}
    del params, enc
    torch.cuda.empty_cache()
    _log(f"whisper: phase {time.perf_counter() - t_phase:.1f}s; row "
         f"launches {counts}")
    return counts


def rel_l2(got, want):
    """||got - want|| / ||want|| over the whole tensor."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


# the xLSTM functions the checks tap (``xlstm_patched``)
XLSTM_FNS = ("mlstm_block", "slstm_apply", "mlstm_chunkwise")


@contextlib.contextmanager
def xlstm_patched(wrap):
    """Within the block, each of ``XLSTM_FNS`` in ``models/xlstm.py`` is
    ``wrap(name, real)`` (the model looks them up on every call); the
    real ones are back after it. Nothing in the port is edited."""
    from repro_torch.models import xlstm as X
    real = {n: getattr(X, n) for n in XLSTM_FNS}
    for n, f in real.items():
        setattr(X, n, wrap(n, f))
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(X, n, f)


def _f32(t):
    from repro_torch.bridge import tree_map
    return None if t is None else tree_map(lambda a: a.float(), t)


def _state_err(st, st32):
    """The widest relative L2 error over a block's new state (the conv
    window aside: it is the input's last positions, held by the update)."""
    return max(rel_l2(st[k], st32[k]) for k in st if k != "conv")


def mlstm_parallel64(q, k, v, ilog, flog, state):
    """The mLSTM over every position of q / k / v (B,S,H,dh) from
    ``state`` (None: zeros) in its parallel form, in f64, the plain
    version of the chunkwise pass: (h (B,S,H,dh), C after the last
    position). With F the cumulative log forget gates and q scaled by
    1/sqrt(dh): C_t = e^{F_t} C_0 + sum_{j<=t} e^{F_t - F_j + i_j} k_j v_j^T,
    n_t likewise, h_t = q_t C_t / max(|q_t . n_t|, 1)."""
    B, S, H, dh = q.shape
    qd = q.double() / math.sqrt(dh)
    kd, vd = k.double(), v.double()
    F = torch.cumsum(flog.double(), 1)                     # (B,S,H)
    g = ilog.double() - F
    tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    w = torch.where(tri[None, :, :, None],
                    torch.exp(F[:, :, None] + g[:, None]), 0.0)
    s = torch.einsum("bthd,bjhd->btjh", qd, kd) * w
    num = torch.einsum("btjh,bjhe->bthe", s, vd)
    den = s.sum(2)
    wS = torch.exp(F[:, -1:] + g)                          # (B,S,H)
    C = torch.einsum("bjh,bjhd,bjhe->bhde", wS, kd, vd)
    if state is not None:
        dec = torch.exp(F)
        num = num + dec[..., None] * torch.einsum(
            "bthd,bhde->bthe", qd, state["C"].double())
        den = den + dec * torch.einsum("bthd,bhd->bth", qd,
                                       state["n"].double())
        C = C + torch.exp(F[:, -1])[..., None, None] * state["C"].double()
    return num / torch.clamp_min(den.abs(), 1.0)[..., None], C


def mlstm_recurrence(q, k, v, ilog, flog, state):
    """The mLSTM step recurrence (``xlstm.mlstm_step``) in f32 over every
    position of q / k / v (B,S,H,dh) from ``state`` (None: zeros):
    (h (B,S,H,dh), the state after the last position)."""
    from repro_torch.models import xlstm as X
    B, S, H, dh = q.shape
    st = state if state is not None else {
        "C": torch.zeros((B, H, dh, dh), device=q.device),
        "n": torch.zeros((B, H, dh), device=q.device)}
    hs = []
    for t in range(S):
        h, st = X.mlstm_step(q[:, t].float(), k[:, t].float(),
                             v[:, t].float(), ilog[:, t], flog[:, t], st)
        hs.append(h)
    return torch.stack(hs, 1), st


@contextlib.contextmanager
def xlstm_blocks_checked(faults=None):
    """Within the block, the model's xLSTM blocks are held at their own
    inputs, one entry a call appended to the list the block receives:
    each block (``mlstm_block``, ``slstm_apply``) against the same block
    in f32 on the same input and state, weights upcast: (kind, the
    update's relative L2 error, the new state's widest); each chunkwise
    mLSTM pass (``mlstm_chunkwise``, f32 by the config) over its first
    ``XLSTM["check_len"]`` positions against its parallel form in f64
    (``mlstm_parallel64``) from the same q / k / v, gates and state:
    ("core", h's largest row relative L2 error, C's relative L2 error);
    the first of them also against the step recurrence in f32 ("step",
    JAX's tests/test_substrate.py chunkwise-against-step check at the
    model's inputs). The f32 block references cannot see the core's
    precision (they differ from the model by the bf16 rounding of q / k /
    v already), these two can. ``faults`` maps a name of ``XLSTM_FNS`` to a
    stand-in ``fault(real, *args)`` run in the model's place, never in a
    reference's, to plant a fault that these checks must catch."""
    faults, errs, in_ref = faults or {}, [], [False]
    n_chk = XLSTM["check_len"]

    def wrap(name, real):
        def run(*a):
            if in_ref[0]:
                return real(*a)
            fn = (lambda *b: faults[name](real, *b)) if name in faults \
                else real
            out = fn(*a)
            in_ref[0] = True
            try:
                if name == "mlstm_chunkwise":
                    q, k, v, il, fl = a[:5]
                    st0 = a[5] if len(a) > 5 else None
                    n = min(q.shape[1], n_chk)
                    cut = [t[:, :n] for t in (q, k, v, il, fl)]
                    hs, C = mlstm_parallel64(*cut, st0)
                    _, st_c = out if n == q.shape[1] else fn(*cut, st0)
                    errs.append(("core", row_rel_l2(out[0][:, :n], hs),
                                 rel_l2(st_c["C"], C)))
                    if not any(e[0] == "step" for e in errs):
                        hs, st = mlstm_recurrence(*cut, st0)
                        errs.append(("step",
                                     row_rel_l2(out[0][:, :n], hs),
                                     rel_l2(st_c["C"], st["C"])))
                else:
                    cfg, p, x = a[:3]
                    y, st = out
                    y32, st32 = real(cfg, _f32(p), x.float(),
                                     _f32(a[3] if len(a) > 3 else None))
                    errs.append((name.split("_")[0],
                                 rel_l2(y - x, y32 - x.float()),
                                 _state_err(st, st32)))
            finally:
                in_ref[0] = False
            return out
        return run
    with xlstm_patched(wrap):
        yield errs


def blocks_check(label, errs, tol=XLSTM_BLOCK_TOL_REL,
                 core_tol=XLSTM_CHUNK_REL_TOL):
    """``errs`` from ``xlstm_blocks_checked`` or
    ``xlstm_teacher_forced``: each block within ``tol``, each chunkwise
    core (against either reference) within ``core_tol``; prints the
    widest of each kind."""
    worst = 0.0
    whats = {"core": "chunkwise cores vs their f64 parallel form",
             "step": "chunkwise core vs the f32 step recurrence"}
    for kind in ("mlstm", "slstm", "core", "step"):
        e = [(u, s_) for k, u, s_ in errs if k == kind]
        if not e:
            continue
        t = core_tol if kind in whats else tol
        what = (whats[kind] + ": widest h row relative L2 {:.3e}, widest "
                "C {:.3e}") if kind in whats \
            else (kind + " blocks vs f32: widest update relative L2 "
                  "{:.3e}, widest state {:.3e}")
        _log(f"{label}: {len(e)} " + what.format(max(u for u, _ in e),
                                                max(s_ for _, s_ in e))
             + f" (tol {t:.3e})")
        worst = max(worst, max(max(u, s_) for u, s_ in e) / t)
    if not worst <= 1.0:
        raise AssertionError(f"{label}: a block parts from its reference "
                             f"by {worst:.2f}x its limit")


def expect_caught(label, check):
    """A fault planted in the model's run must fail ``check``."""
    try:
        check()
    except AssertionError as e:
        _log(f"{label}: caught ({e})")
        return
    raise AssertionError(f"{label}: the check missed a planted fault")


def xlstm_decode_tapped(model, params, st, tok, pos, n_steps, faults=None):
    """``n_steps`` greedy decode steps from state ``st`` and token ``tok``
    at ``pos``, every block call tapped: ``faults`` as in
    ``xlstm_blocks_checked`` (blocks only). Returns (the logits of each
    step, the tokens fed, the taps: per call [kind, params, input, state
    before (the first step's only), output, state after (the last
    step's only)])."""
    faults, taps, logits, fed = faults or {}, [], [], []

    def wrap(name, real):
        if name == "mlstm_chunkwise":
            return real

        def run(cfg, p, x, state):
            y, new = (faults[name](real, cfg, p, x, state) if name in faults
                      else real(cfg, p, x, state))
            taps.append([name.split("_")[0], p, x, state, y, new])
            return y, new
        return run
    with xlstm_patched(wrap), torch.no_grad():
        for t in range(n_steps):
            n0 = len(taps)
            fed.append(tok)
            lg, st = model.decode_step(params, st, tok[:, None], pos + t)
            tok = lg.argmax(-1)
            logits.append(lg)
            if t:
                # keep the first step's states before and the last's after
                for r, prev in zip(taps[n0:], taps[2 * n0 - len(taps):n0]):
                    r[3], prev[5] = None, None
    return logits, fed, taps


def xlstm_teacher_forced(cfg, taps, n_steps):
    """Each block's outputs over the decode steps tapped by
    ``xlstm_decode_tapped`` and its state after the last, against the same
    block in f32 (weights upcast) run over the steps' inputs as one chunk
    from its state before the first step: the blocks teacher-forced at the
    model's inputs, so a state carried wrongly from step to step, or from
    the prefill into the steps, shows at full width. (kind, the updates'
    relative L2 error, the final state's widest) a block."""
    from repro_torch.models import xlstm as X
    nb = len(taps) // n_steps
    if nb * n_steps != len(taps):
        raise AssertionError(f"xlstm: {len(taps)} block calls in {n_steps} "
                             "decode steps")
    errs = []
    with torch.no_grad():
        for i in range(nb):
            rs = taps[i::nb]
            kind, p, st0 = rs[0][0], rs[0][1], rs[0][3]
            xs = torch.cat([r[2] for r in rs], 1)
            ys = torch.cat([r[4] for r in rs], 1)
            fn = X.mlstm_block if kind == "mlstm" else X.slstm_apply
            y32, st32 = fn(cfg, _f32(p), xs.float(), _f32(st0))
            errs.append((kind, rel_l2(ys - xs, y32 - xs.float()),
                         _state_err(rs[-1][5], st32)))
    return errs


def _chunkwise_autocast(real, *a):
    """A planted fault: the chunkwise mLSTM's products in bf16 (under
    autocast), although the config computes it in f32."""
    with torch.autocast(a[0].device.type, dtype=torch.bfloat16):
        h, st = real(*a)
    return h.float(), {k: v.float() for k, v in st.items()}


# planted in the decode steps: the conv window and the sLSTM state not
# carried from step to step
XLSTM_CARRY_FAULTS = {
    "mlstm_block": lambda real, cfg, p, x, s: real(
        cfg, p, x, {**s, "conv": torch.zeros_like(s["conv"])}),
    "slstm_apply": lambda real, cfg, p, x, s: real(cfg, p, x, None),
}


def xlstm_phase(dev):
    """xLSTM-1.3B at full width and depth as the one expert of
    ``CompositionOfExperts(HashRouter(1))`` (a pinned host store, an HBM
    cache of one): ``generate`` on 4 prompts of 2048 tokens, 32 new (no
    kernel: JAX computes both recurrences in XLA), timed, its prefill
    apart; the prefill again with every block and chunkwise core checked
    at the model's inputs (``xlstm_blocks_checked``), then 31 decode steps
    from its state, every block teacher-forced (``xlstm_teacher_forced``);
    a fault planted for each check (the first block's core in bf16; the
    conv window and the sLSTM state not carried) must fail it."""
    from repro_torch.bridge import tree_bytes, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
    from repro_torch.kernels import runtime as rt
    from repro_torch.models import get_model
    from repro_torch.models import xlstm as X
    from repro_torch.store import HostMemoryStore
    x = XLSTM
    cfg = get_config("xlstm-1.3b")
    model = get_model(cfg)
    G, n_m = X._group_counts(cfg)
    t_phase = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(x["seed"]),
                        dev)
    nbytes = tree_bytes(params)
    coe = CompositionOfExperts(HashRouter(1), None, nbytes,
                               store=HostMemoryStore(), device=dev)
    coe.register(ExpertHandle(cfg.name, cfg, params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"xlstm: {cfg.name} at full width and depth: {cfg.n_layers} blocks "
         f"({G} groups of {n_m} mLSTM + 1 sLSTM), D {cfg.d_model}, "
         f"{cfg.n_heads} mLSTM heads of {X._dims(cfg)[3]}, vocab "
         f"{cfg.vocab_size}; {nbytes / 1e9:.3f} GB bf16 made and moved to "
         f"pinned host memory in {time.perf_counter() - t_phase:.1f}s")
    P, n_new, B = x["prompt_len"], x["new_tokens"], x["prompts"]
    toks = np.random.RandomState(x["seed"]).randint(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    # generate's own run, its prefill timed apart (to the logits' argmax)
    emodel, real_prefill, pre_s = coe._models[cfg.name], None, []

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_prefill(*a, **kw)
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t0)
        return out
    real_prefill, emodel.prefill = emodel.prefill, timed_prefill
    torch.cuda.synchronize()
    rt.reset_launches()
    t0 = time.perf_counter()
    try:
        res = coe.generate(toks, n_new)
    finally:
        del emodel.prefill
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("xlstm generate", rt.launch_counts(), {})
    if res.tokens.shape != (B, n_new) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"xlstm generate: tokens {res.tokens.shape} or "
                             "out of vocabulary")
    decode_s = res.exec_seconds - pre_s[0]
    _log(f"xlstm generate: {B} prompts x {P} tokens -> {res.tokens.size} "
         f"tokens in {wall:.3f}s = {res.tokens.size / wall:.2f} tok/s; "
         f"switch_s={res.switch_seconds:.4f} exec_s={res.exec_seconds:.4f}: "
         f"prefill {pre_s[0]:.3f}s ({B * P / pre_s[0]:.0f} tok/s), "
         f"{n_new - 1} decode steps {decode_s:.3f}s = "
         f"{decode_s / (n_new - 1) * 1e3:.2f} ms a step, "
         f"{B * (n_new - 1) / decode_s:.2f} tok/s; no kernel launched")

    # the prefill with every block and chunkwise core checked at the
    # model's inputs
    params = coe.cache.activate(cfg.name)
    tt = torch.as_tensor(toks, device=dev).long()
    t0 = time.perf_counter()
    with xlstm_blocks_checked() as errs:
        last, st = model.prefill(params, {"tokens": tt}, P + n_new)
    kinds = [k for k, _, _ in errs]
    if [kinds.count(k) for k in ("core", "step", "mlstm", "slstm")] != [
            G * n_m, 1, G * n_m, G]:
        raise AssertionError("xlstm prefill: the checks saw other calls "
                             "than the model's 48 blocks")
    blocks_check("xlstm prefill", errs)
    del errs
    lane_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(st)) / B
    c_bytes = st["mlstm"]["C"][:, :, 0].numel() * 4
    _log(f"xlstm: recurrent state {lane_bytes / 1e9:.4f} GB a lane (mLSTM "
         f"C {c_bytes / 1e9:.4f} GB), whatever the prompt length")
    with torch.no_grad():
        x0 = params["embed"]["tok"][tt]
        p0 = X._take(X._take(params["groups"], 0)["mlstm"], 0)

        def first_block_bf16_core():
            with xlstm_blocks_checked(
                    {"mlstm_chunkwise": _chunkwise_autocast}) as errs:
                X.mlstm_block(cfg, p0, x0)
            blocks_check("xlstm planted: block 0's core in bf16", errs)
        expect_caught("xlstm planted: block 0's core in bf16",
                      first_block_bf16_core)
        del x0
    _log(f"xlstm: the prefill's checks {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    xlstm_bf16_check(cfg, params, tt)
    _log(f"xlstm: mlstm_bf16's checks {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()

    # the decode steps from the prefill's state, each block teacher-forced
    logits, fed, taps = xlstm_decode_tapped(model, params, st,
                                            last.argmax(-1), P, n_new - 1)
    if not torch.equal(torch.stack(fed + [logits[-1].argmax(-1)], 1).cpu(),
                       torch.as_tensor(res.tokens)):
        _log("xlstm: the checked decode's tokens differ from generate's (a "
             "near tie)")
    blocks_check(f"xlstm {n_new - 1} decode steps teacher-forced",
                 xlstm_teacher_forced(cfg, taps, n_new - 1),
                 tol=XLSTM_TF_TOL_REL)
    del taps, logits
    n_f = 4
    _, _, taps = xlstm_decode_tapped(model, params, st, last.argmax(-1), P,
                                     n_f, XLSTM_CARRY_FAULTS)
    errs = xlstm_teacher_forced(cfg, taps, n_f)
    for kind in ("mlstm", "slstm"):
        expect_caught(
            f"xlstm planted: the {kind} state not carried ({n_f} steps)",
            lambda: blocks_check(f"xlstm planted {kind}",
                                 [e for e in errs if e[0] == kind],
                                 tol=XLSTM_TF_TOL_REL))
    del taps, errs
    _log(f"xlstm: the decode steps' checks {time.perf_counter() - t0:.1f}s")
    tok = last.argmax(-1)
    t0 = time.perf_counter()
    step_breakdown(lambda: model.decode_step(params, st, tok[:, None], P),
                   f"xlstm decode step ({B} lanes, {cfg.n_layers} blocks)",
                   n_steps=3)
    _log(f"xlstm: the step's breakdown {time.perf_counter() - t0:.1f}s")
    del st, params
    coe.cache.close()
    torch.cuda.empty_cache()
    _log(f"xlstm: phase {time.perf_counter() - t_phase:.1f}s")


def xlstm_bf16_check(cfg, params, tt):
    """``PerfOptions.mlstm_bf16`` at the prefill's shape: the first group's
    mLSTM blocks chained from the embedding of ``tt``, each with the field
    on against the same block in f32 (field off; weights and input
    upcast), the update's relative L2 within ``XLSTM_BLOCK_TOL_REL`` (the
    limit the blocks with the f32 core meet), printed beside the f32
    core's reading and the two blocks' distance; then the first block's
    chunkwise core on its own inputs timed both ways (CUDA events, L2
    flushed)."""
    from repro_torch.distributed import ctx
    from repro_torch.models import xlstm as X
    on = ctx.PerfOptions(mlstm_bf16=True)
    _, n_m = X._group_counts(cfg)
    core_in = []

    def tap(name, real):
        if name != "mlstm_chunkwise":
            return real

        def run(*a):
            if not core_in:
                core_in.append(a)
            return real(*a)
        return run

    worst, rows = 0.0, []
    with torch.no_grad():
        x = params["embed"]["tok"][tt]
        grp = X._take(params["groups"], 0)["mlstm"]
        for j in range(n_m):
            p = X._take(grp, j)
            with ctx.perf_options(on), xlstm_patched(tap):
                y, _ = X.mlstm_block(cfg, p, x)
            y_off, _ = X.mlstm_block(cfg, p, x)
            y32, _ = X.mlstm_block(cfg, _f32(p), x.float())
            e_on = rel_l2(y - x, y32 - x.float())
            rows.append((e_on, rel_l2(y_off - x, y32 - x.float()),
                         rel_l2(y - x, y_off - x)))
            worst = max(worst, e_on)
            x = y
        del x, y, y_off, y32
    B, S = tt.shape
    _log(f"xlstm mlstm_bf16: the first group's {n_m} mLSTM blocks at B {B} "
         f"x {S}, each update against the block in f32: on "
         + " ".join(f"{r[0]:.4f}" for r in rows) + "; the f32 core's "
         + " ".join(f"{r[1]:.4f}" for r in rows) + "; on vs off "
         + " ".join(f"{r[2]:.4f}" for r in rows)
         + f" (tol {XLSTM_BLOCK_TOL_REL})")
    if not worst <= XLSTM_BLOCK_TOL_REL:
        raise AssertionError(f"xlstm mlstm_bf16: a block parts from f32 by "
                             f"{worst} > {XLSTM_BLOCK_TOL_REL}")
    a = core_in[0]
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=tt.device)
    ms = {}
    for name, opts in (("f32", ctx.PerfOptions()), ("bf16", on)):
        with ctx.perf_options(opts), torch.no_grad():
            ms[name] = time_ms(lambda: X.mlstm_chunkwise(*a), flush, 5)
    del flush, core_in
    q = a[0]
    _log(f"xlstm mlstm_bf16: the chunkwise core of block 0 (B {q.shape[0]}, "
         f"S {q.shape[1]}, {q.shape[2]} heads of {q.shape[3]}) "
         f"{ms['bf16']:.3f} ms with the field on, {ms['f32']:.3f} ms off "
         f"(CUDA events, L2 flushed; plain PyTorch products, f32 sums "
         f"either way)")
    return rows, ms


def bwd_cost(B, S, Hq, Hkv, d, window=0, *, Sk=None, dv=None, causal=True):
    """(bytes, flops) of one ``flash_prefill_bwd`` call (its cost function,
    ``ops.attention_bwd_cost``): q (B,S,Hq,d) and, by default, k, v
    (B,S,Hkv,d), causal (and ``window`` > 0: local); ``Sk`` keys and v / o
    of ``dv`` where given; ``causal=False`` and no window is FULL."""
    from repro_torch.kernels.flash_attention.ops import attention_bwd_cost
    Sk, dv = S if Sk is None else Sk, d if dv is None else dv
    c = attention_bwd_cost(B, S, Sk, Hq, Hkv, d, dv, causal, window)
    return c.bytes, c.flops


def bwd_inputs(B, Sq, Sk, Hq, Hkv, dk, dv, gen, dev):
    """Random bf16 q (B,Sq,Hq,dk), k (B,Sk,Hkv,dk), v (B,Sk,Hkv,dv) and dO
    (B,Sq,Hq,dv)."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev) \
            .to(torch.bfloat16)
    return r(B, Sq, Hq, dk), r(B, Sk, Hkv, dk), r(B, Sk, Hkv, dv), \
        r(B, Sq, Hq, dv)


def sdpa_call(q, k, v, causal, window, grad=False):
    """A closure calling SDPA on (q, k, v) in its (B, H, S, d) layout
    (is_causal, the band as a mask, or no mask; GQA by ``enable_gqa``),
    and the transposed inputs; with ``grad`` they require grad. Timing
    only: the port never calls it."""
    import torch.nn.functional as Fn
    Sq = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(grad)
                  for t in (q, k, v))
    mask = None
    if window:
        i = torch.arange(Sq, device=q.device)
        mask = (i[:, None] - i[None, :] < window) & \
            (i[None, :] <= i[:, None] if causal else True)
    return (lambda: Fn.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=q.shape[2] != k.shape[2])), (qt, kt, vt)


def sdpa_grad(q, k, v, do, causal, window):
    """The one-call yardstick: a closure taking the autograd backward of
    SDPA on (q, k, v) for ``do`` (is_causal, the band as a mask, or no
    mask), with the SDPA forward's graph kept; timing only."""
    fwd, inputs = sdpa_call(q, k, v, causal, window, grad=True)
    out, dot = fwd(), do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, inputs, dot, retain_graph=True)


def bwd_row(row, B, S, Hq, Hkv, d, window, gen, flush, *, Sk=None, dv=None,
            causal=True, tol=None):
    """``flash_prefill_bwd`` on (B, S) random bf16 q / dO at Hq q heads and
    (B, Sk) k / v on Hkv kv heads (Sk = S unless given; v / dO of ``dv``
    where given), causal (and local at ``window``) or FULL
    (``causal=False``, no window), o and lse from the LSE forward: dq, dk,
    dv each within ``tol`` (``TRAIN_BWD_REL_L2`` by default; relative L2)
    of ``attention_bwd_ref`` in f32, and two calls equal bit for bit (dQ is
    summed in a fixed order); timed beside that plain version, the
    one-call yardstick (``sdpa_grad``: timing only; the CUDA kernels its
    backward ran are logged) and the LSE forward beside its plain version
    (``lse_plain_ms``) and SDPA's forward (``lse_library_ms``). Returns the
    kernel-table row."""
    from repro_torch.kernels.flash_attention.ops import (attention_bwd,
                                                         attention_lse)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)
    dev = flush.device
    Sk, dv = S if Sk is None else Sk, d if dv is None else dv
    tol = TRAIN_BWD_REL_L2 if tol is None else tol
    q, k, v, do = bwd_inputs(B, S, Sk, Hq, Hkv, d, dv, gen, dev)
    o, lse = attention_lse(q, k, v, causal=causal, window=window)
    kern = lambda: attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    plain = lambda: attention_bwd_ref(q, k, v, do, causal=causal,
                                      window=window)
    got, want, again = kern(), plain(), kern()
    torch.cuda.synchronize()
    errs = [rel_l2(g, w) for g, w in zip(got, want)]
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{row}: two calls differ")
    del got, want, again
    _log(f"kernel {row}: dq / dk / dv relative L2 "
         + " / ".join(f"{e:.3e}" for e in errs) + f" (tol {tol:.3e})")
    if not max(errs) <= tol:
        raise AssertionError(f"{row}: relative L2 {errs} > {tol}")
    lib = sdpa_grad(q, k, v, do, causal, window)
    nbytes, flops = bwd_cost(B, S, Hq, Hkv, d, window, Sk=Sk, dv=dv,
                             causal=causal)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    r = dict(name=row, route="cuda", **KERNELS["flash_prefill_bwd"],
             max_abs_err=None, rel_l2=errs, tol=tol,
             ms=time_ms(kern, flush, 20), plain_ms=time_ms(plain, flush, 3),
             library_ms=time_ms(lib, flush, 10),
             bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             bytes=nbytes, flops=flops, launches=0,
             lse_ms=time_ms(lambda: attention_lse(q, k, v, causal=causal,
                                                  window=window),
                            flush, 20),
             lse_plain_ms=time_ms(lambda: attention_lse_ref(
                 q, k, v, causal=causal, window=window), flush, 3))
    with torch.no_grad():
        # the LSE forward's one-call yardstick: SDPA's forward
        r["lse_library_ms"] = time_ms(sdpa_call(q, k, v, causal, window)[0],
                                      flush, 10)
    got, want = kern(), plain()
    r["max_abs_err"] = max(float((g.float() - w).abs().max())
                           for g, w in zip(got, want))
    del got, want
    r["kernel_ms"] = r["ms"]
    lib_kernels = [n for n in kernels_of(lib, n=1)
                   if not any(w in n.lower() for w in (
                       "elementwise", "reduce", "copy", "fill", "cast"))]
    _log(f"kernel {row}: kernel={r['ms']:.4f}ms plain={r['plain_ms']:.4f}ms "
         f"SDPA backward={r['library_ms']:.4f}ms bound={r['bound_ms']:.4f}ms "
         f"({r['bound_by']}, {nbytes} B, {flops} flops); "
         f"{flops / r['ms'] / 1e9:.1f} TFLOP/s, "
         f"{r['bound_ms'] / r['ms']:.3f} of the bound, "
         f"{r['library_ms'] / r['ms']:.3f}x SDPA's backward time; the LSE "
         f"forward {r['lse_ms']:.4f}ms (plain {r['lse_plain_ms']:.4f}ms, "
         f"SDPA's forward {r['lse_library_ms']:.4f}ms); SDPA's backward ran "
         f"{[n[:90] for n in lib_kernels[:4]]}")
    del q, k, v, o, lse, do, lib
    torch.cuda.empty_cache()
    return r


def lse_row(row, q, k, v, flush):
    """The LSE form of ``flash_prefill`` (causal) on ``q``, ``k``, ``v``
    against its plain version (o row by row, lse within 1e-3), beside
    SDPA's forward. Returns the kernel-table row."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention.ops import (attention_lse,
                                                         attention_lse_cost)
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    B, S, Hq, d = q.shape
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    cost = attention_lse_cost(B, S, S, Hq, k.shape[2], d, v.shape[3])
    r = kernel_row(
        row, lambda: attention_lse(q, k, v, causal=True)[0],
        lambda: attention_lse_ref(q, k, v, causal=True)[0],
        lambda: Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        cost.bytes, cost.flops, flush, kernel="flash_prefill",
        row_tol=PREFILL_ROW_REL_L2)
    lse_err = float((attention_lse(q, k, v, causal=True)[1]
                     - attention_lse_ref(q, k, v, causal=True)[1])
                    .abs().max())
    _log(f"kernel {row}: lse max |kernel - plain| {lse_err:.3e} (tol 1e-3)")
    if not lse_err <= 1e-3:
        raise AssertionError(f"{row}: lse differs by {lse_err}")
    return r


def train_kernel_rows(dev):
    """The training kernels at the training phase's shape (the 7B expert's
    32 heads of 128, B 4, S 2048, causal): ``flash_prefill_bwd`` and the
    LSE form of ``flash_prefill`` beside the plain instantiation; then the
    backward at Mixtral's 5ᴹ shape (32 q on 8 kv heads, B 2, S 4608,
    window 4096), where the GQA sum and the window edges run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import attention
    c, t = get_config(TRAIN["arch"]), TRAIN
    gen = torch.Generator(device=dev).manual_seed(t["seed"])
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    B, S, H, d = t["batch"], t["seq"], c.n_heads, c.head_dim
    rows = {TRAIN_BWD_ROW: bwd_row(TRAIN_BWD_ROW, B, S, H, c.n_kv_heads, d,
                                   0, gen, flush)}
    q, k, v = (torch.randn((B, S, H, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    r = lse_row(TRAIN_LSE_ROW, q, k, v, flush)
    with torch.no_grad():
        r["square_ms"] = time_ms(lambda: attention(q, k, v, causal=True),
                                 flush, 50)
    _log(f"kernel {TRAIN_LSE_ROW}: the plain instantiation "
         f"{r['square_ms']:.4f} ms: the LSE form {r['ms'] / r['square_ms']:.4f}x "
         f"its time")
    rows[TRAIN_LSE_ROW] = r
    del q, k, v
    m = get_config("mixtral-8x7b")
    rows[TRAIN_BWD_GQA_ROW] = bwd_row(
        TRAIN_BWD_GQA_ROW, MIXTRAL["prompts"], MIXTRAL["prompt_len"],
        m.n_heads, m.n_kv_heads, m.head_dim, m.sliding_window, gen, flush)
    del flush
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def bwd_taps():
    """Within the block, every ``FlashAttention`` backward appends its (q,
    k, v, dO, dq, dk, dv) (copies) and its masks (``causal``, ``window``)
    to the list the block receives, in the
    order the backward runs (the last layer first): the Function's
    backward looks ``attention_bwd`` up in ``ops`` on every call. Nothing
    in the port is edited."""
    from repro_torch.kernels.flash_attention import ops
    taps, real = [], ops.attention_bwd

    def tapped(q, k, v, o, lse, do, **kw):
        grads = real(q, k, v, o, lse, do, **kw)
        taps.append(tuple(x.clone() for x in (q, k, v, do, *grads))
                    + (dict(kw),))
        return grads
    ops.attention_bwd = tapped
    try:
        yield taps
    finally:
        ops.attention_bwd = real


@contextlib.contextmanager
def attention_kernel_calls():
    """Within the block, every ``ops.attention_lse`` and ``ops.
    attention_bwd`` call (``FlashAttention`` looks both up in ``ops`` on
    every call) appends (its launch count's name, Sq, Sk, causal, window)
    to the list the block receives. Nothing in the port is edited."""
    from repro_torch.kernels.flash_attention import ops
    calls, real = [], (ops.attention_lse, ops.attention_bwd)

    def recorder(fn, name):
        def recorded(q, k, v, *args, **kw):
            calls.append((name, q.shape[1], k.shape[1],
                          bool(kw.get("causal", True)),
                          int(kw.get("window", 0))))
            return fn(q, k, v, *args, **kw)
        return recorded
    ops.attention_lse = recorder(real[0], "flash_prefill[lse]")
    ops.attention_bwd = recorder(real[1], "flash_prefill_bwd")
    try:
        yield calls
    finally:
        ops.attention_lse, ops.attention_bwd = real


def bwd_faults_caught(q, k, v, do, got):
    """The layer check against references with a fault planted: the causal
    mask skipped on each 64-row diagonal tile, and di taken as 0. Each must
    read above ``TRAIN_BWD_REL_L2``."""
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_masked,
                                                         attention_mask)
    S = q.shape[1]
    i = torch.arange(S, device=q.device)
    causal = attention_mask(S, S, causal=True, device=q.device)
    faults = {
        "diagonal tile unmasked": dict(
            mask=causal | ((i[:, None] // 64) == (i[None, :] // 64))),
        "di taken as 0": dict(mask=causal, di=torch.zeros(
            q.shape[0], q.shape[2], S, device=q.device))}
    for label, kw in faults.items():
        want = attention_bwd_masked(q, k, v, do, **kw)
        err = max(rel_l2(g, w) for g, w in zip(got, want))
        del want
        _log(f"train: planted {label}: relative L2 {err:.3e} "
             f"{'caught' if err > TRAIN_BWD_REL_L2 else 'NOT caught'}")
        if not err > TRAIN_BWD_REL_L2:
            raise AssertionError(f"train: the backward check misses a "
                                 f"planted {label}")


def train_phase(dev):
    """Training on one card: ``TRAIN``'s cut of the 7B expert through the
    port's train step (``distributed.stepfn``: the forward with remat, its
    attention the ``flash_prefill`` LSE form, twice a layer; the backward
    ``flash_prefill_bwd``, once a layer; AdamW). Checks the first loss
    against the plain f32 forward, every leaf's gradient finite and
    non-zero, each layer's attention backward at the model's inputs, the
    launch counts every step and the loss falling; then a checkpoint round
    trip at ``ckpt_layers``. Returns the launch counts summed over the
    steps."""
    import dataclasses

    from repro_torch.bridge import (tree_bytes, tree_items, tree_leaves,
                                    tree_map)
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import stepfn
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.kernels.flash_attention.ops import attention_pairs
    t0 = time.perf_counter()
    t = TRAIN
    full = get_config(t["arch"])
    cfg = dataclasses.replace(full, n_layers=t["layers"])
    model = get_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(t["seed"]), dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    B, S = t["batch"], t["seq"]
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=t["seed"])) \
        .batch_at(0)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
    # the first step's loss in f32: the same bf16 weights upcast, quadratic
    # attention
    with torch.no_grad(), plain_prefill():
        p32 = tree_map(lambda x: x.float(), params)
        loss32 = float(stepfn.softmax_xent(model.forward(p32, batch),
                                           batch["targets"]))
        del p32
    torch.cuda.empty_cache()
    opt_cfg = AdamWConfig(lr=t["lr"], warmup_steps=max(2, t["steps"] // 10),
                          decay_steps=max(4, t["steps"]))
    step_fn = stepfn.make_train_step(cfg, opt_cfg)
    state = stepfn.init_train_state(params)
    _log(f"train: {cfg.name} cut to {cfg.n_layers} of its {full.n_layers} "
         f"layers at full width: {n_params / 1e9:.3f} B params, "
         f"{tree_bytes(state) / 1e9:.2f} GB of state (params, mu, nu); "
         f"batch {B} x {S}, remat, {t['steps']} steps")

    # AdamW's device time by CUDA events, and on the first step every
    # leaf's gradient checked before the update
    real_update, adamw = stepfn.adamw_update, {}

    def timed_update(ocfg, p, g, o):
        if adamw.get("check"):
            bad = [n for n, x in tree_items(g)
                   if x is None or not bool(torch.isfinite(x).all())
                   or not bool(x.ne(0).any())]
            adamw["bad"] = bad
            adamw["check"] = False
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = real_update(ocfg, p, g, o)
        e1.record()
        adamw["events"] = (e0, e1)
        return out

    losses, walls, adamw_ms, totals = [], [], [], {}
    stepfn.adamw_update = timed_update
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(t["steps"]):
            adamw["check"] = i == 0
            rt.reset_launches()
            torch.cuda.synchronize()
            ts = time.perf_counter()
            if i == 0:
                with bwd_taps() as taps:
                    state, m = step_fn(state, batch)
            elif i == t["steps"] - 1:
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    state, m = step_fn(state, batch)
                    torch.cuda.synchronize()
            else:
                state, m = step_fn(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - ts)
            adamw_ms.append(adamw["events"][0].elapsed_time(
                adamw["events"][1]))
            losses.append(loss)
            n = rt.launch_counts()
            check_launches(f"train step {i}", n,
                           stepfn.kernel_launches(cfg))
            for key, val in n.items():
                totals[key] = totals.get(key, 0) + val
            _log(f"train step {i}: loss={loss:.4f} "
                 f"gnorm={float(m['grad_norm']):.4f} lr={float(m['lr']):.3e}"
                 f" {walls[-1]:.3f}s")
    finally:
        stepfn.adamw_update = real_update
    peak = torch.cuda.max_memory_allocated() / 1e9
    if adamw.get("bad"):
        raise AssertionError(f"train: leaves without a finite non-zero "
                             f"gradient: {adamw['bad']}")
    _log(f"train: every one of {len(tree_leaves(params))} leaves has a "
         "finite, non-zero gradient")
    rel = abs(losses[0] - loss32) / abs(loss32)
    _log(f"train: first loss {losses[0]:.6f} against the f32 forward "
         f"{loss32:.6f}: {rel:.3e} relative (tol {TRAIN_LOSS_TOL_REL:.3e})")
    if not rel <= TRAIN_LOSS_TOL_REL:
        raise AssertionError(f"train: first loss {losses[0]} vs f32 "
                             f"{loss32}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    _log(f"train: loss {losses[0]:.4f} -> {losses[-1]:.4f} OK")
    # where the time goes: warm steps (not the first, not the profiled)
    wall = float(np.median(walls[1:-1]))
    busy = busy_us(sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA)) / 1e6
    flops = 6 * (n_params - cfg.vocab_size * cfg.d_model) * B * S \
        + 3 * cfg.n_layers * 2 * B * cfg.n_heads * 2 * cfg.head_dim \
        * attention_pairs(S, S)
    MEASURED["train_step_s"], MEASURED["train_model_flops"] = wall, flops
    _log(f"train: a step {wall:.4f} s (median of steps 1-{t['steps'] - 2}), "
         f"{B * S / wall:.1f} tokens/s, peak memory {peak:.2f} GB, AdamW "
         f"{np.median(adamw_ms):.2f} ms; device busy {busy:.4f} s of the "
         f"profiled step (idle share {1 - busy / walls[-1]:.3f} of its "
         f"wall {walls[-1]:.4f} s); {flops:.3e} model flops a step: "
         f"{flops / wall / BF16_FLOPS_PER_S:.3f} of 989 TFLOP/s")
    del prof

    # each layer's attention backward at the model's inputs
    taps = taps[::-1]
    if len(taps) != cfg.n_layers:
        raise AssertionError(f"train: {len(taps)} backward taps")
    errs = []
    for li, (q, k, v, do, dq, dk, dv, _) in enumerate(taps):
        want = attention_bwd_ref(q, k, v, do, causal=True)
        errs.append([rel_l2(g, w) for g, w in zip((dq, dk, dv), want)])
        del want
    _log("train: attention backward at the model's inputs, dq / dk / dv "
         "relative L2 by layer: " + "; ".join(
             f"{i}: " + "/".join(f"{e:.2e}" for e in es)
             for i, es in enumerate(errs))
         + f" (tol {TRAIN_BWD_REL_L2:.3e}; largest "
           f"{max(max(e) for e in errs):.3e})")
    if not max(max(e) for e in errs) <= TRAIN_BWD_REL_L2:
        raise AssertionError(f"train: a layer's attention backward is off "
                             f"its reference: {errs}")
    q, k, v, do, dq, dk, dv = taps[0][:7]
    del taps
    bwd_faults_caught(q, k, v, do, (dq, dk, dv))
    del q, k, v, do, dq, dk, dv, state, params, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    checkpoint_round_trip(full, batch, opt_cfg)
    _log(f"train: phase {time.perf_counter() - t0:.1f}s")
    return totals


def family_bwd_shapes():
    """{row key: (arch, B, Sq, Sk, Hq, Hkv, dk, dv, causal, window)}: the
    attention backward's shapes in the family-training phase."""
    from repro_torch.configs import get_config
    (rga, rgt), (dsa, dst), (wha, wht) = FAMILY_TRAIN.items()
    rg, ds, wh = (get_config(a) for a in (rga, dsa, wha))
    return {
        "rg": (rga, rgt["batch"], rgt["seq"], rgt["seq"], rg.n_heads,
               rg.n_kv_heads, rg.head_dim, rg.head_dim, True,
               rg.sliding_window),
        "mla": (dsa, dst["batch"], dst["seq"], dst["seq"], ds.n_heads,
                ds.n_kv_heads, *prefill_widths(ds), True, 0),
        "enc": (wha, wht["batch"], wh.encoder_seq, wh.encoder_seq,
                wh.n_heads, wh.n_kv_heads, wh.head_dim, wh.head_dim, False,
                0),
        "cross": (wha, wht["batch"], wht["seq"], wh.encoder_seq, wh.n_heads,
                  wh.n_kv_heads, wh.head_dim, wh.head_dim, False, 0)}


def family_kernel_rows(dev):
    """The backward kernels at the family-training phase's shapes, each
    against its plain version with its LSE forward's o and lse checked on
    the way: ``flash_prefill_bwd`` at RecurrentGemma's local attention (B
    2, S 3000, 16 q heads on one kv head of 256, window 2048), DeepSeek's
    MLA (B 4, S 2048, 16 heads, (192, 128), causal) and Whisper-small's
    encoder (B 8, S 1500, 12 heads of 64) and cross-attention (Sq 448 over
    Sk 1500), both FULL; then ``lru_scan_bwd`` at RecurrentGemma's prefill
    shape (4, 3000, 4096) f32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import attention_lse
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    from repro_torch.kernels.lru_scan.ops import (lru_scan, lru_scan_bwd,
                                                  lru_scan_bwd_cost)
    from repro_torch.kernels.lru_scan.ref import lru_scan_bwd_ref
    gen = torch.Generator(device=dev).manual_seed(47)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    for key, (_, B, Sq, Sk, Hq, Hkv, dk, dv, causal, window) in \
            family_bwd_shapes().items():
        row = FAMILY_BWD_ROWS[key]
        # the LSE form at this shape against its plain version
        q, k, v, _ = bwd_inputs(B, Sq, Sk, Hq, Hkv, dk, dv, gen, dev)
        o, lse = attention_lse(q, k, v, causal=causal, window=window)
        o_ref, lse_ref = attention_lse_ref(q, k, v, causal=causal,
                                           window=window)
        o_err = row_rel_l2(o, o_ref)
        lse_err = float((lse - lse_ref).abs().max())
        _log(f"kernel {row}: its LSE forward's o largest row relative L2 "
             f"{o_err:.3e} (tol {PREFILL_ROW_REL_L2:.3e}), lse max |kernel - "
             f"plain| {lse_err:.3e} (tol 1e-3)")
        if not (o_err <= PREFILL_ROW_REL_L2 and lse_err <= 1e-3):
            raise AssertionError(f"{row}: the LSE forward is off its plain "
                                 f"version ({o_err}, {lse_err})")
        del q, k, v, o, lse, o_ref, lse_ref
        rows[row] = bwd_row(row, B, Sq, Hq, Hkv, dk, window, gen, flush,
                            Sk=Sk, dv=dv, causal=causal)
    B, S, D = RG["prompts"], RG["prompt_len"], \
        get_config("recurrentgemma-9b").d_rnn
    a = torch.rand((B, S, D), generator=gen, device=dev)
    b, dh = (torch.randn((B, S, D), generator=gen, device=dev)
             for _ in range(2))
    with torch.no_grad():
        h = lru_scan(a, b)
    # f32 in both, summed in other orders (a sequential walk, a doubling
    # scan of the reversed recurrence)
    cost = lru_scan_bwd_cost(B, S, D)
    r = kernel_row(
        LRU_BWD_ROW, lambda: lru_scan_bwd(a, h, dh),
        lambda: lru_scan_bwd_ref(a, h, dh), None, cost.bytes, cost.flops,
        flush, rel_tol=1e-5, peak=F32_FLOPS_PER_S)
    r["rel_l2"] = [rel_l2(g, w) for g, w in zip(lru_scan_bwd(a, h, dh),
                                                lru_scan_bwd_ref(a, h, dh))]
    _log(f"kernel {LRU_BWD_ROW}: da / db relative L2 "
         + " / ".join(f"{e:.3e}" for e in r["rel_l2"])
         + f"; {r['bound_ms'] / r['ms']:.3f} of the bound")
    rows[LRU_BWD_ROW] = r
    del a, b, dh, h, flush
    torch.cuda.empty_cache()
    return rows


def train_model_flops(cfg, params, B, S):
    """Model flops of one train step: 6 x the matrix parameters a token
    passes (an MoE layer's experts at top_k / n_experts; Whisper's encoder
    over its frames, the rest over the decoder's tokens; the token
    embedding a gather unless it is the tied output matrix) x the tokens,
    plus 3 x the attention's forward products (no recompute counted)."""
    from repro_torch.bridge import tree_items
    from repro_torch.distributed.stepfn import kernel_launches
    from repro_torch.kernels.flash_attention.ops import attention_pairs
    enc_tokens = B * cfg.encoder_seq if cfg.family == "encdec" else 0
    flops = 0
    has_head = any(n == "lm_head" for n, _ in tree_items(params))
    for n, x in tree_items(params):
        if x.dim() < 2 or (n == "embed/tok" and has_head):
            continue
        share = cfg.top_k / cfg.n_experts if "/experts/" in n else 1.0
        tokens = enc_tokens if n.startswith("enc_") else B * S
        flops += 6 * x.numel() * share * tokens
    dk, dv = prefill_widths(cfg)
    one = 2 * B * cfg.n_heads * (dk + dv)
    if cfg.family == "encdec":
        Se = cfg.encoder_seq
        pairs = cfg.n_encoder_layers * Se * Se + cfg.n_layers * (
            attention_pairs(S, S) + S * Se)
    else:
        pairs = kernel_launches(cfg)["flash_prefill_bwd"] * attention_pairs(
            S, S, True, cfg.sliding_window)
    return flops + 3 * one * pairs


@contextlib.contextmanager
def lru_bwd_taps():
    """Within the block, every ``LruScan`` backward appends its (a, h, dh,
    da, db) (copies) to the list the block receives: the Function's
    backward looks ``lru_scan_bwd`` up in ``ops`` on every call. Nothing in
    the port is edited."""
    from repro_torch.kernels.lru_scan import ops
    taps, real = [], ops.lru_scan_bwd

    def tapped(a, h, dh):
        grads = real(a, h, dh)
        taps.append(tuple(x.clone() for x in (a, h, dh, *grads)))
        return grads
    ops.lru_scan_bwd = tapped
    try:
        yield taps
    finally:
        ops.lru_scan_bwd = real


def expect_above(label, err, tol):
    """A planted fault must read above ``tol``."""
    _log(f"family train: planted {label}: {err:.3e} "
         f"{'caught' if err > tol else 'NOT caught'} (tol {tol:.3e})")
    if not err > tol:
        raise AssertionError(f"family train: the check misses a planted "
                             f"{label}")


def rounding_points_check(name, layer, q, k, v, do, dq, dk, dv, kw):
    """For layer ``layer``'s tapped backward: the kernel's dq, dk, dv and
    the plain formulas at its bf16 rounding points (``attention_bwd_masked(
    ..., rounded=True)``), each against the f32 formulas (largest relative
    L2). Fails unless the kernel's is within ``FAMILY_ROUNDING_RATIO`` of
    the rounded formulas': its error is then the rounding the design
    specifies, not a fault."""
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_masked,
                                                         attention_mask)
    mask = attention_mask(q.shape[1], k.shape[1], device=q.device, **kw)
    want = attention_bwd_masked(q, k, v, do, mask)
    plain = max(rel_l2(g, w) for g, w in zip(
        attention_bwd_masked(q, k, v, do, mask, rounded=True), want))
    kern = max(rel_l2(g, w) for g, w in zip((dq, dk, dv), want))
    del want
    _log(f"family train {name}: layer {layer} (the largest reading): the "
         f"kernel {kern:.3e}, the plain formulas at its bf16 rounding "
         f"points {plain:.3e}, each against the f32 formulas: "
         f"{kern / plain:.3f}x (tol {FAMILY_ROUNDING_RATIO}x)")
    if not kern <= FAMILY_ROUNDING_RATIO * plain:
        raise AssertionError(f"family train {name}: layer {layer}'s backward "
                             f"reads {kern} against {plain} at its rounding "
                             "points")


def attention_tap_errs(q, k, v, do, got, kw, **fault):
    """Relative L2 of a tapped backward's dq, dk, dv against
    ``attention_bwd_masked`` in f32 under its masks (``fault`` may replace
    the mask or di); with a window shorter than the sequence also over the
    rows the window's edge cuts (dq's rows from W on, dk's and dv's keys
    before S - W). Returns the largest."""
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_masked,
                                                         attention_mask)
    Sq, Sk = q.shape[1], k.shape[1]
    mask = fault.pop("mask", None)
    if mask is None:
        mask = attention_mask(Sq, Sk, device=q.device, **kw)
    want = attention_bwd_masked(q, k, v, do, mask, **fault)
    errs = [rel_l2(g, w) for g, w in zip(got, want)]
    W = kw.get("window", 0)
    if W and Sq > W:
        dq, dk, dv = got
        errs += [rel_l2(dq[:, W:], want[0][:, W:]),
                 rel_l2(dk[:, :Sk - W], want[1][:, :Sk - W]),
                 rel_l2(dv[:, :Sk - W], want[2][:, :Sk - W])]
    del want
    return max(errs)


def padding_key_check(cfg, B, Sq, gen, dev, tol):
    """Keys past Sk are masked under FULL: at Whisper's cross-attention
    shape (B, Sq over its Sk = encoder_seq frames, off the 128-key tiles),
    scores far below 0 (q 32 and k -32 in the first 4 columns, normal in
    the rest), where a zero key past Sk would weigh exp(-lse), past f32's
    range, the kernel's gradients are finite and within ``tol`` of the
    plain version outside those columns (there
    the common -32 / 32 cancel in dq = sum ds k and dk = sum ds q: no
    signal); planted: the plain version with one padding key (a zero row at
    Sk) left unmasked."""
    from repro_torch.kernels.flash_attention.ops import (attention_bwd,
                                                         attention_lse)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_masked,
                                                         attention_mask)
    Sk, H, d = cfg.encoder_seq, cfg.n_heads, cfg.head_dim
    q, k, v, do = bwd_inputs(B, Sq, Sk, H, H, d, d, gen, dev)
    q[..., :4], k[..., :4] = 32.0, -32.0
    o, lse = attention_lse(q, k, v, causal=False)
    got = attention_bwd(q, k, v, o, lse, do, causal=False)
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError("family train: the FULL backward is not finite "
                             "where a padding key would overflow")
    cut = lambda ts: [t[..., 4:] if i < 2 else t for i, t in enumerate(ts)]
    mask = attention_mask(Sq, Sk, causal=False, device=dev)
    want = attention_bwd_masked(q, k, v, do, mask)
    err = max(rel_l2(g, w) for g, w in zip(cut(got), cut(want)))
    _log(f"family train: keys past Sk at {B} x {Sq} over {Sk} frames with "
         f"lse up to {float(lse.max()):.1f}: relative L2 {err:.3e} outside "
         f"the 4 offset columns (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"family train: the masked padding keys read "
                             f"{err}")
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
    want = attention_bwd_masked(q, pad(k), pad(v), do,
                                torch.ones(Sq, Sk + 1, dtype=torch.bool,
                                           device=dev))
    want = [want[0], want[1][:, :Sk], want[2][:, :Sk]]
    expect_above("a padding key left unmasked",
                 max(rel_l2(g, w) for g, w in zip(cut(got), cut(want))), tol)
    del q, k, v, do, o, lse, got, want


def family_train(arch, spec, dev):
    """One family at full width through ``stepfn.make_train_step`` (remat,
    AdamW): FAMILY_STEPS steps on one SyntheticLM batch (Whisper's with
    seeded stub frames), launches checked every step against
    ``stepfn.kernel_launches`` and, each attention kernel's, against the
    calls made to it; the first step's gradients (every leaf finite and
    non-zero), attention backwards and ``lru_scan`` backwards tapped and
    each held at the model's inputs against its f32 plain version, with
    the planted faults that apply; the first loss against the plain f32
    forward, the loss falling. Returns {(launch count name, Sq, Sk, causal,
    window): calls} of the attention kernels summed over the steps, and
    the launch counts so summed."""
    import collections
    import dataclasses

    from repro_torch.bridge import tree_bytes, tree_items, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import stepfn
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention.ref import attention_mask
    from repro_torch.kernels.lru_scan.ref import lru_scan_bwd_ref
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = full if spec["layers"] is None else dataclasses.replace(
        full, n_layers=spec["layers"])
    model = get_model(cfg)
    gen = torch.Generator(dev).manual_seed(spec["seed"])
    params = model.init(gen, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    B, S = spec["batch"], spec["seq"]
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=spec["seed"])) \
        .batch_at(0)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                          generator=gen, device=dev)
    logits32 = plain_f32_forward(cfg, params, batch)
    loss32 = float(stepfn.softmax_xent(logits32, batch["targets"]))
    del logits32
    torch.cuda.empty_cache()
    opt_cfg = AdamWConfig(lr=FAMILY_LR, warmup_steps=2,
                          decay_steps=FAMILY_STEPS)
    step_fn = stepfn.make_train_step(cfg, opt_cfg)
    state = stepfn.init_train_state(params)
    want = stepfn.kernel_launches(cfg)
    cut = "" if spec["layers"] is None else \
        f" cut to {cfg.n_layers} of its {full.n_layers} layers"
    _log(f"family train: {cfg.name}{cut} at full width: "
         f"{n_params / 1e9:.3f} B params, {tree_bytes(state) / 1e9:.2f} GB "
         f"of state; batch {B} x {S}"
         + (f" over {cfg.encoder_seq} frames" if cfg.family == "encdec"
            else "") + f", remat, {FAMILY_STEPS} steps; launches a step "
         + " ".join(f"{k}={n}" for k, n in want.items() if n))

    real_update, seen = stepfn.adamw_update, {}

    def checked_update(ocfg, p, g, o):
        if seen.get("check"):
            seen["bad"] = [n for n, x in tree_items(g)
                           if x is None or not bool(torch.isfinite(x).all())
                           or not bool(x.ne(0).any())]
            seen["check"] = False
        return real_update(ocfg, p, g, o)

    losses, walls, totals = [], [], {}
    stepfn.adamw_update = checked_update
    torch.cuda.reset_peak_memory_stats()
    try:
        with attention_kernel_calls() as calls:
            for i in range(FAMILY_STEPS):
                before = len(calls)
                seen["check"] = i == 0
                rt.reset_launches()
                torch.cuda.synchronize()
                ts = time.perf_counter()
                if i == 0:
                    with bwd_taps() as taps, lru_bwd_taps() as lru_taps:
                        state, m = step_fn(state, batch)
                elif i == FAMILY_STEPS - 1:
                    from torch.autograd import DeviceType
                    from torch.profiler import ProfilerActivity, profile
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        state, m = step_fn(state, batch)
                        torch.cuda.synchronize()
                else:
                    state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - ts)
                n = rt.launch_counts()
                check_launches(f"family train {cfg.name} step {i}", n, want)
                made = collections.Counter(c[0] for c in calls[before:])
                for name in ("flash_prefill[lse]", "flash_prefill_bwd"):
                    if made[name] != n[name]:
                        raise AssertionError(
                            f"family train {cfg.name} step {i}: {name} "
                            f"launched {n[name]} times in {made[name]} "
                            "calls")
                for key, val in n.items():
                    totals[key] = totals.get(key, 0) + val
                _log(f"family train {cfg.name} step {i}: "
                     f"loss={losses[-1]:.4f} "
                     f"gnorm={float(m['grad_norm']):.4f} {walls[-1]:.3f}s")
    finally:
        stepfn.adamw_update = real_update
    peak = torch.cuda.max_memory_allocated() / 1e9
    if seen.get("bad"):
        raise AssertionError(f"family train {cfg.name}: leaves without a "
                             f"finite non-zero gradient: {seen['bad']}")
    rel = abs(losses[0] - loss32) / abs(loss32)
    _log(f"family train {cfg.name}: every one of {len(tree_leaves(params))} "
         f"leaves has a finite, non-zero gradient; first loss "
         f"{losses[0]:.6f} against the f32 forward {loss32:.6f}: {rel:.3e} "
         f"relative (tol {FAMILY_LOSS_TOL_REL[arch]:.3e})")
    if not rel <= FAMILY_LOSS_TOL_REL[arch]:
        raise AssertionError(f"family train {cfg.name}: first loss "
                             f"{losses[0]} vs f32 {loss32}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"family train {cfg.name}: loss did not fall: "
                             f"{losses}")
    wall = walls[1]
    busy = busy_us(sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA)) / 1e6
    tokens = B * S
    flops = train_model_flops(cfg, params, B, S)
    shapes = collections.Counter(calls)
    _log(f"family train {cfg.name}: loss {losses[0]:.4f} -> {losses[1]:.4f} "
         f"-> {losses[-1]:.4f}; a step {wall:.4f} s (step 1), "
         f"{tokens / wall:.1f} tokens/s, peak memory {peak:.2f} GB; device "
         f"busy {busy:.4f} s of the profiled step {FAMILY_STEPS - 1}, whose "
         f"wall is {walls[-1]:.4f} s (idle share {1 - busy / walls[-1]:.3f});"
         f" {flops:.3e} model flops a step: "
         f"{flops / wall / BF16_FLOPS_PER_S:.3f} of 989 TFLOP/s; attention "
         f"kernel calls over the {FAMILY_STEPS} steps by (Sq, Sk, causal, "
         "window): " + ", ".join(f"{c[0]} {c[1:]} {n}"
                                  for c, n in sorted(shapes.items())))
    del prof, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # each attention and recurrence backward at the model's inputs, in the
    # forward's order
    taps, lru_taps = taps[::-1], lru_taps[::-1]
    if len(taps) != want["flash_prefill_bwd"] or \
            len(lru_taps) != want["lru_scan_bwd"]:
        raise AssertionError(f"family train {cfg.name}: {len(taps)} "
                             f"attention and {len(lru_taps)} recurrence "
                             "backward taps")
    errs, tol = [], FAMILY_BWD_REL_L2[arch]
    for q, k, v, do, dq, dk, dv, kw in taps:
        errs.append(attention_tap_errs(q, k, v, do, (dq, dk, dv), kw))
    if taps:
        _log(f"family train {cfg.name}: attention backward at the model's "
             "inputs, largest relative L2 of dq / dk / dv (and the window "
             "edge's rows) by layer: "
             + " ".join(f"{e:.2e}" for e in errs)
             + f" (tol {tol:.3e}; largest {max(errs):.3e})")
        worst = int(np.argmax(errs))
        rounding_points_check(cfg.name, worst, *taps[worst])
        if not max(errs) <= tol:
            raise AssertionError(f"family train {cfg.name}: an attention "
                                 f"backward is off its reference: {errs}")
        q, k, v, do, dq, dk, dv, kw = taps[0]
        expect_above(f"di taken as 0 ({cfg.name})", attention_tap_errs(
            q, k, v, do, (dq, dk, dv), kw, di=torch.zeros(
                q.shape[0], q.shape[2], q.shape[1], device=dev)), tol)
        W = kw.get("window", 0)
        if W:
            S_ = q.shape[1]
            expect_above(
                f"the window edge off by one ({cfg.name})",
                attention_tap_errs(q, k, v, do, (dq, dk, dv), kw,
                                   mask=attention_mask(
                                       S_, S_, causal=kw["causal"],
                                       window=W + 1, device=dev)), tol)
    del taps
    lerrs = []
    for a, h, dh, da, db in lru_taps:
        want_da, want_db = lru_scan_bwd_ref(a, h, dh)
        lerrs.append(max(rel_l2(da, want_da), rel_l2(db, want_db)))
    if lru_taps:
        _log(f"family train {cfg.name}: lru_scan backward at the model's "
             "inputs, largest relative L2 of da / db by layer: "
             + " ".join(f"{e:.2e}" for e in lerrs)
             + f" (tol {FAMILY_LRU_REL_L2:.1e})")
        if not max(lerrs) <= FAMILY_LRU_REL_L2:
            raise AssertionError(f"family train {cfg.name}: an lru_scan "
                                 f"backward is off its reference: {lerrs}")
        a, h, dh, da, db = lru_taps[0]
        _, want_db = lru_scan_bwd_ref(a, h, dh)
        expect_above(f"da from h_t in place of h_(t-1) ({cfg.name})",
                     rel_l2(da, want_db * h), FAMILY_LRU_REL_L2)
    del lru_taps
    if cfg.family == "encdec":
        padding_key_check(cfg, B, S, gen, dev, TRAIN_BWD_REL_L2)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"family train {cfg.name}: {time.perf_counter() - t0:.1f}s")
    return shapes, totals


def family_train_phase(dev):
    """Each family of ``FAMILY_TRAIN`` in turn, its state freed before the
    next. Returns {arch: (its attention kernel calls by shape, its launch
    counts), each summed over its steps}."""
    t0 = time.perf_counter()
    out = {}
    for arch, spec in FAMILY_TRAIN.items():
        out[arch] = family_train(arch, spec, dev)
        gc.collect()
        torch.cuda.empty_cache()
    _log(f"family train: phase {time.perf_counter() - t0:.1f}s")
    return out



def _bits(x):
    return x.detach().reshape(-1).view(torch.uint8)


def checkpoint_round_trip(full, batch, opt_cfg):
    """``TRAIN["ckpt_layers"]`` of the expert at full width, trained
    ``ckpt_steps`` steps, saved to a temporary directory and restored into
    a fresh tree on the card: every leaf bit-equal; two more steps from the
    restore against two from the live state, the losses within
    ``TRAIN_RESUME_TOL_REL``."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.bridge import tree_bytes, tree_leaves, tree_map
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import stepfn
    from repro_torch.models import get_model
    t = TRAIN
    dev = batch["tokens"].device
    cfg = dataclasses.replace(full, n_layers=t["ckpt_layers"])
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(t["seed"]),
                                 dev)
    step_fn = stepfn.make_train_step(cfg, opt_cfg)
    state = stepfn.init_train_state(params)
    for _ in range(t["ckpt_steps"]):
        state, _ = step_fn(state, batch)
    need = tree_bytes(state)
    tmp = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        if free < 1.5 * need:
            raise RuntimeError(f"train: {free / 1e9:.1f} GB free under "
                               f"{tmp}, the checkpoint needs "
                               f"{need / 1e9:.2f} GB")
        mgr = CheckpointManager(tmp, keep=1)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        mgr.save(t["ckpt_steps"], state)
        write_s = time.perf_counter() - ts
        like = tree_map(torch.empty_like, state)
        ts = time.perf_counter()
        restored, step = mgr.restore_state(like)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - ts
        del like
        diff = [i for i, (a, b) in enumerate(zip(tree_leaves(restored),
                                                 tree_leaves(state)))
                if a.dtype != b.dtype or a.device != b.device
                or not torch.equal(_bits(a), _bits(b))]
        if step != t["ckpt_steps"] or diff:
            raise AssertionError(f"train: checkpoint restore at step {step}"
                                 f" differs in leaves {diff}")
        _log(f"train: checkpoint of {cfg.n_layers} layer(s) at full width, "
             f"{need / 1e9:.2f} GB: written in {write_s:.1f} s, restored in "
             f"{read_s:.1f} s, {len(tree_leaves(state))} leaves bit-equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    live, back = [], []
    for _ in range(2):
        state, m = step_fn(state, batch)
        live.append(float(m["loss"]))
    del state
    for _ in range(2):
        restored, m = step_fn(restored, batch)
        back.append(float(m["loss"]))
    rel = max(abs(a - b) / abs(a) for a, b in zip(live, back))
    _log(f"train: resumed losses {back} against uninterrupted {live}: "
         f"{rel:.3e} relative (tol {TRAIN_RESUME_TOL_REL:.0e})")
    if not rel <= TRAIN_RESUME_TOL_REL:
        raise AssertionError("train: the resumed run parts from the "
                             "uninterrupted one")
    del restored
    gc.collect()
    torch.cuda.empty_cache()


def _dist_setup(d, layers, dev):
    """The expert cut to ``layers`` at full width, a seeded init on ``dev``,
    the SyntheticLM batch and the AdamW config of the distribution
    phase."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    full = get_config(d["arch"])
    cfg = dataclasses.replace(full, n_layers=layers)
    model = get_model(cfg)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=d["seq"], global_batch=d["batch"],
                                   seed=d["seed"])).batch_at(0)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
    opt = AdamWConfig(lr=d["lr"], warmup_steps=2, decay_steps=4)

    def init():
        return model.init(torch.Generator(dev).manual_seed(d["seed"]), dev)
    return full, cfg, model, init, batch, opt


@contextlib.contextmanager
def collectives_counted():
    """Counts the calls of the process-group collectives and of the
    functional ones DTensor issues, by name; a collective called inside
    another one (a deprecated functional name forwarding to its successor,
    the functional all-gather served by the process group's) counts once,
    as the outer one."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    counts, real, depth = {}, [], [0]
    for mod, names in ((dist, ("all_reduce", "all_gather_into_tensor",
                               "reduce_scatter_tensor", "broadcast",
                               "barrier", "all_to_all_single")),
                       (funcol, ("all_reduce", "all_gather_tensor",
                                 "all_gather_single", "reduce_scatter_tensor",
                                 "reduce_scatter_single",
                                 "all_to_all_single"))):
        for name in names:
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            key = ("functional " + name.replace("_tensor", "")
                   .replace("_single", "") if mod is funcol else name)

            def counted(*a, _fn=fn, _key=key, **kw):
                if not depth[0]:
                    counts[_key] = counts.get(_key, 0) + 1
                depth[0] += 1
                try:
                    return _fn(*a, **kw)
                finally:
                    depth[0] -= 1
            setattr(mod, name, counted)
            real.append((mod, name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)


def dist_one_by_one(dev, d=DIST):
    """(a): a (1, 1) mesh under NCCL in this process. Returns the train
    steps' launch counts."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.bridge import tree_items
    from repro_torch.distributed import partitioning as part
    from repro_torch.distributed import stepfn
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.mesh import init_distributed, single_device_mesh
    full, cfg, model, init, batch, opt = _dist_setup(d, d["layers_nccl"],
                                                     dev)
    L, steps = cfg.n_layers, d["steps"]
    _log(f"distribution (a): {cfg.name} cut to {L} of its {full.n_layers} "
         f"layers at full width, batch {d['batch']} x {d['seq']}, "
         f"{steps} steps: (1, 1) mesh under NCCL against the single-device "
         "step")
    fn = stepfn.make_train_step(cfg, opt)
    state = stepfn.init_train_state(init())
    single, single_s = [], []
    for _ in range(steps):
        ts = time.perf_counter()
        state, m = fn(state, batch)
        single.append((float(m["loss"]), float(m["grad_norm"])))
        single_s.append(time.perf_counter() - ts)
    ref = dict(tree_items(state["params"]))
    del state
    P, S = d["prefill"]
    tokens = batch["tokens"][:P, :S]
    max_len = S + d["decode_steps"]

    def serve(prefill, decode, params):
        logits, cache = prefill(params, tokens)
        out = [logits]
        for i in range(d["decode_steps"]):
            logits, cache = decode(params, cache,
                                   out[-1].argmax(-1)[:, None], S + i)
            out.append(logits)
        return out

    params = init()
    served = serve(lambda p, t: model.prefill(p, {"tokens": t}, max_len),
                   model.decode_step, params)
    tmp = tempfile.mkdtemp(prefix="dist_nccl_")
    init_distributed("nccl", f"file://{tmp}/store", rank=0, world_size=1,
                     device=dev)
    try:
        mesh = single_device_mesh(device=dev)
        fn, sh, bsh = stepfn.make_train_step(cfg, opt, mesh=mesh)
        state = part.device_put(stepfn.init_train_state(init()), sh)
        b = part.device_put(batch, bsh(batch))
        rt.reset_launches()
        torch.cuda.synchronize()
        meshed, meshed_s = [], []
        for _ in range(steps):
            ts = time.perf_counter()
            state, m = fn(state, b)
            meshed.append((float(m["loss"]), float(m["grad_norm"])))
            meshed_s.append(time.perf_counter() - ts)
        launches = rt.launch_counts()
        check_launches("distribution (a) train", launches, {
            "flash_prefill[lse]": 2 * L * steps,
            "flash_prefill_bwd": L * steps})
        diff = [n for n, x in tree_items(state["params"])
                if not torch.equal(_bits(x.to_local()), _bits(ref[n]))]
        _log(f"distribution (a): losses / grad norms {meshed} on the mesh, "
             f"{single} on one device; {len(ref) - len(diff)} of "
             f"{len(ref)} params bit-equal after step {steps}; launches "
             f"flash_prefill[lse]={launches['flash_prefill[lse]']} "
             f"flash_prefill_bwd={launches['flash_prefill_bwd']}; step "
             f"times {[round(t, 4) for t in meshed_s]} s on the mesh (the "
             f"first builds DTensor's sharding rules), "
             f"{[round(t, 4) for t in single_s]} s on one device")
        if meshed != single or diff:
            raise AssertionError(f"distribution (a): the (1, 1) mesh step "
                                 f"parts from the single-device step: "
                                 f"{meshed} vs {single}; params {diff}")
        del state, ref
        prefill, psh, _ = stepfn.make_prefill_step(cfg, mesh, max_len,
                                                   batch=P)
        decode, _, _ = stepfn.make_decode_step(cfg, mesh, batch=P,
                                               max_len=max_len)
        p = part.device_put(params, psh)
        rt.reset_launches()
        got = serve(lambda q, t: prefill(q, {"tokens": t}), decode, p)
        n = rt.launch_counts()
        check_launches("distribution (a) serve", n, {"flash_prefill": L})
        got = [g.to_local() for g in got]
        same = all(torch.equal(g.argmax(-1), r.argmax(-1))
                   for g, r in zip(got, served))
        worst = max(float((g.float() - r.float()).abs().max())
                    for g, r in zip(got, served))
        _log(f"distribution (a): prefill {P} x {S} and {d['decode_steps']} "
             f"greedy steps on the mesh: tokens "
             f"{'identical' if same else 'DIFFER'}, largest logit "
             f"difference {worst:.3e}; flash_prefill={n['flash_prefill']}")
        if not same or worst != 0.0:
            raise AssertionError("distribution (a): the mesh prefill / "
                                 "decode parts from the single-device one")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def gather_through_process_group(dispatch_key="CUDA"):
    """Gloo ends the process on DTensor's functional all-gather of CUDA
    tensors, and takes the process group's ``all_gather_into_tensor``
    (``tools/gloo_cuda_collectives.py``). This registers the latter as the
    functional op's kernel for ``dispatch_key`` (the same gather, issued
    synchronously), for the ranks of part (b) only; returns the library,
    which must stay alive while it serves."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(inp, group_size, group_name):
        inp = inp.contiguous()
        out = inp.new_empty((inp.shape[0] * group_size,)
                            + tuple(inp.shape[1:]))
        dist.all_gather_into_tensor(
            out, inp, group=_resolve_process_group(group_name))
        return out
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, dispatch_key)
    return lib


def _local_part(full, x):
    """The part of the whole tensor ``full`` that DTensor ``x``'s rank holds
    by its placements, cut by index (even shards; mesh dims major to minor),
    independent of DTensor's own gathers."""
    from torch.distributed.tensor import Shard
    coord = x.device_mesh.get_coordinate()
    for md, p in enumerate(x.placements):
        if isinstance(p, Shard):
            full = torch.chunk(full, x.device_mesh.shape[md], p.dim)[coord[md]]
    return full


def _swap_shards(full, x):
    """``full`` with the shards of DTensor ``x``'s sharded mesh dims in
    reverse order: a whole tensor gathered in the wrong shard order."""
    from torch.distributed.tensor import Shard
    for md, p in enumerate(x.placements):
        if isinstance(p, Shard):
            full = torch.cat(torch.chunk(full, x.device_mesh.shape[md],
                                         p.dim)[::-1], p.dim)
    return full


def _worst_rel_l2(got, want):
    """The largest ``rel_l2`` over the leaves of ``want`` (name -> tensor),
    ``got`` holding the same names."""
    return max(rel_l2(got[n], x) for n, x in want.items())


def _gloo_rank(rank, world, tmp, d, q):
    """(b), one rank: TP 2 steps, the save, the restore onto DP 2 and a
    step there, then two planted faults: the TP params gathered with their
    shards swapped, and a DP step on a fresh restore with data shard 0's
    half of the batch on both ranks; puts its readings on ``q``. Rank 0 first runs the 1 x 1 step ``steps`` + 1 times on the same
    weights and batch and holds the mesh's params against it."""
    import faulthandler
    import sys as _sys
    _sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    # a collective gloo refuses on CUDA tensors can end the process in C++:
    # the Python stack is then written here for the parent to print
    fault = open(os.path.join(tmp, f"rank{rank}.fault"), "w")
    faulthandler.enable(fault)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.bridge import tree_items
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import partitioning as part
    from repro_torch.distributed import stepfn
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.mesh import init_distributed, make_mesh
    out = {"rank": rank}
    steps = d["steps"]
    try:
        gather_lib = gather_through_process_group()
        _, cfg, model, init, batch, opt = _dist_setup(d, d["layers_gloo"],
                                                      dev)
        ref = {}
        if rank == 0:
            fn = stepfn.make_train_step(cfg, opt)
            state = stepfn.init_train_state(init())
            out["one"] = []
            for i in range(steps + 1):
                state, m = fn(state, batch)
                out["one"].append((float(m["loss"]), float(m["grad_norm"])))
                if i + 1 >= steps:
                    ref[i + 1] = {n: x.clone()
                                  for n, x in tree_items(state["params"])}
            del state, fn

        def params_err(state, after):
            """The mesh state's params, gathered, against the 1 x 1 run's
            after step ``after`` (rank 0; every rank gathers)."""
            got = {n: x.full_tensor() for n, x in tree_items(state["params"])}
            return _worst_rel_l2(got, ref[after]) if rank == 0 else None

        with collectives_counted() as calls:
            init_distributed("gloo", f"file://{tmp}/store", rank=rank,
                             world_size=world)
            tp = make_mesh((1, world), ("data", "model"), device=dev)
            fn, sh, bsh = stepfn.make_train_step(cfg, opt, mesh=tp)
            state = part.device_put(stepfn.init_train_state(init()), sh)
            b = part.device_put(batch, bsh(batch))
            rt.reset_launches()
            ts = time.perf_counter()
            out["tp"] = []
            for _ in range(steps):
                state, m = fn(state, b)
                out["tp"].append((float(m["loss"]), float(m["grad_norm"])))
            out["tp_s"] = time.perf_counter() - ts
            out["tp_launches"] = rt.launch_counts()
            out["tp_calls"] = dict(calls)
            calls.clear()
            whole = {n: x.full_tensor() for n, x in tree_items(state)}
            out["tp_shards_differ"] = [
                n for n, x in tree_items(state)
                if not torch.equal(_bits(x.to_local()),
                                   _bits(_local_part(whole[n], x)))]
            if rank == 0:
                got = {n: whole["params/" + n] for n in ref[steps]}
                out["tp_param_err"] = _worst_rel_l2(got, ref[steps])
                out["swapped_param_err"] = _worst_rel_l2(
                    {n: _swap_shards(got[n], x)
                     for n, x in tree_items(state["params"])}, ref[steps])
                del got
            ckpt = CheckpointManager(f"{tmp}/ckpt", keep=1)
            ts = time.perf_counter()
            ckpt.save(steps, state)
            out["save_s"] = time.perf_counter() - ts
            del state
            dp = make_mesh((world, 1), ("data", "model"), device=dev)
            fn, sh, bsh = stepfn.make_train_step(cfg, opt, mesh=dp)
            ts = time.perf_counter()
            state, step = ckpt.restore_state(sh, shardings=sh)
            out["restore_s"] = time.perf_counter() - ts
            out["restored_step"] = step
            # each leaf whole (DTensor's own gather) and this rank's part of
            # it (cut by index) bit-equal to the state at the save
            out["differ"] = [
                n for n, x in tree_items(state)
                if not (torch.equal(_bits(x.full_tensor()), _bits(whole[n]))
                        and torch.equal(_bits(x.to_local()),
                                        _bits(_local_part(whole[n], x))))]
            out["n_leaves"] = len(whole)
            out["ckpt_calls"] = dict(calls)
            calls.clear()
            del whole
            rt.reset_launches()
            ts = time.perf_counter()
            state, m = fn(state, part.device_put(batch, bsh(batch)))
            out["dp"] = (float(m["loss"]), float(m["grad_norm"]))
            out["dp_s"] = time.perf_counter() - ts
            out["dp_launches"] = rt.launch_counts()
            out["dp_calls"] = dict(calls)
            out["dp_param_err"] = params_err(state, steps + 1)
            del state
            # planted: both ranks step on data shard 0's half of the batch
            state, _ = ckpt.restore_state(sh, shardings=sh)
            half = d["batch"] // world
            bsh_b = bsh(batch)
            bad = {k: DTensor.from_local(v[:half], dp, bsh_b[k].placements,
                                         run_check=False)
                   for k, v in batch.items()}
            state, m = fn(state, bad)
            out["planted"] = (float(m["loss"]), float(m["grad_norm"]))
            out["planted_param_err"] = params_err(state, steps + 1)
            del state
            dist.barrier()
            dist.destroy_process_group()
        del gather_lib
    except Exception as e:                       # reported by the parent
        import traceback
        out["error"] = traceback.format_exc()[-3000:]
        del e
    q.put(out)


def dist_two_ranks(dev, d=DIST):
    """(b): two spawned ranks over gloo, the tensors on the card. Returns
    each rank's launch counts summed over its steps."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile
    L, steps = d["layers_gloo"], d["steps"]
    _log(f"distribution (b): {d['arch']} cut to {L} layers at full width, "
         f"batch {d['batch']} x {d['seq']}: 2 ranks over gloo sharing the "
         f"card; TP 2 (1, 2) for {steps} steps, save, restore onto DP 2 "
         "(2, 1), 1 step; the default layout (Megatron-SP residual, the "
         "loss on the gathered logits)")
    tmp = tempfile.mkdtemp(prefix="dist_gloo_")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_gloo_rank, args=(r, 2, tmp, d, q))
             for r in range(2)]
    ts = time.perf_counter()
    for p in procs:
        p.start()
    res = {}
    try:
        while len(res) < 2 and time.perf_counter() - ts < d["timeout"]:
            try:
                r = q.get(timeout=5)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            res[r["rank"]] = r
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        faults = [open(os.path.join(tmp, f"rank{r}.fault")).read()[-3000:]
                  if os.path.exists(os.path.join(tmp, f"rank{r}.fault"))
                  else "" for r in range(2)]
        shutil.rmtree(tmp, ignore_errors=True)
    if len(res) < 2:
        raise AssertionError(f"distribution (b): ranks ended without a "
                             f"result (exit codes "
                             f"{[p.exitcode for p in procs]}):\n"
                             + "\n".join(faults))
    errs = [r["error"] for r in res.values() if "error" in r]
    if errs:
        raise AssertionError("distribution (b): a rank failed:\n"
                             + "\n".join(errs))
    totals = {}
    for r in (0, 1):
        x = res[r]
        for k in ("tp_launches", "dp_launches"):
            for name, n in x[k].items():
                totals.setdefault(r, {})[name] = \
                    totals.get(r, {}).get(name, 0) + n
        _log(f"distribution (b) rank {r}: TP 2 steps {x['tp']} in "
             f"{x['tp_s']:.2f} s, collectives {x['tp_calls']}; save "
             f"{x['save_s']:.2f} s, restore {x['restore_s']:.2f} s onto DP "
             f"2 (collectives {x['ckpt_calls']}); "
             f"{x['n_leaves'] - len(x['differ'])} of {x['n_leaves']} leaves "
             f"bit-equal, whole and this rank's part; DP step {x['dp']} in "
             f"{x['dp_s']:.2f} s, collectives {x['dp_calls']}; launches TP "
             f"flash_prefill[lse]={x['tp_launches']['flash_prefill[lse]']} "
             f"flash_prefill_bwd={x['tp_launches']['flash_prefill_bwd']}, DP "
             f"flash_prefill[lse]={x['dp_launches']['flash_prefill[lse]']} "
             f"flash_prefill_bwd={x['dp_launches']['flash_prefill_bwd']} "
             "(times through host memory: not a rate of distributed "
             "training)")
    r0 = res[0]
    one = r0["one"]
    pairs = [(f"TP 2 step {i + 1}", got, one[i])
             for i, got in enumerate(r0["tp"])]
    pairs.append((f"DP 2 step {steps + 1}", r0["dp"], one[steps]))
    bad = []
    for label, (lg, gg), (lw, gw) in pairs:
        rl, rg = abs(lg - lw) / abs(lw), abs(gg - gw) / abs(gw)
        _log(f"distribution (b): {label} loss {lg:.6f} against the 1 x 1 "
             f"step's {lw:.6f}: {rl:.3e} relative (tol "
             f"{d['loss_tol']:.1e}); grad norm {gg:.6f} against {gw:.6f}: "
             f"{rg:.3e} (tol {d['gnorm_tol']:.1e})")
        if not (rl <= d["loss_tol"] and rg <= d["gnorm_tol"]):
            bad.append(label)
    lw = one[steps][0]
    planted_rl = abs(r0["planted"][0] - lw) / abs(lw)
    caught = {"shards swapped": r0["swapped_param_err"] > d["param_tol"],
              "data shard 0's half on both DP ranks":
                  planted_rl > d["loss_tol"]
                  or r0["planted_param_err"] > d["param_tol"]}
    _log(f"distribution (b): params against the 1 x 1 run's, worst leaf "
         f"relative L2: after TP 2 step {steps} {r0['tp_param_err']:.3e}, "
         f"after DP 2 step {steps + 1} {r0['dp_param_err']:.3e} (tol "
         f"{d['param_tol']:.1e}); planted: the TP params' shards swapped "
         f"{r0['swapped_param_err']:.3e}; both DP ranks on data shard 0's "
         f"half of the batch: loss {r0['planted'][0]:.6f} ({planted_rl:.3e} "
         f"relative), params {r0['planted_param_err']:.3e}; "
         + ", ".join(f"{k} {'caught' if v else 'NOT caught'}"
                     for k, v in caught.items()))
    if bad or not all(caught.values()) or max(r0["tp_param_err"],
                                r0["dp_param_err"]) > d["param_tol"]:
        raise AssertionError(f"distribution (b): the mesh steps part from "
                             f"1 x 1 ({bad}) or the planted fault passed")
    for r, x in res.items():
        if x["differ"] or x["tp_shards_differ"] \
                or x["restored_step"] != steps:
            raise AssertionError(f"distribution (b) rank {r}: the DP 2 "
                                 f"restore differs in {x['differ']}, the "
                                 f"TP shards in {x['tp_shards_differ']}")
        for k in ("tp_launches", "dp_launches"):
            for name in ("flash_prefill[lse]", "flash_prefill_bwd"):
                if not x[k][name] > 0:
                    raise AssertionError(f"distribution (b) rank {r}: "
                                         f"{name} never launched ({k})")
    return totals


def _family_inputs(cfg, B, S, dev):
    """The distribution phase's SyntheticLM batch (B, S) for ``cfg``, and
    for Whisper seeded bf16 frame embeddings (B, encoder_seq, D)."""
    from repro_torch.data import DataConfig, SyntheticLM
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B,
                                   seed=DIST["seed"])).batch_at(0)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
    if cfg.family == "encdec":
        gen = torch.Generator(dev).manual_seed(DIST["seed"])
        batch["enc_embeds"] = torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)
    return batch


def dist_family(arch, f, mesh, dev):
    """(a′) for one family: ``f``'s cut of ``arch`` at full width, two
    train steps, a prefill and ``DIST_FAMILY_DECODE`` greedy decode steps
    on the (1, 1) ``mesh`` against the single-device steps, bit for bit.
    Returns the train steps' and the serving's launch counts."""
    import dataclasses

    from repro_torch.bridge import tree_items
    from repro_torch.configs import get_config
    from repro_torch.distributed import partitioning as part
    from repro_torch.distributed import stepfn
    from repro_torch.kernels import runtime as rt
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    full = get_config(arch)
    cfg = dataclasses.replace(full, **f["cut"])
    model = get_model(cfg)
    B, S, steps = f["batch"], f["seq"], DIST["steps"]
    batch = _family_inputs(cfg, B, S, dev)
    opt = AdamWConfig(lr=DIST["lr"], warmup_steps=2, decay_steps=4)

    def init():
        return model.init(torch.Generator(dev).manual_seed(DIST["seed"]),
                          dev)

    def train(fn, state, b):
        out, walls = [], []
        for _ in range(steps):
            ts = time.perf_counter()
            state, m = fn(state, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
            walls.append(round(time.perf_counter() - ts, 3))
        return state, out, walls

    state, single, single_s = train(stepfn.make_train_step(cfg, opt),
                                    stepfn.init_train_state(init()), batch)
    ref = dict(tree_items(state["params"]))
    del state
    fn, sh, bsh = stepfn.make_train_step(cfg, opt, mesh=mesh)
    b = part.device_put(batch, bsh(batch))
    rt.reset_launches()
    state, meshed, meshed_s = train(
        fn, part.device_put(stepfn.init_train_state(init()), sh), b)
    train_n = rt.launch_counts()
    check_launches(f"distribution (a') {arch} train", train_n,
                   {k: v * steps for k, v in
                    stepfn.kernel_launches(cfg).items()})
    diff = [n for n, x in tree_items(state["params"])
            if not torch.equal(_bits(x.to_local()), _bits(ref[n]))]
    n_params = len(ref)
    del state, b, ref
    _log(f"distribution (a') {arch}: cut to {cfg.n_layers} of its "
         f"{full.n_layers} layers at full width, batch {B} x {S}: losses / "
         f"grad norms {meshed} on the mesh, {single} on one device; "
         f"{n_params - len(diff)} of {n_params} params bit-equal after "
         f"step {steps}; launches "
         + (" ".join(f"{k}={v}" for k, v in train_n.items() if v)
            or "none (xLSTM's blocks run no kernel)")
         + f"; step times {meshed_s} s on the mesh, {single_s} s on one "
         "device")
    if meshed != single or diff:
        raise AssertionError(f"distribution (a') {arch}: the (1, 1) mesh "
                             f"step parts from the single-device step: "
                             f"{meshed} vs {single}; params {diff}")
    P, Sp = f["prefill"]
    pre = {k: v[:P, :Sp] if k == "tokens" else v[:P]
           for k, v in batch.items() if k != "targets"}
    max_len = Sp + DIST_FAMILY_DECODE

    def serve(prefill, decode, params):
        logits, cache = prefill(params, pre)
        out = [logits]
        for i in range(DIST_FAMILY_DECODE):
            logits, cache = decode(params, cache,
                                   out[-1].argmax(-1)[:, None], Sp + i)
            out.append(logits)
        return out

    params = init()
    served = serve(lambda p, x: model.prefill(p, x, max_len),
                   model.decode_step, params)
    prefill, psh, _ = stepfn.make_prefill_step(cfg, mesh, max_len, batch=P)
    decode, _, _ = stepfn.make_decode_step(cfg, mesh, batch=P,
                                           max_len=max_len)
    p = part.device_put(params, psh)
    rt.reset_launches()
    got = [g.to_local() for g in serve(prefill, decode, p)]
    serve_n = rt.launch_counts()
    want = stepfn.kernel_launches(cfg)
    check_launches(f"distribution (a') {arch} serve", serve_n, {
        "flash_prefill": want["flash_prefill_bwd"],
        "lru_scan": want["lru_scan_bwd"]})
    same = all(torch.equal(g.argmax(-1), r.argmax(-1))
               for g, r in zip(got, served))
    worst = max(float((g.float() - r.float()).abs().max())
                for g, r in zip(got, served))
    _log(f"distribution (a') {arch}: prefill {P} x {Sp} and "
         f"{DIST_FAMILY_DECODE} greedy steps on the mesh: tokens "
         f"{'identical' if same else 'DIFFER'}, largest logit difference "
         f"{worst:.3e}; launches "
         + (" ".join(f"{k}={v}" for k, v in serve_n.items() if v)
            or "none (the decode steps run no kernel)"))
    if not same or worst != 0.0:
        raise AssertionError(f"distribution (a') {arch}: the mesh prefill /"
                             " decode parts from the single-device one")
    del params, p, served, got
    return train_n, serve_n


def dist_families(dev, fams=DIST_FAMILIES):
    """(a′): ``dist_family`` for each family on one (1, 1) NCCL mesh in
    this process. Returns the launch counts by family."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, single_device_mesh
    tmp = tempfile.mkdtemp(prefix="dist_fam_")
    init_distributed("nccl", f"file://{tmp}/store", rank=0, world_size=1,
                     device=dev)
    out = {}
    try:
        mesh = single_device_mesh(device=dev)
        for arch, f in fams.items():
            t0 = time.perf_counter()
            out[arch] = dist_family(arch, f, mesh, dev)
            gc.collect()
            torch.cuda.empty_cache()
            _log(f"distribution (a') {arch}: "
                 f"{time.perf_counter() - t0:.1f}s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def distribution_phase(dev, d=DIST):
    """The distribution phase: (a), (a′), then (b). Returns (a)'s launch
    counts, (a′)'s by family and (b)'s per rank."""
    t0 = time.perf_counter()
    one = dist_one_by_one(dev, d)
    gc.collect()
    torch.cuda.empty_cache()
    fams = dist_families(dev)
    gc.collect()
    torch.cuda.empty_cache()
    two = dist_two_ranks(dev, d)
    _log(f"distribution: phase {time.perf_counter() - t0:.1f}s")
    return one, fams, two


# PerfOptions.moe_dispatch_constraint in the dry-run: DeepSeek-V2-Lite's
# train_4k cell at one layer unit on the fake single-pod (16, 16) group,
# traced with the field off and on: collective bytes by kind, and the MoE
# buffers' placements the trace applies
_MOE_PIN_TRACE = """
import json, logging, sys
from repro_torch.configs import get_config, pad_for_tp
from repro_torch.distributed import ctx
from repro_torch.launch import dryrun as D
from repro_torch.launch.loopfix import reduced_depth_cfg
from repro_torch.launch.mesh import make_production_mesh
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
arch, cell = sys.argv[1:]
D.start_group(256)
mesh = make_production_mesh(multi_pod=False)
cfg = reduced_depth_cfg(pad_for_tp(get_config(arch), 16), 1)
pin, seen, out = ctx.constrain_named, [], {}

def spy(name, t):
    y = pin(name, t)
    if name == "moe_dispatch":
        seen.append([list(t.shape), str(y.placements)])
    return y

ctx.constrain_named = spy
for on in (False, True):
    seen.clear()
    with ctx.perf_options(ctx.PerfOptions(moe_dispatch_constraint=on)):
        tr = D.trace_step(cfg, D._cell(cell), mesh)
    out[str(on)] = dict(coll=D.collective_bytes(tr.coll), seen=list(seen),
                        peak=tr.peak)
print(json.dumps(out))
"""
_TRAIN_TRACE = """
import dataclasses, json, logging, sys
from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import RooflineTerms
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
arch, L, B, S, model_flops = sys.argv[1:]
cfg = dataclasses.replace(get_config(arch), n_layers=int(L))
D.start_group(1)
mesh = make_mesh((1, 1), ("data", "model"), device=D.fake_devices()[1])
tr = D.trace_step(cfg, ShapeCell("train", int(S), int(B), "train"), mesh)
coll = D.collective_bytes(tr.coll)
t = RooflineTerms(arch, "train", "(1, 1)", 1, float(tr.flops),
                  float(tr.bytes), float(sum(coll.values())), coll,
                  float(model_flops), float(tr.peak))
print(json.dumps({"kernels": tr.kernels, "argument_bytes": tr.argument_bytes,
                  "devices": D.fake_devices(), **t.as_dict()}))
"""


def dryrun_phase(root):
    """The dry-run phase: the CLI on ``DRYRUN``'s cell (single pod,
    ``--correct``), then the training phase's step traced on a fake (1, 1)
    group beside the time the training phase measured; its kernel calls
    must equal the 5ᴸ / 5ᴮ rows' launches a step. Each in a subprocess
    (a fake group owns its process's default group)."""
    import tempfile

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    d = DRYRUN
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        path = os.path.join(tmp, "dryrun.json")
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             d["arch"], "--cell", d["cell"], "--single-pod-only",
             "--correct", "--results", path], capture_output=True,
            text=True, env=env, cwd=root, timeout=d["timeout"])
        if out.returncode:
            raise AssertionError(f"dryrun: the CLI failed:\n"
                                 f"{out.stdout[-3000:]}{out.stderr[-3000:]}")
        rec = json.load(open(path))[f"{d['arch']}|{d['cell']}|single"]
    r, m = rec["roofline"], rec["memory"]
    _log(f"dryrun: {d['arch']} x {d['cell']} x {r['mesh']}: status "
         f"{rec['status']}, traced in {rec['trace_s']} s; per device "
         f"arguments {m['argument_bytes_per_device'] / 1e9:.3f} GB, peak "
         f"{m['peak_bytes_per_device'] / 1e9:.3f} GB; flops "
         f"{r['hlo_flops']:.4e} bytes {r['hlo_bytes']:.4e} collective "
         f"{r['collective_bytes']:.4e} {r['collective_breakdown']}; "
         f"compute {r['compute_s'] * 1e3:.3f} ms, memory "
         f"{r['memory_s'] * 1e3:.3f} ms, collective "
         f"{r['collective_s'] * 1e3:.3f} ms -> {r['bottleneck']}-bound, "
         f"useful {r['useful_flops_ratio']:.3f} (extrapolated from 1 and 2 "
         f"layers over {rec['loopfix']['units']} units; the full trace's "
         f"flops {rec['roofline_raw']['hlo_flops']:.4e}); modelled with the "
         "H100's data-sheet constants, not measured")
    if rec["status"] != "ok":
        raise AssertionError(f"dryrun: {d['arch']} x {d['cell']}: {rec}")
    t = TRAIN
    cfg = get_config(t["arch"])
    out = subprocess.run(
        [sys.executable, "-c", _TRAIN_TRACE, t["arch"], str(t["layers"]),
         str(t["batch"]), str(t["seq"]),
         str(MEASURED.get("train_model_flops", 0.0))],
        capture_output=True, text=True, env=env, cwd=root,
        timeout=d["timeout"])
    if out.returncode:
        raise AssertionError(f"dryrun: the training trace failed:\n"
                             f"{out.stderr[-3000:]}")
    tr = json.loads(out.stdout.strip().splitlines()[-1])
    want = {"flash_prefill[lse]": 2 * t["layers"],
            "flash_prefill_bwd": t["layers"]}
    measured = MEASURED.get("train_step_s")
    _log(f"dryrun: the training phase's step ({cfg.name} cut to "
         f"{t['layers']} layers, B {t['batch']} x {t['seq']}, remat) traced "
         f"on a fake (1, 1) group of {tr['devices']} tensors: flops "
         f"{tr['hlo_flops']:.4e} (model flops {tr['model_flops']:.4e}, "
         f"useful {tr['useful_flops_ratio']:.3f}), bytes "
         f"{tr['hlo_bytes']:.4e}, arguments "
         f"{tr['argument_bytes'] / 1e9:.2f} GB, peak "
         f"{tr['per_device_peak_bytes'] / 1e9:.2f} GB; terms compute "
         f"{tr['compute_s'] * 1e3:.2f} ms, memory {tr['memory_s'] * 1e3:.2f}"
         f" ms -> {tr['bottleneck']}-bound, step >= {tr['step_s']:.4f} s "
         f"modelled against {measured} s measured by the training phase; "
         f"kernel calls {tr['kernels']} "
         f"(the 5ᴸ / 5ᴮ rows' launches a step: {want})")
    if tr["kernels"] != want:
        raise AssertionError(f"dryrun: the traced kernel calls "
                             f"{tr['kernels']} are not the training step's "
                             f"{want}")
    moe_pin_trace(root, env)
    _log(f"dryrun: phase {time.perf_counter() - t0:.1f}s")
    return rec, tr


def moe_pin_trace(root, env, arch="deepseek-v2-lite-16b", cell="train_4k"):
    """``PerfOptions.moe_dispatch_constraint`` in the dry-run
    (``_MOE_PIN_TRACE``): with the field on, every MoE buffer the trace
    pins lies by expert over 'model', and the collective bytes by kind
    differ from the field off; both printed."""
    out = subprocess.run([sys.executable, "-c", _MOE_PIN_TRACE, arch, cell],
                         capture_output=True, text=True, env=env, cwd=root,
                         timeout=DRYRUN["timeout"])
    if out.returncode:
        raise AssertionError(f"dryrun: the moe_dispatch_constraint trace "
                             f"failed:\n{out.stderr[-3000:]}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    off, on = r["False"], r["True"]
    for label, x in (("off", off), ("on", on)):
        _log(f"dryrun: {arch} x {cell} (one layer unit, single-pod (16, 16), "
             f"per device) with PerfOptions.moe_dispatch_constraint {label}: "
             f"collective bytes by kind "
             + ", ".join(f"{k} {v:.4e}" for k, v in sorted(x["coll"].items()))
             + f"; peak {x['peak'] / 1e9:.2f} GB; MoE buffers pinned: "
             + (", ".join(f"{tuple(sh)} {pl}" for sh, pl in x["seen"])
                or "none") + " (modelled, not measured)")
    if off["seen"] or not on["seen"] or any(
            pl != "(Replicate(), Shard(dim=0))" for _, pl in on["seen"]) \
            or on["coll"] == off["coll"]:
        raise AssertionError(f"dryrun: moe_dispatch_constraint: {r}")


# The examples phase (``examples/*_torch.py``, each ``main`` in this
# process at its own sizes). coe_serving's three runs: the defaults; the
# baseline scheduler on the int8 store; the mmap store with one expert's
# worth of the HBM tier carved out for the KV pool and a trace. The
# training check: a straight run of ``train_steps`` and one that loses its
# last checkpoint and resumes from the one before (the example's
# ``CKPT_EVERY``, 100), which must end bit-equal. A run of 100 steps
# resumed to 120 would follow another schedule (the cosine decays over
# --steps, as in JAX's example), so both runs take --steps 120.
EXAMPLES = dict(serve_runs=([], ["--scheduler", "run_to_completion",
                                 "--store", "int8"],
                            ["--store", "mmap", "--kv-reserve-experts",
                             "1"]),
                train_steps=120, seed=47)
# The examples' kernel rows: each kernel of the phase at the shape the
# phase gives it. The paged kernels at the reduced expert's widths (D 128,
# 4 q on 4 kv heads of 32, F 256) over coe_serving's pool (4 slots, block
# 8, 48 positions; lane 3 inactive); flash_prefill at the quickstart's
# prompt; the LSE form and the backward at train_expert's (8 heads of 64,
# B 8 x 256, causal).
EXAMPLE_PAGED_ROWS = {k: f"{k}[examples,D=128,dh=32,G=1,block=8]"
                      for k in PAGED_KERNELS}
EXAMPLE_PAGED_LEN1 = (9, 48, 17, 1)
EXAMPLE_PREFILL_ROW = "flash_prefill[examples,dh=32,G=1,B=2,S=16]"
EXAMPLE_LSE_ROW = "flash_prefill[lse,examples,dh=64,B=8,S=256]"
EXAMPLE_BWD_ROW = "flash_prefill_bwd[examples,dh=64,B=8,S=256]"


def example_kernel_rows(root, dev):
    """The examples phase's kernels against their plain versions at its
    shapes (``EXAMPLE_*_ROW``)."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("samba-coe-expert-7b"))
    cs = load_example(root, "coe_serving_torch")
    qs = load_example(root, "quickstart_torch")
    te = load_example(root, "train_expert_torch")
    n_slots = cs.parse_args([]).n_slots
    rows, _, _ = paged_rows(cfg, dev, EXAMPLE_PAGED_ROWS, EXAMPLES["seed"],
                            B=n_slots, block=cs.ENGINE["block_size"],
                            max_len=cs.ENGINE["max_len"],
                            len1=EXAMPLE_PAGED_LEN1)
    gen = torch.Generator(device=dev).manual_seed(EXAMPLES["seed"])
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows[EXAMPLE_PREFILL_ROW] = prefill_row(EXAMPLE_PREFILL_ROW, cfg,
                                            *qs.PROMPT, 0, gen, flush)
    t, c = te.parse_args([]), te.expert_config()
    B, S, H, d = t.batch, t.seq, c.n_heads, c.head_dim
    rows[EXAMPLE_BWD_ROW] = bwd_row(EXAMPLE_BWD_ROW, B, S, H, c.n_kv_heads,
                                    d, 0, gen, flush)
    q, k, v = (torch.randn((B, S, H, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    rows[EXAMPLE_LSE_ROW] = lse_row(EXAMPLE_LSE_ROW, q, k, v, flush)
    del q, k, v, flush
    torch.cuda.empty_cache()
    return rows


def nvidia_smi():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def load_example(root, name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counted_calls(mod, names, calls):
    """Replace ``mod``'s functions ``names`` by wrappers that zero the
    launch counts before each call and append (name, counts) after it."""
    from repro_torch.kernels import runtime as rt

    def wrap(name, fn):
        def call(*a, **k):
            rt.reset_launches()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            calls.append((name, rt.launch_counts()))
            return out
        return call
    for n in names:
        setattr(mod, n, wrap(n, getattr(mod, n)))


def examples_quickstart(root, dev):
    """quickstart_torch: forward and prefill each launch ``flash_prefill``
    once a layer and nothing else (the decode steps are plain); the
    forward's logits against the plain f32 forward of the same weights."""
    from repro_torch.bridge import tree_map
    from repro_torch.models import transformer as T
    qs = load_example(root, "quickstart_torch")
    calls = []
    counted_calls(qs, ("forward_logits", "prefill_and_decode"), calls)
    t0 = time.perf_counter()
    out = qs.main([])
    wall = time.perf_counter() - t0
    cfg = out["cfg"]
    for name, launches in calls:
        check_launches(f"examples: quickstart {name}", launches,
                       {"flash_prefill": cfg.n_layers})
    with torch.no_grad(), plain_prefill():
        ref = T.forward(cfg, tree_map(lambda t: t.float(), out["params"]),
                        {"tokens": out["tokens"]})
    logits_check("examples: quickstart forward logits (kernels, bf16) vs "
                 "the plain f32 forward", out["logits"], ref,
                 DENSE_PREFILL_LOGIT_TOL_REL)
    if out["spilled"] != ["act_a", "act_b"]:
        raise AssertionError(f"examples: quickstart placement {out}")
    _log(f"examples: quickstart {wall:.2f}s; flash_prefill launches "
         f"{[(n, c['flash_prefill']) for n, c in calls]} "
         f"({cfg.n_layers} layers a call)")
    return {EXAMPLE_PREFILL_ROW: sum(c["flash_prefill"] for _, c in calls)}


def serve_counts(coe, engine):
    """The counts of a coe_serving run that its timing cannot move."""
    st, cs, ps = engine.stats, coe.cache.stats, engine.pool.stats
    return dict(requests=st.requests, switches=st.switches,
                misses=cs.misses, decode_rounds=st.decode_rounds,
                allocs=ps.allocs, frees=ps.frees)


def examples_serving(root, dev):
    """coe_serving_torch's three runs on the card, each against the same
    run on the CPU made here: every request served, a clean pool, an
    evicting cache, the three paged kernels once a layer a decode round
    and nothing else (the packed prefill is plain, as in JAX), the
    timing-free counts equal to the CPU run's, and the trace valid."""
    import io
    import tempfile

    from repro_torch.kernels import runtime as rt
    from repro_torch.obs.trace import validate_chrome_trace
    cs = load_example(root, "coe_serving_torch")
    args = cs.parse_args([])
    out = dict.fromkeys(EXAMPLE_PAGED_ROWS.values(), 0)
    with tempfile.TemporaryDirectory(prefix="coe_trace_") as tmp:
        for i, extra in enumerate(EXAMPLES["serve_runs"]):
            argv, path = list(extra), None
            if "mmap" in extra:
                path = os.path.join(tmp, "trace.json")
                argv += ["--trace", path]
            label = f"examples: coe_serving {' '.join(extra) or 'defaults'}"
            with contextlib.redirect_stdout(io.StringIO()):
                ccoe, ceng, _ = cs.main(argv + ["--device", "cpu"])
            want = serve_counts(ccoe, ceng)
            torch.cuda.synchronize()
            rt.reset_launches()
            t0 = time.perf_counter()
            coe, eng, done = cs.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = rt.launch_counts()
            cfg = eng.cfg
            st, ps = eng.stats, eng.pool.stats
            if len(done) != args.requests or st.requests != args.requests:
                raise AssertionError(f"{label}: {len(done)} of "
                                     f"{args.requests} requests done")
            if ps.blocks_in_use or ps.allocs != ps.frees \
                    or eng.pool.check_invariants():
                raise AssertionError(f"{label}: KV pool {ps.as_dict()}")
            if coe.cache.stats.evictions < 1:
                raise AssertionError(f"{label}: no eviction "
                                     f"{coe.cache.stats.as_dict()}")
            check_launches(f"{label} ({cfg.n_layers} layers x "
                           f"{st.decode_rounds} decode rounds)", launches,
                           {k: cfg.n_layers * st.decode_rounds
                            for k in PAGED_KERNELS})
            got = serve_counts(coe, eng)
            if got != want:
                raise AssertionError(f"{label}: counts {got} on the card, "
                                     f"{want} on the CPU")
            if path is not None:
                with open(path) as f:
                    problems = validate_chrome_trace(json.load(f))
                if problems:
                    raise AssertionError(f"{label}: trace {problems[:5]}")
            _log(f"{label}: {wall:.2f}s, {st.tokens_out} tokens, "
                 f"{st.tokens_out / wall:.1f} tok/s; counts {got} equal to "
                 f"the CPU run's; launches "
                 f"{ {k: launches[k] for k in PAGED_KERNELS} }"
                 + ("; trace valid" if path is not None else ""))
            for k, row in EXAMPLE_PAGED_ROWS.items():
                out[row] += launches[k]
    return out


def examples_training(root, dev):
    """train_expert_torch: a straight run of ``train_steps`` in one
    directory; in another the same run, its last checkpoint removed, then
    resumed from the checkpoint before it. The two final checkpoints (every leaf's
    file) and states bit-equal, every loss finite, the training kernels
    launched as ``stepfn.kernel_launches`` counts a step."""
    import io
    import shutil
    import tempfile

    from repro_torch.bridge import tree_leaves
    from repro_torch.distributed import stepfn
    from repro_torch.kernels import runtime as rt
    te = load_example(root, "train_expert_torch")
    e = EXAMPLES
    steps = str(e["train_steps"])
    resume_at = (e["train_steps"] - 1) // te.CKPT_EVERY * te.CKPT_EVERY
    cfg, args = te.expert_config(), te.parse_args([])
    with tempfile.TemporaryDirectory(prefix="train_expert_") as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        rt.reset_launches()
        t0 = time.perf_counter()
        straight, losses_b, steady = te.main(["--steps", steps,
                                              "--ckpt", b])
        wall = time.perf_counter() - t0
        launches = rt.launch_counts()
        check_launches("examples: train_expert", launches,
                       {k: n * e["train_steps"] for k, n in
                        stepfn.kernel_launches(cfg).items()})
        _, losses_a, _ = te.main(["--steps", steps, "--ckpt", a])
        last = f"step-{e['train_steps']:09d}"
        shutil.rmtree(os.path.join(a, last))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            resumed, losses_r, _ = te.main(["--steps", steps, "--ckpt", a])
        text = buf.getvalue()
        print(text, end="")
        if f"resumed from step {resume_at}" not in text:
            raise AssertionError("examples: train_expert did not resume "
                                 f"from step {resume_at}")
        for name, losses, n in (("straight", losses_b, e["train_steps"]),
                                ("first", losses_a, e["train_steps"]),
                                ("resumed", losses_r,
                                 e["train_steps"] - resume_at)):
            if len(losses) != n or not torch.isfinite(losses).all():
                raise AssertionError(f"examples: train_expert {name} run "
                                     f"losses {losses}")
        diff = [i for i, (x, y) in enumerate(zip(tree_leaves(resumed),
                                                 tree_leaves(straight)))
                if x.dtype != y.dtype or not torch.equal(_bits(x), _bits(y))]
        files = sorted(f for f in os.listdir(os.path.join(b, last))
                       if f.endswith(".npy"))
        differ = [f for f in files if open(os.path.join(a, last, f), "rb")
                  .read() != open(os.path.join(b, last, f), "rb").read()]
        if diff or differ or not files:
            raise AssertionError(f"examples: train_expert resumed and "
                                 f"straight differ: leaves {diff}, files "
                                 f"{differ} of {len(files)}")
        if not torch.equal(losses_a[resume_at:], losses_r):
            raise AssertionError("examples: train_expert resumed losses "
                                 "differ from the first run's")
    n = e["train_steps"] - 1
    tokens = n * args.batch * args.seq
    _log(f"examples: train_expert {cfg.name} ({cfg.n_params() / 1e6:.1f}M "
         f"params, B {args.batch} x {args.seq}): {e['train_steps']} steps in "
         f"{wall:.2f}s; "
         f"{steady / n * 1e3:.2f} ms a step, {tokens / steady:.0f} tokens/s "
         f"(after the first step, checkpoint writes excluded); loss "
         f"{float(losses_b[0]):.4f} -> {float(losses_b[-1]):.4f}; resumed "
         f"from step {resume_at}: {len(files)} leaf files and "
         f"{len(tree_leaves(straight))} leaves bit-equal to the straight "
         f"run")
    return {EXAMPLE_LSE_ROW: launches["flash_prefill[lse]"],
            EXAMPLE_BWD_ROW: launches["flash_prefill_bwd"]}


def examples_phase(root, dev):
    """The user-facing examples on the card: quickstart, coe_serving's
    three runs, train_expert's straight and resumed runs. Returns each
    ``EXAMPLE_*`` row's launches: the quickstart's forward and prefill,
    the three serving runs, the straight training run."""
    t0 = time.perf_counter()
    launches = examples_quickstart(root, dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(examples_serving(root, dev))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(examples_training(root, dev))
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"examples: phase {time.perf_counter() - t0:.1f}s on "
         f"{nvidia_smi()}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available; this run needs one "
                 "H100")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.bridge import tree_map
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("samba-coe-expert-7b")
    t_start = time.perf_counter()
    build_kernels()
    warm_card(dev)
    rg_cfg = get_config("recurrentgemma-9b")
    rows = kernel_phase(cfg, dev)
    rows.update(dense_kernel_phase(cfg, dev))
    rows.update(node_kernel_phase(cfg, dev))
    rows.update(prefill_kernel_phase(cfg, rg_cfg, dev))
    rows.update(variant_kernel_phase(dev))
    rows.update(mixtral_kernel_row(dev))
    rows.update(deepseek_kernel_row(dev))
    rows.update(whisper_kernel_rows(dev))
    rows.update(train_kernel_rows(dev))
    rows.update(family_kernel_rows(dev))
    rows.update(example_kernel_rows(root, dev))
    rows.update(monarch_kernel_phase(dev))
    torch.cuda.empty_cache()
    launches = monarch_phase(dev)
    for name in ("monarch_fused", "monarch_conv_fused"):
        rows[name]["launches"] = launches[name]
    torch.cuda.empty_cache()
    launches, store, names, round_s, serve_out = serve_phase(cfg, dev)
    for name in PAGED_KERNELS:
        rows[name]["launches"] = launches[name]
    rows[FULL_PAGED_ROW]["launches"] = launches["decode_paged"]
    gc.collect()
    torch.cuda.empty_cache()
    modes_launches = serve_modes_phase(cfg, dev, store, names, round_s)
    gc.collect()
    torch.cuda.empty_cache()
    tenancy_phase(cfg, dev, store, names)
    gc.collect()
    torch.cuda.empty_cache()
    spec_prefills = speculative_phase(cfg, dev, store, names)
    gc.collect()
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.to(dev), store.get(names[0]))
    launches, prefill_launches = dense_decode_phase(cfg, dev, params)
    for name in DENSE_KERNELS:
        rows[name]["launches"] = launches[name]
    # the dense prefill's launches; the B 1 prefills of the sequential serve
    # drain and of the speculative phase
    rows["flash_prefill"]["launches"] = prefill_launches["flash_prefill"]
    rows[B1_PREFILL_ROW]["launches"] = (modes_launches["flash_prefill"]
                                        + spec_prefills)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    generate_phase(cfg, dev, store, names)
    gc.collect()
    torch.cuda.empty_cache()
    launches = node_phase(cfg, dev, store, names, serve_out)
    for kernel, row in NODE_ROWS.items():
        rows[row]["launches"] = launches[kernel]
    del serve_out
    store.delete(names[2])               # the tier phase takes two experts
    gc.collect()
    torch.cuda.empty_cache()
    tier_phase(cfg, dev, store, names)
    del store
    gc.collect()
    torch.cuda.empty_cache()
    launches = variants_phase(dev)
    for kernel, row in GRANITE_ROWS.items():
        rows[row]["launches"] = launches["granite-8b"][kernel]
    rows[ROPE_FRAC_ROW]["launches"] = sum(
        n[PARTIAL_ROPE] for n in launches.values())
    for arch, row in VARIANT_PREFILL_ROWS.items():
        rows[row]["launches"] = launches[arch]["flash_prefill"]
    for arch in GROUP_DECODE_ARCHS[:-1]:
        for kernel, row in zip(("decode_paged", "flash_decode"),
                               group_decode_row_names(arch)):
            rows[row]["launches"] = launches[arch].get(kernel, 0)
    rows[MIXTRAL_ROW]["launches"], rows[MIXTRAL_B1_ROW]["launches"] = \
        mixtral_phase(dev)
    rows[DEEPSEEK_ROW]["launches"] = deepseek_phase(dev)
    for row, n in whisper_phase(dev).items():
        rows[row]["launches"] = n
    xlstm_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches = train_phase(dev)
    rows[TRAIN_BWD_ROW]["launches"] = launches["flash_prefill_bwd"]
    rows[TRAIN_LSE_ROW]["launches"] = launches["flash_prefill[lse]"]
    gc.collect()
    torch.cuda.empty_cache()
    launches = family_train_phase(dev)
    # each backward row's launches: the calls made at its shape
    for key, (arch, _, Sq, Sk, *_, causal, window) in \
            family_bwd_shapes().items():
        n = launches[arch][0][("flash_prefill_bwd", Sq, Sk, causal, window)]
        if not n:
            raise AssertionError(f"{FAMILY_BWD_ROWS[key]}: no call at its "
                                 "shape in the family-training phase")
        rows[FAMILY_BWD_ROWS[key]]["launches"] = n
    rows[LRU_BWD_ROW]["launches"] = \
        launches["recurrentgemma-9b"][1]["lru_scan_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    distribution_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(root)
    launches = rg_phase(rg_cfg, dev)
    rows[RG_PREFILL_ROW]["launches"] = launches["flash_prefill"]
    rows["lru_scan"]["launches"] = launches["lru_scan"]
    for kernel, row in zip(("decode_paged", "flash_decode"),
                           group_decode_row_names(GROUP_DECODE_ARCHS[-1])):
        rows[row]["launches"] = launches.get(kernel, 0)
    gc.collect()
    torch.cuda.empty_cache()
    for row, n in examples_phase(root, dev).items():
        rows[row]["launches"] = n
    smi = nvidia_smi()
    _log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
