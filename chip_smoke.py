"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. Builds the hand-written kernels from ``src/repro_torch/**/csrc`` (one
   ``nvcc`` per source, in parallel) and prints each one's registers and
   spills; for ``decode_paged``, ``flash_prefill`` and the four
   weight-stream kernels (``qkv_rope_paged``, ``oproj_ffn_swiglu``,
   ``qkv_rope``, ``ffn_swiglu``) one line per kernel instantiation
   (head_dim and group; pass, lanes and column group) with its registers,
   spills and dynamic shared memory, failing on a spill or on wgmma
   instructions that ptxas serialised.
2. Kernel phase at the samba-coe-expert-7b widths (B = 8 lanes, bf16): the
   paged kernels at ragged positions 1..512 straddling blocks with one
   inactive lane (``decode_paged`` also with every lane at 512, held row by
   row to both its plain versions, the masked softmax and its own chunked
   arithmetic, with two chunk faults planted in the latter that the row
   check must catch), the dense-cache kernels at length 4096 in a 4096-position
   cache (``ffn_swiglu`` in both forms); then the prefill kernels:
   ``flash_prefill`` at the expert's prefill (8 x 2048 tokens, 32 heads,
   dh 128, causal) and at RecurrentGemma-9B's (4 x 3000 tokens, 16 q heads
   on 1 kv head, dh 256, window 2048), ``lru_scan`` at (4, 3000, 4096) f32.
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
5. Dense decode phase on one of those experts: ``prefill`` of 8 lanes x 2048
   tokens into a 4096-position cache (``flash_prefill`` once per layer), its
   first lane's last-token logits against the plain ``forward`` run in f32 a
   layer at a time, 16 greedy steps of 32 ``decoder_layer_step``s (each
   dense kernel once per layer per step), one step's logits against the
   plain ``decode_step`` run in f32 a layer at a time, two planted faults,
   and one step's device time by kernel.
6. Generate phase: ``CompositionOfExperts.generate`` over the same three
   experts (their pinned store, an HBM cache of two) with an ``LMRouter`` on
   the expert backbone: 8 prompts of 128 tokens, 16 new tokens each; the
   router and every group's prefill through ``flash_prefill``.
7. RecurrentGemma phase, after the experts' store is released:
   recurrentgemma-9b at full width and depth (38 layers, 10.4 G parameters,
   bf16) as the one expert of a ``CompositionOfExperts(HashRouter(1))`` on
   a pinned host store with an HBM cache of one expert; ``generate`` on 4
   prompts of 3000 tokens (past the 2048-position window), 16 new tokens,
   twice: 12 ``flash_prefill`` and 26 ``lru_scan`` launches per call; the
   first lane's prefill logits against the plain f32 composition.
8. Prints the kernel table as one JSON line, the card's name and power
   limit, and ends with ``{"ok": true, "device": {...}}``.

Exits non-zero without a card, and on any failure. Weights are random,
drawn from a fixed seed.
"""
from __future__ import annotations

import contextlib
import gc
import json
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
    "lru_scan": dict(
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


def build_kernels():
    from repro_torch.kernels import runtime as rt
    t0 = time.perf_counter()
    logs = rt.build()
    _log(f"built {len(logs)} kernel libraries in "
         f"{time.perf_counter() - t0:.1f}s (sm_90a)")
    prefill_smem = rt.bind("flash_prefill", "flash_prefill_smem_bytes",
                           [rt.I])
    passes = ("OprojPass", "GateUpPass", "DownPass")
    lanes = ("8", "16")
    for name, log in logs.items():
        if name == "decode_paged":
            paged_smem = rt.bind(name, "decode_paged_smem_bytes",
                                 [rt.I, rt.I])
            entry_build_report(
                name, log, r"decode_split_kernelILi(\d+)ELi(\d+)E",
                [(str(dh), str(g)) for dh in (32, 64, 128, 256)
                 for g in (1, 2, 4, 8)],
                lambda k: f"decode_paged[dh={k[0]} G={k[1]}]",
                lambda k: paged_smem(int(k[0]), int(k[1])))
        elif name == "flash_prefill":
            entry_build_report(
                name, log, r"prefill_kernelILi(\d+)E",
                [(str(dh),) for dh in (32, 64, 128, 256)],
                lambda k: f"flash_prefill[dh={k[0]}]",
                lambda k: prefill_smem(int(k[0])))
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


def split_faults_caught(name, got, q, kp, vp, tables, len1):
    """Row ``name`` of ``decode_paged``: its output ``got`` against its
    split plain version (the kernel's own chunks, merged in chunk order) row
    by row, within
    DECODE_ROW_REL_L2; then two faults planted in that plain version must
    read above it: the longest lane's second chunk's partial dropped, and
    the position at the start of every chunk but the first left out. Fails
    where a check does not hold."""
    from repro_torch.kernels.flash_attention.ops import split_chunk
    from repro_torch.kernels.flash_attention.ref import (merge_partials,
                                                         split_inputs,
                                                         split_partials)
    C = split_chunk()
    s, vc, valid = split_inputs(q, kp, vp, tables, len1)
    m, l, acc = split_partials(s, vc, valid, C)

    def merged(m, l, acc):
        return merge_partials(m, l, acc).reshape(q.shape).to(q.dtype)

    err = row_rel_l2(got, merged(m, l, acc))
    _log(f"kernel {name}: against the split plain version (chunk {C})"
         f" largest row relative L2 error {err:.3e} (tol "
         f"{DECODE_ROW_REL_L2:.3e})")
    if not err <= DECODE_ROW_REL_L2:
        raise AssertionError(f"{name}: a row's relative L2 error "
                             f"{err} against the split plain version")
    b = int(len1.argmax())
    m, l, acc = m.clone(), l.clone(), acc.clone()
    m[b, :, :, 1], l[b, :, :, 1], acc[b, :, :, 1] = float("-inf"), 0.0, 0.0
    edge = valid.clone()
    edge[:, C::C] = False
    for fault, want in (("chunk_dropped", merged(m, l, acc)),
                        ("chunk_edge_dropped",
                         merged(*split_partials(s, vc, edge, C)))):
        f_err = row_rel_l2(got, want)
        caught = f_err > DECODE_ROW_REL_L2
        _log(f"kernel {name}: planted fault {fault} (in the split "
             f"plain version) reads a row relative L2 error of {f_err:.3e} "
             f"-> {'caught' if caught else 'NOT caught'} at "
             f"{DECODE_ROW_REL_L2:.3e}")
        if not caught:
            raise AssertionError(f"{name}: the row check missed a planted "
                                 f"fault ({fault})")


def kernel_phase(cfg, dev, B=8):
    """Each kernel against its plain version at the config's widths."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention.ops import decode_paged
    from repro_torch.kernels.flash_attention.ref import decode_paged_ref
    from repro_torch.kernels.fused_decode.ops import (oproj_ffn_swiglu,
                                                      qkv_rope_paged)
    from repro_torch.kernels.fused_decode.ref import (oproj_ffn_swiglu_ref,
                                                      qkv_rope_paged_ref,
                                                      rope_inv_freq)
    from repro_torch.serving.backends import kernel_flops, kernel_hbm_bytes

    bf = torch.bfloat16
    D, Hq, Hkv, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    block, maxb = SERVE["block_size"], SERVE["max_len"] // SERVE["block_size"]
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    rows = B * maxb + 1
    x = rnd(B, D)
    q = rnd(B, Hq, dh)
    kp, vp = rnd(rows, block, Hkv, dh), rnd(rows, block, Hkv, dh)
    perm = torch.randperm(rows - 1, generator=gen, device=dev)
    tables = perm[:B * maxb].reshape(B, maxb).to(torch.int32)
    tables[3] = rows - 1                               # inactive lane
    len1_host = [1, 15, 16, 1, 17, 255, 300, 512]
    len1 = torch.tensor(len1_host, dtype=torch.int32, device=dev)
    pos = len1 - 1
    scale = (1.0 + 0.1 * rnd(D).float()).to(bf)
    wq, wk, wv = (rnd(D, Hq, dh, scale=D ** -0.5), rnd(D, Hkv, dh, scale=D ** -0.5),
                  rnd(D, Hkv, dh, scale=D ** -0.5))
    attn = rnd(B, Hq * dh)
    wo = rnd(Hq * dh, D, scale=(Hq * dh) ** -0.5)
    wg, wu = rnd(D, F, scale=D ** -0.5), rnd(D, F, scale=D ** -0.5)
    wd = rnd(F, D, scale=F ** -0.5)
    inv = torch.as_tensor(rope_inv_freq(dh, cfg.rope_theta), device=dev)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def lib_decode(tables, len1):
        S = maxb * block
        kc = kp[tables.long()].reshape(B, S, Hkv, dh).transpose(1, 2)
        vc = vp[tables.long()].reshape(B, S, Hkv, dh).transpose(1, 2)
        mask = (torch.arange(S, device=dev)[None, :] < len1[:, None])
        return Fn.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask[:, None, None, :],
            enable_gqa=Hq != Hkv)

    def lib_qkv():
        xn = (Fn.rms_norm(x.float(), (D,), eps=1e-6) * scale.float()).to(bf)
        return [torch.matmul(xn, w.reshape(D, -1)) for w in (wq, wk, wv)]

    def lib_epilogue():
        y = x + attn @ wo
        yn = Fn.rms_norm(y, (D,), weight=scale, eps=1e-6)
        return y + (Fn.silu(yn @ wg) * (yn @ wu)) @ wd

    cases = {
        "decode_paged": (lambda: decode_paged(q, kp, vp, tables, len1),
                         lambda: decode_paged_ref(q, kp, vp, tables, len1),
                         lambda: lib_decode(tables, len1)),
        "qkv_rope_paged": (lambda: qkv_rope_paged(x, scale, wq, wk, wv, pos,
                                                  theta=cfg.rope_theta),
                           lambda: qkv_rope_paged_ref(x, scale, wq, wk, wv,
                                                      pos, inv),
                           lib_qkv),
        "oproj_ffn_swiglu": (lambda: oproj_ffn_swiglu(x, attn, wo, scale, wg,
                                                      wu, wd),
                             lambda: oproj_ffn_swiglu_ref(x, attn, wo, scale,
                                                          wg, wu, wd),
                             lib_epilogue),
    }
    nbytes = kernel_hbm_bytes(cfg, B, len1_host, maxb)
    flops = kernel_flops(cfg, B, len1_host)
    rows_out = {name: kernel_row(name, *fns, nbytes[name], flops[name], flush,
                                 row_tol=DECODE_ROW_REL_L2
                                 if name == "decode_paged"
                                 else STREAM_ROW_REL_L2)
                for name, fns in cases.items()}
    split_faults_caught("decode_paged", decode_paged(q, kp, vp, tables, len1),
                        q, kp, vp, tables, len1)
    # every lane at 512 positions, on rows of its own
    full = perm[:B * maxb].reshape(B, maxb).to(torch.int32)
    len1_full = torch.full((B,), maxb * block, dtype=torch.int32, device=dev)
    rows_out[FULL_PAGED_ROW] = kernel_row(
        FULL_PAGED_ROW, lambda: decode_paged(q, kp, vp, full, len1_full),
        lambda: decode_paged_ref(q, kp, vp, full, len1_full),
        lambda: lib_decode(full, len1_full),
        kernel_hbm_bytes(cfg, B, [maxb * block] * B, maxb)["decode_paged"],
        kernel_flops(cfg, B, [maxb * block] * B)["decode_paged"], flush,
        kernel="decode_paged", row_tol=DECODE_ROW_REL_L2)
    split_faults_caught(FULL_PAGED_ROW,
                        decode_paged(q, kp, vp, full, len1_full), q, kp, vp,
                        full, len1_full)
    for name in ("qkv_rope_paged", "oproj_ffn_swiglu"):
        pass_times(name, rows_out[name], cases[name][0], flush)
    got = cases["qkv_rope_paged"][0]()
    rope_fault_caught("qkv_rope_paged", got, qkv_rope_paged_ref(
        x, scale, wq, wk, wv, torch.zeros_like(pos), inv))
    del flush
    return rows_out


def dense_kernel_phase(cfg, dev, B=8):
    """The dense-cache decode kernels against their plain versions at the
    config's widths: ``flash_decode`` at length 4096 in a 4096-position
    cache (8 lanes x 32 kv heads), ``qkv_rope`` at position 4095,
    ``ffn_swiglu`` in both forms (the row times the residual form)."""
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
                             if name in STREAM_PASSES else None)
            for name, fns in cases.items()}
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


def prefill_kernel_phase(cfg, rg_cfg, dev):
    """The prefill kernels against their plain versions at the main paths'
    shapes: ``flash_prefill`` at the dense phase's prefill (8 x 2048 tokens
    at the expert's widths, causal) and at the RG phase's (4 x 3000 tokens,
    RecurrentGemma's local attention), ``lru_scan`` at the RG phase's
    recurrence (4 x 3000 x d_rnn, f32, coefficients in (0, 1) as
    ``_lru_coeffs`` makes them)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.lru_scan.ops import lru_scan
    from repro_torch.kernels.lru_scan.ref import lru_scan_ref
    from repro_torch.models.layers import naive_attention
    from repro_torch.serving.backends import (lru_scan_hbm_bytes,
                                              prefill_attention_flops,
                                              prefill_attention_hbm_bytes)

    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    shapes = {
        "flash_prefill": (cfg, DENSE["lanes"], DENSE["prompt_len"], 0),
        RG_PREFILL_ROW: (rg_cfg, RG["prompts"], RG["prompt_len"],
                         rg_cfg.sliding_window),
    }
    for row, (c, B, S, window) in shapes.items():
        Hq, Hkv, dh = c.n_heads, c.n_kv_heads, c.head_dim
        q, k, v = (torch.randn((B, S, h, dh), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
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
        rows[row] = kernel_row(
            row, lambda: attention(q, k, v, causal=True, window=window),
            lambda: attention_ref(q, k, v, causal=True, window=window), lib,
            prefill_attention_hbm_bytes(B, S, Hq, Hkv, dh),
            prefill_attention_flops(B, S, Hq, dh, window), flush,
            kernel="flash_prefill", row_tol=PREFILL_ROW_REL_L2)
        r = rows[row]
        _log(f"kernel {row}: {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s, "
             f"{r['bound_ms'] / r['ms']:.3f} of the bound; SDPA "
             f"{r['library_ms']:.4f} ms ({r['library_ms'] / r['ms']:.3f}x "
             "the kernel's time)")
        # off-by-one masks, planted in the plain version: each must fail
        # the row check against the true plain output
        want = attention_ref(q, k, v, causal=True, window=window)
        mutants = {"causal edge +1": dict(window=window, q_offset=1)}
        if window:
            mutants["window edge +1"] = dict(window=window + 1)
            mutants["window edge -1"] = dict(window=window - 1)
        for label, kw in mutants.items():
            m_err = row_rel_l2(naive_attention(q, k, v, causal=True, **kw),
                               want)
            _log(f"kernel {row}: planted {label}: row relative L2 error "
                 f"{m_err:.3e} "
                 f"{'caught' if m_err > PREFILL_ROW_REL_L2 else 'NOT caught'}")
            if not m_err > PREFILL_ROW_REL_L2:
                raise AssertionError(f"{row}: the row check misses a "
                                     f"planted {label}")
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()
    B, S, D = RG["prompts"], RG["prompt_len"], rg_cfg.d_rnn
    a = torch.rand((B, S, D), generator=gen, device=dev)
    b = torch.randn((B, S, D), generator=gen, device=dev)
    # f32 in both, summed in other orders (a sequential walk, a doubling
    # scan): 1e-5 of the largest |h| (CPU trials at S = 3000: 5e-7)
    rows["lru_scan"] = kernel_row(
        "lru_scan", lambda: lru_scan(a, b), lambda: lru_scan_ref(a, b), None,
        lru_scan_hbm_bytes(B, S, D), 2 * B * S * D, flush, rel_tol=1e-5,
        peak=F32_FLOPS_PER_S)
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
    """TTFT p50 / p99 read exactly from the done requests, beside the
    ``serve.ttft_s`` histogram's P² estimates."""
    ttft = np.asarray([r.first_token_s - r.arrival_s for r in done])
    h = registry.histogram("serve.ttft_s")
    return (f"TTFT p50={np.percentile(ttft, 50):.4f}s "
            f"p99={np.percentile(ttft, 99):.4f}s (serve.ttft_s P2: "
            f"p50={h.quantile(0.5):.4f}s p99={h.quantile(0.99):.4f}s, "
            f"count {h.count})")


def serve_phase(cfg, dev):
    """The port's main path: the engine serving full-width experts."""
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.serve import build_coe, make_requests
    from repro_torch.serving import ServingEngine, xla_paged_extend

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
    if len(done) != s["requests"]:
        raise AssertionError(f"{len(done)} of {s['requests']} requests done")
    for r in done:
        if r.output is None or len(r.output) != s["new_tokens"]:
            raise AssertionError(f"request {r.rid}: output {r.output}")
        if not ((r.output >= 0) & (r.output < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.rid}: token out of vocabulary")
    problems = engine.pool.check_invariants()
    if problems or engine.pool.stats.blocks_in_use:
        raise AssertionError(f"KV pool: {problems}, "
                             f"{engine.pool.stats.blocks_in_use} leaked")
    want = cfg.n_layers * st.decode_rounds
    for name, n in launches.items():
        if name in PAGED_KERNELS and n != want or \
                name not in PAGED_KERNELS and n != 0:
            raise AssertionError(f"{name}: {n} launches, expected {want} "
                                 f"({cfg.n_layers} layers x "
                                 f"{st.decode_rounds} decode rounds)")
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

    # one decode step, fused kernels vs the plain reference, same pool state
    rs = np.random.RandomState(1)
    params = coe.cache.activate(coe.expert_names()[0])
    prompts = [rs.randint(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rs.randint(1, 120, size=s["n_slots"])]
    rids = list(range(10_000, 10_000 + s["n_slots"]))
    for i in range(0, len(prompts), 4):
        chunk = rids[i:i + 4]
        res = engine.prefill_runner(params, prompts[i:i + 4])
        engine.prefill_runner.scatter_into(engine.pool, res, chunk,
                                           extra_tokens=[1] * len(chunk))
    tables = torch.as_tensor(np.stack([engine.pool.padded_table(
        r, engine.max_blocks) for r in rids]), device=dev)
    lengths = torch.as_tensor([engine.pool.length(r) for r in rids],
                              dtype=torch.int32, device=dev)
    active = torch.ones(s["n_slots"], dtype=torch.bool, device=dev)
    active[3] = False
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, (s["n_slots"], 1)),
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
    from repro_torch.bridge import tree_map
    l32, _, _ = xla_paged_extend(cfg, tree_map(lambda t: t.float(), params),
                                 *(t.float() for t in state), tables, lengths,
                                 active, toks, scratch)
    lf, lr, l32 = (t[active].float() for t in (lf, lr, l32))
    if not torch.isfinite(lf).all():
        raise AssertionError("fused logits not finite")
    tol = LOGIT_TOL_REL * float(l32.abs().max())

    def gap(logits, ref):
        return (float((logits - ref).abs().max()),
                float((logits - ref).norm() / ref.norm()))

    err, rel = gap(lf, l32)
    agree = float((lf.argmax(-1) == l32.argmax(-1)).float().mean())
    _log(f"reference check: fused vs f32 plain body max_abs_err={err:.4f} "
         f"(tol {tol:.4f}) rel_l2={rel:.5f} argmax_agree={agree:.3f} "
         f"|logits|max={float(l32.abs().max()):.3f}; bf16 plain body vs f32: "
         "max_abs_err=%.4f rel_l2=%.5f" % gap(lr, l32))
    if not err <= tol:
        raise AssertionError(f"fused vs f32 reference logits differ by {err} "
                             f"> {tol}")
    for fault, (name, fn) in planted_faults(cfg).items():
        with fault_planted(name, fn):
            lx = fused_step()[active].float()
        f_err, f_rel = gap(lx, l32)
        _log(f"planted fault {fault} (layer {FAULT_LAYER}): max_abs_err="
             f"{f_err:.4f} rel_l2={f_rel:.5f} -> "
             f"{'caught' if f_err > tol else 'NOT caught'} at tol {tol:.4f}")
    del l32

    # where one decode step's time goes: host wall per step without the
    # profiler, device time per kernel name with it
    kc, vc = (t.clone() for t in state)
    step = lambda: engine.runner.extend(params, kc, vc, tables, lengths,
                                        active, toks)
    label = f"decode step ({s['n_slots']} lanes, {cfg.n_layers} layers)"
    step_breakdown(step, label)
    step_under(step, label, ("decode_split_kernel", "OprojPass"))
    del kc, vc
    for r in rids:
        engine.pool.free(r)
    coe.cache.close()
    return (launches, coe.store, coe.expert_names(),
            st.exec_s / st.decode_rounds)


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

    from repro_torch.bridge import tree_map
    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
    from repro_torch.kernels import runtime as rt
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
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
    f32 = lambda tree: tree_map(lambda t: t.float(), tree)
    with torch.no_grad(), plain_prefill():
        h = T.embed_tokens(cfg, params, toks).float()
        positions = torch.arange(len(prompt), device=dev)[None]
        for i in range(nL):
            h, _ = T._layer(cfg, f32(T.layer_params(params, i)), h, positions)
        h = L.apply_norm(cfg, f32(params["final_norm"]), h[:, -1:])
        l32 = (h @ params["lm_head"].float())[0, 0]
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
    del h, l32

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
    # the first lane's last-token logits against the plain forward in f32,
    # upcasting one layer's weights at a time
    with torch.no_grad(), plain_prefill():
        h = T.embed_tokens(cfg, params, prompts[:1]).float()
        positions = torch.arange(P, device=dev)[None]
        for i in range(nL):
            h, _ = T._layer(cfg, f32(T.layer_params(params, i)), h, positions)
        h = L.apply_norm(cfg, f32(params["final_norm"]), h[:, -1:])
        l32 = (h @ params["lm_head"].float())[:, 0]
    logits_check("dense prefill reference check: kernels vs f32 plain "
                 "forward", last[:1], l32, DENSE_PREFILL_LOGIT_TOL_REL)
    del h, l32
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
    lb = T.decode_step(cfg, params, cache, tok[:, None], pos)[0].float()
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
    rg_cfg = get_config("recurrentgemma-9b")
    rows = kernel_phase(cfg, dev)
    rows.update(dense_kernel_phase(cfg, dev))
    rows.update(prefill_kernel_phase(cfg, rg_cfg, dev))
    rows.update(monarch_kernel_phase(dev))
    torch.cuda.empty_cache()
    launches = monarch_phase(dev)
    for name in ("monarch_fused", "monarch_conv_fused"):
        rows[name]["launches"] = launches[name]
    torch.cuda.empty_cache()
    launches, store, names, round_s = serve_phase(cfg, dev)
    for name in PAGED_KERNELS:
        rows[name]["launches"] = launches[name]
    rows[FULL_PAGED_ROW]["launches"] = launches["decode_paged"]
    gc.collect()
    torch.cuda.empty_cache()
    modes_launches = serve_modes_phase(cfg, dev, store, names, round_s)
    gc.collect()
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.to(dev), store.get(names[0]))
    launches, prefill_launches = dense_decode_phase(cfg, dev, params)
    for name in DENSE_KERNELS:
        rows[name]["launches"] = launches[name]
    # the dense prefill's launches and the sequential serve drain's
    rows["flash_prefill"]["launches"] = (prefill_launches["flash_prefill"]
                                         + modes_launches["flash_prefill"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    generate_phase(cfg, dev, store, names)
    del store
    gc.collect()
    torch.cuda.empty_cache()
    launches = rg_phase(rg_cfg, dev)
    rows[RG_PREFILL_ROW]["launches"] = launches["flash_prefill"]
    rows["lru_scan"]["launches"] = launches["lru_scan"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
