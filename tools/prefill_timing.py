"""Time the port's ``flash_prefill`` at the shapes ``chip_smoke.py``'s
kernel phases hold it to (``chip_smoke.prefill_shapes``, then Whisper's
three FULL shapes, neither causal nor windowed), on one card, for
comparing two trees of the repository in one call:

    python tools/prefill_timing.py --src build/parent/src --label parent
    python tools/prefill_timing.py --src src --label tree

``--src`` is the ``src`` directory of the tree under test: its
``repro_torch`` (kernel, configs) is imported from there and builds its
kernels into its own ``build/``; the shapes are this tree's. A shape whose
config or widths the tree under test does not have is reported as
skipped. Each shape, random bf16 q / k / v from seed 0, causal, is held
against the plain version (largest row relative L2 error within 2^-6) and
timed as ``chip_smoke.py`` times a row (``chip_smoke.time_ms``: the mean
of ``--reps`` launches, each after a 128 MB write flushed the L2, behind a
spin kernel). One JSON line a shape: its name, ms, the row error, the card
and its power limit. A first JSON line gives each kernel instantiation's
``-Xptxas -v`` report and a digest of its SASS (``cuobjdump -sass``, with
addresses and encodings left out), so two trees' builds of an unchanged
instantiation can be seen to be the same code.

Then the LSE form at the training phase's shape (``chip_smoke.
TRAIN_LSE_ROW``) and the backward, ``flash_prefill_bwd``, at that shape,
at Mixtral's (``chip_smoke.TRAIN_BWD_ROW``, ``TRAIN_BWD_GQA_ROW``) and at
the families' training shapes (``chip_smoke.FAMILY_BWD_ROWS``:
RecurrentGemma's d 256, DeepSeek's (192, 128), Whisper's FULL encoder
and cross-attention at d 64): a JSON line of
its kernels' reports, SASS digests and counts of tensor-core instructions
(``HMMA``: ``mma.sync``; ``HGMMA``: ``wgmma``), then one a shape: dq / dk
/ dv against ``attention_bwd_ref`` (relative L2 within ``chip_smoke.
TRAIN_BWD_REL_L2``), the kernel's time and, in the same process, the
autograd backward of SDPA on the same inputs (``chip_smoke.sdpa_grad``,
the yardstick ``chip_smoke.bwd_row`` times)."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# prefill_kernel<DK>, <DK, DV>, <DK, DV, FULL> or <DK, DV, FULL, LSE> in a
# mangled name
_ENTRY = r"prefill_kernelILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?(?:Lb([01])E)?"
# the backward's kernels: <D>, the warp-specialised <D, FULL> and <DK,
# DV> (wide_kernel and its sum; a tree before it: the mma.sync <DK, DV>)
_BWD_ENTRY = (r"((?:mma_)?(?:di|stat|dkdv|dq|bwd|dq_out|wide|wide_dq|"
              r"wide_sum)_kernel)ILi(\d+)E(?:Lb([01])E)?(?:Li(\d+)E)?")


def _key(m):
    return f"{m.group(1)},{m.group(2) or m.group(1)}" + (
        ",full" if m.group(3) == "1" else "") + (
        ",lse" if m.group(4) == "1" else "")


def _bwd_key(m):
    # a square instantiation reads as the trees before FULL named it
    return f"{m.group(1)},{m.group(2)}" + (
        ",full" if m.group(3) == "1" else "") + (
        f",{m.group(4)}" if m.group(4) else "")


def instantiations(lib, log, entry=_ENTRY, key_of=_key):
    """{"dk,dv": {"ptxas": [...], "sass": sha256}} of every
    ``prefill_kernel`` instantiation in library ``lib`` (a tree that
    instantiates one width per kernel reads as dk = dv; a FULL
    instantiation, neither causal nor windowed, as "dk,dv,full"; the LSE
    form, the training forward, as "dk,dv,lse")."""
    import hashlib
    import re
    import shutil
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(entry, m.group(1))
            key = key_of(k) if k else None
        elif key is not None and ("spill" in ln or "Used" in ln):
            out.setdefault(key, {"ptxas": []})["ptxas"].append(
                ln.split("info    :")[-1].strip())
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    for name, body in zip(parts[1::2], parts[2::2]):
        k = re.search(entry, name)
        if not k:
            continue
        body = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", body)
        text = "\n".join(ln.strip() for ln in body.splitlines() if ln.strip())
        rec = out.setdefault(key_of(k), {})
        rec["sass"] = hashlib.sha256(text.encode()).hexdigest()[:16]
        rec["HMMA"] = len(re.findall(r"\bHMMA\b", text))
        rec["HGMMA"] = len(re.findall(r"\bHGMMA\b", text))
    return out


def kernel_split(fn, calls=10):
    """{CUDA kernel name: mean device ms a call} of ``fn`` under
    ``torch.profiler`` (warm L2: back to back)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    import re
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            m = re.search(r"([A-Za-z_]\w*)(?:<[^()]*>)?\(", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def backward_rows(args, card, flush):
    """The backward's kernels' reports, then one JSON line a shape: the
    kernel's time and SDPA's backward's on the same inputs."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention.ops import (attention_bwd,
                                                         attention_lse)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    log = rt.build(["flash_prefill_bwd"])["flash_prefill_bwd"]
    print(json.dumps({"label": args.label, "bwd_instantiations":
                      instantiations(rt._lib_path("flash_prefill_bwd"), log,
                                     _BWD_ENTRY, _bwd_key)}), flush=True)
    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(1)
    c, m = get_config(cs.TRAIN["arch"]), get_config("mixtral-8x7b")
    # (row, B, Sq, Sk, Hq, Hkv, dk, dv, causal, window)
    shapes = [(cs.TRAIN_BWD_ROW, cs.TRAIN["batch"], cs.TRAIN["seq"],
               cs.TRAIN["seq"], c.n_heads, c.n_kv_heads, c.head_dim,
               c.head_dim, True, 0),
              (cs.TRAIN_BWD_GQA_ROW, cs.MIXTRAL["prompts"],
               cs.MIXTRAL["prompt_len"], cs.MIXTRAL["prompt_len"],
               m.n_heads, m.n_kv_heads, m.head_dim, m.head_dim, True,
               m.sliding_window)]
    family = cs.family_bwd_shapes()
    shapes += [(cs.FAMILY_BWD_ROWS[key], *family[key][1:])
               for key in ("rg", "mla", "enc", "cross")]
    for row, B, Sq, Sk, Hq, Hkv, dk, dv, causal, window in shapes:
        if args.only and not any(row.startswith(o) for o in args.only):
            continue
        q, k, v, do = cs.bwd_inputs(B, Sq, Sk, Hq, Hkv, dk, dv, gen, dev)
        o, lse = attention_lse(q, k, v, causal=causal, window=window)
        kern = lambda: attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window)
        got, again = kern(), kern()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{row}: two calls differ")
        errs = [cs.rel_l2(g, w) for g, w in zip(
            got, attention_bwd_ref(q, k, v, do, causal=causal,
                                   window=window))]
        del got, again
        if not max(errs) <= cs.TRAIN_BWD_REL_L2:
            raise AssertionError(f"{row}: relative L2 {errs}")
        ms = cs.time_ms(kern, flush, args.reps)
        lib = cs.sdpa_grad(q, k, v, do, causal, window)
        sdpa_ms = cs.time_ms(lib, flush, args.reps)
        nbytes, flops = cs.bwd_cost(B, Sq, Hq, Hkv, dk, window, Sk=Sk, dv=dv,
                                    causal=causal)
        print(json.dumps({"label": args.label, "row": row, "ms": ms,
                          "sdpa_bwd_ms": sdpa_ms, "rel_l2": errs,
                          "tflops": flops / ms / 1e9,
                          "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S,
                                          flops / cs.BF16_FLOPS_PER_S) * 1e3,
                          "kernels_ms": kernel_split(kern), "card": card}),
              flush=True)
        del q, k, v, o, lse, do, lib
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--only", nargs="*", default=None,
                    help="shape names (by prefix) to time; all by default "
                         "(the backward's start flash_prefill_bwd)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    if not torch.cuda.is_available():
        sys.exit("prefill_timing: needs a CUDA card")
    log = rt.build(["flash_prefill"])["flash_prefill"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "instantiations": instantiations(
        rt._lib_path("flash_prefill"), log)}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for arch, B, S, windowed in cs.prefill_shapes():
        name = f"{arch},B={B},S={S}" + (",windowed" if windowed else "")
        if args.only and not any(name.startswith(o) for o in args.only):
            continue
        try:
            c = get_config(arch)
        except KeyError as e:            # a tree without this config
            print(json.dumps({"label": args.label, "row": name,
                              "skipped": str(e)}), flush=True)
            continue
        window = c.sliding_window if windowed else 0
        dk, dv = cs.prefill_widths(c)
        q, k = (torch.randn((B, S, h, dk), generator=gen, device=dev)
                .to(torch.bfloat16) for h in (c.n_heads, c.n_kv_heads))
        v = torch.randn((B, S, c.n_kv_heads, dv), generator=gen,
                        device=dev).to(torch.bfloat16)
        try:
            got = attention(q, k, v, causal=True, window=window)
        except ValueError as e:          # a tree without these widths
            print(json.dumps({"label": args.label, "row": name,
                              "skipped": str(e)}), flush=True)
            continue
        want = attention_ref(q, k, v, causal=True, window=window)
        err = cs.row_rel_l2(got, want)
        if not err <= 2.0 ** -6:
            raise AssertionError(f"{name}: row relative L2 error {err}")
        ms = cs.time_ms(lambda: attention(q, k, v, causal=True,
                                          window=window), flush, args.reps)
        print(json.dumps({"label": args.label, "row": name, "ms": ms,
                          "row_rel_l2": err, "card": card}), flush=True)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    # the FULL instantiation (neither mask) at Whisper-small's three shapes:
    # the encoder, the teacher-forced cross-attention, the prefill's
    c, w = get_config("whisper-small"), cs.WHISPER
    B, Se, H, d = w["lanes"], c.encoder_seq, c.n_heads, c.head_dim
    for Sq in (Se, w["target_len"], w["prompt_len"]):
        name = f"whisper-small,B={B},Sq={Sq},Sk={Se},full"
        if args.only and not any(name.startswith(o) for o in args.only):
            continue
        q = torch.randn((B, Sq, H, d), generator=gen, device=dev) \
            .to(torch.bfloat16)
        k, v = (torch.randn((B, Se, H, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        err = cs.row_rel_l2(attention(q, k, v, causal=False),
                            attention_ref(q, k, v, causal=False))
        if not err <= 2.0 ** -6:
            raise AssertionError(f"{name}: row relative L2 error {err}")
        ms = cs.time_ms(lambda: attention(q, k, v, causal=False), flush,
                        args.reps)
        print(json.dumps({"label": args.label, "row": name, "ms": ms,
                          "row_rel_l2": err, "card": card}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    # the LSE form (the training forward) at the training phase's shape
    # (chip_smoke.TRAIN_LSE_ROW)
    from repro_torch.kernels.flash_attention.ops import attention_lse
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    name = cs.TRAIN_LSE_ROW
    if not args.only or any(name.startswith(o) for o in args.only):
        c = get_config(cs.TRAIN["arch"])
        B, S, H, d = cs.TRAIN["batch"], cs.TRAIN["seq"], c.n_heads, c.head_dim
        q, k, v = (torch.randn((B, S, H, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        err = cs.row_rel_l2(attention_lse(q, k, v, causal=True)[0],
                            attention_lse_ref(q, k, v, causal=True)[0])
        if not err <= 2.0 ** -6:
            raise AssertionError(f"{name}: row relative L2 error {err}")
        ms = cs.time_ms(lambda: attention_lse(q, k, v, causal=True), flush,
                        args.reps)
        print(json.dumps({"label": args.label, "row": name, "ms": ms,
                          "row_rel_l2": err, "card": card}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    backward_rows(args, card, flush)


if __name__ == "__main__":
    main()
