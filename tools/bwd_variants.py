"""Time variants of the ``flash_prefill_bwd`` kernels against the tree's
own, in turns, on one card:

    python tools/bwd_variants.py                 # every variant below
    python tools/bwd_variants.py --variants probe_no_sync --reps 20

Each variant is ``prefill_bwd.cu`` with the text substitutions of
``PATCHES`` applied (a patch that no longer applies is reported and
skipped), built by ``nvcc`` with the runtime's flags into
``build/bwd_variants/<name>/``; its ``-Xptxas -v`` report is printed
(registers, spills, any serialised-wgmma warning). Then, at the training
phase's shape and at Mixtral's (``chip_smoke.TRAIN_BWD_ROW``,
``TRAIN_BWD_GQA_ROW``), or at the rows ``--rows`` names (any of those
and ``chip_smoke.FAMILY_BWD_ROWS``: ``wide_kernel``'s probes at
RecurrentGemma's and DeepSeek's), every build is held to ``attention_bwd_ref``
(relative L2 within ``chip_smoke.TRAIN_BWD_REL_L2``) and timed as
``chip_smoke.time_ms`` times a row, in the order tree, v1, ..., vn, vn,
..., v1, tree; one JSON line a (build, shape, turn), with each CUDA
kernel's device time from ``torch.profiler`` and the card's name and
power limit."""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Probes (names starting ``probe_``) take a piece of work out to show what
# it costs; their results are wrong, so they are timed but not held to the
# reference.
PATCHES = {
    # the writer adds without waiting for its turn (the sums' order, and so
    # the result's last bits, then vary)
    "probe_no_turn": [("        while (ld_acquire(flag) != rank) {\n"
                       "        }\n", "")],
    # the writer writes nothing
    "probe_no_writes": [(
        "            if (rank == 0)\n"
        "              tma_store_4d(&tacc, box, c0, BQ * t, h, b);\n"
        "            else\n"
        "              tma_reduce_add_4d(&tacc, box, c0, BQ * t, h, b);\n",
        "            (void)box, (void)c0;\n")],
    # the warpgroups do not wait for each other's ds
    "probe_no_sync": [("      named_sync(3, 256);                  // both "
                       "warpgroups' ds stored\n", "")],
    # no dQ product
    "probe_no_dq_mma": [("      issue_dq(n & 1);\n", "")],
    # none of dQ's work: no ds store, no product, no staging, no writer
    "probe_dkdv_only": [
        ("      store_ds(n & 1);\n", ""),
        ("      named_sync(3, 256);                  // both "
         "warpgroups' ds stored\n", ""),
        ("      issue_dq(n & 1);\n", ""),
        ("      stage_dq(n);\n", ""),
        ("      for (int n = 0; n < n_it; ++n) {\n"
         "        const int i = n & 1, h = hk * G + n / n_t,",
         "      for (int n = 0; n < 0; ++n) {\n"
         "        const int i = n & 1, h = hk * G + n / n_t,")],
    # the heaviest key tile of a (batch, kv head) launched first (its turns
    # then wait on key tiles launched after it)
    "probe_heavy_first": [(
        "const int n_kt = gridDim.x, kt = n_kt - 1 - blockIdx.x;",
        "const int n_kt = gridDim.x, kt = blockIdx.x;")],
    # wide_kernel (d 256, (192, 128); time them with --rows at the family
    # rows): its writer writes nothing
    "probe_wide_no_writes": [(
        "          if (rank == 0)\n"
        "            tma_store_4d(&tacc, box, f * 32, BQ * t, h, b);\n"
        "          else\n"
        "            tma_reduce_add_4d(&tacc, box, f * 32, BQ * t, h, b);\n",
        "          (void)box;\n")],
    # no dQ product
    "probe_wide_no_dq_mma": [(
        "      issue_half<DK, true>(dq, desc_lo(ds_s, PANEL), k_s, wg, 0);\n",
        "")],
    # no dV or dK product
    "probe_wide_no_dkdv_mma": [(
        "      issue_half<DV, false>(dv, desc_lo(p_s, 16), dot, wg, 1);\n"
        "      issue_half<DK, false>(dk, desc_lo(ds_s, 16), qt, wg, 1);\n",
        "")],
    # no dp^T product (ds from whatever dp holds)
    "probe_wide_no_dp_mma": [(
        "      issue_st<DV>(dp, opaque(v_lo), desc_lo(dot + wg * 32 * 128, 16));\n",
        "")],
    # dQ not staged in the ring stage
    "probe_wide_no_dq_stage": [(
        "        put_f32(qt, c0, piece, wrow, tig);\n", "")],
    # the warpgroups do not wait for each other before staging dQ
    "probe_wide_no_sync": [("      named_sync(4, 256);\n", "")],
    # wide_kernel's writer waits for its turn before the tile's dQ is staged
    # (the flag's round trip under the consumers' products)
    "wide_turn_first": [(
        "        mbar_wait(dq_full(s), parity(n));\n"
        "        while (ld_acquire(flag) != rank) {\n"
        "        }\n"
        "        fence_async_global();\n"
        "        for (int f = 0; f < DK / 32; ++f) {\n",
        "        while (ld_acquire(flag) != rank) {\n"
        "        }\n"
        "        mbar_wait(dq_full(s), parity(n));\n"
        "        fence_async_global();\n"
        "        for (int f = 0; f < DK / 32; ++f) {\n")],
    # wide_kernel launches every group's key tiles the last first, as
    # bwd_kernel does (the tree: the first first where a group fits the card)
    "wide_last_first": [(
        "                   n_kt <= sms,  scale, stat, turn,   part};\n",
        "                   0,            scale, stat, turn,   part};\n")],
    # wide_kernel's turns count 32-column boxes: a contributor adds box f
    # once the previous one's box f is in, and counts its own boxes once
    # that one has counted all of its
    "wide_box_turns": [
        ("constexpr int PANEL = 64 * 128;          // 64 rows of 128 bytes\n",
         "constexpr int PANEL = 64 * 128;          // 64 rows of 128 bytes\n"
         "\n"
         "template <int N>\n"
         "__device__ __forceinline__ void bulk_wait_n() {\n"
         "  asm volatile(\"cp.async.bulk.wait_group %0;\\n\" ::\"n\"(N) : \"memory\");\n"
         "}\n"
         "\n"
         "template <int NB, int F = 0>\n"
         "__device__ __forceinline__ void count_boxes(unsigned* flag) {\n"
         "  if constexpr (F < NB) {\n"
         "    bulk_wait_n<NB - 1 - F>();\n"
         "    fence_async_global();\n"
         "    __threadfence();\n"
         "    atomicAdd(flag, 1u);\n"
         "    count_boxes<NB, F + 1>(flag);\n"
         "  }\n"
         "}\n"),
        ("        mbar_wait(dq_full(s), parity(n));\n"
         "        while (ld_acquire(flag) != rank) {\n"
         "        }\n"
         "        fence_async_global();\n"
         "        for (int f = 0; f < DK / 32; ++f) {\n"
         "          const uint32_t box = ring + s * T::STAGE + f * PANEL;\n"
         "          if (rank == 0)\n"
         "            tma_store_4d(&tacc, box, f * 32, BQ * t, h, b);\n"
         "          else\n"
         "            tma_reduce_add_4d(&tacc, box, f * 32, BQ * t, h, b);\n"
         "        }\n"
         "        tma_store_commit();\n"
         "        tma_store_wait();                  // the stage is read\n"
         "        mbar_arrive(empty(s));\n"
         "        tma_store_wait_all();              // the sums are written\n"
         "        fence_async_global();\n"
         "        __threadfence();\n"
         "        atomicAdd(flag, 1u);\n",
         "        constexpr unsigned NB = DK / 32;\n"
         "        mbar_wait(dq_full(s), parity(n));\n"
         "        for (int f = 0; f < (int)NB; ++f) {\n"
         "          const uint32_t box = ring + s * T::STAGE + f * PANEL;\n"
         "          if (rank == 0) {\n"
         "            tma_store_4d(&tacc, box, f * 32, BQ * t, h, b);\n"
         "          } else {\n"
         "            while (ld_acquire(flag) < (rank - 1) * NB + f + 1) {\n"
         "            }\n"
         "            fence_async_global();\n"
         "            tma_reduce_add_4d(&tacc, box, f * 32, BQ * t, h, b);\n"
         "          }\n"
         "          tma_store_commit();\n"
         "        }\n"
         "        tma_store_wait();                  // the stage is read\n"
         "        mbar_arrive(empty(s));\n"
         "        while (ld_acquire(flag) != rank * NB) {\n"
         "        }\n"
         "        count_boxes<NB>(flag);\n")],
    # wide_kernel's writer passes a q tile's turn on once it has issued the
    # next tile's sums (bulk wait_group 1), not before it takes that tile
    "wide_writer_lag": [(
        "      tma_prefetch_map(&tacc);\n"
        "      for (int n = 0; n < n_it; ++n) {\n"
        "        const int s = stage(n), h = h0 + n / n_t, t = t_lo + n % n_t;\n",
        "      tma_prefetch_map(&tacc);\n"
        "      unsigned* held = nullptr;\n"
        "      for (int n = 0; n < n_it; ++n) {\n"
        "        const int s = stage(n), h = h0 + n / n_t, t = t_lo + n % n_t;\n"),
        ("        tma_store_commit();\n"
         "        tma_store_wait();                  // the stage is read\n"
         "        mbar_arrive(empty(s));\n"
         "        tma_store_wait_all();              // the sums are written\n"
         "        fence_async_global();\n"
         "        __threadfence();\n"
         "        atomicAdd(flag, 1u);\n"
         "      }\n"
         "    }\n"
         "  } else {\n"
         "    // ------------------------------------------------------- consumers\n"
         "    setmaxnreg_inc<CONSUMER_REGS>();\n"
         "    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
         "    const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;\n"
         "    const int wrow = (warp & 3) * 16 + g;        // row g of the warp's 16\n"
         "    const int key[2] = {k0 + wrow, k0 + wrow + 8};\n",
         "        tma_store_commit();\n"
         "        tma_store_wait();                  // the stage is read\n"
         "        mbar_arrive(empty(s));\n"
         "        if (held != nullptr) {\n"
         "          asm volatile(\"cp.async.bulk.wait_group 1;\\n\" ::: \"memory\");\n"
         "          fence_async_global();\n"
         "          __threadfence();\n"
         "          atomicAdd(held, 1u);\n"
         "        }\n"
         "        held = flag;\n"
         "      }\n"
         "      tma_store_wait_all();\n"
         "      fence_async_global();\n"
         "      __threadfence();\n"
         "      if (held != nullptr) atomicAdd(held, 1u);\n"
         "    }\n"
         "  } else {\n"
         "    // ------------------------------------------------------- consumers\n"
         "    setmaxnreg_inc<CONSUMER_REGS>();\n"
         "    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
         "    const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;\n"
         "    const int wrow = (warp & 3) * 16 + g;        // row g of the warp's 16\n"
         "    const int key[2] = {k0 + wrow, k0 + wrow + 8};\n")],
}

_SRC = "flash_attention/csrc/prefill_bwd.cu"
_LIB = "flash_prefill_bwd"


def build(names, rt):
    """{name: library path} of every variant that applies and builds."""
    base = open(os.path.join(rt._KERNELS_DIR, _SRC)).read()
    out_dir = os.path.join(ROOT, "build", "bwd_variants")
    procs = {}
    for name in names:
        text = base
        for old, new in PATCHES.get(name, []):
            if old not in text:
                print(json.dumps({"variant": name, "skipped":
                                  "a patch no longer applies"}), flush=True)
                text = None
                break
            text = text.replace(old, new)
        if text is None:
            continue
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "prefill_bwd.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(d, f"lib{_LIB}.so")
        cmd = [rt._nvcc(), *rt.NVCC_FLAGS, "-I",
               os.path.join(rt._KERNELS_DIR, "csrc"), "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        report = [ln.split("info    :")[-1].strip() for ln in
                  log.splitlines() if "Compiling entry" in ln or "Used" in ln
                  or "spill" in ln or "serialized" in ln or "arning" in ln]
        print(json.dumps({"variant": name, "rc": p.returncode,
                          "ptxas": report if p.returncode == 0 else log}),
              flush=True)
        if p.returncode == 0:
            libs[name] = lib
    return libs


def use(rt, path):
    """Route ``ops.attention_bwd`` through the library at ``path``."""
    lib = ctypes.CDLL(path)
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    rt._libs[_LIB] = lib
    for key in [k for k in rt._fns if k[0] == _LIB]:
        del rt._fns[key]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=list(PATCHES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", nargs="*", default=None,
                    help="rows (by prefix) to time: the training phase's "
                         "and Mixtral's by default; chip_smoke."
                         "FAMILY_BWD_ROWS's too")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))

    import torch

    import chip_smoke as cs
    from prefill_timing import kernel_split
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention.ops import (attention_bwd,
                                                         attention_lse)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    if not torch.cuda.is_available():
        sys.exit("bwd_variants: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build(["tree", *args.variants], rt)
    if "tree" not in libs:
        sys.exit("bwd_variants: the tree's kernel does not build")
    names = [n for n in args.variants if n in libs]
    order = ["tree", *names, *names[::-1], "tree"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
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
    shapes += [(row, *family[key][1:])
               for key, row in cs.FAMILY_BWD_ROWS.items()]
    rows = args.rows or [cs.TRAIN_BWD_ROW, cs.TRAIN_BWD_GQA_ROW]
    shapes = [sh for sh in shapes if any(sh[0].startswith(r) for r in rows)]
    for row, B, Sq, Sk, Hq, Hkv, dk, dv, causal, window in shapes:
        q, k, v, do = cs.bwd_inputs(B, Sq, Sk, Hq, Hkv, dk, dv, gen, dev)
        use(rt, libs["tree"])
        o, lse = attention_lse(q, k, v, causal=causal, window=window)
        want = attention_bwd_ref(q, k, v, do, causal=causal, window=window)
        kern = lambda: attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window)
        first = {}
        for turn, name in enumerate(order):
            use(rt, libs[name])
            got = kern()
            errs = [cs.rel_l2(g, w) for g, w in zip(got, want)]
            if name in first:
                same = all(torch.equal(a, b) for a, b in zip(got, first[name]))
            else:
                first[name], same = got, True
            rec = {"variant": name, "turn": turn, "row": row,
                   "rel_l2": errs, "equal_to_its_first_call": same,
                   "ms": cs.time_ms(kern, flush, args.reps),
                   "kernels_ms": kernel_split(kern), "card": card}
            print(json.dumps(rec), flush=True)
            if not name.startswith("probe_") and \
                    not (max(errs) <= cs.TRAIN_BWD_REL_L2 and same):
                raise AssertionError(f"{name} at {row}: {errs}, {same}")
        del q, k, v, o, lse, do, want, first, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
