"""Time the port's two decode kernels, ``decode_paged`` and
``flash_decode``, at the shapes ``chip_smoke.py``'s kernel rows hold them
to, on one card, for comparing two trees of the repository in one call:

    python tools/decode_timing.py --src build/parent/src --label parent
    python tools/decode_timing.py --src src --label tree

``--src`` is the ``src`` directory of the tree under test: its
``repro_torch`` is imported from there and builds its kernels into its own
``build/``. The rows: ``decode_paged`` at the 7B expert's widths over the
serve phase's pool (8 lanes at ``chip_smoke.paged_inputs``' ragged
lengths, lane 3 inactive; row 1), every lane at 512 positions (1′), one
tensor-parallel rank's 16 heads (1″), granite-8b's 32 q on 8 kv heads (G
4, 1‴), the examples' coe_serving (the reduced expert's 4 q on 4 kv heads
of 32, 4 slots of blocks of 8; 1ᴱ), and ``flash_decode`` at the 7B's
widths, 8 lanes at length 4096 (row 6); then both kernels at each GQA group of
``chip_smoke.GROUP_DECODE_ARCHS`` (rows 1⁗ and 6′), which a tree that
refuses that group reports as skipped. Inputs are random bf16 from a
torch generator seeded per row; each call is held to its plain version
(largest row relative L2 error within 2^-7) and timed as ``chip_smoke.py``
times a row (``chip_smoke.time_ms``: the mean of ``--reps`` launches, each
after a 128 MB write flushed the L2, behind a spin kernel; and
``ms_read_flushed`` after a flush that only reads), each
``flash_decode`` row beside SDPA (``enable_gqa``, a length mask) in the
same process. One JSON line a row: its name, ms, the row error, the card
and its power limit. ``--only`` keeps the rows whose name holds one of its
strings; ``--chunks`` also times each ``flash_decode`` row at each chunk
given (``ops.decode``'s ``chunk``, a probe of ``decode_plan``), as rows
``<name>[chunk=C]`` (the plan's own chunk in each row's ``plan``)."""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEN1 = (1, 15, 16, 1, 17, 255, 300, 512)


def paged_args(cfg, gen, dev, len1, B=8, block=16, max_len=512):
    """q, pools, tables (distinct rows, lane 3 on the scratch row unless
    every lane is full) and len1 of one ``decode_paged`` call."""
    import torch
    bf = torch.bfloat16
    maxb = max_len // block
    rows = B * maxb + 1
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((B, Hq, dh), generator=gen, device=dev).to(bf)
    kp, vp = (torch.randn((rows, block, Hkv, dh), generator=gen,
                          device=dev).to(bf) for _ in range(2))
    tables = torch.randperm(rows - 1, generator=gen, device=dev)[
        :B * maxb].reshape(B, maxb).to(torch.int32)
    if min(len1) < max_len:
        tables[3] = rows - 1
    return q, kp, vp, tables, torch.tensor(len1, dtype=torch.int32,
                                           device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--chunks", nargs="*", type=int, default=())
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    import torch.nn.functional as Fn

    import chip_smoke as cs
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (decode_attention_ref,
                                                         decode_paged_ref)

    if not torch.cuda.is_available():
        sys.exit("decode_timing: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    c7 = get_config("samba-coe-expert-7b")
    tp2 = dataclasses.replace(c7, n_heads=c7.n_heads // 2,
                              n_kv_heads=c7.n_kv_heads // 2)
    rows = [("decode_paged", c7, LEN1), ("decode_paged[len1=512x8]", c7,
                                         (512,) * 8),
            ("decode_paged[tp=2,heads=16]", tp2, LEN1),
            ("decode_paged[granite-8b,G=4]", get_config("granite-8b"), LEN1),
            (cs.EXAMPLE_PAGED_ROWS["decode_paged"],
             reduced(get_config("samba-coe-expert-7b")),
             cs.EXAMPLE_PAGED_LEN1),
            ("flash_decode", c7, None)]
    for arch in cs.GROUP_DECODE_ARCHS:
        paged, dense = cs.group_decode_row_names(arch)
        rows += [(paged, get_config(arch), LEN1),
                 (dense, get_config(arch), None)]

    def emit(name, kern, plain, **extra):
        try:
            got = kern()
        except ValueError as e:       # a tree that refuses this group
            print(json.dumps({"label": args.label, "row": name,
                              "skipped": str(e)}), flush=True)
            return
        err = cs.row_rel_l2(got, plain())
        if not err <= 2.0 ** -7:
            raise AssertionError(f"{name}: row relative L2 error {err}")
        ms = cs.time_ms(kern, flush, args.reps)
        rf = cs.time_ms(kern, flush, args.reps, read=True)
        print(json.dumps({"label": args.label, "row": name, "ms": ms,
                          "ms_read_flushed": rf, "row_rel_l2": err,
                          **extra, "card": card}), flush=True)

    for i, (name, cfg, len1) in enumerate(rows):
        if args.only is not None and not any(o in name for o in args.only):
            continue
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        if len1 is None:              # flash_decode: 8 lanes, a full cache
            S = 4096 if name == "flash_decode" else \
                cs.GROUP_DENSE["length"]
            Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
            q = torch.randn((8, Hq, cfg.head_dim), generator=gen,
                            device=dev).to(torch.bfloat16)
            kc, vc = (torch.randn((8, S, Hkv, cfg.head_dim),
                                  generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
            mask = torch.ones((8, 1, 1, S), dtype=torch.bool, device=dev)
            plain = lambda: decode_attention_ref(q, kc, vc, S)
            plan = getattr(ops, "decode_plan", None)
            extra = {} if plan is None else {"plan": plan(
                8, Hkv, Hq // Hkv, cfg.head_dim, S,
                rt.device_sms(dev.index or 0))._asdict()}
            sdpa = lambda: Fn.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=Hq != Hkv)
            extra["sdpa_ms"] = cs.time_ms(sdpa, flush, args.reps)
            emit(name, lambda: ops.decode(q, kc, vc, S), plain, **extra)
            for c in args.chunks:
                emit(f"{name}[chunk={c}]",
                     lambda c=c: ops.decode(q, kc, vc, S, chunk=c), plain)
        else:
            # the examples' row: 4 slots of blocks of 8 over 48 positions
            a = paged_args(cfg, gen, dev, len1, B=4, block=8, max_len=48) \
                if "examples" in name else paged_args(cfg, gen, dev, len1)
            emit(name, lambda: ops.decode_paged(*a),
                 lambda: decode_paged_ref(*a))
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
