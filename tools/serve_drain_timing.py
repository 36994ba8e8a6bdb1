"""Time the port's continuous-batching serve drain on one card, several
drains in one process, for comparing two trees of the repository:

    python tools/serve_drain_timing.py --src build/parent/src --drains 4
    python tools/serve_drain_timing.py --src src --drains 4

``--src`` is the ``src`` directory of the tree under test (its
``repro_torch`` is imported from there). The composition is
``chip_smoke.py``'s serve phase: three samba-coe-expert-7b experts (L 32,
D 4096, bf16, random from seed 0) in pinned host memory, an HBM cache of
two, 16 requests of 64-256 prompt tokens and 32 new tokens, 8 slots. The
experts are built once; each drain runs on a fresh engine over the same
composition. The first drain pays first launches and is printed but marked
``warm: false``.

Per drain it prints one JSON line: tok/s over the drain's wall, the decode
round's wall (``exec_s / decode_rounds``: the extend, its argmax read and
the engine's bookkeeping of the round), the part of it inside the policy's
``round`` (the extend and the argmax read) and the rest, the engine's
per-round bookkeeping on the host, where the registry-backed counters
live. It uses only what both the parent and the change offer.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--drains", type=int, default=4)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_coe, make_requests
    from repro_torch.serving import ServingEngine

    if not torch.cuda.is_available():
        sys.exit("serve_drain_timing: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("samba-coe-expert-7b")
    coe, _ = build_coe(cfg, 3, 2.0, 0, dev)
    label = args.label or args.src
    for d in range(args.drains + 1):
        engine = ServingEngine(coe, cfg, max_len=512, n_slots=8,
                               block_size=16, device=dev)
        policy_round, inside = engine.policy.round, [0.0]

        def timed(params, active, _real=policy_round):
            t0 = time.perf_counter()
            out = _real(params, active)
            inside[0] += time.perf_counter() - t0
            return out

        engine.policy.round = timed
        reqs, _ = make_requests(16, cfg.vocab_size, (64, 256), 32,
                                coe.expert_names(), 0.5, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        done = engine.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = engine.stats
        n = st.decode_rounds
        print(json.dumps({
            "tree": label, "drain": d, "warm": d > 0,
            "requests": len(done), "tokens": st.tokens_out,
            "tok_s": st.tokens_out / wall, "rounds": n,
            "round_ms": st.exec_s / n * 1e3,
            "round_in_policy_ms": inside[0] / n * 1e3,
            "round_bookkeeping_ms": (st.exec_s - inside[0]) / n * 1e3,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del engine, done, reqs
        gc.collect()
    coe.cache.close()


if __name__ == "__main__":
    main()
