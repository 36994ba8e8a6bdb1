"""CoE serving driver of the port: ``python -m repro_torch.launch.serve``.

Builds a Samba-CoE-style composition (hash router + N experts derived from
one backbone), keeps every expert in pinned host memory (the capacity tier),
and serves a batch of requests through the continuous-batching engine, the
HBM weight cache and the paged KV pool, decoding through the hand-written
kernels. For example, on one H100:

    python -m repro_torch.launch.serve --device cuda --n-experts 3 \\
        --hbm-experts 2 --requests 16 --new-tokens 32

Expert weights are random, drawn from ``--seed`` on the serving device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_experts(cfg, n_experts: int, seed: int = 0, device=None):
    """Expert trees: per-expert perturbations of one base init, expert i =
    base + 0.01 * N(0, 1), as the JAX driver builds them. The numbers are
    drawn on ``device`` from a seeded generator (drawing 7B parameters on the
    host would take minutes). Yields ``(name, tree, domain)`` one expert at
    a time, so only the base and one expert live on the device at once.
    Returns ``(generator, nbytes)``."""
    from repro_torch import resolve_device
    from repro_torch.bridge import tree_bytes, tree_map
    from repro_torch.models import get_model

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    base = get_model(cfg).init(gen, dev)
    nbytes = tree_bytes(base)
    domains = ["code", "math", "translate", "chat", "legal", "medical"]

    def experts():
        for i in range(n_experts):
            g = torch.Generator(device=dev)
            g.manual_seed(seed * 1000 + i + 1)

            def perturb(x):
                noise = torch.randn(x.shape, generator=g, device=dev,
                                    dtype=torch.float32)
                return (x.float() + 0.01 * noise).to(x.dtype)
            yield f"expert{i:03d}", tree_map(perturb, base), \
                domains[i % len(domains)]

    return experts(), nbytes


def build_coe(cfg, n_experts: int, hbm_experts: float, seed: int = 0,
              device=None):
    """Composition of ``n_experts`` experts with an HBM tier of
    ``hbm_experts`` experts' bytes. Returns ``(coe, nbytes)``."""
    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter

    experts, nbytes = build_experts(cfg, n_experts, seed, device)
    coe = CompositionOfExperts(
        HashRouter(n_experts), None,
        hbm_capacity_bytes=int(max(1.0, hbm_experts) * nbytes), device=device)
    for name, tree, domain in experts:
        coe.register(ExpertHandle(name, cfg, tree, domain=domain))
        del tree
    return coe, nbytes


def make_requests(n: int, vocab_size: int, prompt_lens, new_tokens: int,
                  expert_names, tagged_fraction: float, seed: int = 0):
    """``n`` requests with prompt lengths drawn from ``prompt_lens`` =
    (low, high) inclusive; the first ``tagged_fraction`` of them are tagged
    round-robin over the experts, the rest routed at submit."""
    from repro_torch.serving import Request

    rs = np.random.RandomState(seed)
    n_tagged = int(n * tagged_fraction)
    lo, hi = prompt_lens
    reqs = []
    for i in range(n):
        S = int(rs.randint(lo, hi + 1))
        toks = rs.randint(0, vocab_size, (S,)).astype(np.int32)
        tag = expert_names[i % len(expert_names)] if i < n_tagged else None
        reqs.append(Request(rid=i, tokens=toks, max_new_tokens=new_tokens,
                            expert=tag))
    return reqs, n_tagged


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="samba-coe-expert-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU smoke runs)")
    ap.add_argument("--n-experts", type=int, default=3)
    ap.add_argument("--hbm-experts", type=float, default=2.0,
                    help="HBM tier capacity in units of one expert")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(64, 256),
                    metavar=("LOW", "HIGH"))
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--tagged-fraction", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import ServingEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    coe, nbytes = build_coe(cfg, args.n_experts, args.hbm_experts, args.seed,
                            args.device)
    engine = ServingEngine(coe, cfg, max_len=args.max_len,
                           n_slots=args.n_slots, block_size=args.block_size,
                           device=args.device)
    reqs, n_tagged = make_requests(args.requests, cfg.vocab_size,
                                   args.prompt_len, args.new_tokens,
                                   coe.expert_names(), args.tagged_fraction,
                                   args.seed)
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.drain()
    wall = time.perf_counter() - t0
    st = engine.stats
    print(f"served {len(done)} requests in {wall:.2f}s ({st.tokens_out} "
          f"tokens, {st.tokens_out / wall:.1f} tok/s wall); {n_tagged} "
          f"caller-tagged, {len(done) - n_tagged} router-routed")
    print(f"breakdown: route={st.route_s:.3f}s switch={st.switch_s:.3f}s "
          f"prefill={st.prefill_s:.3f}s decode={st.exec_s:.3f}s")
    print(f"scheduler: {st.decode_rounds} rounds, occupancy "
          f"{st.mean_occupancy:.2f}, {st.switches} switches")
    print(f"weight cache: {coe.cache.stats.as_dict()}")
    print(f"kv pool: {engine.pool.stats.as_dict()} "
          f"leaked={engine.pool.stats.blocks_in_use}")
    coe.cache.close()
    return engine, done


if __name__ == "__main__":
    main()
