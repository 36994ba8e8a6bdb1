"""End-to-end serving example of the PyTorch port (counterpart of
``examples/coe_serving.py``): serve a Composition of Experts with the
continuous-batching engine over the paged KV pool (paper §V/§VI-C).

Builds N reduced experts on the capacity tier (host memory, pinned when a
card is present; or ``--store mmap`` / ``int8``), an HBM weight cache of
``--hbm-experts`` experts (optionally carving a KV share out of it with
``--kv-reserve-experts``), replays a staggered request trace through the
engine, and reports the Fig-1 switch/execute breakdown, LRU + paged-pool
statistics, slot occupancy, and per-request latency percentiles. On the
card every decode round runs the three paged kernels (``qkv_rope_paged``,
``decode_paged``, ``oproj_ffn_swiglu``) once a layer.

    PYTHONPATH=src python examples/coe_serving_torch.py [--n-experts 6]
    PYTHONPATH=src python examples/coe_serving_torch.py --scheduler run_to_completion
    PYTHONPATH=src python examples/coe_serving_torch.py --device cpu
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import tree_bytes, tree_map
from repro_torch.configs import get_config, reduced
from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter
from repro_torch.models import get_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.store import make_store

DOMAINS = ["code", "math", "translate", "chat", "legal", "medical"]
ENGINE = dict(max_len=48, block_size=8)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-experts", type=int, default=6)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "run_to_completion"])
    ap.add_argument("--hbm-experts", type=float, default=2.5,
                    help="HBM tier capacity in units of one expert "
                    "(forces evictions when < n-experts)")
    ap.add_argument("--kv-reserve-experts", type=float, default=0.0,
                    help="slice of the HBM tier reserved for the paged KV "
                    "pool, in units of one expert (0 = size the pool for "
                    "n-slots full-length requests instead)")
    ap.add_argument("--store", default="host",
                    help="capacity-tier backend: host | mmap[:dir] | "
                    "int8[:block] (mmap defaults to a temp dir)")
    ap.add_argument("--tagged-fraction", type=float, default=0.25,
                    help="fraction of requests submitted with a caller "
                    "tag (expert pinned by the client); the rest arrive "
                    "expert=None and are routed by the composition's "
                    "router at submit")
    ap.add_argument("--trace", default=None, metavar="PATH", nargs="?",
                    const="results/trace_coe_serving_torch.json",
                    help="record request-lifecycle spans and export a "
                    "Chrome-trace / Perfetto JSON (default "
                    "results/trace_coe_serving_torch.json; open at "
                    "https://ui.perfetto.dev)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)


def build_experts(cfg, n, device):
    """``n`` random experts drawn on ``device`` from seeds 0..n-1, each
    moved to host memory (the capacity tier)."""
    model = get_model(cfg)
    return [tree_map(lambda t: t.cpu(),
                     model.init(torch.Generator(device).manual_seed(i),
                                device)) for i in range(n)]


def build(cfg, experts, args, device, store_root=None,
          kv_dtype=torch.bfloat16):
    """The composition over ``experts`` (host trees, registered in order as
    ``expert-<domain>-<i>``) behind a hash router, and its engine."""
    nbytes = tree_bytes(experts[0])
    store = make_store(args.store, root=store_root)
    coe = CompositionOfExperts(
        HashRouter(len(experts)), None,
        hbm_capacity_bytes=int(args.hbm_experts * nbytes),
        kv_reserve_bytes=int(args.kv_reserve_experts * nbytes),
        store=store, device=device)
    for i, host in enumerate(experts):
        d = DOMAINS[i % len(DOMAINS)]
        coe.register(ExpertHandle(f"expert-{d}-{i}", cfg, host, domain=d))
    engine = ServingEngine(coe, cfg, n_slots=args.n_slots,
                           scheduler=args.scheduler, kv_dtype=kv_dtype,
                           device=device, **ENGINE)
    return coe, engine


def make_trace(n_requests, tagged_fraction, names, vocab):
    """The staggered trace: prompts of 16 tokens and 4-12 new tokens drawn
    from ``RandomState(0)``; the first ``tagged_fraction`` arrive
    caller-tagged (round robin over ``names``), the rest ``expert=None``,
    routed at submit (§II)."""
    rs = np.random.RandomState(0)
    n_tagged = int(n_requests * tagged_fraction)
    return [Request(
        rid=i, tokens=rs.randint(0, vocab, (16,)).astype(np.int32),
        max_new_tokens=int(rs.randint(4, 13)),
        expert=names[i % len(names)] if i < n_tagged else None)
        for i in range(n_requests)], n_tagged


def serve(engine, reqs):
    """Half the requests queued up front, the rest submitted one a step
    while the engine is already decoding (continuous admission at work).
    Returns (done requests, wall seconds)."""
    half = len(reqs) // 2
    upfront, late = list(reqs[:half]), list(reqs[half:])
    t0 = time.perf_counter()
    for r in upfront:
        engine.submit(r)
    done = []
    while engine.has_work or late:
        if late:
            engine.submit(late.pop(0))
        done.extend(engine.step())
    return done, time.perf_counter() - t0


def report(args, coe, engine, done, wall, n_tagged):
    st = engine.stats
    cs = coe.cache.stats
    ps = engine.pool.stats
    print(f"\n[{args.scheduler}] served {st.requests} requests / "
          f"{st.tokens_out} tokens in {wall:.2f}s "
          f"({st.tokens_out/wall:.1f} tok/s)")
    total = st.switch_s + st.exec_s + st.prefill_s + st.route_s
    print(f"Fig-1 breakdown: route {100*st.route_s/total:.1f}% | "
          f"switch {100*st.switch_s/total:.1f}% | "
          f"prefill {100*st.prefill_s/total:.1f}% | "
          f"decode {100*st.exec_s/total:.1f}%")
    print(f"scheduler: {st.decode_rounds} decode rounds, "
          f"mean slot occupancy {st.mean_occupancy:.2f}, "
          f"{st.switches} expert switches")
    print(f"HBM weight cache: hits={cs.hits} misses={cs.misses} "
          f"prefetch_hits={cs.prefetch_hits} evictions={cs.evictions} "
          f"copied_in={cs.bytes_copied_in>>20}MiB "
          f"copyback_elided={cs.bytes_copyback_elided>>20}MiB (read-only)")
    print(f"prefetch pipeline [{args.store}]: stall "
          f"{cs.switch_seconds*1e3:.0f}ms of {cs.copy_seconds*1e3:.0f}ms load "
          f"(store-read {cs.store_read_seconds*1e3:.0f}ms + "
          f"h2d {cs.h2d_seconds*1e3:.0f}ms), overlap {cs.overlap_ratio:.0%}; "
          f"capacity tier holds {coe.store.total_stored_bytes()>>20}MiB")
    print(f"paged KV pool: allocs={ps.allocs} frees={ps.frees} "
          f"peak_blocks={ps.peak_blocks} leaked={ps.blocks_in_use}")
    lat = np.array([r.latency_s for r in done]) * 1e3
    print(f"latency: p50={np.percentile(lat, 50):.0f}ms "
          f"p99={np.percentile(lat, 99):.0f}ms")
    by_expert = {}
    for r in done:
        by_expert[r.expert] = by_expert.get(r.expert, 0) + 1
    print(f"requests per expert ({n_tagged} caller-tagged, "
          f"{len(done) - n_tagged} router-routed):", by_expert)


def main(argv=None):
    """Serve the trace; returns the composition, the engine and the done
    requests (the cache's prefetch thread already stopped)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.trace:
        from repro_torch.obs import trace
        trace.enable()

    cfg = reduced(get_config("samba-coe-expert-7b"))
    print(f"building {args.n_experts} experts "
          f"({cfg.n_params()/1e6:.1f}M params each) on the capacity tier...")
    experts = build_experts(cfg, args.n_experts, device)
    with tempfile.TemporaryDirectory(prefix="coe-store-") as tmp:
        coe, engine = build(cfg, experts, args, device, store_root=tmp)
        del experts                      # the store owns the copies now
        try:
            reqs, n_tagged = make_trace(args.requests, args.tagged_fraction,
                                        coe.expert_names(), cfg.vocab_size)
            done, wall = serve(engine, reqs)
        finally:
            coe.cache.close()
        report(args, coe, engine, done, wall, n_tagged)

    if args.trace:
        from repro_torch.obs import trace
        trace.disable()
        path = trace.export(args.trace)
        print(f"trace: {len(trace.events())} events -> {path} "
              f"(open at https://ui.perfetto.dev)")
    return coe, engine, done


if __name__ == "__main__":
    main()
