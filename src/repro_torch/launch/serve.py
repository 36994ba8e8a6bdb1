"""CoE serving driver of the port: ``python -m repro_torch.launch.serve``.

Builds a Samba-CoE-style composition (hash router + N experts derived from
one backbone), keeps every expert in pinned host memory (the capacity tier),
and serves a batch of requests through the continuous-batching engine, the
HBM weight cache and the paged KV pool, decoding through the hand-written
kernels. For example, on one H100:

    python -m repro_torch.launch.serve --device cuda --n-experts 3 \\
        --hbm-experts 2 --requests 16 --new-tokens 32

Expert weights are random, drawn from ``--seed`` on the serving device.

``--scheduler run_to_completion`` serves one expert group to completion at a
time (the paper's baseline); ``--prefill-mode sequential`` prefills each
prompt at its own length (``flash_prefill`` on the card). The observability
plane (``repro_torch.obs``): ``--metrics-port`` serves the registry over
HTTP (``/metrics``, ``/metrics.json``, ``/readyz``, which answers 503 until
``--warmup`` has run, and ``/debug/*``); ``--trace-out`` exports a
Chrome-trace JSON; ``--watchdog`` starts the invariant sampler; ``SIGUSR2``
(or a watchdog anomaly) dumps the flight recorder to ``--flight-out``.
"""
from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch


def install_flight_dump_signal(path, registry=None, signum=None):
    """Install a signal handler (default ``SIGUSR2``) that dumps the process
    flight recorder's postmortem bundle to ``path``. Returns the signal
    number installed, or ``None`` where SIGUSR2 does not exist."""
    from repro_torch.obs import flightrec, get_registry

    if signum is None:
        signum = getattr(signal, "SIGUSR2", None)
        if signum is None:
            return None
    reg = registry if registry is not None else get_registry()

    def _dump(_sig, _frame):
        out = flightrec.dump(path, reg, reason="signal")
        print(f"flight recorder: postmortem bundle -> {out}")

    signal.signal(signum, _dump)
    return signum


def _wire_obs(args, server, ready, providers, engines):
    """Hook one serve target into the observability plane: mount its debug
    snapshots on the httpd and the flight recorder, point ``/readyz`` at the
    engines' warmed state, and (``--watchdog``) start the invariant
    sampler. Returns the watchdog, or None."""
    from repro_torch.obs import Watchdog, flightrec

    for name, fn in providers.items():
        flightrec.add_state_provider(name, fn)
        if server is not None:
            server.add_debug(name, fn)
    if ready is not None:
        ready["fn"] = lambda: all(getattr(e, "warmed", False)
                                  for e in engines)
    if not args.watchdog:
        return None
    return Watchdog(engines, interval_s=args.watchdog_interval,
                    dump_path=args.flight_out).start()


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
              device=None, registry=None):
    """Composition of ``n_experts`` experts with an HBM tier of
    ``hbm_experts`` experts' bytes; ``registry`` publishes the weight
    cache's series. Returns ``(coe, nbytes)``."""
    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter

    experts, nbytes = build_experts(cfg, n_experts, seed, device)
    coe = CompositionOfExperts(
        HashRouter(n_experts), None,
        hbm_capacity_bytes=int(max(1.0, hbm_experts) * nbytes), device=device,
        registry=registry)
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


def _serve(args, cfg, server, ready):
    from repro_torch.obs import get_registry
    from repro_torch.serving import ServingEngine

    # every engine, pool, cache and ledger series goes to the process
    # default registry: what --metrics-port serves
    reg = get_registry()
    coe, nbytes = build_coe(cfg, args.n_experts, args.hbm_experts, args.seed,
                            args.device, registry=reg)
    engine = ServingEngine(coe, cfg, max_len=args.max_len,
                           n_slots=args.n_slots, block_size=args.block_size,
                           scheduler=args.scheduler,
                           prefill_mode=args.prefill_mode,
                           device=args.device, registry=reg)
    wd = _wire_obs(args, server, ready, engine.debug_providers(), [engine])
    try:
        if args.warmup:
            t0 = time.perf_counter()
            engine.warmup()
            print(f"warmup: {time.perf_counter() - t0:.2f}s")
        reqs, n_tagged = make_requests(args.requests, cfg.vocab_size,
                                       args.prompt_len, args.new_tokens,
                                       coe.expert_names(),
                                       args.tagged_fraction, args.seed)
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        done = engine.drain()
        wall = time.perf_counter() - t0
    finally:
        if wd is not None:
            wd.stop()
    st = engine.stats
    print(f"served {len(done)} requests in {wall:.2f}s ({st.tokens_out} "
          f"tokens, {st.tokens_out / wall:.1f} tok/s wall); {n_tagged} "
          f"caller-tagged, {len(done) - n_tagged} router-routed")
    print(f"breakdown: route={st.route_s:.3f}s switch={st.switch_s:.3f}s "
          f"prefill={st.prefill_s:.3f}s decode={st.exec_s:.3f}s")
    print(f"scheduler ({args.scheduler}, {args.prefill_mode} prefill): "
          f"{st.decode_rounds} rounds, occupancy {st.mean_occupancy:.2f}, "
          f"{st.switches} switches")
    print(f"weight cache: {coe.cache.stats.as_dict()}")
    print(f"tier ledger: overlap={coe.cache.ledger.overlap_ratio:.2f} "
          f"store_read={coe.cache.ledger.bytes_moved('store_read')}B "
          f"h2d={coe.cache.ledger.bytes_moved('h2d')}B")
    print(f"kv pool: {engine.pool.stats.as_dict()} "
          f"leaked={engine.pool.stats.blocks_in_use}")
    if wd is not None:
        print(f"watchdog: {wd.checks_run} checks")
    coe.cache.close()
    return engine, done


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
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "run_to_completion"])
    ap.add_argument("--prefill-mode", default="packed",
                    choices=["packed", "sequential"],
                    help="'packed' admits through bucketed packed forwards; "
                    "'sequential' prefills each prompt at its own length "
                    "(flash_prefill on the card)")
    ap.add_argument("--warmup", action="store_true",
                    help="pay the hot path's first launches before traffic "
                    "(flips /readyz from 503 to 200)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the metrics registry over HTTP while "
                    "running (/metrics, /metrics.json, /healthz, /readyz, "
                    "/debug/*); 0 binds a free port, printed at startup")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record spans and export a Chrome-trace / "
                    "Perfetto JSON to PATH on exit")
    ap.add_argument("--flight-out", default="flight_dump.json",
                    metavar="PATH",
                    help="where SIGUSR2 and watchdog anomalies dump the "
                    "flight recorder's postmortem bundle")
    ap.add_argument("--watchdog", action="store_true",
                    help="start the background invariant sampler: stuck "
                    "requests, KV refcount books, HBM budget, queue age")
    ap.add_argument("--watchdog-interval", type=float, default=1.0,
                    metavar="S", help="watchdog sampling interval")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.obs import get_registry, serve_metrics, trace

    install_flight_dump_signal(args.flight_out)
    # the engine is built after the httpd starts: /readyz reads its warmed
    # state through this slot once _wire_obs fills it in
    ready = {"fn": lambda: False}
    server = None
    if args.metrics_port is not None:
        server = serve_metrics(get_registry(), port=args.metrics_port,
                               ready_check=lambda: ready["fn"]())
        print(f"metrics: {server.url}/metrics "
              f"(+ /metrics.json, /healthz, /readyz, /debug/*)")
    if args.trace_out:
        trace.enable()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    try:
        return _serve(args, cfg, server, ready)
    finally:
        if args.trace_out:
            trace.disable()
            path = trace.export(args.trace_out)
            print(f"trace: {len(trace.events())} events -> {path}")
        if server is not None:
            server.stop()


if __name__ == "__main__":
    main()
