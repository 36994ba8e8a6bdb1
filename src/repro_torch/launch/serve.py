"""CoE serving driver of the port: ``python -m repro_torch.launch.serve``.

Builds a Samba-CoE-style composition (hash router + N experts derived from
one backbone), keeps every expert in pinned host memory (the capacity tier),
and serves a batch of requests through the continuous-batching engine, the
HBM weight cache and the paged KV pool, decoding through the hand-written
kernels. For example, on one H100:

    python -m repro_torch.launch.serve --device cuda --n-experts 3 \\
        --hbm-experts 2 --requests 16 --new-tokens 32

It takes JAX's command line (``repro.launch.serve``) and JAX's defaults,
but for ``--backend`` (``fused``: on the card, the kernels) and
``--prompt-len`` (a range, 64-256; JAX's single N gives every prompt N
tokens), and adds ``--device`` (``cpu`` off the card); JAX's own example
runs as it is:

    python -m repro_torch.launch.serve --device cpu --reduced \
        --requests 8 --n-experts 4 --prompt-len 16 --new-tokens 6

Expert weights are random, drawn from ``--seed`` on the serving device.
``--arch`` names any dense or moe config of the port (``configs.CONFIGS``).
The default ``--backend fused`` decodes on the kernels, which refuse an MoE
FFN, a LayerNorm, GELU, partial or m-RoPE and biases (``chatglm3-6b``,
``starcoder2-3b``, ``qwen2-vl-2b``, ``qwen2.5-32b``); ``--backend xla``
decodes those on the plain paged body, as JAX's driver does.
``mixtral-8x7b`` is refused on both, as JAX's runner refuses it: paged
serving takes no sliding window (its 4096 positions).

``--scheduler run_to_completion`` serves one expert group to completion at a
time (the paper's baseline); ``--prefill-mode sequential`` prefills each
prompt at its own length (``flash_prefill`` on the card).
``--prefix-sharing`` turns on copy-on-write prefix sharing and session
retention; ``--shared-prefix N`` opens every prompt with the same N
system-prompt tokens, the traffic it dedups. ``--store`` picks the capacity
tier (``host``, ``mmap:DIR``, ``int8[:BLOCK]``). ``--node-shape TPxG`` serves
through an ``RDUNode`` of G tensor-parallel groups of TP sockets, all
sharing the one device (``--n-slots`` split over the groups; a group's HBM
share is ``--hbm-experts`` experts, 0.8 of one carved out for its KV);
``--prefill-groups N`` gives the first N groups to prefill (disaggregated
serving). The observability
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
              device=None, registry=None, store=None):
    """Composition of ``n_experts`` experts with an HBM tier of
    ``hbm_experts`` experts' bytes, on ``store`` (pinned host memory when
    None); ``registry`` publishes the weight cache's series. Returns
    ``(coe, nbytes)``."""
    from repro_torch.core import CompositionOfExperts, ExpertHandle, HashRouter

    experts, nbytes = build_experts(cfg, n_experts, seed, device)
    coe = CompositionOfExperts(
        HashRouter(n_experts), None,
        hbm_capacity_bytes=int(max(1.0, hbm_experts) * nbytes), device=device,
        registry=registry, store=store)
    for name, tree, domain in experts:
        coe.register(ExpertHandle(name, cfg, tree, domain=domain))
        del tree
    return coe, nbytes


def make_requests(n: int, vocab_size: int, prompt_lens, new_tokens: int,
                  expert_names, tagged_fraction: float, seed: int = 0,
                  shared_prefix: int = 0):
    """``n`` requests with prompt lengths drawn from ``prompt_lens`` =
    (low, high) inclusive; the first ``tagged_fraction`` of them are tagged
    round-robin over the experts, the rest routed at submit. With
    ``shared_prefix`` N every prompt opens with the same N tokens (at least
    one of its own follows)."""
    from repro_torch.serving import Request

    rs = np.random.RandomState(seed)
    shared = (np.random.RandomState(seed + 1).randint(
        0, vocab_size, (shared_prefix,)).astype(np.int32)
        if shared_prefix else np.zeros((0,), np.int32))
    n_tagged = int(n * tagged_fraction)
    lo, hi = prompt_lens
    reqs = []
    for i in range(n):
        S = int(rs.randint(lo, hi + 1))
        toks = np.concatenate([
            shared, rs.randint(0, vocab_size, (max(1, S - len(shared)),))
            .astype(np.int32)])
        tag = expert_names[i % len(expert_names)] if i < n_tagged else None
        reqs.append(Request(rid=i, tokens=toks, max_new_tokens=new_tokens,
                            expert=tag))
    return reqs, n_tagged


def _backend(args, cfg):
    """``--backend``: None (the engine's default, the kernels) or the plain
    body as an object."""
    from repro_torch.serving import XlaPagedBackend
    return XlaPagedBackend(cfg) if args.backend == "xla" else None


def _serve_node(args, cfg, server, ready):
    """``--node-shape TPxG``: the same traffic through an ``RDUNode``."""
    from repro_torch.core import HashRouter
    from repro_torch.node import (RDUNode, ensure_emulated_sockets,
                                  make_node_topology)
    from repro_torch.obs import get_registry
    from repro_torch.store import make_store

    tp, n_groups = (int(x) for x in args.node_shape.split("x"))
    topo = make_node_topology(tp, n_groups, devices=ensure_emulated_sockets(
        tp * n_groups, args.device))
    experts, nbytes = build_experts(cfg, args.n_experts, args.seed,
                                    args.device)
    node = RDUNode(topo, cfg, HashRouter(args.n_experts), None,
                   group_hbm_bytes=int(max(1.0, args.hbm_experts) * nbytes),
                   group_kv_reserve_bytes=int(0.8 * nbytes),
                   store=make_store(args.store),
                   n_slots=max(1, args.n_slots // n_groups),
                   block_size=args.block_size, max_len=args.max_len,
                   scheduler=args.scheduler, prefill_mode=args.prefill_mode,
                   prefix_sharing=args.prefix_sharing,
                   prefill_groups=args.prefill_groups,
                   backend=_backend(args, cfg), registry=get_registry())
    for name, tree, domain in experts:
        node.register_expert(name, tree, domain=domain)
        del tree
    placement = node.plan()
    wd = _wire_obs(args, server, ready, node.debug_providers(),
                   node.engines())
    try:
        if args.warmup:
            node.warmup()
        reqs, n_tagged = make_requests(args.requests, cfg.vocab_size,
                                       args.prompt_len, args.new_tokens,
                                       node.expert_names(),
                                       args.tagged_fraction, args.seed,
                                       args.shared_prefix)
        t0 = time.perf_counter()
        for r in reqs:
            node.submit(r)
        done = node.drain()
        wall = time.perf_counter() - t0
    finally:
        if wd is not None:
            wd.stop()
    st = node.stats()
    print(f"[node {topo.name}] served {len(done)} requests in {wall:.2f}s "
          f"({st.tokens_out} tokens, {st.tokens_per_second(wall):.1f} tok/s);"
          f" {n_tagged} caller-tagged, {len(done) - n_tagged} router-routed")
    print(f"route={st.route_s:.3f}s switch_stall={st.switch_stall_s:.3f}s "
          f"imbalance={st.imbalance:.2f} "
          f"spilled_experts={len(placement.spilled)}")
    for g in st.per_group:
        print(f"  group {g['gid']} (tp={g['tp']}): {g['requests']} req / "
              f"{g['tokens_out']} tok, occupancy {g['occupancy']:.2f}, "
              f"{g['switches']} switches, cache h/m "
              f"{g['cache_hits']}/{g['cache_misses']}")
    for g in st.prefill_groups:
        print(f"  prefill group {g['gid']} (tp={g['tp']}): {g['prefilled']} "
              f"prefilled, cache h/m {g['cache_hits']}/{g['cache_misses']}")
    leaked = sum(gs.engine.pool.stats.blocks_in_use for gs in node.groups)
    print(f"kv pools: leaked={leaked}")
    node.close()
    return node, done


def _serve(args, cfg, server, ready):
    from repro_torch.obs import get_registry
    from repro_torch.serving import ServingEngine
    from repro_torch.store import make_store

    # every engine, pool, cache and ledger series goes to the process
    # default registry: what --metrics-port serves
    reg = get_registry()
    coe, nbytes = build_coe(cfg, args.n_experts, args.hbm_experts, args.seed,
                            args.device, registry=reg,
                            store=make_store(args.store))
    engine = ServingEngine(coe, cfg, max_len=args.max_len,
                           n_slots=args.n_slots, block_size=args.block_size,
                           scheduler=args.scheduler,
                           prefill_mode=args.prefill_mode,
                           prefix_sharing=args.prefix_sharing,
                           backend=_backend(args, cfg), device=args.device,
                           registry=reg)
    wd = _wire_obs(args, server, ready, engine.debug_providers(), [engine])
    try:
        if args.warmup:
            t0 = time.perf_counter()
            engine.warmup()
            print(f"warmup: {time.perf_counter() - t0:.2f}s")
        reqs, n_tagged = make_requests(args.requests, cfg.vocab_size,
                                       args.prompt_len, args.new_tokens,
                                       coe.expert_names(),
                                       args.tagged_fraction, args.seed,
                                       args.shared_prefix)
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
    if args.prefix_sharing:
        print(f"prefix sharing: {st.prefix_hit_tokens} prompt tokens "
              f"adopted from shared KV, "
              f"{engine.pool.stats.cow_splits} COW splits, "
              f"{len(engine.prefix_index)} indexed blocks")
        engine.release_shared()
    print(f"kv pool: {engine.pool.stats.as_dict()} "
          f"leaked={engine.pool.stats.blocks_in_use}")
    if wd is not None:
        print(f"watchdog: {wd.checks_run} checks")
    coe.cache.close()
    return engine, done


def build_parser():
    """The command line: JAX's flags (``repro.launch.serve``), with JAX's
    defaults but two: ``--backend`` defaults to ``fused`` (the kernels, the
    card's path) and ``--prompt-len`` to a range; plus the port's own
    (``--device``, ``--arch`` choices, the pool's shape, ``--store``,
    ``--seed``, the watchdog's)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    from repro_torch.configs import CONFIGS
    ap.add_argument("--arch", default="samba-coe-expert-7b",
                    choices=sorted(n for n, c in CONFIGS.items()
                                   if c.family in ("dense", "moe")))
    ap.add_argument("--backend", default="fused", choices=["fused", "xla"],
                    help="decode-step backend (serving/backends.py): "
                         "'fused' the kernels (dense RMSNorm/SwiGLU/full-"
                         "RoPE configs without biases), 'xla' the plain "
                         "paged body (every dense and MoE config without "
                         "a sliding window)")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU smoke runs)")
    ap.add_argument("--n-experts", type=int, default=8)
    ap.add_argument("--hbm-experts", type=float, default=2.5,
                    help="HBM tier capacity in units of one expert")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, nargs="+", default=[64, 256],
                    metavar="N",
                    help="N: every prompt N tokens (JAX's form); LOW HIGH: "
                    "lengths drawn from [LOW, HIGH]")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None,
                    help="the pool's positions a request (default: the "
                    "longest prompt plus --new-tokens, as JAX's)")
    ap.add_argument("--tagged-fraction", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "run_to_completion"])
    ap.add_argument("--prefill-mode", default="packed",
                    choices=["packed", "sequential"],
                    help="'packed' admits through bucketed packed forwards; "
                    "'sequential' prefills each prompt at its own length "
                    "(flash_prefill on the card)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="copy-on-write prefix sharing + session retention: "
                    "shared prompt prefixes prefill once and later requests "
                    "adopt the KV blocks read-only (serving/kvcache.py "
                    "PrefixIndex)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="open every generated prompt with the same N "
                    "system-prompt tokens (the workload --prefix-sharing "
                    "dedups)")
    ap.add_argument("--store", default="host", metavar="SPEC",
                    help="the capacity tier: 'host' (pinned host memory), "
                    "'mmap:DIR' (a raw file and a manifest an expert) or "
                    "'int8[:BLOCK]' (int8 absmax blocks, dequantized at "
                    "each load)")
    ap.add_argument("--node-shape", default=None, metavar="TPxG",
                    help="serve through a node of G tensor-parallel groups "
                    "of TP sockets (e.g. 2x2) sharing the device")
    ap.add_argument("--prefill-groups", type=int, default=0, metavar="N",
                    help="with --node-shape: the first N groups prefill "
                    "only and hand the KV to the decode groups")
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
    return ap


def parse_args(argv=None):
    """``build_parser``'s namespace with ``prompt_len`` as (low, high) and
    ``max_len`` filled in."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if len(args.prompt_len) > 2:
        ap.error("--prompt-len takes N or LOW HIGH")
    args.prompt_len = (args.prompt_len[0], args.prompt_len[-1])
    if args.max_len is None:
        args.max_len = args.prompt_len[1] + args.new_tokens
    return args


def main(argv=None):
    args = parse_args(argv)

    from repro_torch.configs import get_config, pad_for_tp, reduced
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
        if args.node_shape:
            cfg = pad_for_tp(cfg, int(args.node_shape.split("x")[0]))
            return _serve_node(args, cfg, server, ready)
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
