"""Node front-end: router-driven dispatch over socket groups (counterpart
of ``repro.node.scheduler``; paper §V-B).

One ``RDUNode`` owns:

  * the §II Samba-CoE router (``LMRouter`` / ``HashRouter``): untagged
    requests are routed exactly once, at node arrival; caller-tagged
    requests keep their tag;
  * a shared ``ExpertStore`` — the node-wide DDR capacity tier every socket
    group streams experts from;
  * one ``CompositionOfExperts`` + tensor-parallel ``ServingEngine`` per
    socket group: each group's ``HBMWeightCache`` is its private HBM working
    set (placed as per-rank shards), its paged KV pool head-sharded over the
    group's ranks;
  * a ``Placement`` (``node/placement.py``) mapping experts to owning
    groups, recomputable online from observed demand (``rebalance``).

Dispatch: route -> owning groups from the placement -> least-loaded owner
(queue depth + busy slots). Per-group fairness (starvation aging, resident-
preferred group selection, prefetch) is the engine's own machinery —
unchanged from the single-device path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coe import CompositionOfExperts, ExpertHandle
from repro_torch.core.memory_tiers import DGX_H100, MachineTiers
from repro_torch.node.execution import PrefillWorker, make_group_engine
from repro_torch.node.placement import (ExpertProfile, Placement,
                                        plan_expert_placement)
from repro_torch.node.topology import NodeTopology, SocketGroup
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.stats import StatsView, counter_field
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.store import ExpertStore, HostMemoryStore


@dataclass
class GroupState:
    group: SocketGroup
    coe: CompositionOfExperts
    engine: ServingEngine
    submitted: int = 0

    @property
    def load(self) -> int:
        """Outstanding work: queued requests + busy decode slots."""
        return (len(self.engine.queue)
                + sum(s is not None for s in self.engine.slots))


class NodeStats(StatsView):
    """Node-level counters as a view over the metrics registry (``node.*``
    series). ``per_group`` — the per-socket-group breakdown list — is not a
    scalar metric and rides along as a plain attribute (the per-group
    numbers themselves live in the registry under ``group=<gid>`` labels
    when the node publishes into a shared registry)."""

    PREFIX = "node"
    DERIVED = ("imbalance",)

    requests = counter_field()
    tokens_out = counter_field()
    route_s = counter_field(0.0)
    switch_stall_s = counter_field(0.0)    # Σ per-group engine switch stalls
    starvation_overrides = counter_field()

    def __init__(self, registry=None, labels=None,
                 per_group: Optional[List[Dict[str, Any]]] = None,
                 prefill_groups: Optional[List[Dict[str, Any]]] = None,
                 **values):
        super().__init__(registry, labels, **values)
        self.per_group = list(per_group or [])
        self.prefill_groups = list(prefill_groups or [])

    @property
    def imbalance(self) -> float:
        """Inter-group load spread: (max - min) / mean of per-group tokens
        (0 = perfectly balanced). The Table-V analogue sweep reports this
        next to throughput."""
        toks = [g["tokens_out"] for g in self.per_group]
        mean = sum(toks) / max(len(toks), 1)
        return (max(toks) - min(toks)) / mean if mean else 0.0

    def tokens_per_second(self, wall_s: float) -> float:
        return self.tokens_out / wall_s if wall_s > 0 else 0.0

    def as_dict(self) -> Dict[str, Any]:
        d = super().as_dict()
        d["per_group"] = self.per_group
        if self.prefill_groups:
            d["prefill_groups"] = self.prefill_groups
        return d


class RDUNode:
    """A multi-socket serving node over a topology's socket groups (one
    process drives them all: ``node.execution``)."""

    def __init__(self, topology: NodeTopology, cfg: ModelConfig, router,
                 router_params=None, *,
                 group_hbm_bytes: int, group_kv_reserve_bytes: int = 0,
                 store: Optional[ExpertStore] = None,
                 machine: MachineTiers = DGX_H100,
                 avg_tokens: int = 16, replicate_share: float = 0.5,
                 registry: Optional[MetricsRegistry] = None,
                 prefill_groups: int = 0, prefill_pack: Optional[int] = None,
                 **engine_kwargs):
        """``group_hbm_bytes`` is one socket group's pooled HBM tier (its
        ``tp`` sockets' HBM behaves as one software-managed cache, the way
        the paper's compiler treats a TP domain); ``group_kv_reserve_bytes``
        carves each group's paged KV pool out of it. ``engine_kwargs`` pass
        through to every group's ``ServingEngine`` (n_slots, block_size,
        max_len, ...).

        ``prefill_groups=N`` enables DISAGGREGATED mode: the first N
        topology groups become dedicated ``PrefillWorker``s (compute-bound
        phase) and only the remaining groups run decode engines
        (bandwidth-bound phase). Requests are prefilled on a worker, then
        their KV blocks are handed off to a decode group's cache
        (``Request.handoff``) — decode engines never run a prefill forward.
        ``prefill_pack`` caps prompts per packed prefill call (default: the
        engines' ``n_slots``)."""
        if not 0 <= prefill_groups < len(topology.groups):
            raise ValueError(
                f"prefill_groups={prefill_groups} must leave at least one "
                f"decode group (topology has {len(topology.groups)})")
        self.topology = topology
        self.cfg = cfg
        self.router = router
        self.router_params = router_params
        self.store = store if store is not None else HostMemoryStore()
        self.machine = machine
        self.avg_tokens = avg_tokens
        self.replicate_share = replicate_share
        # one node-wide registry: every group's engine/cache/ledger series
        # lands here under a group=<gid> label, so the --metrics-port
        # endpoint and registry snapshots see the whole node at once
        self.registry = registry if registry is not None else MetricsRegistry()
        self.workers: List[PrefillWorker] = []
        for g in topology.groups[:prefill_groups]:
            glabels = {"group": g.gid, "role": "prefill"}
            coe = CompositionOfExperts(
                router, router_params, group_hbm_bytes,
                kv_reserve_bytes=group_kv_reserve_bytes, store=self.store,
                device=g.device, registry=self.registry,
                obs_labels=glabels)
            self.workers.append(PrefillWorker(
                g, coe, cfg,
                max_len=engine_kwargs.get("max_len", 4096),
                block_size=engine_kwargs.get("block_size", 16),
                n_pack=prefill_pack or engine_kwargs.get("n_slots", 8),
                kv_dtype=engine_kwargs.get("kv_dtype", torch.bfloat16),
                registry=self.registry, labels=glabels))
        self.groups: List[GroupState] = []
        for g in topology.groups[prefill_groups:]:
            glabels = {"group": g.gid}
            coe = CompositionOfExperts(
                router, router_params, group_hbm_bytes,
                kv_reserve_bytes=group_kv_reserve_bytes, store=self.store,
                device=g.device, registry=self.registry,
                obs_labels=glabels)
            eng = make_group_engine(coe, cfg, g,
                                    registry=self.registry,
                                    obs_labels=glabels, **engine_kwargs)
            self.groups.append(GroupState(group=g, coe=coe, engine=eng))
        self.placement: Optional[Placement] = None
        self.demand: Dict[str, int] = {}
        self.route_s = 0.0
        self.requests_in = 0
        # session affinity: a session's retained KV pages live in ONE
        # group's pool, so later turns must land on that group to adopt
        # them (prefix_sharing engines); maps session id -> groups index
        self._session_groups: Dict[str, int] = {}

    # -- registry ---------------------------------------------------------
    def register_expert(self, name: str, host_params, domain: str = "general"):
        """Register one expert node-wide: the first group's registration
        persists the params into the shared store; every other group
        (prefill workers included) links the store-resident copy (no extra
        DRAM)."""
        coes = ([w.coe for w in self.workers]
                + [gs.coe for gs in self.groups])
        for i, coe in enumerate(coes):
            coe.register(ExpertHandle(
                name, self.cfg, host_params if i == 0 else None,
                domain=domain))
        self.placement = None              # registry changed: replan lazily

    def expert_names(self) -> List[str]:
        return self.groups[0].coe.expert_names()

    # -- placement --------------------------------------------------------
    def plan(self, demand: Optional[Dict[str, float]] = None) -> Placement:
        """(Re)compute the expert -> group placement from a demand map
        (requests per expert; omitted experts weigh 0, an empty/None map
        plans uniform demand)."""
        coe0 = self.groups[0].coe
        demand = demand or {}
        profiles = [ExpertProfile(n, coe0.experts[n].nbytes,
                                  float(demand.get(n, 0.0)))
                    for n in coe0.expert_names()]
        with trace.span("plan_placement", cat="node",
                        experts=len(profiles)) as sp:
            self.placement = plan_expert_placement(
                profiles,
                [gs.coe.hbm_budget.weights_bytes for gs in self.groups],
                machine=self.machine, tp=self.topology.tp,
                avg_tokens=self.avg_tokens,
                replicate_share=self.replicate_share)
            sp.add(resident={g: list(v) for g, v in
                             self.placement.resident.items()})
        trace.instant("placement", cat="node",
                      groups=len(self.groups), experts=len(profiles))
        return self.placement

    def rebalance(self) -> Placement:
        """Replan from the demand observed so far and prewarm each group's
        cache with one planned-resident expert (async prefetch — never
        blocks decode)."""
        with trace.span("rebalance", cat="node",
                        demand_experts=len(self.demand)):
            placement = self.plan(dict(self.demand))
            for gs in self.groups:
                for name in placement.resident.get(gs.group.gid, ()):
                    if not gs.coe.cache.resident(name):
                        gs.coe.cache.prefetch(name)
                        trace.instant("prewarm", cat="node",
                                      group=gs.group.gid, expert=name)
                        break
        return placement

    # -- serving ----------------------------------------------------------
    def submit(self, req: Request) -> int:
        """Route (if untagged) and enqueue. Colocated mode: straight to the
        least-loaded owning decode group. Disaggregated mode: to the
        least-loaded prefill worker first — the request reaches a decode
        group later, carrying its KV handoff. Returns the chosen group's
        topology gid."""
        if self.placement is None:
            self.plan(dict(self.demand))
        with trace.span("dispatch", cat="node", request_id=req.rid) as sp:
            if req.expert is None:
                coe0 = (self.workers[0].coe if self.workers
                        else self.groups[0].coe)
                req.expert, dt = coe0.route_request(req.tokens)
                self.route_s += dt
            elif req.expert not in self.groups[0].coe.experts:
                raise KeyError(
                    f"request {req.rid}: unknown expert {req.expert!r}")
            self.demand[req.expert] = self.demand.get(req.expert, 0) + 1
            self.requests_in += 1
            if self.workers and req.handoff is None:
                w = min(self.workers, key=lambda w: w.load)
                sp.add(expert=req.expert, prefill_group=w.group.gid)
                w.submit(req)
                return w.group.gid
            gid = self._dispatch_decode(req)
            sp.add(expert=req.expert, group=gid)
        return gid

    def _dispatch_decode(self, req: Request) -> int:
        """Least-loaded owning decode group — unless the request belongs to
        a session seen before, which sticks to the group holding its
        retained KV pages (any group can execute any expert; affinity only
        overrides the load heuristic). Returns the topology gid."""
        gi = (self._session_groups.get(req.session_id)
              if req.session_id is not None else None)
        if gi is None:
            owners = self.placement.owners(req.expert) or tuple(
                range(len(self.groups)))
            gi = min(owners, key=lambda g: self.groups[g].load)
            if req.session_id is not None:
                self._session_groups[req.session_id] = gi
        self.groups[gi].engine.submit(req)
        self.groups[gi].submitted += 1
        return self.groups[gi].group.gid

    @property
    def has_work(self) -> bool:
        return (any(w.has_work for w in self.workers)
                or any(gs.engine.has_work for gs in self.groups))

    def step(self) -> List[Request]:
        """One node iteration: run every prefill worker's packed batch and
        hand the finished requests (KV attached) to decode groups, then
        step every decode engine with work; returns requests completed
        across the node."""
        done: List[Request] = []
        for w in self.workers:
            for req in w.step():
                self._dispatch_decode(req)
        for gs in self.groups:
            if gs.engine.has_work:
                done.extend(gs.engine.step())
        return done

    def drain(self, max_steps: int = 1_000_000) -> List[Request]:
        out: List[Request] = []
        steps = 0
        while self.has_work:
            out.extend(self.step())
            steps += 1
            if steps >= max_steps:
                raise RuntimeError("node drain: exceeded max_steps")
        return out

    def warmup(self, expert: Optional[str] = None):
        """Pay every group's hot-path first launches (prefill buckets and
        scatters, the decode extend) before traffic arrives."""
        for w in self.workers:
            w.warmup(expert)
        for gs in self.groups:
            gs.engine.warmup(expert)

    @property
    def warmed(self) -> bool:
        """True once every decode engine finished ``warmup()`` — the node's
        ``/readyz`` signal."""
        return all(gs.engine.warmed for gs in self.groups)

    def engines(self) -> List[Any]:
        """The decode engines, for the obs watchdog."""
        return [gs.engine for gs in self.groups]

    def debug_placement(self) -> Dict[str, Any]:
        """Current expert->group placement (``/debug/placement``)."""
        if self.placement is None:
            return {"planned": False, "groups": len(self.groups)}
        return {"planned": True, "groups": len(self.groups),
                "resident": {name: list(gids) for name, gids in
                             self.placement.resident.items()}}

    def debug_providers(self) -> Dict[str, Any]:
        """Node-wide debug snapshot map: ``placement`` plus every group's
        engine providers namespaced ``g<gid>.<name>`` (multi-group nodes
        keep one httpd)."""
        provs: Dict[str, Any] = {"placement": self.debug_placement}
        for gs in self.groups:
            for name, fn in gs.engine.debug_providers().items():
                provs[f"g{gs.group.gid}.{name}"] = fn
        return provs

    # -- accounting -------------------------------------------------------
    def hbm_within_budget(self) -> bool:
        """Every group's weight cache and KV pool inside its HBM shares
        (prefill workers' staging pools included)."""
        for gs in self.groups:
            cache, budget = gs.coe.cache, gs.coe.hbm_budget
            if cache.used_bytes > cache.capacity:
                return False
            if budget.kv_bytes and (gs.engine.pool.capacity_bytes()
                                    > budget.kv_bytes):
                return False
        for w in self.workers:
            cache, budget = w.coe.cache, w.coe.hbm_budget
            if cache.used_bytes > cache.capacity:
                return False
            if budget.kv_bytes and w.pool.capacity_bytes() > budget.kv_bytes:
                return False
        return True

    def stats(self) -> NodeStats:
        per_group = []
        for gs in self.groups:
            st, cs = gs.engine.stats, gs.coe.cache.stats
            per_group.append({
                "gid": gs.group.gid, "tp": gs.group.tp,
                "submitted": gs.submitted,
                "requests": st.requests, "tokens_out": st.tokens_out,
                "decode_rounds": st.decode_rounds,
                "occupancy": st.mean_occupancy,
                "switches": st.switches,
                "switch_stall_s": st.switch_s,
                "starvation_overrides": st.starvation_overrides,
                "cache_hits": cs.hits, "cache_misses": cs.misses,
                "prefetch_hits": cs.prefetch_hits,
                "hbm_used_bytes": gs.coe.cache.used_bytes,
            })
        prefill_groups = []
        for w in self.workers:
            cs = w.coe.cache.stats
            prefill_groups.append({
                "gid": w.group.gid, "tp": w.group.tp,
                "queued": len(w.queue), "prefilled": w.prefilled,
                "cache_hits": cs.hits, "cache_misses": cs.misses,
                "hbm_used_bytes": w.coe.cache.used_bytes,
            })
        return NodeStats(
            registry=self.registry,
            requests=sum(g["requests"] for g in per_group),
            tokens_out=sum(g["tokens_out"] for g in per_group),
            route_s=self.route_s,
            switch_stall_s=sum(g["switch_stall_s"] for g in per_group),
            starvation_overrides=sum(g["starvation_overrides"]
                                     for g in per_group),
            per_group=per_group, prefill_groups=prefill_groups)

    def close(self):
        for w in self.workers:
            w.coe.cache.close()
        for gs in self.groups:
            gs.coe.cache.close()
