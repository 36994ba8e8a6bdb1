"""Continuous-batching CoE serving engine over the paged KV pool
(counterpart of ``repro.serving.engine``).

  * every decode slot's KV lives in ``PagedKVCache`` block tables;
  * one paged extend step of fixed ``(n_slots, 1)`` shape serves any subset
    of slots through an active-lane mask — inactive lanes scatter to the
    pool's scratch block;
  * per-step admission: requests for the active expert are prefilled into
    free slots while decode continues; when a group drains, the next expert
    is chosen preferring experts whose weights are ready in the
    ``HBMWeightCache``; an aging counter admits any request stuck behind
    that preference;
  * next-expert prefetch overlaps the weight copy with decode (paper Fig 9).

``scheduler="run_to_completion"`` is the paper's baseline: admit one expert
group, decode until every request of it completes, then the next group.
``prefill_mode="packed"`` admits through bucketed packed forwards (plain
attention, as JAX's); ``"sequential"`` prefills each prompt at its own
length through ``PagedDecodeRunner.prefill_kv``, whose attention is the
``flash_prefill`` kernel on the card.

Ported here: both schedulers, both prefill modes, ``warmup()``,
``GreedyDecode``, decoding through the hand-written kernels
(``FusedPagedBackend``), and the observability plane (``repro_torch.obs``):
registry-backed ``ServeStats``, the ``serve.ttft_s`` / ``serve.tpot_s``
histograms, the lifecycle and SLO trackers, spans, instants, one async
trace lane per request and flight-recorder events. Not ported yet
(``ROADMAP.md``): prefix sharing, sessions, ``SpeculativeDecode`` and
disaggregated prefill handoffs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.coe import CompositionOfExperts
from repro_torch.obs import flightrec, trace
from repro_torch.obs.lifecycle import LifecycleTracker
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.slo import SLOTracker
from repro_torch.obs.stats import StatsView, counter_field
from repro_torch.serving.backends import PagedBackend, PagedDecodeRunner
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.prefill import (PackedPrefillRunner, default_buckets,
                                         plan_packs)


# the JAX engine's scheduling defaults: decode rounds an expert keeps the
# batch while others wait, and admission passes a request may be skipped
SWITCH_QUANTUM = 8
STARVATION_LIMIT = 16


@dataclass(eq=False)
class Request:
    rid: int
    tokens: np.ndarray          # (S,) prompt
    max_new_tokens: int
    arrival_s: float = field(default_factory=time.perf_counter)
    expert: Optional[str] = None        # routed at submit when None
    prefill_done_s: Optional[float] = None
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    output: Optional[np.ndarray] = None
    skipped: int = 0                    # admission passes survived unadmitted
    # tenancy: per-tenant accounting, priority and SLO deadlines
    # (``obs.slo``), streaming callbacks run on the engine's thread
    tenant: str = "default"
    priority: int = 0
    slo_ttft_s: Optional[float] = None
    slo_tpot_s: Optional[float] = None  # mean inter-token deadline
    on_token: Optional[Callable[["Request", int], None]] = None
    on_done: Optional[Callable[["Request"], None]] = None
    # lifecycle stamps and attribution (``obs.lifecycle``): route_s is the
    # router forward's cost, switch_stall_s the activation time this
    # request's admission paid
    submit_s: Optional[float] = None
    admit_s: Optional[float] = None
    last_token_s: Optional[float] = None
    route_s: float = 0.0
    switch_stall_s: float = 0.0
    preemptions: int = 0

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done_s is None else self.done_s - self.arrival_s


@dataclass
class _Slot:
    req: Request
    expert: str
    last_token: int                     # next decode input
    generated: List[int]
    admitted_step: int

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.generated)


class ServeStats(StatsView):
    """Engine counters as a view over the metrics registry (``serve.*``
    series, JAX's names). ``prefix_hit_tokens`` stays 0 until prefix
    sharing is ported."""

    PREFIX = "serve"
    DERIVED = ("tokens_per_second", "mean_occupancy")

    requests = counter_field()
    tokens_out = counter_field()
    admitted = counter_field()
    decode_rounds = counter_field()
    switches = counter_field()
    starvation_overrides = counter_field()
    prefix_hit_tokens = counter_field()
    occupancy_sum = counter_field(0.0)  # sum of active_slots/n_slots a round
    route_s = counter_field(0.0)
    switch_s = counter_field(0.0)
    prefill_s = counter_field(0.0)
    exec_s = counter_field(0.0)

    @property
    def tokens_per_second(self):
        t = self.switch_s + self.exec_s + self.prefill_s
        return self.tokens_out / t if t else 0.0

    @property
    def mean_occupancy(self):
        return self.occupancy_sum / max(self.decode_rounds, 1)


class _DeviceTableCache:
    """Device copies of the per-slot block tables / lengths, rebuilt only when
    the pool's bookkeeping versions or the slot->request mapping moved."""

    def __init__(self, pool: PagedKVCache, max_blocks: int,
                 empty_table: np.ndarray):
        self.pool = pool
        self.max_blocks = max_blocks
        self._empty = empty_table
        self._tab_key = None
        self._len_key = None
        self._tables = None
        self._lengths = None

    def tables(self, rids: Tuple[Optional[int], ...]):
        key = (self.pool.table_version, rids)
        if key != self._tab_key:
            self._tables = torch.as_tensor(np.stack([
                self.pool.padded_table(r, self.max_blocks)
                if r is not None else self._empty for r in rids]),
                device=self.pool.k.device)
            self._tab_key = key
        return self._tables

    def lengths(self, rids: Tuple[Optional[int], ...]):
        key = (self.pool.length_version, rids)
        if key != self._len_key:
            self._lengths = torch.as_tensor(np.array(
                [self.pool.length(r) if r is not None else 0 for r in rids],
                np.int32), device=self.pool.k.device)
            self._len_key = key
        return self._lengths


class GreedyDecode:
    """One argmax token per active slot per round."""

    name = "greedy"
    reserve_slack = 0

    def bind(self, engine: "ServingEngine"):
        self.engine = engine

    def on_admit(self, slot_idx: int, req: Request, params):
        pass

    def on_free(self, rid: int):
        pass

    def round(self, params, active: np.ndarray) -> Dict[int, List[int]]:
        eng = self.engine
        toks = np.zeros((eng.n_slots, 1), np.int64)
        for i in np.nonzero(active)[0]:
            toks[i, 0] = eng.slots[i].last_token
        tables, lengths = eng._device_tables()
        logits, pk, pv = eng.runner.extend(
            params, eng.pool.k, eng.pool.v, tables, lengths,
            eng._device_active(active),
            torch.as_tensor(toks, device=eng.device))
        eng.pool.k, eng.pool.v = pk, pv
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        return {int(i): [int(nxt[i])] for i in np.nonzero(active)[0]}


class ServingEngine:
    """Continuous-batching scheduler over the paged KV pool.

    ``step()`` is one scheduler iteration: pick/keep the active expert,
    admit newly arrived requests into free slots (prefill), prefetch the
    next expert, run one decode round for the active expert's slots,
    recycle completed slots. ``drain()`` loops until idle.
    ``device`` defaults to the card and must be the composition's device.
    Decode runs through the fused kernels unless ``backend`` passes another
    ``PagedBackend`` object (the parity tests pass the reference).
    ``registry``/``obs_labels`` publish the engine's and its pool's series
    (a private registry when omitted).
    """

    def __init__(self, coe: CompositionOfExperts, cfg: ModelConfig, *,
                 max_len: int = 4096, n_slots: int = 8, block_size: int = 16,
                 scheduler: str = "continuous",
                 backend: Optional[PagedBackend] = None,
                 prefill_mode: str = "packed",
                 kv_dtype=torch.bfloat16,
                 device=None,
                 registry: Optional[MetricsRegistry] = None,
                 obs_labels: Optional[Dict[str, Any]] = None):
        if scheduler not in ("continuous", "run_to_completion"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if prefill_mode not in ("packed", "sequential"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        self.device = resolve_device(device)
        if self.device != coe.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"composition's {coe.device}")
        self.coe = coe
        self.cfg = cfg
        self.max_len = max_len
        self.n_slots = n_slots
        self.block = block_size
        self.scheduler = scheduler
        self.switch_quantum = SWITCH_QUANTUM
        self.starvation_limit = STARVATION_LIMIT
        self.policy = GreedyDecode()
        self.max_blocks = -(-(max_len + self.policy.reserve_slack)
                            // block_size)
        # the budget's KV carve, else every slot holds a full-length request
        kv_budget_bytes = coe.hbm_budget.kv_bytes or (
            (self.n_slots * self.max_blocks + 1) * PagedKVCache.block_bytes(
                block_size, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                kv_dtype))
        # one registry backs ServeStats and the pool's PagedStats
        self._registry = registry if registry is not None \
            else MetricsRegistry()
        self._obs_labels = dict(obs_labels or {})
        self.pool = PagedKVCache.for_budget(
            kv_budget_bytes, block_size, cfg.n_layers, cfg.n_kv_heads,
            cfg.head_dim, kv_dtype, scratch=True, device=self.device,
            registry=self._registry, labels=self._obs_labels)
        self._empty_table = np.full((self.max_blocks,),
                                    self.pool.scratch_index, np.int32)
        self.runner = PagedDecodeRunner(cfg, self.pool.scratch_index,
                                        backend=backend)
        self._dev_tables = _DeviceTableCache(self.pool, self.max_blocks,
                                             self._empty_table)
        self._active_cache: Optional[Tuple[np.ndarray, torch.Tensor]] = None
        self.prefill_mode = prefill_mode
        self.prefill_runner: Optional[PackedPrefillRunner] = (
            PackedPrefillRunner(cfg, buckets=default_buckets(max_len),
                                max_segments=n_slots)
            if prefill_mode == "packed" else None)
        # TTFT (arrival -> first token) and TPOT (mean inter-token seconds
        # after the first) as P2 streaming histograms
        self._ttft_hist = self._registry.histogram("serve.ttft_s",
                                                   labels=self._obs_labels)
        self._tpot_hist = self._registry.histogram("serve.tpot_s",
                                                   labels=self._obs_labels)
        # per-request phase ledger and SLO accounting, both fed at _finish
        self.lifecycle = LifecycleTracker(self._registry,
                                          labels=self._obs_labels)
        self.slo = SLOTracker(self._registry, labels=self._obs_labels)
        self.warmed = False              # /readyz: set by warmup()
        self._registry.gauge("serve.backend", labels={
            **self._obs_labels,
            "backend": self.runner.backend_name}).set(1.0)
        self.policy.bind(self)

        self.queue: List[Request] = []
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.stats = ServeStats(registry=self._registry,
                                labels=self._obs_labels)
        self._active_expert: Optional[str] = None
        self._params = None
        self._quantum_used = 0
        self._step_count = 0

    # -- public API -------------------------------------------------------
    def submit(self, req: Request):
        """Enqueue a request. An untagged request is routed through the
        composition's router once, here."""
        if req.submit_s is None:         # keep the first stamp on re-submits
            req.submit_s = time.perf_counter()
        need = len(req.tokens) + req.max_new_tokens + self.policy.reserve_slack
        if need > self.max_blocks * self.block:
            raise ValueError(
                f"request {req.rid}: {need} tokens exceed engine max_len "
                f"{self.max_len}")
        if -(-need // self.block) > self.pool.n_blocks:
            raise ValueError(
                f"request {req.rid} needs more KV blocks than the pool owns")
        if req.expert is None:
            with trace.span("route", cat="engine", request_id=req.rid) as sp:
                req.expert, dt = self.coe.route_request(req.tokens)
                sp.add(expert=req.expert)
            self.stats.route_s += dt
            req.route_s = dt
        elif req.expert not in self.coe.experts:
            raise KeyError(
                f"request {req.rid}: unknown expert {req.expert!r}")
        # one async lane per request, closed by _finish
        trace.async_begin("request", id=req.rid, cat="engine",
                          expert=req.expert, prompt_tokens=len(req.tokens))
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def step(self) -> List[Request]:
        """One scheduler iteration; returns requests completed in it."""
        self._step_count += 1
        done: List[Request] = []
        with trace.span("step", cat="engine", step=self._step_count) as sp:
            name = self._pick_expert()
            if name is None:
                return done
            if name != self._active_expert:
                self._switch_to(name)
            self._admit(done)
            self._prefetch_next()
            active = np.array([s is not None
                               and s.expert == self._active_expert
                               for s in self.slots], bool)
            if active.any():
                self._decode_round(active, done)
            self._quantum_used += 1
            self.stats.requests += len(done)
            sp.add(expert=self._active_expert, completed=len(done))
        return done

    def drain(self, max_steps: int = 1_000_000) -> List[Request]:
        """Run until queue and slots are empty; returns all completions."""
        out: List[Request] = []
        steps = 0
        while self.has_work:
            out.extend(self.step())
            steps += 1
            if steps >= max_steps:
                raise RuntimeError("drain: exceeded max_steps")
        return out

    def warmup(self, expert: Optional[str] = None) -> None:
        """Pay the hot path's first-launch costs before traffic arrives
        (what JAX's warmup spends on compiling): every packed-prefill bucket
        once with its pool scatter (packed mode), and one all-inactive
        ``(n_slots, 1)`` extend. Every expert shares the backbone, so one
        expert's weights cover the composition. What it writes lands in the
        pool's scratch block only; it synchronizes the card, then sets
        ``warmed``."""
        names = self.coe.expert_names()
        if not names:
            raise RuntimeError("warmup: no experts registered")
        name = expert if expert is not None else (self._active_expert
                                                 or names[0])
        t0 = time.perf_counter()
        params = self.coe.cache.activate(name)
        self.stats.switch_s += time.perf_counter() - t0
        with trace.span("warmup", cat="engine", expert=name):
            if self.prefill_runner is not None:
                self.prefill_runner.warmup(params, self.pool)
            n = self.n_slots
            tables = torch.as_tensor(np.stack([self._empty_table] * n),
                                     device=self.device)
            lengths = torch.zeros((n,), dtype=torch.int32, device=self.device)
            active = torch.zeros((n,), dtype=torch.bool, device=self.device)
            toks = torch.zeros((n, 1), dtype=torch.long, device=self.device)
            logits, pk, pv = self.runner.extend(
                params, self.pool.k, self.pool.v, tables, lengths, active,
                toks)
            self.pool.k, self.pool.v = pk, pv
            torch.argmax(logits[:, -1], dim=-1).cpu()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.warmed = True

    # -- scheduling internals --------------------------------------------
    def _blocks_for(self, req: Request) -> int:
        need = (len(req.tokens) + req.max_new_tokens
                + self.policy.reserve_slack)
        return -(-need // self.block)

    def _any_active(self) -> bool:
        return any(s is not None for s in self.slots)

    def _pick_expert(self) -> Optional[str]:
        occupied: Dict[str, List[_Slot]] = {}
        for s in self.slots:
            if s is not None:
                occupied.setdefault(s.expert, []).append(s)
        if self.scheduler == "run_to_completion":
            if occupied:
                return self._active_expert
            return self.queue[0].expert if self.queue else None
        if self._active_expert in occupied:
            # rotate only among experts with slots ready to decode
            others = [e for e in occupied if e != self._active_expert]
            if self._quantum_used < self.switch_quantum or not others:
                return self._active_expert
            return min(others, key=lambda e: min(
                s.admitted_step for s in occupied[e]))
        if occupied:         # active expert drained: longest-waiting slots
            return min(occupied, key=lambda e: min(
                s.admitted_step for s in occupied[e]))
        if not self.queue:
            return None
        # from the queue: starving first, then stall-free, then most demand
        starving = [r for r in self.queue if r.skipped >= self.starvation_limit]
        if starving:
            self.stats.starvation_overrides += 1
            return starving[0].expert
        ready = [r for r in self.queue if self.coe.cache.ready(r.expert)]
        demand: Dict[str, int] = {}
        for r in ready or self.queue:
            demand[r.expert] = demand.get(r.expert, 0) + 1
        return max(demand, key=demand.get)

    def _switch_to(self, name: str):
        t0 = time.perf_counter()
        with trace.span("switch", cat="engine", expert=name,
                        prev=self._active_expert):
            self._params = self.coe.cache.activate(name)
        dt = time.perf_counter() - t0
        self.stats.switch_s += dt
        flightrec.record("switch", expert=name, prev=self._active_expert,
                         stall_s=dt, **self._obs_labels)
        if self._active_expert is not None:
            self.stats.switches += 1
        self._active_expert = name
        self._quantum_used = 0

    def _admit(self, done: List[Request]):
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        if self.scheduler == "run_to_completion":
            if self._any_active():
                return                   # the batch still runs: no refill
            candidates = [r for r in self.queue
                          if r.expert == self._active_expert]
        else:
            # refill from the active expert's queue only (plus starving
            # requests): a foreign-expert slot would idle in every round
            starving = [r for r in self.queue
                        if r.skipped >= self.starvation_limit]
            candidates = starving + [r for r in self.queue
                                     if r.expert == self._active_expert
                                     and r not in starving]
        # KV backpressure stops admission, but an otherwise idle engine
        # always admits one request
        admitted: List[Request] = []
        if self.prefill_runner is None:
            for r in candidates:
                if not free:
                    break
                if (self._blocks_for(r) > self.pool.free_blocks
                        and (admitted or self._any_active())):
                    break
                self._prefill_into_slot(free.pop(0), r, done)
                admitted.append(r)
        else:
            planned = 0
            for r in candidates:
                if len(admitted) >= len(free):
                    break
                need = self._blocks_for(r)
                if (planned + need > self.pool.free_blocks
                        and (admitted or self._any_active())):
                    break
                admitted.append(r)
                planned += need
            if admitted:
                self._admit_packed(admitted, free, done)
        if admitted:
            # age only requests passed over while admission had capacity
            for r in self.queue:
                if r not in admitted:
                    r.skipped += 1
        self.queue = [r for r in self.queue if r not in admitted]

    def _prefill_into_slot(self, slot_idx: int, req: Request,
                           done: List[Request]):
        """Sequential admission: one prefill at the prompt's own length
        (``flash_prefill`` on the card), its K/V appended to the pool."""
        req.admit_s = time.perf_counter()
        trace.instant("admit", cat="engine", request_id=req.rid,
                      expert=req.expert, slot=slot_idx)
        flightrec.record("admit", rid=req.rid, expert=req.expert,
                         slot=slot_idx, **self._obs_labels)
        t0 = time.perf_counter()
        params = self.coe.cache.activate(req.expert)
        if (req.expert != self._active_expert
                and self._active_expert is not None):
            # a starving admission may have evicted the decoding expert
            self._params = self.coe.cache.activate(self._active_expert)
        dt = time.perf_counter() - t0
        self.stats.switch_s += dt
        req.switch_stall_s += dt
        t0 = time.perf_counter()
        S = len(req.tokens)
        with trace.span("prefill", cat="engine", request_id=req.rid,
                        expert=req.expert, prompt_tokens=S,
                        **{"prefill.bucket": S, "prefill.packed": 0}):
            last, k, v = self.runner.prefill_kv(
                params, torch.as_tensor(req.tokens[None],
                                        device=self.device).long())
            first = int(torch.argmax(last))
            self.pool.open(req.rid)
            self.pool.append(req.rid, k, v)
            # commit the whole output budget now, so admission can never
            # over-admit into mid-decode pool exhaustion
            self.pool.reserve(req.rid,
                              req.max_new_tokens + self.policy.reserve_slack)
        self.stats.prefill_s += time.perf_counter() - t0
        # sequential prefill runs at the raw prompt length: the bucket
        # label is the length
        self._registry.counter("serve.prefill_bucket", labels={
            **self._obs_labels, "bucket": S}).inc()
        self._slot_ready(slot_idx, req, first, params, done)

    def _admit_packed(self, reqs: List[Request], free: List[int],
                      done: List[Request]):
        """Group this step's admits by expert (selection order kept) and run
        one packed prefill per bucket-capacity chunk."""
        now = time.perf_counter()
        for r in reqs:
            if r.admit_s is None:
                r.admit_s = now
        groups: Dict[str, List[Request]] = {}
        for r in reqs:
            groups.setdefault(r.expert, []).append(r)
        foreign = False
        pr = self.prefill_runner
        for expert, rs in groups.items():
            t0 = time.perf_counter()
            params = self.coe.cache.activate(expert)
            dt = time.perf_counter() - t0
            self.stats.switch_s += dt
            for r in rs:                 # activation stall split pro rata
                r.switch_stall_s += dt / len(rs)
            foreign |= expert != self._active_expert
            for idx in plan_packs([len(r.tokens) for r in rs], pr.buckets,
                                  pr.max_segments):
                self._prefill_chunk([rs[i] for i in idx], params, free, done)
        if foreign and self._active_expert is not None:
            # a starving admission may have evicted the decoding expert
            t0 = time.perf_counter()
            self._params = self.coe.cache.activate(self._active_expert)
            self.stats.switch_s += time.perf_counter() - t0

    def _prefill_chunk(self, reqs: List[Request], params, free: List[int],
                       done: List[Request]):
        """One packed prefill call, the pool bookkeeping of its requests, and
        one scatter of the whole bucket."""
        for r in reqs:
            trace.instant("admit", cat="engine", request_id=r.rid,
                          expert=r.expert, slot=-1)
            flightrec.record("admit", rid=r.rid, expert=r.expert,
                             packed=len(reqs), **self._obs_labels)
        t0 = time.perf_counter()
        with trace.span("prefill", cat="engine",
                        request_ids=",".join(str(r.rid) for r in reqs),
                        expert=reqs[0].expert,
                        prompt_tokens=sum(len(r.tokens) for r in reqs),
                        **{"prefill.packed": len(reqs)}) as sp:
            res = self.prefill_runner(params, [r.tokens for r in reqs])
            sp.add(**{"prefill.bucket": res.bucket})
            firsts = torch.argmax(res.logits[:len(reqs)],
                                  dim=-1).cpu().numpy()
            # reserve prompt + whole output budget up front, so admission
            # can never over-admit into mid-decode pool exhaustion
            self.prefill_runner.scatter_into(
                self.pool, res, [r.rid for r in reqs],
                extra_tokens=[r.max_new_tokens + self.policy.reserve_slack
                              for r in reqs])
        self.stats.prefill_s += time.perf_counter() - t0
        self._registry.counter("serve.prefill_bucket", labels={
            **self._obs_labels, "bucket": res.bucket}).inc(len(reqs))
        for i, r in enumerate(reqs):
            self._slot_ready(free.pop(0), r, int(firsts[i]), params, done)

    def _slot_ready(self, slot_idx: int, req: Request, first: int, params,
                    done: List[Request]):
        """Shared admission tail: timestamps, the TTFT histogram, slot
        seating, the policy callback, immediate finish when
        ``max_new_tokens == 1``."""
        now = time.perf_counter()
        if req.admit_s is None:
            req.admit_s = now
        if req.prefill_done_s is None:
            req.prefill_done_s = now
        if req.first_token_s is None:
            req.first_token_s = now
            self._ttft_hist.observe(req.first_token_s - req.arrival_s)
        req.last_token_s = now               # the watchdog's stall baseline
        self.stats.admitted += 1
        self.stats.tokens_out += 1
        if req.on_token is not None:
            req.on_token(req, first)
        slot = _Slot(req=req, expert=req.expert, last_token=first,
                     generated=[first], admitted_step=self._step_count)
        self.policy.on_admit(slot_idx, req, params)
        if slot.remaining == 0:              # max_new_tokens == 1
            self._finish(slot, done)
            return
        self.slots[slot_idx] = slot

    def _prefetch_next(self):
        """One-ahead prefetch of the next switch target: the longest-waiting
        foreign batch if any, else the most-demanded queued expert."""
        waiting: Dict[str, int] = {}
        for s in self.slots:
            if s is not None and s.expert != self._active_expert:
                waiting[s.expert] = min(waiting.get(s.expert, 1 << 30),
                                        s.admitted_step)
        if waiting:
            name = min(waiting, key=waiting.get)
        else:
            demand: Dict[str, int] = {}
            for r in self.queue:
                if r.expert != self._active_expert:
                    demand[r.expert] = demand.get(r.expert, 0) + 1
            if not demand:
                return
            name = max(demand, key=demand.get)
        if self.coe.cache.resident(name):
            return
        need = self.coe.experts[name].nbytes
        active_bytes = (self.coe.experts[self._active_expert].nbytes
                        if self._active_expert else 0)
        if need + active_bytes <= self.coe.cache.capacity:
            self.coe.cache.prefetch(name)

    def _slot_rids(self) -> Tuple[Optional[int], ...]:
        return tuple(s.req.rid if s is not None else None for s in self.slots)

    def _device_tables(self):
        rids = self._slot_rids()
        return self._dev_tables.tables(rids), self._dev_tables.lengths(rids)

    def _device_active(self, active: np.ndarray):
        if (self._active_cache is None
                or not np.array_equal(self._active_cache[0], active)):
            self._active_cache = (active.copy(),
                                  torch.as_tensor(active, device=self.device))
        return self._active_cache[1]

    def _decode_round(self, active: np.ndarray, done: List[Request]):
        t0 = time.perf_counter()
        # the span closes after the policy's host read of the argmax, the
        # sync point that ends the round's device work
        with trace.span("decode", cat="engine", expert=self._active_expert,
                        active_slots=int(active.sum())):
            emits = self.policy.round(self._params, active)
        now = time.perf_counter()
        for i, toks in emits.items():
            slot = self.slots[i]
            self.pool.advance(slot.req.rid, len(toks))
            slot.generated.extend(toks)
            slot.last_token = toks[-1]
            slot.req.last_token_s = now
            self.stats.tokens_out += len(toks)
            if slot.req.on_token is not None:
                for t in toks:
                    slot.req.on_token(slot.req, int(t))
            if slot.remaining <= 0:
                self._finish(slot, done)
                self.slots[i] = None         # immediate slot recycling
        self.stats.exec_s += time.perf_counter() - t0
        self.stats.decode_rounds += 1
        self.stats.occupancy_sum += float(active.sum()) / self.n_slots

    def _finish(self, slot: _Slot, done: List[Request]):
        req = slot.req
        req.output = np.asarray(slot.generated[: req.max_new_tokens], np.int32)
        req.done_s = time.perf_counter()
        req.last_token_s = req.done_s
        self.pool.free(req.rid)
        self.policy.on_free(req.rid)
        if req.on_done is not None:
            req.on_done(req)
        trace.async_end("request", id=req.rid, cat="engine",
                        tokens_out=len(req.output), latency_s=req.latency_s)
        if len(req.output) > 1:
            self._tpot_hist.observe((req.done_s - req.first_token_s)
                                    / (len(req.output) - 1))
        self.lifecycle.complete(req)
        self.slo.observe(req)
        flightrec.record("done", rid=req.rid, expert=req.expert,
                         tokens_out=len(req.output), **self._obs_labels)
        done.append(req)

    # -- accounting and debug snapshots -----------------------------------
    def hbm_in_budget(self) -> bool:
        """Weights + live KV inside this engine's HBM tier right now: the
        weight cache within its capacity and, when the budget carves a KV
        share, the pool within that carve and both tiers' live bytes within
        the total. Reads host bookkeeping only."""
        cache = self.coe.cache
        if cache.used_bytes > cache.capacity:
            return False
        b = self.coe.hbm_budget
        if b.kv_bytes:
            if self.pool.capacity_bytes() > b.kv_bytes:
                return False
            return (cache.used_bytes + self.pool.bytes_in_use()
                    <= b.total_bytes)
        return True

    def debug_slots(self) -> Dict[str, Any]:
        """Live decode-slot table: what every slot is doing right now."""
        now = time.perf_counter()
        slots = []
        for idx, s in enumerate(self.slots):
            if s is None:
                slots.append({"slot": idx, "state": "free"})
                continue
            r = s.req
            last = r.last_token_s or r.first_token_s or r.arrival_s
            slots.append({
                "slot": idx, "state": "decoding", "rid": r.rid,
                "expert": s.expert, "tenant": r.tenant,
                "generated": len(s.generated), "remaining": s.remaining,
                "since_last_token_s": now - last,
                "admitted_step": s.admitted_step})
        return {"active_expert": self._active_expert,
                "queue_depth": len(self.queue),
                "queued_rids": [r.rid for r in self.queue],
                "slots": slots}

    def debug_pool(self) -> Dict[str, Any]:
        """KV pool books: occupancy, refcounts and the invariant audit (host
        bookkeeping only: no device tensor is read)."""
        p = self.pool
        return {"n_blocks": p.n_blocks, "block_size": p.block,
                "free_blocks": p.free_blocks,
                "blocks_in_use": p.stats.blocks_in_use,
                "shared_blocks": p.stats.shared_blocks,
                "bytes_in_use": p.bytes_in_use(),
                "capacity_bytes": p.capacity_bytes(),
                "open_rids": list(p.open_rids()),
                "reclaimable_blocks": p.reclaimable_blocks(),
                "invariant_violations": p.check_invariants()}

    def debug_sessions(self) -> Dict[str, Any]:
        """Retained-session table: empty, sessions are not ported."""
        return {"sessions": [], "bytes_retained": 0}

    def debug_providers(self) -> Dict[str, Any]:
        """Name -> zero-arg snapshot function, for the metrics httpd's
        ``/debug/<name>`` and the flight recorder's state providers."""
        return {"slots": self.debug_slots, "pool": self.debug_pool,
                "sessions": self.debug_sessions}
