"""Continuous-batching CoE serving engine over the paged KV pool
(counterpart of ``repro.serving.engine``).

  * every decode slot's KV lives in ``PagedKVCache`` block tables;
  * one paged extend step of fixed ``(n_slots, 1)`` shape serves any subset
    of slots through an active-lane mask — inactive lanes scatter to the
    pool's scratch block;
  * per-step admission: requests for the active expert are prefilled, packed
    into bucketed forwards, into free slots while decode continues; when a
    group drains, the next expert is chosen preferring experts whose weights
    are ready in the ``HBMWeightCache``; an aging counter admits any request
    stuck behind that preference;
  * next-expert prefetch overlaps the weight copy with decode (paper Fig 9).

Ported here: the continuous scheduler, packed prefill, ``GreedyDecode`` and
decoding through the hand-written kernels (``FusedPagedBackend``). Not ported
yet (``ROADMAP.md``): the trace / lifecycle / SLO / flight-recorder plane,
prefix sharing, sessions, ``SpeculativeDecode``, the run-to-completion
scheduler, sequential prefill and disaggregated prefill handoffs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.coe import CompositionOfExperts
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
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    output: Optional[np.ndarray] = None
    skipped: int = 0                    # admission passes survived unadmitted

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


@dataclass
class ServeStats:
    """Engine counters, under the JAX package's ``as_dict`` keys."""
    requests: int = 0
    tokens_out: int = 0
    admitted: int = 0
    decode_rounds: int = 0
    switches: int = 0
    starvation_overrides: int = 0
    prefix_hit_tokens: int = 0
    occupancy_sum: float = 0.0
    route_s: float = 0.0
    switch_s: float = 0.0
    prefill_s: float = 0.0
    exec_s: float = 0.0

    @property
    def tokens_per_second(self):
        t = self.switch_s + self.exec_s + self.prefill_s
        return self.tokens_out / t if t else 0.0

    @property
    def mean_occupancy(self):
        return self.occupancy_sum / max(self.decode_rounds, 1)

    def as_dict(self):
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["tokens_per_second"] = self.tokens_per_second
        d["mean_occupancy"] = self.mean_occupancy
        return d


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
    admit newly arrived requests into free slots (packed prefill), prefetch
    the next-most-demanded expert, run one decode round for the active
    expert's slots, recycle completed slots. ``drain()`` loops until idle.
    ``device`` defaults to the card and must be the composition's device.
    Decode runs through the fused kernels unless ``backend`` passes another
    ``PagedBackend`` object (the parity tests pass the reference).
    """

    def __init__(self, coe: CompositionOfExperts, cfg: ModelConfig, *,
                 max_len: int = 4096, n_slots: int = 8, block_size: int = 16,
                 backend: Optional[PagedBackend] = None,
                 kv_dtype=torch.bfloat16,
                 device=None):
        self.device = resolve_device(device)
        if self.device != coe.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"composition's {coe.device}")
        self.coe = coe
        self.cfg = cfg
        self.max_len = max_len
        self.n_slots = n_slots
        self.block = block_size
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
        self.pool = PagedKVCache.for_budget(
            kv_budget_bytes, block_size, cfg.n_layers, cfg.n_kv_heads,
            cfg.head_dim, kv_dtype, scratch=True, device=self.device)
        self._empty_table = np.full((self.max_blocks,),
                                    self.pool.scratch_index, np.int32)
        self.runner = PagedDecodeRunner(cfg, self.pool.scratch_index,
                                        backend=backend)
        self._dev_tables = _DeviceTableCache(self.pool, self.max_blocks,
                                             self._empty_table)
        self._active_cache: Optional[Tuple[np.ndarray, torch.Tensor]] = None
        self.prefill_runner = PackedPrefillRunner(
            cfg, buckets=default_buckets(max_len), max_segments=n_slots)
        self.ttft_s: List[float] = []     # arrival -> first token, per request
        self.policy.bind(self)

        self.queue: List[Request] = []
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.stats = ServeStats()
        self._active_expert: Optional[str] = None
        self._params = None
        self._quantum_used = 0
        self._step_count = 0

    # -- public API -------------------------------------------------------
    def submit(self, req: Request):
        """Enqueue a request. An untagged request is routed through the
        composition's router once, here."""
        need = len(req.tokens) + req.max_new_tokens + self.policy.reserve_slack
        if need > self.max_blocks * self.block:
            raise ValueError(
                f"request {req.rid}: {need} tokens exceed engine max_len "
                f"{self.max_len}")
        if -(-need // self.block) > self.pool.n_blocks:
            raise ValueError(
                f"request {req.rid} needs more KV blocks than the pool owns")
        if req.expert is None:
            req.expert, dt = self.coe.route_request(req.tokens)
            self.stats.route_s += dt
        elif req.expert not in self.coe.experts:
            raise KeyError(
                f"request {req.rid}: unknown expert {req.expert!r}")
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def step(self) -> List[Request]:
        """One scheduler iteration; returns requests completed in it."""
        self._step_count += 1
        done: List[Request] = []
        name = self._pick_expert()
        if name is None:
            return done
        if name != self._active_expert:
            self._switch_to(name)
        self._admit(done)
        self._prefetch_next()
        active = np.array([s is not None and s.expert == self._active_expert
                           for s in self.slots], bool)
        if active.any():
            self._decode_round(active, done)
        self._quantum_used += 1
        self.stats.requests += len(done)
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
        self._params = self.coe.cache.activate(name)
        self.stats.switch_s += time.perf_counter() - t0
        if self._active_expert is not None:
            self.stats.switches += 1
        self._active_expert = name
        self._quantum_used = 0

    def _admit(self, done: List[Request]):
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        # refill from the active expert's queue only (plus starving
        # requests): a foreign-expert slot would idle in every decode batch
        starving = [r for r in self.queue if r.skipped >= self.starvation_limit]
        candidates = starving + [r for r in self.queue
                                 if r.expert == self._active_expert
                                 and r not in starving]
        admitted: List[Request] = []
        planned = 0
        for r in candidates:
            if len(admitted) >= len(free):
                break
            need = self._blocks_for(r)
            if (planned + need > self.pool.free_blocks
                    and (admitted or self._any_active())):
                break                    # KV backpressure: stop admitting
            admitted.append(r)
            planned += need
        if not admitted:
            return
        self._admit_packed(admitted, free, done)
        for r in self.queue:
            if r not in admitted:
                r.skipped += 1
        self.queue = [r for r in self.queue if r not in admitted]

    def _admit_packed(self, reqs: List[Request], free: List[int],
                      done: List[Request]):
        """Group this step's admits by expert (selection order kept) and run
        one packed prefill per bucket-capacity chunk."""
        groups: Dict[str, List[Request]] = {}
        for r in reqs:
            groups.setdefault(r.expert, []).append(r)
        foreign = False
        pr = self.prefill_runner
        for expert, rs in groups.items():
            t0 = time.perf_counter()
            params = self.coe.cache.activate(expert)
            self.stats.switch_s += time.perf_counter() - t0
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
        t0 = time.perf_counter()
        res = self.prefill_runner(params, [r.tokens for r in reqs])
        firsts = torch.argmax(res.logits[:len(reqs)], dim=-1).cpu().numpy()
        # reserve prompt + whole output budget up front, so admission can
        # never over-admit into mid-decode pool exhaustion
        self.prefill_runner.scatter_into(
            self.pool, res, [r.rid for r in reqs],
            extra_tokens=[r.max_new_tokens + self.policy.reserve_slack
                          for r in reqs])
        self.stats.prefill_s += time.perf_counter() - t0
        for i, r in enumerate(reqs):
            self._slot_ready(free.pop(0), r, int(firsts[i]), params, done)

    def _slot_ready(self, slot_idx: int, req: Request, first: int, params,
                    done: List[Request]):
        req.first_token_s = time.perf_counter()
        self.ttft_s.append(req.first_token_s - req.arrival_s)
        self.stats.admitted += 1
        self.stats.tokens_out += 1
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
        emits = self.policy.round(self._params, active)
        for i, toks in emits.items():
            slot = self.slots[i]
            self.pool.advance(slot.req.rid, len(toks))
            slot.generated.extend(toks)
            slot.last_token = toks[-1]
            self.stats.tokens_out += len(toks)
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
        self.pool.free(req.rid)
        self.policy.on_free(req.rid)
        done.append(req)
