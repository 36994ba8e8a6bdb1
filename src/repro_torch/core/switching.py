"""Expert switching: the HBM tier as a software-managed LRU cache of expert
weights over the capacity tier (counterpart of
``repro.core.switching.HBMWeightCache``).

  * LRU eviction when the tier's capacity is hit; read-only weights skip any
    copy-back;
  * in-flight reservations: a prefetch reserves its expert's bytes up front,
    so concurrent loads can never over-commit the tier;
  * prefetch: the store read and the host-to-device copy run on a background
    thread, the copy on a side ``torch.cuda.Stream`` from pinned host memory.
    The copy records an event; ``activate`` makes the consuming stream wait
    on it, so decode never reads half-copied weights. On the CPU, prefetch is
    a synchronous copy.

Counters are a ``SwitchStats`` view over a metrics registry; every tier
transfer lands in a ``TransferLedger`` on the same registry, and the loads
record ``store_read`` / ``h2d`` / ``activate`` spans when tracing is on.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.bridge import tree_bytes, tree_leaves, tree_map
from repro_torch.core.memory_tiers import DGX_H100, MachineTiers
from repro_torch.obs import trace
from repro_torch.obs.ledger import TransferLedger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.stats import StatsView, counter_field
from repro_torch.store import ExpertStore


class SwitchStats(StatsView):
    """Switching-cache counters as a view over the metrics registry
    (``switch.*`` series, JAX's names). ``drops`` and ``bytes_copied_back``
    stay 0 until dirty write-back and ``drop`` are ported: every entry is
    read-only weights, whose copy-back is elided."""

    PREFIX = "switch"
    DERIVED = ("copy_seconds", "overlap_ratio")

    hits = counter_field()
    misses = counter_field()
    prefetch_hits = counter_field()   # activates served by an in-flight prefetch
    prefetch_failures = counter_field()  # prefetch loads that raised; retried as miss
    prefetches_issued = counter_field()
    prefetches_cancelled = counter_field()
    evictions = counter_field()
    drops = counter_field()
    bytes_copied_in = counter_field()
    bytes_copied_back = counter_field()
    bytes_copyback_elided = counter_field()
    switch_seconds = counter_field(0.0)  # caller-side stall inside activate()
    stall_miss_seconds = counter_field(0.0)      # ...due to true misses
    stall_prefetch_seconds = counter_field(0.0)  # ...due to prefetch consumes
    stall_failed_prefetch_seconds = counter_field(0.0)  # ...waiting on a
    # prefetch that then raised
    store_read_seconds = counter_field(0.0)
    h2d_seconds = counter_field(0.0)

    @property
    def copy_seconds(self) -> float:
        return self.store_read_seconds + self.h2d_seconds

    @property
    def overlap_ratio(self) -> float:
        """Fraction of total load time hidden off the critical path."""
        total = self.copy_seconds
        if total <= 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.switch_seconds / total))


@dataclass
class _Loaded:
    value: Any                        # device tree
    nbytes: int
    read_s: float
    h2d_s: float
    ready: Optional[torch.cuda.Event]  # recorded on the copy stream


class HBMWeightCache:
    """LRU cache of expert parameter trees in device memory, backed by an
    ``ExpertStore`` capacity tier."""

    def __init__(self, capacity_bytes: int, store: ExpertStore, device,
                 max_inflight: int = 2,
                 registry: Optional[MetricsRegistry] = None,
                 labels: Optional[Dict[str, Any]] = None):
        self.capacity = int(capacity_bytes)
        self.store = store
        self.device = torch.device(device)
        self.max_inflight = max(1, int(max_inflight))
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._nbytes: dict = {}
        self._inflight: "OrderedDict[str, Future]" = OrderedDict()
        self._reserved: dict = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._used = 0
        # the stats view and the tier-transfer ledger share one registry (a
        # private one unless the caller publishes into a shared registry)
        registry = registry if registry is not None else MetricsRegistry()
        self.stats = SwitchStats(registry=registry, labels=labels)
        self.ledger = TransferLedger(registry, labels)
        self._hbm_used_gauge = registry.gauge("switch.hbm_used_bytes", labels)

    # -- internals -----------------------------------------------------
    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.max_inflight,
                                            thread_name_prefix="hbm-prefetch")
        return self._pool

    def _load_job(self, expert_id: str) -> _Loaded:
        """Store read, then the host-to-device copy. On the card the copy
        runs on the side stream and this thread waits for it inside the
        ``h2d`` span, so the span and the ``h2d_s`` it reports are the copy's
        own time, not its launch's."""
        t0 = time.perf_counter()
        with trace.span("store_read", cat="switch", expert=expert_id):
            host = self.store.get(expert_id)
        t1 = time.perf_counter()
        ready = None
        with trace.span("h2d", cat="switch", expert=expert_id):
            if self.device.type == "cuda":
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(self._copy_stream):
                    dev = tree_map(
                        lambda t: t.to(self.device, non_blocking=True), host)
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
                ready.synchronize()
            else:
                dev = tree_map(lambda t: t.to(self.device), host)
        t2 = time.perf_counter()
        return _Loaded(dev, tree_bytes(host), t1 - t0, t2 - t1, ready)

    def _evict_one(self):
        name, _ = self._entries.popitem(last=False)      # LRU = oldest
        nb = self._nbytes.pop(name)
        self._used -= nb
        self._hbm_used_gauge.set(self._used)
        self.stats.evictions += 1
        self.stats.bytes_copyback_elided += nb            # read-only weights
        self.ledger.record("elided", nb, cause="read_only", expert=name)

    def _budget(self) -> int:
        return self.capacity - sum(self._reserved.values())

    def _make_room(self, need: int, *, strict: bool = True) -> bool:
        """Evict until ``need`` bytes fit inside the capacity not reserved by
        in-flight loads. A demand miss (``strict``) cancels stale prefetches
        before giving up; a prefetch returns False instead."""
        if need > self._budget():
            if not strict:
                return False
            while need > self._budget() and self._inflight:
                self.cancel(next(iter(self._inflight)))
            if need > self._budget():
                raise MemoryError(
                    f"expert of {need} bytes exceeds HBM tier capacity "
                    f"{self.capacity}")
        while self._used + need > self._budget():
            self._evict_one()
        return True

    def _unreserve(self, expert_id: str):
        need = self._reserved.pop(expert_id, None)
        if need:
            self.ledger.release(need)

    def _install(self, expert_id: str, loaded: _Loaded, cause: str):
        self._make_room(loaded.nbytes)
        if loaded.ready is not None:
            # the consumer stream waits for the copy, and the allocator learns
            # that the consumer stream uses memory the copy stream allocated
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(loaded.ready)
            for t in tree_leaves(loaded.value):
                t.record_stream(stream)
        self.stats.bytes_copied_in += loaded.nbytes
        self.stats.store_read_seconds += loaded.read_s
        self.stats.h2d_seconds += loaded.h2d_s
        self.ledger.record("store_read", loaded.nbytes, loaded.read_s,
                           cause=cause, expert=expert_id)
        self.ledger.record("h2d", loaded.nbytes, loaded.h2d_s, cause=cause)
        self._entries[expert_id] = loaded.value
        self._nbytes[expert_id] = loaded.nbytes
        self._used += loaded.nbytes
        self._hbm_used_gauge.set(self._used)
        return loaded.value

    # -- public API ------------------------------------------------------
    def resident(self, expert_id: str) -> bool:
        return expert_id in self._entries

    def ready(self, expert_id: str) -> bool:
        """Activating this expert would not stall: resident, or its prefetch
        has landed successfully."""
        if expert_id in self._entries:
            return True
        fut = self._inflight.get(expert_id)
        return (fut is not None and fut.done() and not fut.cancelled()
                and fut.exception() is None)

    @property
    def used_bytes(self) -> int:
        return self._used

    def activate(self, expert_id: str):
        """The device tree of an expert. Resident -> no stall; in-flight
        prefetch -> wait for its unfinished tail; miss -> synchronous load.
        A prefetch whose store read or copy raised is counted in
        ``stats.prefetch_failures`` and reloaded inline as a miss. The stall
        lands in ``stats.switch_seconds``, split by cause as JAX splits it
        (a consumed prefetch, a true miss, the wait on a failed prefetch)."""
        if expert_id in self._entries:
            self._entries.move_to_end(expert_id)
            self.stats.hits += 1
            return self._entries[expert_id]
        t0 = time.perf_counter()
        with trace.span("activate", cat="switch", expert=expert_id) as sp:
            fut = self._inflight.pop(expert_id, None)
            consumed_prefetch = False
            failed_wait_s = 0.0      # time sunk into a prefetch that raised
            loaded = None
            if fut is not None:
                self._unreserve(expert_id)
                try:
                    loaded = fut.result()
                    consumed_prefetch = True
                    self.stats.hits += 1
                    self.stats.prefetch_hits += 1
                except Exception:
                    # the wait on the doomed load is its own stall cause
                    failed_wait_s = time.perf_counter() - t0
                    self.stats.prefetch_failures += 1
                    self.stats.stall_failed_prefetch_seconds += failed_wait_s
                    self.ledger.note_stall(failed_wait_s,
                                           cause="failed_prefetch")
                    trace.instant("prefetch_failed", cat="switch",
                                  expert=expert_id)
            if loaded is None:
                self.stats.misses += 1
                loaded = self._load_job(expert_id)
            cause = "prefetch" if consumed_prefetch else (
                "failed_prefetch" if failed_wait_s else "miss")
            value = self._install(expert_id, loaded, cause)
            dt = time.perf_counter() - t0
            self.stats.switch_seconds += dt
            if consumed_prefetch:
                self.stats.stall_prefetch_seconds += dt
                self.ledger.note_stall(dt, cause="prefetch")
            else:
                self.stats.stall_miss_seconds += dt - failed_wait_s
                self.ledger.note_stall(dt - failed_wait_s, cause="miss")
            sp.add(outcome=cause, nbytes=loaded.nbytes)
        return value

    def prefetch(self, expert_id: str) -> bool:
        """Start loading a predicted-next expert; True if a load started.
        On the card the load runs on the background thread and this call
        never blocks; on the CPU it is a synchronous copy. An expert the store
        cannot size is skipped (False); a load that raises is left in its
        future for ``activate`` to retry."""
        if expert_id in self._entries or expert_id in self._inflight:
            return False
        while len(self._inflight) >= self.max_inflight:
            self.cancel(next(iter(self._inflight)))   # oldest prediction loses
        try:
            need = self.store.nbytes(expert_id)
        except Exception:
            return False                        # unknown expert
        if not self._make_room(need, strict=False):
            return False
        self._reserved[expert_id] = need
        self.ledger.reserve(need)
        if self.device.type == "cuda":
            fut = self._executor().submit(self._load_job, expert_id)
        else:
            fut = Future()
            try:
                fut.set_result(self._load_job(expert_id))
            except Exception as e:
                fut.set_exception(e)
        self._inflight[expert_id] = fut
        self.stats.prefetches_issued += 1
        return True

    def cancel(self, expert_id: str) -> bool:
        """Cancel an in-flight prefetch; a load already running is discarded
        when it lands."""
        fut = self._inflight.pop(expert_id, None)
        if fut is None:
            return False
        self._unreserve(expert_id)
        fut.cancel()
        self.stats.prefetches_cancelled += 1
        return True

    def close(self):
        """Cancel pending prefetches and stop the background thread."""
        for expert_id in list(self._inflight):
            self.cancel(expert_id)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def model_switch_time(nbytes: int, machine: MachineTiers = DGX_H100) -> float:
    """Analytic switch latency: capacity-tier -> HBM copy at the node's
    published copy bandwidth (paper Fig 1 / Fig 12)."""
    return nbytes / machine.copy_bw_node
