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
"""
from __future__ import annotations

import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import asdict, dataclass
from typing import Any, Optional

import torch

from repro_torch.bridge import tree_bytes, tree_leaves, tree_map
from repro_torch.core.memory_tiers import DGX_H100, MachineTiers
from repro_torch.store import ExpertStore


@dataclass
class SwitchStats:
    hits: int = 0
    misses: int = 0
    prefetch_hits: int = 0
    prefetch_failures: int = 0        # prefetch loads that raised; retried as miss
    prefetches_issued: int = 0
    prefetches_cancelled: int = 0
    evictions: int = 0
    bytes_copied_in: int = 0
    bytes_copyback_elided: int = 0
    switch_seconds: float = 0.0       # caller-side stall inside activate()
    stall_failed_prefetch_seconds: float = 0.0  # ...waiting on a prefetch
    # that then raised
    store_read_seconds: float = 0.0
    h2d_seconds: float = 0.0

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

    def as_dict(self):
        return {**asdict(self), "copy_seconds": self.copy_seconds,
                "overlap_ratio": self.overlap_ratio}


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
                 max_inflight: int = 2):
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
        self.stats = SwitchStats()

    # -- internals -----------------------------------------------------
    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.max_inflight,
                                            thread_name_prefix="hbm-prefetch")
        return self._pool

    def _load_job(self, expert_id: str) -> _Loaded:
        """Store read, then the host-to-device copy. On the card the copy
        runs on the side stream and this thread waits for it, so the
        ``h2d_s`` it reports is the copy's own time."""
        t0 = time.perf_counter()
        host = self.store.get(expert_id)
        t1 = time.perf_counter()
        ready = None
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                dev = tree_map(lambda t: t.to(self.device, non_blocking=True),
                               host)
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
        self.stats.evictions += 1
        self.stats.bytes_copyback_elided += nb            # read-only weights

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

    def _install(self, expert_id: str, loaded: _Loaded):
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
        self._entries[expert_id] = loaded.value
        self._nbytes[expert_id] = loaded.nbytes
        self._used += loaded.nbytes
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
        lands in ``stats.switch_seconds``."""
        if expert_id in self._entries:
            self._entries.move_to_end(expert_id)
            self.stats.hits += 1
            return self._entries[expert_id]
        t0 = time.perf_counter()
        fut = self._inflight.pop(expert_id, None)
        loaded = None
        if fut is not None:
            self._reserved.pop(expert_id, None)
            try:
                loaded = fut.result()
                self.stats.hits += 1
                self.stats.prefetch_hits += 1
            except Exception:
                # the wait on the doomed load is its own stall cause
                self.stats.prefetch_failures += 1
                self.stats.stall_failed_prefetch_seconds += (
                    time.perf_counter() - t0)
        if loaded is None:
            self.stats.misses += 1
            loaded = self._load_job(expert_id)
        value = self._install(expert_id, loaded)
        self.stats.switch_seconds += time.perf_counter() - t0
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
        self._reserved.pop(expert_id, None)
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
