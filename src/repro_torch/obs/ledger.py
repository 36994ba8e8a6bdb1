"""Tier-transfer ledger: one byte-and-latency-attributed view of every move
between memory tiers.

Before this existed, DDR->host reads, host->HBM copies and HBM reservations
were accounted three different ways (``core/switching.py`` stat fields,
``store/*`` ``StoreStats``, ad-hoc gauges in ``node/scheduler.py``). The
ledger unifies them: every transfer is recorded against a named *edge* of
the three-tier system with a *cause*, and the registry exposes

  * ``ledger.bytes{edge=,cause=}`` / ``ledger.seconds{edge=,cause=}``
    counters,
  * ``ledger.transfers{edge=,cause=}`` counts,
  * ``ledger.bandwidth_bps{edge=}`` derived gauges (bytes / seconds so far),
  * ``ledger.hbm_reserved_bytes`` — in-flight prefetch reservations against
    the HBM tier (the switching engine's over-commit guard),
  * ``ledger.stall_seconds{cause=}`` — caller-visible stall attributed per
    cause, and ``ledger.overlap_ratio``, the paper's Fig-9 claim as a
    first-class metric: the fraction of total transfer time hidden off the
    critical path.

Edges (src->dst in tier terms):
    ``store_read``  DDR/disk capacity tier -> host staging (store ``get``)
    ``h2d``         host -> HBM (``device_put``)
    ``writeback``   HBM -> capacity tier (dirty mutable state on evict/drop)
    ``elided``      a copy the runtime proved unnecessary (read-only
                    weights skipping writeback — bytes only, zero seconds)
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from repro_torch.obs.metrics import MetricsRegistry

EDGES = ("store_read", "h2d", "writeback", "elided")

_EDGE_TIERS = {
    "store_read": ("ddr", "host"),
    "h2d": ("host", "hbm"),
    "writeback": ("hbm", "ddr"),
    "elided": ("hbm", "ddr"),
}


class TransferLedger:
    """Byte + latency accounting for tier transfers, over a registry."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 labels: Optional[Dict[str, Any]] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._bytes: Dict[str, float] = {e: 0.0 for e in EDGES}
        self._seconds: Dict[str, float] = {e: 0.0 for e in EDGES}
        self._reserved = self.registry.gauge("ledger.hbm_reserved_bytes",
                                             self.labels)
        for edge in EDGES:
            self.registry.derived_gauge(
                "ledger.bandwidth_bps", self._bw_fn(edge),
                {**self.labels, "edge": edge})
        self.registry.derived_gauge("ledger.overlap_ratio",
                                    lambda: self.overlap_ratio, self.labels)

    def _bw_fn(self, edge: str):
        def fn():
            s = self._seconds[edge]
            return self._bytes[edge] / s if s > 0 else 0.0
        return fn

    def _labeled(self, edge: str, cause: Optional[str]):
        lbl = dict(self.labels)
        lbl["edge"] = edge
        if cause:
            lbl["cause"] = cause
        return lbl

    # -- recording -----------------------------------------------------
    def record(self, edge: str, nbytes: int, seconds: float = 0.0, *,
               cause: Optional[str] = None, expert: Optional[str] = None):
        """Account one transfer on ``edge``: ``nbytes`` moved in
        ``seconds`` (as measured where the copy ran — worker-side for the
        prefetch pipeline). ``cause`` attributes it (prefetch / miss /
        failed_prefetch / writeback...); ``expert`` adds a per-expert bytes
        series."""
        if edge not in EDGES:
            raise ValueError(f"unknown ledger edge {edge!r} (not in {EDGES})")
        lbl = self._labeled(edge, cause)
        reg = self.registry
        reg.counter("ledger.bytes", lbl).inc(nbytes)
        reg.counter("ledger.seconds", lbl).inc(seconds)
        reg.counter("ledger.transfers", lbl).inc()
        if seconds > 0:
            reg.histogram("ledger.transfer_s",
                          {**self.labels, "edge": edge}).observe(seconds)
        if expert is not None:
            reg.counter("ledger.bytes_by_expert",
                        {**self.labels, "expert": expert}).inc(nbytes)
        with self._lock:
            self._bytes[edge] += nbytes
            self._seconds[edge] += seconds

    def note_stall(self, seconds: float, *, cause: str):
        """Caller-visible stall time (what the serving thread actually
        waited), attributed per cause. The gap between total transfer
        seconds and stall seconds is what prefetch hid."""
        self.registry.counter(
            "ledger.stall_seconds",
            {**self.labels, "cause": cause}).inc(seconds)
        self.registry.histogram(
            "ledger.stall_s", {**self.labels, "cause": cause}).observe(seconds)

    def reserve(self, nbytes: int):
        """HBM bytes promised to an in-flight load (prefetch issue)."""
        self._reserved.inc(nbytes)

    def release(self, nbytes: int):
        """Reservation resolved: the load landed, failed or was cancelled."""
        self._reserved.dec(nbytes)

    # -- derived views ---------------------------------------------------
    def bytes_moved(self, edge: str) -> int:
        return int(self._bytes[edge])

    def seconds(self, edge: str) -> float:
        return self._seconds[edge]

    def bandwidth_bps(self, edge: str) -> float:
        return self._bw_fn(edge)()

    @property
    def reserved_bytes(self) -> int:
        return int(self._reserved.value)

    @property
    def copy_seconds(self) -> float:
        """End-to-end inbound load time (store read + H2D)."""
        return self._seconds["store_read"] + self._seconds["h2d"]

    @property
    def stall_seconds(self) -> float:
        total = 0.0
        for m in self.registry.metrics():
            if m.name == "ledger.stall_seconds":
                lbl = dict(m.labels)
                if all(lbl.get(k) == str(v) for k, v in self.labels.items()):
                    total += m.value
        return total

    @property
    def overlap_ratio(self) -> float:
        """Fraction of inbound transfer time hidden from the caller
        (clamped to [0, 1]: stall includes bookkeeping the worker-side
        phase timers don't see)."""
        total = self.copy_seconds
        if total <= 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.stall_seconds / total))

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for edge in EDGES:
            out[f"{edge}_bytes"] = self.bytes_moved(edge)
            out[f"{edge}_seconds"] = self.seconds(edge)
            out[f"{edge}_bandwidth_bps"] = self.bandwidth_bps(edge)
        out["hbm_reserved_bytes"] = self.reserved_bytes
        out["stall_seconds"] = self.stall_seconds
        out["overlap_ratio"] = self.overlap_ratio
        return out
