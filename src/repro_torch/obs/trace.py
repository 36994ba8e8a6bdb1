"""Span tracing with Chrome-trace / Perfetto JSON export.

``span("prefill", request_id=3)`` is a context manager that records one
complete event (begin/end/attrs) into a per-thread ring buffer; ``instant``
records a point event (placement decisions, request admission);
``async_begin``/``async_end`` bracket one request's whole lifecycle across
scheduler steps (they need not nest and may even end on another thread).
Buffers are per-thread so the switching cache's prefetch workers and the
engine's caller thread never contend on a lock in the record path; ring
semantics bound memory on long runs (oldest events drop first). Drops are
COUNTED per ring — ``Tracer.dropped_events`` totals them, the default
registry exposes them as the ``trace.dropped_events`` gauge
(``register_metrics``), and every Chrome-trace export stamps the total
into its ``metadata`` so a truncated timeline is never mistaken for a
complete one.

Tracing is OFF by default and the disabled path is allocation-free:
``span()`` returns a module-level no-op singleton, so the engine can leave
trace calls on the per-step decode hot path (asserted by
``tests/test_obs.py``).

``export(path)`` writes the Chrome trace-event format that Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing`` open directly:
``{"traceEvents": [{"name", "ph", "ts", "dur", "pid", "tid", "args"}]}``
with timestamps in microseconds since the tracer was enabled.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional


class Span:
    """A live span: ``with`` records one complete ("X") event on exit.
    ``add(**attrs)`` attaches attrs discovered mid-span (outcome, bytes)."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def add(self, **attrs):
        self.args.update(attrs)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tracer
        tr._record({"name": self.name, "cat": self.cat, "ph": "X",
                    "ts": tr._us(self._t0), "dur": (t1 - self._t0) * 1e6,
                    "args": self.args})
        return False


class _NoopSpan:
    """Shared do-nothing span for the disabled path — one instance per
    process, so disabled tracing allocates nothing per call."""

    __slots__ = ()

    def add(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Ring:
    """One thread's event ring. Only the owning thread appends, so the
    bounded-append drop count needs no lock; readers snapshot under the
    tracer lock like before."""

    __slots__ = ("events", "maxlen", "dropped")

    def __init__(self, maxlen: int):
        self.events: deque = deque(maxlen=maxlen)
        self.maxlen = maxlen
        self.dropped = 0

    def append(self, ev: Dict[str, Any]):
        if len(self.events) == self.maxlen:
            self.dropped += 1            # deque(maxlen) evicts the oldest
        self.events.append(ev)

    def clear(self):
        self.events.clear()
        self.dropped = 0


class Tracer:
    """Per-thread ring buffers of Chrome trace events."""

    def __init__(self, buffer_size: int = 1 << 16):
        self.buffer_size = buffer_size
        self.enabled = False
        self._pid = os.getpid()
        self._epoch = time.perf_counter()
        self._local = threading.local()
        # list of (tid, ring), not a dict keyed by tid: thread idents are
        # reused after a thread exits, and a dict would silently drop a
        # dead thread's events when a new thread inherits its ident
        self._rings: List[tuple] = []
        self._thread_names: Dict[int, str] = {}
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------
    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            tid = threading.get_ident()
            ring = _Ring(self.buffer_size)
            with self._lock:
                self._rings.append((tid, ring))
                self._thread_names[tid] = threading.current_thread().name
            self._local.ring = ring
        return ring

    def _record(self, ev: Dict[str, Any]):
        if not self.enabled:
            return
        ev.setdefault("pid", self._pid)
        ev.setdefault("tid", threading.get_ident())
        self._ring().append(ev)

    def span(self, name: str, cat: str = "repro", **attrs):
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, cat, attrs)

    def instant(self, name: str, cat: str = "repro", **attrs):
        if not self.enabled:
            return
        self._record({"name": name, "cat": cat, "ph": "i",
                      "ts": self._us(time.perf_counter()), "s": "t",
                      "args": attrs})

    def async_begin(self, name: str, id: int, cat: str = "repro", **attrs):
        """Open one lane of a non-nesting flow (e.g. a request's admit->done
        lifecycle). Pair with ``async_end`` on the same (name, id)."""
        if not self.enabled:
            return
        self._record({"name": name, "cat": cat, "ph": "b", "id": int(id),
                      "ts": self._us(time.perf_counter()), "args": attrs})

    def async_end(self, name: str, id: int, cat: str = "repro", **attrs):
        if not self.enabled:
            return
        self._record({"name": name, "cat": cat, "ph": "e", "id": int(id),
                      "ts": self._us(time.perf_counter()), "args": attrs})

    # -- lifecycle -----------------------------------------------------
    def start(self, *, reset: bool = True):
        if reset:
            self.clear()
        self.enabled = True

    def stop(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            rings = list(self._rings)
        for _, r in rings:
            r.clear()
        self._epoch = time.perf_counter()

    @property
    def dropped_events(self) -> int:
        """Events lost to ring overflow across all threads (since the last
        ``clear``)."""
        with self._lock:
            rings = list(self._rings)
        return sum(r.dropped for _, r in rings)

    # -- export --------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """All recorded events, oldest first across threads."""
        with self._lock:
            rings = list(self._rings)
        evs: List[Dict[str, Any]] = []
        for _, ring in rings:
            evs.extend(list(ring.events))
        evs.sort(key=lambda e: e.get("ts", 0.0))
        return evs

    def to_chrome_trace(self) -> Dict[str, Any]:
        evs = self.events()
        with self._lock:
            names = dict(self._thread_names)
        meta = [{"name": "thread_name", "ph": "M", "pid": self._pid,
                 "tid": tid, "args": {"name": tname}}
                for tid, tname in sorted(names.items())]
        # Perfetto ignores unknown top-level keys; readers of the exported
        # document can tell a truncated timeline from a complete one
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms",
                "metadata": {"trace.dropped_events": self.dropped_events}}

    def export(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome_trace()))
        return path


# ----------------------------------------------------------------------
# Process-wide default tracer (module-level API all call sites use)
# ----------------------------------------------------------------------
_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    global _tracer
    old, _tracer = _tracer, tracer
    return old


def enabled() -> bool:
    return _tracer.enabled


def enable(*, reset: bool = True):
    _tracer.start(reset=reset)


def disable():
    _tracer.stop()


def span(name: str, cat: str = "repro", **attrs):
    t = _tracer
    if not t.enabled:
        return NOOP_SPAN
    return Span(t, name, cat, attrs)


def instant(name: str, cat: str = "repro", **attrs):
    _tracer.instant(name, cat, **attrs)


def async_begin(name: str, id: int, cat: str = "repro", **attrs):
    _tracer.async_begin(name, id, cat, **attrs)


def async_end(name: str, id: int, cat: str = "repro", **attrs):
    _tracer.async_end(name, id, cat, **attrs)


def export(path) -> Path:
    return _tracer.export(path)


def events() -> List[Dict[str, Any]]:
    return _tracer.events()


def dropped_events() -> int:
    return _tracer.dropped_events


def register_metrics(registry) -> None:
    """Expose the default tracer's overflow count as the
    ``trace.dropped_events`` gauge on ``registry`` (reads through
    ``set_tracer`` swaps). Idempotent — re-registering returns the same
    series."""
    registry.derived_gauge("trace.dropped_events",
                           lambda: float(_tracer.dropped_events))


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Schema check for an exported trace document; returns a list of
    problems (empty = valid). Used by tests and the bench harness."""
    problems = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing top-level 'traceEvents'"]
    open_async: Dict[Any, int] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        for req in ("name", "ph", "pid", "tid"):
            if req not in ev:
                problems.append(f"event {i}: missing {req!r}")
        ph = ev.get("ph")
        if ph not in ("X", "i", "b", "e", "M"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph != "M" and "ts" not in ev:
            problems.append(f"event {i}: missing ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"event {i}: complete event without dur")
        if ph in ("b", "e"):
            key = (ev.get("name"), ev.get("id"))
            open_async[key] = open_async.get(key, 0) + (1 if ph == "b" else -1)
            if open_async[key] < 0:
                problems.append(f"event {i}: async end before begin {key}")
    for key, n in open_async.items():
        if n > 0:
            problems.append(f"unclosed async span {key}")
    return problems
