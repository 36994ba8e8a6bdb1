"""Black-box flight recorder: a bounded ring of structured serving events.

Production postmortems need the *last thing the system did*, not the full
history: which requests were admitted into which slots, which expert
switches ran, what got preempted, which sessions were evicted and which
blocks reclaimed — right up to the moment something wedged. The recorder is
a fixed-capacity ring of small dicts (``record()`` is one deque append on
the hot path; overflow drops the oldest event and counts the drop), plus
registered *state providers* that snapshot live component state
(slots/pool/sessions/placement) only when a dump is actually taken.

``dump()`` writes one self-contained JSON postmortem bundle::

    {"schema": "repro.flightrec/1", "events": [...], "dropped_events": n,
     "metrics": <registry snapshot>, "state": {"slots": ..., "pool": ...}}

Triggers: on demand (``/debug/flight``), on a watchdog anomaly
(``Watchdog(dump_on_anomaly=...)``), or via SIGUSR2 in ``launch/serve.py``.
``validate_bundle`` is the schema check the tests and the signal handler
round-trip through.

Like ``obs.trace``, a process-default recorder backs a module-level
``record()`` so the kv pool and session manager can emit events without
threading a recorder handle through every constructor.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

SCHEMA = "repro.flightrec/1"

#: every ring event carries these; ``kind`` names the event class
EVENT_KINDS = ("admit", "evict", "preempt", "switch", "reclaim", "handoff",
               "anomaly", "done")


class FlightRecorder:
    """Bounded ring of structured events + lazily-snapshotted state."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._ring: deque = deque()
        self._lock = threading.Lock()
        self.dropped_events = 0
        # name -> zero-arg callable returning a JSON-able snapshot; called
        # only at dump time so providers may be arbitrarily expensive
        self._state_providers: Dict[str, Callable[[], Any]] = {}

    # -- recording (hot path) ---------------------------------------------
    def record(self, kind: str, **fields) -> None:
        ev = {"ts": time.perf_counter(), "kind": kind, **fields}
        with self._lock:
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped_events += 1
            self._ring.append(ev)

    # -- state providers ---------------------------------------------------
    def add_state_provider(self, name: str,
                           fn: Callable[[], Any]) -> None:
        """Register (or replace) a named live-state snapshot for dumps."""
        self._state_providers[name] = fn

    def state_providers(self) -> Dict[str, Callable[[], Any]]:
        return dict(self._state_providers)

    # -- export ------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped_events = 0

    def bundle(self, registry=None, reason: str = "on_demand"
               ) -> Dict[str, Any]:
        """The postmortem document. A provider that raises is captured as
        ``{"error": ...}`` — a dump taken because something is broken must
        not die on the broken component's own state."""
        state: Dict[str, Any] = {}
        for name, fn in self._state_providers.items():
            try:
                state[name] = fn()
            except Exception as e:        # noqa: BLE001 — postmortem path
                state[name] = {"error": f"{type(e).__name__}: {e}"}
        return {"schema": SCHEMA,
                "reason": reason,
                "wall_time": time.time(),
                "capacity": self.capacity,
                "dropped_events": self.dropped_events,
                "events": self.events(),
                "metrics": dict(registry.snapshot()) if registry is not None
                else {},
                "state": state}

    def dump(self, path, registry=None,
             reason: str = "on_demand") -> Path:
        """Write the bundle as JSON; returns the path written."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.bundle(registry, reason=reason),
                                   indent=1, default=str))
        return path


def validate_bundle(doc: Dict[str, Any]) -> List[str]:
    """Schema check for a dumped bundle; returns problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["bundle is not an object"]
    if doc.get("schema") != SCHEMA:
        problems.append(f"schema {doc.get('schema')!r} != {SCHEMA!r}")
    for key, typ in (("events", list), ("metrics", dict), ("state", dict),
                     ("dropped_events", int), ("reason", str)):
        if not isinstance(doc.get(key), typ):
            problems.append(f"missing/typed-wrong {key!r} "
                            f"(want {typ.__name__})")
    for i, ev in enumerate(doc.get("events") or []):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        if "kind" not in ev or "ts" not in ev:
            problems.append(f"event {i}: missing kind/ts")
    return problems


# ----------------------------------------------------------------------
# Process-wide default recorder (module-level API the components use)
# ----------------------------------------------------------------------
_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def set_recorder(rec: FlightRecorder) -> FlightRecorder:
    global _recorder
    old, _recorder = _recorder, rec
    return old


def record(kind: str, **fields) -> None:
    _recorder.record(kind, **fields)


def add_state_provider(name: str, fn: Callable[[], Any]) -> None:
    _recorder.add_state_provider(name, fn)


def dump(path, registry=None, reason: str = "on_demand") -> Path:
    return _recorder.dump(path, registry, reason=reason)
