"""Runtime invariant watchdog: a background sampler over live engines.

A wedged serving process rarely crashes — it sits there with a stuck slot,
a leaked KV block, or a queue nobody drains, while the metrics endpoint
keeps answering. The watchdog samples engine state on an interval and
checks the invariants the rest of the system assumes:

  * **stuck_request** — an occupied slot whose request has emitted no token
    for ``stall_s`` (decode stopped making progress for THAT request);
  * **kv_invariant** — the ``PagedKVCache`` refcount books no longer
    balance (``pool.check_invariants()``: free list + refcounted blocks
    must partition the pool, refcount sum must cover the live tables — a
    leaked or double-freed block shows up here);
  * **hbm_budget** — the engine reports weights+KV outside its HBM tier
    budget (``hbm_in_budget()``);
  * **queue_stall** — a queued request older than ``queue_age_s`` (stalled
    admission: KV backpressure wedge, starvation logic gone wrong).

Every anomaly increments ``obs.anomaly{kind=}``, lands an instant trace
event and a flight-recorder event, and (``dump_path=``) triggers a full
postmortem bundle. ``strict=True`` raises ``WatchdogError`` from
``check_now()`` — the fault-injection tests run in that mode; production
samplers stay non-strict and page off the counter.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs import flightrec, trace
from repro_torch.obs.metrics import MetricsRegistry


class WatchdogError(RuntimeError):
    """Strict-mode invariant violation; ``.anomalies`` holds the findings."""

    def __init__(self, anomalies: List[Dict[str, Any]]):
        self.anomalies = anomalies
        super().__init__(
            "; ".join(a.get("message", a["kind"]) for a in anomalies))


class Watchdog:
    """Samples one or more engines for invariant violations."""

    def __init__(self, engines, *,
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 1.0,
                 stall_s: float = 30.0,
                 queue_age_s: float = 60.0,
                 strict: bool = False,
                 recorder: Optional[flightrec.FlightRecorder] = None,
                 dump_path=None,
                 clock=time.perf_counter):
        if not isinstance(engines, Sequence):
            engines = [engines]
        self.engines = list(engines)
        self._registry = registry if registry is not None else (
            self.engines[0]._registry if self.engines
            else MetricsRegistry())
        self.interval_s = interval_s
        self.stall_s = stall_s
        self.queue_age_s = queue_age_s
        self.strict = strict
        self._recorder = recorder
        self._dump_path = dump_path
        self._clock = clock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.checks_run = 0

    # -- the checks --------------------------------------------------------
    def _engine_anomalies(self, eng, now: float) -> List[Dict[str, Any]]:
        found: List[Dict[str, Any]] = []
        labels = dict(getattr(eng, "_obs_labels", {}) or {})

        for idx, slot in enumerate(getattr(eng, "slots", ())):
            if slot is None:
                continue
            req = slot.req
            last = (getattr(req, "last_token_s", None)
                    or req.first_token_s or req.arrival_s)
            stalled = now - last
            if stalled > self.stall_s:
                found.append({
                    "kind": "stuck_request", "slot": idx, "rid": req.rid,
                    "expert": slot.expert, "stalled_s": stalled, **labels,
                    "message": f"slot {idx} rid {req.rid}: no token for "
                               f"{stalled:.1f}s"})

        pool = getattr(eng, "pool", None)
        if pool is not None:
            violations = pool.check_invariants()
            if violations:
                found.append({
                    "kind": "kv_invariant", "violations": violations,
                    **labels,
                    "message": "kv pool invariant: "
                               + "; ".join(violations)})

        in_budget = getattr(eng, "hbm_in_budget", None)
        if in_budget is not None and not in_budget():
            found.append({"kind": "hbm_budget", **labels,
                          "message": "HBM tier over budget"})

        for req in getattr(eng, "queue", ()):
            age = now - (getattr(req, "submit_s", None) or req.arrival_s)
            if age > self.queue_age_s:
                found.append({
                    "kind": "queue_stall", "rid": req.rid,
                    "expert": req.expert, "age_s": age, **labels,
                    "message": f"rid {req.rid} queued {age:.1f}s "
                               f"without admission"})
        return found

    def check_now(self) -> List[Dict[str, Any]]:
        """One sampling pass over every engine. Returns the anomalies
        (empty on a clean system); raises in strict mode instead."""
        self.checks_run += 1
        now = self._clock()
        anomalies: List[Dict[str, Any]] = []
        for eng in self.engines:
            anomalies.extend(self._engine_anomalies(eng, now))
        rec = self._recorder if self._recorder is not None \
            else flightrec.get_recorder()
        for a in anomalies:
            self._registry.counter(
                "obs.anomaly", labels={"kind": a["kind"]}).inc()
            trace.instant("anomaly", cat="watchdog", **{
                k: v for k, v in a.items() if k != "violations"})
            # the event's own "kind" is the ring-event class; the anomaly
            # class rides along as anomaly_kind
            rec.record("anomaly", anomaly_kind=a["kind"], **{
                k: v for k, v in a.items() if k != "kind"})
        if anomalies and self._dump_path is not None:
            rec.dump(self._dump_path, self._registry,
                     reason="watchdog_anomaly")
        if anomalies and self.strict:
            raise WatchdogError(anomalies)
        return anomalies

    # -- background sampler ------------------------------------------------
    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.check_now()
                except WatchdogError:
                    pass       # strict raise is for check_now() callers;
                               # the sampler already counted + dumped

        self._thread = threading.Thread(target=loop, name="obs-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None
