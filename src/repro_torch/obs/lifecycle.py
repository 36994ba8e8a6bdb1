"""Per-request phase ledger: where every request's wall-clock went.

CoServe-style serving analysis decomposes each request's latency into the
queue/switch/compute phases that scheduling actually controls. The engine
stamps five monotonic timestamps on every ``Request``::

    arrival_s   offered arrival (frontend heap entry / trace replay offset)
    submit_s    entered the engine (top of ``ServingEngine.submit``)
    admit_s     admission started its prefill / handoff adoption
    first_token_s   prefill done, first token emitted
    done_s      last token emitted

and the ledger derives the phase decomposition::

    queue_wait = submit_s - arrival_s        (frontend heap / replay delay)
    route      = route_s                     (router forward at submit)
    admit_wait = admit_s - submit_s - route_s (engine queue: expert rotation,
                                              KV backpressure, slot waits)
    prefill    = first_token_s - admit_s
    decode     = done_s - first_token_s

The five phases telescope: their sum is EXACTLY ``done_s - arrival_s``
(tests assert it to float tolerance). Two attribution fields ride along
without entering the sum — ``switch_stall_s`` (expert activation time the
request's own admission paid) and ``preemptions`` (times the frontend
pulled it back out of the engine queue) — because they explain *why*
``admit_wait``/``prefill`` grew, they are not extra wall-clock.

Aggregation: each phase lands in a ``serve.phase_seconds{phase=}`` P²
histogram (per engine, so node deployments get per-``{group=}`` series),
and the last ``keep`` per-request records stay readable for ``/debug``
and the flight-recorder bundle.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry

PHASES = ("queue_wait", "route", "admit_wait", "prefill", "decode")


def phase_record(req: Any) -> Dict[str, Any]:
    """Pure phase decomposition of one finished request (no registry).
    Requests missing a stamp (direct engine submits predate the frontend,
    a handoff carries its own prefill stamp) degrade to zero-width phases
    rather than failing — the telescoped sum stays exact."""
    arrival = req.arrival_s
    submit = getattr(req, "submit_s", None) or arrival
    route = float(getattr(req, "route_s", 0.0) or 0.0)
    admit = getattr(req, "admit_s", None) or submit
    first = req.first_token_s if req.first_token_s is not None else admit
    done = req.done_s if req.done_s is not None else first
    phases = {
        "queue_wait": submit - arrival,
        "route": route,
        "admit_wait": admit - submit - route,
        "prefill": first - admit,
        "decode": done - first,
    }
    out = len(req.output) if getattr(req, "output", None) is not None else 0
    tpot: Optional[float] = ((done - first) / (out - 1)) if out > 1 else None
    return {
        "rid": req.rid,
        "tenant": getattr(req, "tenant", "default"),
        "priority": int(getattr(req, "priority", 0)),
        "expert": req.expert,
        "tokens_out": out,
        "prefix_hit_tokens": int(getattr(req, "prefix_hit_tokens", 0)),
        "wall_s": done - arrival,
        "ttft_s": first - arrival,
        "tpot_s": tpot,
        "phases": phases,
        # attribution (not part of the telescoped sum):
        "switch_stall_s": float(getattr(req, "switch_stall_s", 0.0) or 0.0),
        "preemptions": int(getattr(req, "preemptions", 0)),
    }


class LifecycleTracker:
    """Aggregates finished requests' phase decompositions into
    ``serve.phase_seconds{phase=}`` histograms + a bounded record ring."""

    def __init__(self, registry: MetricsRegistry,
                 labels: Optional[Dict[str, Any]] = None, keep: int = 512):
        labels = dict(labels or {})
        self._hists = {
            ph: registry.histogram("serve.phase_seconds",
                                   labels={**labels, "phase": ph})
            for ph in PHASES}
        self._stall_hist = registry.histogram("serve.switch_stall_s",
                                              labels=labels)
        self._records: deque = deque(maxlen=keep)

    def complete(self, req: Any) -> Dict[str, Any]:
        """Record one finished request; returns its phase record."""
        rec = phase_record(req)
        for ph, h in self._hists.items():
            h.observe(max(0.0, rec["phases"][ph]))
        if rec["switch_stall_s"]:
            self._stall_hist.observe(rec["switch_stall_s"])
        self._records.append(rec)
        return rec

    def records(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Most recent ``n`` (default all retained) per-request records,
        oldest first."""
        recs = list(self._records)
        return recs if n is None else recs[-n:]
