"""SLO attainment and goodput accounting per tenant/priority.

The frontend accepts TTFT deadlines (``slo_ttft_s``) and — new here — TPOT
deadlines (``slo_tpot_s``, mean inter-token seconds after the first token).
This tracker turns finished requests into the serving numbers an operator
actually pages on:

  * **attainment** — fraction of finished requests that met every SLO they
    declared (a request with no SLO counts as met: vacuous truth keeps
    mixed traffic comparable);
  * **goodput** — *SLO-met* tokens per second (tokens from requests that
    missed a deadline are throughput, not goodput — the §VII serving
    claims are only meaningful in goodput terms);
  * **burn rate** — per-tenant miss rate over rolling windows divided by
    the error budget (``1 - target_attainment``), the SRE-style signal:
    burn rate 1.0 = exactly spending the budget, >1 = on track to blow it.

Registry series (all labeled ``{tenant=,priority=}`` so node deployments
compose with ``{group=}`` labels): ``slo.requests``, ``slo.requests_met``,
``slo.ttft_miss``, ``slo.tpot_miss``, ``slo.tokens_out``,
``slo.tokens_met``, plus ``slo.burn_rate{tenant=,window=}`` gauges.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry


def ttft_met(req: Any) -> Optional[bool]:
    """Did the request meet its TTFT deadline? ``None`` = no deadline."""
    slo = getattr(req, "slo_ttft_s", None)
    if slo is None or req.first_token_s is None:
        return None
    return (req.first_token_s - req.arrival_s) <= slo


def tpot_met(req: Any) -> Optional[bool]:
    """Did the request meet its TPOT (mean inter-token) deadline? ``None``
    = no deadline or single-token output (no inter-token gap exists)."""
    slo = getattr(req, "slo_tpot_s", None)
    if slo is None or req.done_s is None or req.first_token_s is None:
        return None
    n = len(req.output) if req.output is not None else 0
    if n <= 1:
        return None
    return (req.done_s - req.first_token_s) / (n - 1) <= slo


def request_slo_met(req: Any) -> bool:
    """True unless a *declared* deadline was missed."""
    return ttft_met(req) is not False and tpot_met(req) is not False


class SLOTracker:
    """Rolls finished requests into attainment/goodput/burn-rate series."""

    def __init__(self, registry: MetricsRegistry,
                 labels: Optional[Dict[str, Any]] = None, *,
                 target_attainment: float = 0.99,
                 windows: Tuple[float, ...] = (60.0, 300.0),
                 clock=time.perf_counter):
        if not 0.0 < target_attainment < 1.0:
            raise ValueError("target_attainment must be in (0, 1)")
        self._registry = registry
        self._labels = dict(labels or {})
        self.target_attainment = target_attainment
        self.windows = tuple(float(w) for w in windows)
        self._clock = clock
        self._t0 = clock()
        # mirrors of the registry counters, keyed (tenant, priority), so
        # attainment/goodput math never re-parses label strings
        self._requests: Dict[Tuple[str, int], int] = {}
        self._met: Dict[Tuple[str, int], int] = {}
        self._tokens: Dict[Tuple[str, int], int] = {}
        self._tokens_met: Dict[Tuple[str, int], int] = {}
        # per-tenant rolling (t, met) events for the burn-rate windows
        self._events: Dict[str, deque] = {}

    def _ctr(self, name: str, tenant: str, priority: int):
        return self._registry.counter(name, labels={
            **self._labels, "tenant": tenant, "priority": priority})

    # -- ingest ------------------------------------------------------------
    def observe(self, req: Any) -> bool:
        """Account one finished request; returns whether it met its SLOs."""
        tenant = getattr(req, "tenant", "default")
        prio = int(getattr(req, "priority", 0))
        key = (tenant, prio)
        n_tok = len(req.output) if getattr(req, "output", None) is not None \
            else 0
        t_ok, p_ok = ttft_met(req), tpot_met(req)
        met = t_ok is not False and p_ok is not False

        self._requests[key] = self._requests.get(key, 0) + 1
        self._tokens[key] = self._tokens.get(key, 0) + n_tok
        self._ctr("slo.requests", tenant, prio).inc()
        self._ctr("slo.tokens_out", tenant, prio).inc(n_tok)
        if t_ok is False:
            self._ctr("slo.ttft_miss", tenant, prio).inc()
        if p_ok is False:
            self._ctr("slo.tpot_miss", tenant, prio).inc()
        if met:
            self._met[key] = self._met.get(key, 0) + 1
            self._tokens_met[key] = self._tokens_met.get(key, 0) + n_tok
            self._ctr("slo.requests_met", tenant, prio).inc()
            self._ctr("slo.tokens_met", tenant, prio).inc(n_tok)

        now = self._clock()
        evs = self._events.setdefault(tenant, deque())
        evs.append((now, met))
        horizon = max(self.windows) if self.windows else 0.0
        while evs and evs[0][0] < now - horizon:
            evs.popleft()
        for w in self.windows:
            self._registry.gauge("slo.burn_rate", labels={
                **self._labels, "tenant": tenant, "window": int(w)}
            ).set(self.burn_rate(w, tenant, now=now))
        return met

    # -- derived views -----------------------------------------------------
    def _sum(self, d: Dict[Tuple[str, int], int],
             tenant: Optional[str]) -> int:
        return sum(v for (t, _), v in d.items()
                   if tenant is None or t == tenant)

    def attainment(self, tenant: Optional[str] = None) -> float:
        """SLO-met fraction of finished requests (1.0 before any finish)."""
        n = self._sum(self._requests, tenant)
        return self._sum(self._met, tenant) / n if n else 1.0

    def goodput(self, tenant: Optional[str] = None,
                wall_s: Optional[float] = None) -> float:
        """SLO-met tokens/s since construction (or over ``wall_s``)."""
        wall = wall_s if wall_s is not None else self._clock() - self._t0
        return self._sum(self._tokens_met, tenant) / wall if wall > 0 else 0.0

    def burn_rate(self, window_s: float, tenant: str,
                  now: Optional[float] = None) -> float:
        """Miss rate over the trailing window / error budget. 0.0 with no
        traffic in the window (nothing served = nothing missed)."""
        now = self._clock() if now is None else now
        evs = self._events.get(tenant, ())
        n = miss = 0
        for t, met in evs:
            if t >= now - window_s:
                n += 1
                miss += not met
        if n == 0:
            return 0.0
        return (miss / n) / (1.0 - self.target_attainment)

    def as_dict(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Summary for ``/debug`` endpoints and bench reporting."""
        return {
            "requests": self._sum(self._requests, tenant),
            "requests_met": self._sum(self._met, tenant),
            "tokens_out": self._sum(self._tokens, tenant),
            "tokens_met": self._sum(self._tokens_met, tenant),
            "attainment": self.attainment(tenant),
            "goodput_tok_s": self.goodput(tenant),
            "target_attainment": self.target_attainment,
        }

    def tenants(self):
        return sorted({t for t, _ in self._requests})
