"""Unified observability layer: metrics, tracing, ledger, lifecycle plane
(the port's own copy of ``repro.obs``: stdlib-only, with the same metric
names, label keys and ``as_dict`` keys, so registry snapshots of the two
packages compare series by series).

The paper's claims are measurement claims (Fig 1 switch/execute split,
Fig 9 prefetch overlap, Fig 12-13 switching/footprint curves); this package
is where the repro attributes every millisecond and byte:

  * ``obs.metrics``  — ``MetricsRegistry``: counters / gauges / streaming-
    quantile histograms, labeled (expert, socket group, tier), with a
    process default registry and ``scoped()`` test isolation;
  * ``obs.trace``    — ``span()`` context managers recording into per-thread
    ring buffers, exported as Chrome-trace / Perfetto JSON (overflow drops
    counted and stamped into the export);
  * ``obs.ledger``   — ``TransferLedger``: every DDR->host / host->HBM /
    writeback transfer byte-and-latency-attributed on one view, with
    derived bandwidth gauges and the overlap ratio first-class;
  * ``obs.stats``    — the registry-backed view machinery behind
    ``ServeStats`` / ``SwitchStats`` / ``NodeStats`` / ``PagedStats`` and
    the shared ``as_dict`` serializer;
  * ``obs.lifecycle`` — per-request phase ledger (queue_wait / route /
    admit_wait / prefill / decode) aggregated into
    ``serve.phase_seconds{phase=}`` histograms;
  * ``obs.slo``      — TTFT+TPOT SLO attainment, goodput (SLO-met tokens/s)
    and burn-rate windows per tenant/priority;
  * ``obs.watchdog`` — background invariant sampler (stuck requests, KV
    refcount leaks, HBM budget, queue age) feeding ``obs.anomaly{kind=}``;
  * ``obs.flightrec`` — black-box event ring whose ``dump()`` writes a JSON
    postmortem bundle (SIGUSR2 / watchdog / ``/debug/flight``);
  * ``obs.httpd``    — the ``--metrics-port`` Prometheus/JSON endpoint plus
    ``/readyz`` and the ``/debug/*`` state snapshots.

See ``docs/observability.md`` for the metric catalog, span taxonomy, phase
taxonomy, and the postmortem walkthrough.
"""
from repro_torch.obs import flightrec, trace
from repro_torch.obs.flightrec import FlightRecorder, validate_bundle
from repro_torch.obs.httpd import MetricsServer, serve_metrics
from repro_torch.obs.ledger import TransferLedger
from repro_torch.obs.lifecycle import LifecycleTracker, phase_record
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               get_registry, scoped, set_registry)
from repro_torch.obs.slo import SLOTracker, request_slo_met
from repro_torch.obs.stats import (StatsView, as_dict, counter_field, gauge_field,
                             stat_field)
from repro_torch.obs.watchdog import Watchdog, WatchdogError

# the default registry always carries the tracer's overflow count
trace.register_metrics(get_registry())

__all__ = [
    "trace", "flightrec",
    "FlightRecorder", "validate_bundle",
    "MetricsServer", "serve_metrics",
    "TransferLedger",
    "LifecycleTracker", "phase_record",
    "SLOTracker", "request_slo_met",
    "Watchdog", "WatchdogError",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "scoped", "set_registry",
    "StatsView", "as_dict", "counter_field", "gauge_field", "stat_field",
]
