"""Metrics registry: counters, gauges and streaming-quantile histograms.

One ``MetricsRegistry`` is the single place every subsystem (serving engine,
switching cache, paged KV pool, node scheduler, tier ledger) publishes its
numbers. Metrics are identified by ``(name, labels)`` — labels are the
low-cardinality dimensions the paper's analysis needs (expert, socket group,
memory tier, transfer cause) — and the registry can render itself as a flat
JSON-able snapshot or Prometheus text exposition.

Histograms estimate p50/p95/p99 *without storing samples* via the P²
algorithm (Jain & Chlamtac 1985): five markers per target quantile, O(1)
memory and O(1) per observation, accurate to a few percent on the smooth
latency distributions serving produces (accuracy is asserted against exact
quantiles in ``tests/test_obs.py``).

A process-wide default registry (``get_registry``) backs components that are
not handed an explicit one; ``scoped()`` swaps it out for a fresh registry
inside a ``with`` block so tests and benchmark sweeps never see each other's
series.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

LabelsT = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Dict[str, Any]]) -> LabelsT:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _flat_name(name: str, labels: LabelsT) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically-increasing sum (int or float increments)."""

    kind = "counter"

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: LabelsT = ()):
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, v=1):
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        with self._lock:
            self._value += v

    def set(self, v):
        """Stats-view escape hatch (``stats.hits += 1`` is get-then-set);
        plain counter users should ``inc``."""
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value


class Gauge:
    """A value that can go up and down (bytes in use, occupancy, ratios)."""

    kind = "gauge"

    __slots__ = ("name", "labels", "_value", "_fn", "_lock")

    def __init__(self, name: str, labels: LabelsT = (),
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, v=1):
        with self._lock:
            self._value += v

    def dec(self, v=1):
        self.inc(-v)

    @property
    def value(self):
        if self._fn is not None:
            return self._fn()
        return self._value


class _P2Quantile:
    """P² single-quantile estimator (Jain & Chlamtac, CACM 1985)."""

    __slots__ = ("p", "_init", "q", "n", "np_", "dn")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0,1), got {p}")
        self.p = p
        self._init: List[float] = []     # first five observations
        self.q: List[float] = []         # marker heights
        self.n: List[float] = []         # marker positions (1-indexed)
        self.np_: List[float] = []       # desired positions
        self.dn = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def observe(self, x: float):
        if len(self._init) < 5:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self.q = list(self._init)
                self.n = [1.0, 2.0, 3.0, 4.0, 5.0]
                p = self.p
                self.np_ = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p,
                            3.0 + 2.0 * p, 5.0]
            return
        q, n, np_ = self.q, self.n, self.np_
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            np_[i] += self.dn[i]
        for i in (1, 2, 3):
            d = np_[i] - n[i]
            if ((d >= 1.0 and n[i + 1] - n[i] > 1.0)
                    or (d <= -1.0 and n[i - 1] - n[i] < -1.0)):
                d = 1.0 if d > 0 else -1.0
                qp = self._parabolic(i, d)
                if not q[i - 1] < qp < q[i + 1]:
                    qp = self._linear(i, d)
                q[i] = qp
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self.q, self.n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        q, n = self.q, self.n
        j = i + int(d)
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    @property
    def value(self) -> float:
        k = len(self._init)
        if k == 0:
            return 0.0
        if k < 5 or not self.q:
            s = sorted(self._init)
            idx = min(int(self.p * k), k - 1)
            return s[idx]
        return self.q[2]


class Histogram:
    """Streaming-quantile histogram: count/sum/min/max plus one P²
    estimator per requested quantile. No samples are retained."""

    kind = "histogram"

    def __init__(self, name: str, labels: LabelsT = (),
                 quantiles: Iterable[float] = (0.5, 0.95, 0.99)):
        self.name = name
        self.labels = labels
        self.quantiles = tuple(quantiles)
        self._est = {p: _P2Quantile(p) for p in self.quantiles}
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, x: float):
        x = float(x)
        with self._lock:
            self.count += 1
            self.sum += x
            self.min = min(self.min, x)
            self.max = max(self.max, x)
            for est in self._est.values():
                est.observe(x)

    def quantile(self, p: float) -> float:
        return self._est[p].value

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        out = {"count": self.count, "sum": self.sum, "mean": self.mean}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
        for p in self.quantiles:
            out[f"p{_plabel(p)}"] = self.quantile(p)
        return out


def _plabel(p: float) -> str:
    s = f"{p * 100:g}"
    return s.replace(".", "_")


class MetricsRegistry:
    """Get-or-create metric store keyed by ``(name, sorted labels)``."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelsT], Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, labels, **kwargs):
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, labels: Optional[Dict] = None) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Dict] = None) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def derived_gauge(self, name: str, fn: Callable[[], float],
                      labels: Optional[Dict] = None) -> Gauge:
        """A gauge whose value is computed at read time (bandwidths,
        ratios over other metrics)."""
        g = self._get_or_create(Gauge, name, labels, fn=fn)
        g._fn = fn                     # rebinding refreshes the closure
        return g

    def histogram(self, name: str, labels: Optional[Dict] = None,
                  quantiles: Iterable[float] = (0.5, 0.95, 0.99)) -> Histogram:
        return self._get_or_create(Histogram, name, labels,
                                   quantiles=quantiles)

    def metrics(self) -> List[Any]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, Any]:
        """Flat ``{flat_name: value}`` dict. Histograms expand into
        ``name:count / name:sum / name:p50 ...`` entries."""
        out: Dict[str, Any] = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[_flat_name(f"{m.name}:{k}", m.labels)] = v
            else:
                out[_flat_name(m.name, m.labels)] = m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (quantiles as ``summary`` series)."""
        def sanitize(name):
            return "".join(c if c.isalnum() or c == "_" else "_"
                           for c in name)

        def fmt_labels(labels, extra=()):
            items = list(labels) + list(extra)
            if not items:
                return ""
            return "{" + ",".join(f'{sanitize(k)}="{v}"'
                                  for k, v in items) + "}"

        lines = []
        for m in sorted(self.metrics(), key=lambda m: (m.name, m.labels)):
            name = sanitize(m.name)
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {name} summary")
                for p in m.quantiles:
                    lines.append(
                        f"{name}{fmt_labels(m.labels, [('quantile', p)])} "
                        f"{m.quantile(p)}")
                lines.append(f"{name}_sum{fmt_labels(m.labels)} {m.sum}")
                lines.append(f"{name}_count{fmt_labels(m.labels)} {m.count}")
            else:
                lines.append(f"# TYPE {name} {m.kind}")
                lines.append(f"{name}{fmt_labels(m.labels)} {m.value}")
        return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# Process-wide default registry
# ----------------------------------------------------------------------
_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what ``--metrics-port`` serves)."""
    return _default


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _default
    with _default_lock:
        old, _default = _default, reg
    return old


@contextmanager
def scoped(reg: Optional[MetricsRegistry] = None):
    """Swap the default registry for ``reg`` (or a fresh one) inside the
    block — test/benchmark isolation without threading a registry through
    every constructor."""
    reg = reg if reg is not None else MetricsRegistry()
    old = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(old)
