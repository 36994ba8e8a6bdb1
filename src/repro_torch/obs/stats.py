"""Registry-backed stats views.

The repo's four serving stats objects (``ServeStats``, ``SwitchStats``,
``NodeStats``, ``PagedStats``) used to be ad-hoc dataclasses of bare
counters. They are now *views* over a ``MetricsRegistry``: every field is a
descriptor whose storage is a registry counter/gauge named
``<prefix>.<field>`` under the view's labels, so the same numbers the
engine/cache/node mutate in place are simultaneously visible to the
Prometheus endpoint, registry snapshots and the benchmark JSON — no copying,
no second bookkeeping path.

The classes keep their dataclass ergonomics: ``stats.hits += 1``,
keyword construction (``NodeStats(requests=3, ...)``), a dataclass-style
``repr`` and the public ``.as_dict()`` shape every benchmark gate depends
on. A view constructed bare (``SwitchStats()``) owns a private registry —
two engines never alias each other's counters by accident; passing
``registry=``/``labels=`` publishes into a shared registry (what
``launch/serve.py --metrics-port`` and ``RDUNode`` do, labelling per
socket group).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.obs.metrics import Counter, Gauge, MetricsRegistry


class stat_field:
    """Descriptor: one numeric stats field stored in the view's registry."""

    __slots__ = ("kind", "default", "name")

    def __init__(self, kind: str = "counter", default=0):
        if kind not in ("counter", "gauge"):
            raise ValueError(f"unknown stat kind {kind!r}")
        self.kind = kind
        self.default = default

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        v = obj._metric(self.name).value
        # preserve int-ness for count-like fields initialised with an int
        if isinstance(self.default, int) and isinstance(v, float):
            return int(v) if v.is_integer() else v
        return v

    def __set__(self, obj, v):
        obj._metric(self.name).set(v)


def counter_field(default=0):
    return stat_field("counter", default)


def gauge_field(default=0):
    return stat_field("gauge", default)


class StatsView:
    """Base class for registry-backed stats. Subclasses declare fields as
    ``counter_field()`` / ``gauge_field()`` class attributes, set ``PREFIX``
    (the registry metric-name prefix) and optionally ``DERIVED`` (property
    names included in ``as_dict``)."""

    PREFIX = "stats"
    DERIVED: Tuple[str, ...] = ()

    _FIELDS: Tuple[str, ...] = ()
    _KINDS: Dict[str, stat_field] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        fields = dict(getattr(cls, "_KINDS", {}))
        for name, attr in vars(cls).items():
            if isinstance(attr, stat_field):
                fields[name] = attr
        cls._KINDS = fields
        cls._FIELDS = tuple(fields)

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 labels: Optional[Dict[str, Any]] = None, **values):
        self._registry = registry if registry is not None else MetricsRegistry()
        self._labels = dict(labels or {})
        self._metrics: Dict[str, Any] = {}
        for f in self._FIELDS:          # eager: snapshots show zeros, not gaps
            self._metric(f)
        unknown = set(values) - set(self._FIELDS)
        if unknown:
            raise TypeError(f"{type(self).__name__}: unknown fields {unknown}")
        for k, v in values.items():
            setattr(self, k, v)

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    @property
    def labels(self) -> Dict[str, Any]:
        return dict(self._labels)

    def _metric(self, field: str):
        m = self._metrics.get(field)
        if m is None:
            spec = self._KINDS[field]
            name = f"{self.PREFIX}.{field}"
            if spec.kind == "counter":
                m = self._registry.counter(name, self._labels)
            else:
                m = self._registry.gauge(name, self._labels)
            if m.value == 0 and spec.default != 0:
                m.set(spec.default)
            self._metrics[field] = m
        return m

    def reset(self):
        """Zero every field in place (same registry, same series)."""
        for f in self._FIELDS:
            self._metric(f).set(self._KINDS[f].default)
        return self

    def as_dict(self) -> Dict[str, Any]:
        return as_dict(self)

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in self._FIELDS)
        return f"{type(self).__name__}({inner})"

    def __eq__(self, other):
        if not isinstance(other, type(self)):
            return NotImplemented
        return all(getattr(self, f) == getattr(other, f)
                   for f in self._FIELDS)


def as_dict(obj, derived: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """THE shared stats serializer (previously each stats class hand-rolled
    its own). Works on ``StatsView`` subclasses (fields + their ``DERIVED``
    properties) and plain dataclasses (``dataclasses.asdict`` + ``derived``
    extras)."""
    if isinstance(obj, StatsView):
        out = {f: getattr(obj, f) for f in obj._FIELDS}
        names = tuple(obj.DERIVED) + tuple(d for d in derived
                                           if d not in obj.DERIVED)
    elif dataclasses.is_dataclass(obj):
        out = dataclasses.asdict(obj)
        names = derived
    else:
        raise TypeError(f"as_dict: unsupported type {type(obj).__name__}")
    for d in names:
        out[d] = getattr(obj, d)
    return out
