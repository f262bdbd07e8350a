"""Labelled counter/gauge/histogram registry with Prometheus exposition.

The registry is the *single source of truth* for the repo's operational
counters: store/cache objects declare their legacy integer attributes as
:class:`MetricAttr` descriptors, so existing ``self.lookups += 1`` call
sites and ``stats()`` readers keep working bitwise-identically while the
values live in a shared :class:`Metrics` registry that can be scraped as
Prometheus text (``ServiceReport.metrics_text()``) or snapshotted for
exact per-run reconciliation tests.

Zero dependencies; every instrument shares one registry lock (mutation
rates here are per-plan/per-run, not per-row).
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricAttr", "Metrics"]

LabelKey = Tuple[Tuple[str, str], ...]

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 60.0)


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    """Monotonic-by-convention numeric cell.  ``set()`` exists so that
    :class:`MetricAttr`-backed attributes support plain assignment."""

    __slots__ = ("name", "label_key", "_v", "_lock")

    def __init__(self, name: str, label_key: LabelKey, lock: threading.Lock):
        self.name = name
        self.label_key = label_key
        self._v = 0
        self._lock = lock

    def inc(self, n=1) -> None:
        with self._lock:
            self._v += n

    def set(self, v) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self):
        return self._v


class Gauge(Counter):
    """A cell that may go up and down."""

    __slots__ = ()

    def dec(self, n=1) -> None:
        self.inc(-n)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    __slots__ = ("name", "label_key", "buckets", "counts", "sum", "count", "_lock")

    def __init__(
        self,
        name: str,
        label_key: LabelKey,
        lock: threading.Lock,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.label_key = label_key
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def observe(self, v: float) -> None:
        with self._lock:
            self.counts[bisect_right(self.buckets, v)] += 1
            self.sum += v
            self.count += 1

    @property
    def value(self) -> float:
        return self.sum


class Metrics:
    """Registry of labelled instruments, keyed by (name, sorted labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}

    # -- instrument access ---------------------------------------------------
    def counter(self, name: str, **labels: Any) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = Counter(name, key[1], self._lock)
                self._counters[key] = c
            return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = Gauge(name, key[1], self._lock)
                self._gauges[key] = g
            return g

    def histogram(
        self, name: str, buckets: Optional[Sequence[float]] = None, **labels: Any
    ) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = Histogram(name, key[1], self._lock, buckets or DEFAULT_BUCKETS)
            self._histograms[key] = h
            return h

    # -- reading -------------------------------------------------------------
    def value(self, name: str, **labels: Any):
        """Current value of a counter/gauge (0 when never touched)."""
        key = (name, _label_key(labels))
        inst = self._counters.get(key) or self._gauges.get(key)
        return inst.value if inst is not None else 0

    def total(self, name: str):
        """Sum of a counter/gauge across all label sets."""
        with self._lock:
            insts = [c for (n, _), c in self._counters.items() if n == name]
            insts += [g for (n, _), g in self._gauges.items() if n == name]
        return sum(i.value for i in insts)

    def snapshot(self) -> Dict[str, float]:
        """Flat ``name{labels} -> value`` map: counters, gauges, and
        histogram ``_sum``/``_count`` series.  Subtract two snapshots for
        exact per-interval deltas."""
        out: Dict[str, float] = {}
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        for c in counters + gauges:
            out[c.name + _render_labels(c.label_key)] = c.value
        for h in hists:
            lbl = _render_labels(h.label_key)
            out[h.name + "_sum" + lbl] = h.sum
            out[h.name + "_count" + lbl] = h.count
        return out

    # -- exposition ----------------------------------------------------------
    def to_text(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        with self._lock:
            counters = sorted(self._counters.values(), key=lambda c: (c.name, c.label_key))
            gauges = sorted(self._gauges.values(), key=lambda g: (g.name, g.label_key))
            hists = sorted(self._histograms.values(), key=lambda h: (h.name, h.label_key))
        seen_type: set = set()
        for c in counters:
            if c.name not in seen_type:
                seen_type.add(c.name)
                lines.append(f"# TYPE {c.name} counter")
            lines.append(f"{c.name}{_render_labels(c.label_key)} {c.value}")
        for g in gauges:
            if g.name not in seen_type:
                seen_type.add(g.name)
                lines.append(f"# TYPE {g.name} gauge")
            lines.append(f"{g.name}{_render_labels(g.label_key)} {g.value}")
        for h in hists:
            if h.name not in seen_type:
                seen_type.add(h.name)
                lines.append(f"# TYPE {h.name} histogram")
            cum = 0
            for b, n in zip(h.buckets, h.counts):
                cum += n
                lines.append(f'{h.name}_bucket{_le_labels(h.label_key, b)} {cum}')
            cum += h.counts[-1]
            lines.append(f'{h.name}_bucket{_le_labels(h.label_key, "+Inf")} {cum}')
            lbl = _render_labels(h.label_key)
            lines.append(f"{h.name}_sum{lbl} {h.sum}")
            lines.append(f"{h.name}_count{lbl} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _le_labels(key: LabelKey, le) -> str:
    merged = key + (("le", str(le)),)
    return _render_labels(tuple(sorted(merged)))


class MetricAttr:
    """A class attribute backed by a registry counter.

    Declared on classes whose instances expose ``metrics`` (a
    :class:`Metrics` registry) and optionally ``metrics_labels`` (a dict
    merged into the instrument's labels)::

        class Store:
            lookups = MetricAttr("cache_lookups")

    Reads return the counter's current value; ``+=`` and plain assignment
    write through — so legacy ``self.lookups += 1`` call sites and
    ``stats()`` readers are unchanged while the value lives in the
    registry.  The bound Counter is cached per-instance (label sets are
    fixed at first touch)."""

    __slots__ = ("metric_name", "labels", "_slot")

    def __init__(self, metric_name: str, **labels: Any):
        self.metric_name = metric_name
        self.labels = labels
        self._slot = "_metric_" + metric_name

    def __set_name__(self, owner, name) -> None:
        self._slot = "_metric_attr_" + name

    def _counter(self, obj) -> Counter:
        c = obj.__dict__.get(self._slot)
        if c is None:
            merged = dict(getattr(obj, "metrics_labels", None) or {})
            merged.update(self.labels)
            c = obj.metrics.counter(self.metric_name, **merged)
            obj.__dict__[self._slot] = c
        return c

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return self._counter(obj).value

    def __set__(self, obj, value) -> None:
        self._counter(obj).set(value)
