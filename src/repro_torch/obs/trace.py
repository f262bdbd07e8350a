"""Zero-dependency span tracer with per-thread trace trees.

A :class:`Tracer` hands out :class:`Span` context managers::

    with tracer.span("scan", table="events") as sp:
        ...
        sp.attrs["rows"] = 128

Spans opened on the same thread nest (children attach to the innermost
open span); completed roots collect in a bounded deque.  Timestamps are
``time.perf_counter_ns()`` — monotonic and comparable across threads in
one process, which lets a worker thread record a queue-wait interval that
started on the submitter's clock (:meth:`Tracer.add_span`).

``Tracer(enabled=False)`` compiles to no-ops: ``span()`` returns a shared
null context manager and nothing is recorded.

Export: :meth:`Tracer.save` writes the trees as JSON; ``chrome_trace``
converts them to the Chrome ``traceEvents`` format Perfetto/``chrome://
tracing`` load directly (see ``python -m repro_torch.trace``).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "NULL_TRACER",
    "Span",
    "Tracer",
    "chrome_trace",
    "get_tracer",
    "load_trace",
    "set_tracer",
]


class Span:
    """One timed interval.  Mutate ``attrs`` freely while the span is open."""

    __slots__ = (
        "name", "attrs", "t0_ns", "t1_ns", "tid", "children", "_tracer", "_stk"
    )

    def __init__(self, name: str, attrs: Dict[str, Any], tracer: "Tracer"):
        self.name = name
        self.attrs = attrs
        self.t0_ns = 0
        self.t1_ns = 0
        self.tid = 0
        self.children: List["Span"] = []
        self._tracer = tracer
        self._stk: Optional[List["Span"]] = None

    @property
    def duration_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    # enter/exit inline the tracer's push/pop and cache the thread stack:
    # spans sit on the plan/serve hot path, so every indirection counts
    def __enter__(self) -> "Span":
        self.tid = threading.get_ident()
        tls = self._tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        stack.append(self)
        self._stk = stack
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.t1_ns = time.perf_counter_ns()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        stack = self._stk if self._stk is not None else self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # unbalanced exit; drop to keep the tree consistent
            try:
                stack.remove(self)
            except ValueError:
                pass
        if stack:
            stack[-1].children.append(self)
        else:
            tracer = self._tracer
            with tracer._lock:
                tracer._roots.append(self)

    def walk(self) -> Iterable["Span"]:
        """This span and every descendant, pre-order."""
        yield self
        for c in self.children:
            yield from c.walk()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "t0_ns": self.t0_ns,
            "t1_ns": self.t1_ns,
            "tid": self.tid,
            "attrs": self.attrs,
            "children": [c.to_dict() for c in self.children],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        sp = cls(d["name"], dict(d.get("attrs") or {}), NULL_TRACER)
        sp.t0_ns = int(d.get("t0_ns", 0))
        sp.t1_ns = int(d.get("t1_ns", 0))
        sp.tid = int(d.get("tid", 0))
        sp.children = [cls.from_dict(c) for c in d.get("children", ())]
        return sp

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, children={len(self.children)})"


class _NullSpan:
    """Shared do-nothing span for disabled tracers.  ``attrs`` is a scratch
    dict callers may write to; it is never read."""

    __slots__ = ("attrs",)

    def __init__(self):
        self.attrs: Dict[str, Any] = {}

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


class Tracer:
    """Thread-safe span collector.

    ``max_roots`` bounds memory for long-lived services: only the most
    recent completed root spans are retained (children ride along with
    their root and do not count separately).
    """

    def __init__(self, enabled: bool = True, max_roots: int = 16384):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._roots: deque = deque(maxlen=max_roots)
        self._tls = threading.local()
        self._null = _NullSpan()

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Context manager for a timed span nested under the innermost open
        span on this thread."""
        if not self.enabled:
            return self._null
        return Span(name, attrs, self)

    def add_span(self, name: str, t0_ns: int, t1_ns: int, **attrs: Any) -> None:
        """Record an already-measured interval (e.g. a queue wait whose start
        was stamped on another thread).  Attaches under the innermost open
        span on the calling thread, else becomes a root."""
        if not self.enabled:
            return
        sp = Span(name, attrs, self)
        sp.t0_ns, sp.t1_ns = int(t0_ns), int(t1_ns)
        sp.tid = threading.get_ident()
        stack = self._stack()
        if stack:
            stack[-1].children.append(sp)
        else:
            with self._lock:
                self._roots.append(sp)

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    # -- inspection ----------------------------------------------------------
    def roots(self) -> List[Span]:
        with self._lock:
            return list(self._roots)

    def find(self, name: str) -> List[Span]:
        """Every completed span (any depth) with the given name."""
        return [sp for root in self.roots() for sp in root.walk() if sp.name == name]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name {count, total_s} over all completed spans."""
        out: Dict[str, Dict[str, float]] = {}
        for root in self.roots():
            for sp in root.walk():
                agg = out.setdefault(sp.name, {"count": 0, "total_s": 0.0})
                agg["count"] += 1
                agg["total_s"] += sp.duration_s
        return out

    def clear(self) -> None:
        with self._lock:
            self._roots.clear()

    # -- export --------------------------------------------------------------
    def to_dicts(self) -> List[Dict[str, Any]]:
        return [r.to_dict() for r in self.roots()]

    def save(self, path: str) -> None:
        """Write the completed trace trees as JSON (load with
        :func:`load_trace`; convert with ``python -m repro_torch.trace``)."""
        payload = {"format": "repro-trace", "version": 1, "spans": self.to_dicts()}
        with open(path, "w") as f:
            # attrs may hold arbitrary objects; persist them like the chrome
            # export does rather than refusing to save the whole trace
            json.dump(payload, f, default=repr)

    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(self.roots())


def load_trace(path: str) -> List[Span]:
    """Load span trees saved by :meth:`Tracer.save`."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("format") != "repro-trace":
        raise ValueError(f"{path} is not a repro trace file")
    return [Span.from_dict(d) for d in payload.get("spans", ())]


def chrome_trace(roots: Iterable[Span]) -> Dict[str, Any]:
    """Convert span trees to Chrome-trace JSON (``ph: "X"`` complete events,
    microsecond timestamps) — loadable by Perfetto / chrome://tracing."""
    events: List[Dict[str, Any]] = []
    for root in roots:
        for sp in root.walk():
            events.append(
                {
                    "name": sp.name,
                    "ph": "X",
                    "ts": sp.t0_ns / 1e3,
                    "dur": max(0.0, (sp.t1_ns - sp.t0_ns) / 1e3),
                    "pid": 1,
                    "tid": sp.tid,
                    "args": {k: _jsonable(v) for k, v in sp.attrs.items()},
                }
            )
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


NULL_TRACER = Tracer(enabled=False)

_default_tracer = Tracer()
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-wide default tracer (enabled, bounded)."""
    return _default_tracer


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Swap the process-wide default tracer; returns the previous one."""
    global _default_tracer
    with _default_lock:
        prev = _default_tracer
        _default_tracer = tracer if tracer is not None else Tracer()
    return prev
