"""repro_torch.obs — structured tracing, metrics, and cache-decision explanation.

Three zero-dependency layers threaded through the planner/executor/service
hot path:

- :mod:`repro_torch.obs.trace` — a thread-safe span tracer with per-run trace
  trees, exportable as Chrome-trace/Perfetto JSON (``python -m repro_torch.trace``).
- :mod:`repro_torch.obs.metrics` — a labelled counter/gauge/histogram registry
  that is the single source of truth behind ``ScanReport`` / ``RunResult``
  / ``SharedStore.stats()`` / ``ServiceReport``, with Prometheus-style
  text exposition.
- :mod:`repro_torch.obs.explain` — structured decision events for every window
  the planner serves or recomputes, with the *cause* (code-edit, append,
  overwrite/pin-stale, snapshot-travel, scope-narrowed, …), surfaced as
  ``RunResult.explain()`` and ``python -m repro_torch.explain``.
"""

from repro_torch.obs.trace import NULL_TRACER, Span, Tracer, get_tracer, set_tracer
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricAttr, Metrics
from repro_torch.obs.explain import Decision, Explainer, RunExplanation

__all__ = [
    "Counter",
    "Decision",
    "Explainer",
    "Gauge",
    "Histogram",
    "MetricAttr",
    "Metrics",
    "NULL_TRACER",
    "RunExplanation",
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
]
