"""The ``pretrain`` window's data spans, read from the program's own tracer.

The ``pretrain`` harness builds its ``ScanExecutor`` without a tracer, so the
scans, and ``TokenBatchPipeline``'s ``data.wait`` and ``data.batch`` spans on
the executor's tracer, go to the program's process-wide tracer
(``repro_torch.obs.trace.get_tracer``), which outlives the run.  Nothing
after the window takes a batch, so the window's steps waited in the last
``run.steps`` ``data.wait`` spans; the window began with the first of them
and lasted ``run.window_s``.  A program without these spans gives none.
"""

from __future__ import annotations

from typing import List, Tuple


def window_spans(run) -> Tuple[List, List]:
    """``(waits, batches)``: the ``data.wait`` spans of the window's steps
    and the ``data.batch`` spans begun in the window, or two empty lists."""
    if run.kind != "pretrain" or run.steps <= 0:
        return [], []
    from repro_torch.obs.trace import get_tracer

    spans = [sp for root in get_tracer().roots() for sp in root.walk()]
    waits = sorted((sp for sp in spans if sp.name == "data.wait"), key=lambda sp: sp.t0_ns)
    if len(waits) < run.steps:
        return [], []
    waits = waits[-run.steps:]
    t0 = waits[0].t0_ns
    t1 = t0 + int(run.window_s * 1e9)
    batches = [sp for sp in spans if sp.name == "data.batch" and t0 <= sp.t0_ns <= t1]
    return waits, batches
