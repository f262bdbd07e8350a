"""Reading the card's work from ``torch.profiler`` over a traced window.

``DeviceTrace`` profiles the host and the card between ``start`` and
``stop``.  ``summary`` merges the device's operations (kernels, copies,
sets) into busy intervals and reports the busy seconds, the window's
length, the operations that took most time, the longest idle gaps named by
the host span that was open at their middle, and the device seconds of
kernels by name.  Host spans are the program's own (``obs.trace`` spans,
on ``time.perf_counter_ns``) and the harness's (``HostSpans``, on the same
clock); a marker recorded at ``start`` puts the profiler's clock on it.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

SMALL_GAP_NS = 50_000  # idle gaps under 50 us are lumped together
TOP = 10


class HostSpans:
    """The harness's own host spans: ``(name, t0_ns, t1_ns, thread)`` on
    ``time.perf_counter_ns``."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, int, int, int]] = []

    @contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns(), threading.get_ident()))


def program_spans(roots: Iterable) -> List[Tuple[str, int, int, int]]:
    """Every span of the program's trace trees, flattened; a span that names
    a node or table carries it, as ``node.residual:clean``."""
    out = []
    stack = list(roots)
    while stack:
        sp = stack.pop()
        label = sp.attrs.get("model") or sp.attrs.get("table")
        out.append((f"{sp.name}:{label}" if label else sp.name, sp.t0_ns, sp.t1_ns, sp.tid))
        stack.extend(sp.children)
    return out


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


class DeviceTrace:
    """``torch.profiler`` over one window of the host and the card."""

    MARK = "portbench.clock"

    def __init__(self) -> None:
        self._prof = None
        self.t0_ns = self.t1_ns = 0
        self._mark_ns = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        with record_function(self.MARK):
            self._mark_ns = time.perf_counter_ns()
        self.t0_ns = self._mark_ns

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1_ns = time.perf_counter_ns()
        self._prof.stop()

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def summary(self, spans: Iterable[Tuple[str, int, int, int]] = ()) -> Dict:
        """Busy and idle time of the card over the window, on the host's
        clock.  ``spans`` name the idle gaps; the main thread's spans are
        preferred, the innermost one that covers a gap's middle wins."""
        events = self._prof.profiler.kineto_results.events()
        offset = None
        device = []
        for e in events:
            if e.device_type().name == "CUDA":
                device.append(e)
            elif offset is None and e.name() == self.MARK:
                offset = e.start_ns() - self._mark_ns
        if offset is None:
            raise RuntimeError("the profiler recorded no clock marker")
        by_name: Dict[str, float] = defaultdict(float)
        intervals = []
        for e in device:
            lo = e.start_ns() - offset
            hi = lo + e.duration_ns()
            lo, hi = max(lo, self.t0_ns), min(hi, self.t1_ns)
            if hi <= lo:
                continue
            by_name[e.name()] += (hi - lo) / 1e9
            intervals.append((lo, hi))
        busy = _merge(intervals)
        busy_ns = sum(hi - lo for lo, hi in busy)
        gaps: Dict[str, float] = defaultdict(float)
        main = threading.main_thread().ident
        spans = sorted(spans, key=lambda s: (s[3] != main, s[2] - s[1]))
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        for lo, hi in zip(edges[0::2], edges[1::2]):
            if hi <= lo:
                continue
            if hi - lo < SMALL_GAP_NS:
                gaps["gaps_under_50_us"] += (hi - lo) / 1e9
                continue
            mid = (lo + hi) // 2
            label = next((s[0] for s in spans if s[1] <= mid < s[2]), "host (no span)")
            gaps[label] += (hi - lo) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {
            "busy_s": busy_ns / 1e9,
            "window_s": self.window_s,
            "kernel_s": dict(by_name),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
        }


def kernel_seconds(summary: Optional[Dict], fragment: str) -> float:
    """Device seconds of the operations whose name holds ``fragment``."""
    if not summary:
        return 0.0
    return sum(s for name, s in summary["kernel_s"].items() if fragment in name)


def idle_share(summary: Optional[Dict]) -> Optional[float]:
    """The share of the traced window in which the card ran nothing, in %."""
    if not summary or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
