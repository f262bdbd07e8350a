"""Store reads a residual scan repeats: GETs of column chunks the scan cache
already holds.

A residual read (:func:`repro_torch.core.scan.read_window`) issues one GET
per (fragment, column) for every fragment that overlaps the residual.  A
scan that adds a column to a cached window plans the whole window as
residual (no element holds every column), so it fetches again the chunks of
the columns the cache already has.  :func:`refetch_gets` counts those GETs
for the tracer; nothing in the plan or the read depends on it.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.cache import snapshot_usable_window
from repro_torch.core.intervals import Interval, IntervalSet
from repro_torch.core.scan import fragments_overlapping

__all__ = ["refetch_gets"]


def refetch_gets(cache, table: str, snapshot, residual: IntervalSet,
                 columns: Sequence[str]) -> int:
    """The GETs of reading ``columns`` over ``residual`` under ``snapshot``
    that fetch a chunk the cache already holds: a (fragment, column) counts
    when one element of ``table``, usable under ``snapshot``, has that
    column over all of the fragment's rows inside ``residual``.  Reads the
    elements only (no LRU tick, counter or ledger moves); call it under the
    lock the plan holds."""
    elements = getattr(cache, "elements", None)
    if elements is None or residual.empty:
        return 0
    wanted = set(columns)
    held = []
    for e in elements(table):
        cols = wanted.intersection(e.columns)
        usable = snapshot_usable_window(e, snapshot)
        if cols and not usable.empty:
            held.append((usable, cols))
    if not held:
        return 0
    n = 0
    for f in fragments_overlapping(snapshot, residual):
        rows = residual.intersect(IntervalSet([Interval(f.key_min, f.key_max + 1)]))
        cols = set()
        for usable, have in held:
            if usable.covers(rows):
                cols |= have
        n += len(cols)
    return n
