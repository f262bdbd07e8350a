"""The scan model: the atomic building block the cache reasons about.

A :class:`Scan` is the paper's `(table, snapshot, projections, filter)`
tuple.  This module also provides the *uncached* physical path — mapping a
scan onto fragment range-reads — and the byte-cost estimator used by the
greedy cache (`compute_cost` in paper Listing 3 "returns either the size of
the required scan or a bound on the size").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.columnar import ChunkedTable, Table, concat_tables
from repro_torch.core.intervals import Interval, IntervalSet
from repro_torch.lake.s3sim import ObjectStore

if TYPE_CHECKING:  # annotation-only: importing at runtime would close the
    # package cycle lake/__init__ → fragments → core → scan → catalog →
    # fragments, which breaks any tool whose cold entry point is repro_torch.lake
    from repro_torch.lake.catalog import Snapshot
    from repro_torch.lake.fragments import FragmentMeta

__all__ = [
    "Scan",
    "fragments_overlapping",
    "scan_cost_bytes",
    "read_window",
]


@dataclass(frozen=True)
class Scan:
    """A logical scan request (projections + sort-key window)."""

    table: str  # namespace.name
    snapshot_id: str
    columns: Tuple[str, ...]  # projections, sorted, sort key excluded
    window: IntervalSet  # filter on the table's sort key

    def __post_init__(self) -> None:
        object.__setattr__(self, "columns", tuple(sorted(set(self.columns))))

    def physical_columns(self, sort_key: str) -> Tuple[str, ...]:
        """Columns actually read: projections plus the filter column (Parquet
        readers must fetch the predicate column too)."""
        return tuple(sorted(set(self.columns) | {sort_key}))

    def cache_key(self) -> tuple:
        return (self.table, self.snapshot_id, self.columns, self.window.to_pairs())


def fragments_overlapping(
    snapshot: Snapshot, window: IntervalSet
) -> List[FragmentMeta]:
    """Min/max pruning: fragments whose key range intersects the window."""
    out = []
    for f in snapshot.fragments:
        for iv in window:
            if f.overlaps(iv.lo, iv.hi):
                out.append(f)
                break
    return out


def scan_cost_bytes(
    snapshot: Snapshot, window: IntervalSet, physical_columns: Sequence[str]
) -> int:
    """Upper bound on bytes a residual scan must move from object storage.

    Column-chunk granularity: a fragment overlapping *any* residual interval
    contributes its full requested column chunks exactly once (we issue one
    range-read per column per fragment, however many intervals it overlaps).
    """
    return sum(
        f.columns_bytes(physical_columns) for f in fragments_overlapping(snapshot, window)
    )


def read_window(
    store: ObjectStore,
    snapshot: Snapshot,
    window: IntervalSet,
    physical_columns: Sequence[str],
    sort_key: str,
    schema: Optional[Dict[str, str]] = None,
) -> Table:
    """Execute the physical scan: range-read overlapping fragments' column
    chunks, keep rows whose sort key falls in the window, return rows sorted
    by the sort key.  This is the only function that touches object storage
    on behalf of scans."""
    parts: List[Table] = []
    for f in fragments_overlapping(snapshot, window):
        from repro_torch.lake.fragments import read_fragment_columns

        tbl = read_fragment_columns(store, f, list(physical_columns))
        keys = tbl.column(sort_key)
        # fragment rows are sorted: use searchsorted slices per interval
        for iv in window:
            lo = int(np.searchsorted(keys, iv.lo, side="left"))
            hi = int(np.searchsorted(keys, iv.hi, side="left"))
            if hi > lo:
                parts.append(tbl.slice(lo, hi))
    if not parts:
        # schema-complete empty table (dtypes from the catalog when known)
        dt = lambda n: np.dtype(schema[n]) if schema and n in schema else np.int64
        return Table({n: np.empty(0, dtype=dt(n)) for n in physical_columns})
    out = concat_tables(parts)
    return out.sort_by(sort_key)
