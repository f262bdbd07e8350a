"""Baseline cache designs the paper compares against (Table II).

- :class:`ResultCache` — memoizes tuples under the hash of the *exact input
  parameters* (table, snapshot, projections, filter, post-predicate).  Any
  difference in inputs is a miss ("a so-called result cache in the database
  community").
- :class:`ScanCache` — memoizes the results of *S3 scans* exactly (which may
  or may not equal the fully specified input parameters: the post-predicate
  is applied after the scan, so two queries differing only in post-predicates
  share a scan).  Hits require an exact (projection, window, snapshot) match.

Both implement the same protocol the executor drives, so all three designs
(result/scan/differential) run the same workloads over the same object store
and the bytes ledger is directly comparable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from repro_torch.core.cache import CacheElement, CacheHit, CachePlan, DifferentialCache
from repro_torch.core.columnar import Table
from repro_torch.core.intervals import IntervalSet
from repro_torch.core.scan import Scan, scan_cost_bytes

if TYPE_CHECKING:  # annotation-only: a runtime import would close the
    # lake -> fragments -> core -> ... -> lake.catalog package cycle
    from repro_torch.lake.catalog import Snapshot


__all__ = ["ScanCache", "NoCache"]


class NoCache:
    """Every scan goes to object storage (the cold baseline)."""

    def plan(self, scan: Scan, snapshot: Snapshot, sort_key: str, tenant=None) -> CachePlan:
        cost = scan_cost_bytes(snapshot, scan.window, scan.physical_columns(sort_key))
        return CachePlan([], scan.window, cost, cost)

    def insert(self, scan, snapshot, sort_key, window, data, tenant=None) -> None:
        return None


class ScanCache:
    """Exact-match scan cache: key = (table, snapshot, physical columns,
    window).  No differential reuse — overlapping-but-different windows miss.
    """

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = max_bytes
        self._store: Dict[tuple, Tuple[IntervalSet, Table]] = {}
        self._order: List[tuple] = []
        self.lookups = 0
        self.full_hits = 0

    @staticmethod
    def _key(scan: Scan, snapshot: Snapshot, sort_key: str) -> tuple:
        return (
            scan.table,
            snapshot.snapshot_id,
            scan.physical_columns(sort_key),
            scan.window.to_pairs(),
        )

    def plan(self, scan: Scan, snapshot: Snapshot, sort_key: str, tenant=None) -> CachePlan:
        self.lookups += 1
        key = self._key(scan, snapshot, sort_key)
        baseline = scan_cost_bytes(snapshot, scan.window, scan.physical_columns(sort_key))
        if key in self._store:
            self.full_hits += 1
            window, data = self._store[key]
            # wrap the memoized table as a pseudo cache element for uniformity
            elem = CacheElement(
                elem_id=-1,
                table=scan.table,
                sort_key=sort_key,
                columns=tuple(sorted(data.column_names)),
                window=window,
                pins=(),
                data=data,
            )
            return CachePlan([CacheHit(elem, window)], IntervalSet(), 0, baseline)
        return CachePlan([], scan.window, baseline, baseline)

    def insert(self, scan: Scan, snapshot: Snapshot, sort_key, window, data, tenant=None) -> None:
        key = self._key(scan, snapshot, sort_key)
        self._store[key] = (window, data)
        self._order.append(key)
        if self.max_bytes is not None:
            while sum(t.nbytes for _, t in self._store.values()) > self.max_bytes and self._order:
                self._store.pop(self._order.pop(0), None)
