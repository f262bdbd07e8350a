"""The system scan function (paper Fig. 3) — logical scan → physical plan →
assembled columnar dataframe, through a pluggable cache policy.

`ScanExecutor.scan()` is the function Bauplan inserts *before* user code: it
translates a `Model("raw_data", columns=…, filter=…)` reference into cache
slices + residual object-storage reads, UNIONs them (zero-copy,
:class:`ChunkedTable`), applies any post-predicate, and hands the caller a
columnar dataframe.  It also returns a :class:`ScanReport` so benchmarks can
attribute bytes to cache vs store — the paper's Table II currency.

A ``ResultCache`` (memoizing the *final* output under the exact input hash,
post-predicate included) is implemented here rather than in
``core.baselines`` because it wraps the whole executor, not the scan layer.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.baselines import NoCache, ScanCache
from repro_torch.core.cache import DifferentialCache
from repro_torch.core.columnar import ChunkedTable, Table
from repro_torch.core.intervals import IntervalSet
from repro_torch.core.scan import Scan, read_window, scan_cost_bytes
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.obs.explain import Explainer, RunExplanation
from repro_torch.obs.metrics import Metrics
from repro_torch.obs.trace import Tracer, get_tracer

if TYPE_CHECKING:  # annotation-only: a runtime import would close the
    # lake -> fragments -> core -> ... -> lake.catalog package cycle
    from repro_torch.lake.catalog import Catalog, Snapshot


__all__ = ["ScanExecutor", "ScanReport", "ResultCachingExecutor", "Predicate"]

# A post-scan row predicate: column arrays in, boolean mask out.  It is applied
# AFTER assembly and is NOT part of the cache geometry (window/projections),
# mirroring real engines: window+projection push down, residual predicates
# filter in memory.
Predicate = Callable[[Table], np.ndarray]


@dataclass
class ScanReport:
    table: str
    snapshot_id: str
    columns: Tuple[str, ...]
    window_pairs: tuple
    bytes_from_store: int
    bytes_from_cache: int
    store_requests: int
    cache_chunks: int  # hit-served cache views ONLY (never the residual)
    fully_cached: bool
    simulated_seconds: float
    residual_rows: int = 0  # rows fetched fresh from object storage
    bytes_from_spill: int = 0  # payload bytes promoted spill -> RAM for hits
    bytes_mmap: int = 0  # mmap-promoted spill payload bytes (zero-copy reads)
    coalesced_waits: int = 0  # replans after subscribing to another's claim
    # device-tier ledger (all zero on the numpy path)
    bytes_h2d: int = 0  # host->device bytes this scan uploaded
    device_hits: int = 0  # hit columns served from resident device pins
    gather_fast: int = 0  # fragment_gather block-run fast-path calls
    gather_fallbacks: int = 0  # non-RB-aligned gathers (RB=1)
    device_union_bytes: int = 0  # output bytes assembled on device

    @property
    def bytes_processed(self) -> int:
        """Bytes moved from object storage — the paper's Table II metric."""
        return self.bytes_from_store


class ScanExecutor:
    """Executes logical scans through a cache policy against a catalog."""

    def __init__(
        self,
        store: ObjectStore,
        catalog: Catalog,
        cache: Optional[Union[DifferentialCache, ScanCache, NoCache]] = None,
        tenant: Optional[str] = None,
        tracer: Optional[Tracer] = None,
        metrics: Optional[Metrics] = None,
        explainer: Optional[Explainer] = None,
    ):
        self.store = store
        self.catalog = catalog
        self.cache = cache if cache is not None else DifferentialCache()
        self.tenant = tenant  # attribution when the cache is tenant-aware
        # obs wiring: share the cache's registry/tracer unless given one, so
        # spill-tier hit bytes and scan-level series land in ONE registry
        self.tracer = tracer or getattr(self.cache, "tracer", None) or get_tracer()
        self.metrics = metrics or getattr(self.cache, "metrics", None) or Metrics()
        self.explainer = explainer if explainer is not None else Explainer()
        self.reports: List[ScanReport] = []
        # the plan+slice / insert critical sections must serialize across
        # EVERY executor sharing this cache object (repro_torch.service gives each
        # tenant session its own executor over one shared cache), so the
        # lock is the cache's own when it has one; baseline caches without a
        # lock fall back to a private one (single-executor use)
        self._lock = getattr(self.cache, "lock", None) or threading.Lock()

    def _claim_timeout(self) -> float:
        """Max seconds to wait on another executor's residual claim before
        replanning (and potentially taking the claim over) — configured on
        the shared cache (``SharedStore(claim_timeout=...)``)."""
        return float(getattr(self.cache, "claim_timeout", 60.0))

    # -- the system function -------------------------------------------------
    def scan(
        self,
        table: str,
        columns: Sequence[str],
        window: Optional[IntervalSet] = None,
        snapshot_id: Optional[str] = None,
        predicate: Optional[Predicate] = None,
        sorted_output: bool = False,
        device_consumer: bool = False,
        explain: Optional[RunExplanation] = None,
    ) -> ChunkedTable:
        with self.tracer.span("scan", table=table, tenant=self.tenant or ""):
            return self._scan(
                table, columns, window, snapshot_id, predicate,
                sorted_output, device_consumer, explain,
            )

    def _scan(
        self,
        table: str,
        columns: Sequence[str],
        window: Optional[IntervalSet],
        snapshot_id: Optional[str],
        predicate: Optional[Predicate],
        sorted_output: bool,
        device_consumer: bool,
        explain: Optional[RunExplanation],
    ) -> ChunkedTable:
        meta = self.catalog.table(table)
        snapshot = (
            self.catalog.snapshot(table, snapshot_id)
            if snapshot_id
            else self.catalog.current_snapshot(table)
        )
        window = window if window is not None else IntervalSet.everything()
        scan = Scan(table, snapshot.snapshot_id, tuple(columns), window)
        phys = scan.physical_columns(meta.sort_key)
        proj = [c for c in phys if c in scan.columns]

        # device serving path: only when the consumer declared itself a torch
        # node AND the cache carries a device tier AND this scan's output is
        # the raw hit∪residual UNION (a post-predicate or a host sort would
        # reshape rows after assembly — those scans stay on the numpy path)
        tier = getattr(self.cache, "device", None)
        use_device = (
            device_consumer
            and tier is not None
            and predicate is None
            and not sorted_output
        )
        dev_ledger: Dict[str, int] = {}

        # thread-local ledger: per-scan deltas stay exact when concurrent
        # runs (repro_torch.service workers) share this object store
        ledger = self.store.thread_stats()
        before = ledger.snapshot()
        # plan AND slice the hits under one lock acquisition: between a plan
        # and its slicing, a concurrent insert may merge or evict the very
        # elements the plan's hits reference — the slices (zero-copy views
        # over immutable buffers) must be taken while the plan is still the
        # cache's current truth.  Shared caches also coalesce: claiming the
        # residual in the SAME critical section as the plan means of N
        # concurrent identical scans exactly one reads the residual from
        # object storage and the rest subscribe, replan, and hit.
        claimer = getattr(self.cache, "claim_residual", None)
        claim = None
        waits = 0
        spill_bytes = 0  # accumulated across replan rounds (see executor)
        quarantined = 0  # spill payloads failing integrity checks, ditto
        elem_views: List[Tuple] = []  # pre-insert element state, for explain
        try:
            while True:
                chunks: List[Table] = []
                # device union layout, mirrored 1:1 with `chunks`: each entry
                # is (provider arrays, lo, hi) in final chunk order
                dev_runs: List[Tuple] = []
                dev_ok = use_device
                bytes_from_cache = 0
                wait_event = None
                plan_kwargs = {"tenant": self.tenant}
                if use_device:
                    plan_kwargs["device_consumer"] = True
                with self.tracer.span("scan.plan", table=table), self._lock:
                    q0 = getattr(self.cache, "plan_quarantines", 0)
                    plan = self.cache.plan(
                        scan, snapshot, meta.sort_key, **plan_kwargs
                    )
                    quarantined += getattr(self.cache, "plan_quarantines", 0) - q0
                    if (
                        explain is not None
                        and explain.enabled
                        and not plan.residual.empty
                    ):
                        # immutable views of the pre-insert element state,
                        # captured under the same lock the plan ran under;
                        # the explainer only consults them on the recompute
                        # path, so fully-served scans skip the copy
                        elem_views = [
                            (e.window, e.pins, e.columns, e.table)
                            for e in getattr(self.cache, "elements", lambda s: ())(
                                scan.table
                            )
                        ]
                    spill_bytes += plan.promoted_spill_bytes
                    if claimer is not None and not plan.residual.empty:
                        claim, wait_event = claimer(
                            scan.table, plan.residual, phys,
                            snapshot_id=snapshot.snapshot_id,
                            kind="scan",
                        )
                    if wait_event is None:
                        for hit in plan.hits:
                            views = hit.element.slice_window(hit.window, phys)
                            for v in views:
                                bytes_from_cache += v.nbytes
                            chunks.extend(views)
                            if dev_ok:
                                # pin under the SAME lock the slices are
                                # taken under: a concurrent merge drops the
                                # element's pins the moment the plan stops
                                # being the cache's current truth
                                arrays = tier.pin_columns(
                                    hit.element, proj, dev_ledger
                                )
                                if arrays is None:  # unsupported dtype/demoted
                                    dev_ok = False
                                    dev_runs = []
                                else:
                                    dev_runs.extend(
                                        (arrays, lo, hi)
                                        for _iv, lo, hi
                                        in hit.element.window_runs(hit.window)
                                    )
                if wait_event is None:
                    break
                waits += 1
                t_wait = time.perf_counter()
                with self.tracer.span("scan.claim_wait", table=table):
                    wait_event.wait(timeout=self._claim_timeout())
                self.metrics.histogram("claim_wait_seconds", kind="scan").observe(
                    time.perf_counter() - t_wait
                )
            hit_chunks = len(chunks)

            residual_rows = 0
            if not plan.residual.empty:
                with self.tracer.span("scan.residual", table=table) as res_sp:
                    fresh = read_window(
                        self.store, snapshot, plan.residual, phys, meta.sort_key,
                        schema=meta.schema,
                    )
                    res_sp.attrs["rows"] = fresh.num_rows
                fresh_dev = None
                if dev_ok and fresh.num_rows:
                    fresh_dev = self._to_device(fresh, proj, dev_ledger, tier.device)
                    if fresh_dev is None:
                        dev_ok = False
                insert_kwargs = {"tenant": self.tenant}
                if fresh_dev is not None:
                    insert_kwargs["device_arrays"] = fresh_dev
                with self.tracer.span("scan.insert", table=table), self._lock:
                    self.cache.insert(
                        scan, snapshot, meta.sort_key, plan.residual, fresh,
                        **insert_kwargs,
                    )
                if fresh.num_rows:
                    residual_rows = fresh.num_rows
                    chunks.append(fresh)
                    if dev_ok:
                        dev_runs.append((fresh_dev, 0, fresh.num_rows))
        finally:
            if claim is not None:
                self.cache.release_residual(claim)

        delta = ledger.delta(before)
        self.reports.append(
            ScanReport(
                table=table,
                snapshot_id=snapshot.snapshot_id,
                columns=scan.columns,
                window_pairs=window.to_pairs(),
                bytes_from_store=delta.bytes_read,
                bytes_from_cache=bytes_from_cache,
                store_requests=delta.get_requests,
                cache_chunks=hit_chunks,
                fully_cached=plan.fully_cached,
                simulated_seconds=delta.simulated_seconds,
                residual_rows=residual_rows,
                bytes_from_spill=spill_bytes,
                bytes_mmap=delta.bytes_mmap,
                coalesced_waits=waits,
                bytes_h2d=dev_ledger.get("bytes_h2d", 0) + plan.bytes_h2d,
                device_hits=dev_ledger.get("device_hits", 0),
                gather_fast=dev_ledger.get("gather_fast", 0),
                gather_fallbacks=dev_ledger.get("gather_fallbacks", 0),
                device_union_bytes=dev_ledger.get("device_union_bytes", 0),
            )
        )

        # the scan-level series the ScanReport fields reconcile against
        m = self.metrics
        m.counter("scan_requests", table=table).inc()
        m.counter("bytes_from_store", table=table).inc(delta.bytes_read)
        m.counter("store_requests", table=table).inc(delta.get_requests)
        m.counter("bytes_mmap", table=table).inc(delta.bytes_mmap)
        m.counter("cache_hit_bytes", tier="ram").inc(bytes_from_cache)
        m.counter("residual_rows", kind="scan").inc(residual_rows)
        if waits:
            m.counter("coalesced_wait_rounds", kind="scan").inc(waits)

        if explain is not None and explain.enabled:
            def current_id() -> Optional[str]:
                # lazy (only a genuine invalidation pays the pointer read)
                # and memoized on the run's explanation
                memo = explain.head_ids
                if table not in memo:
                    try:
                        memo[table] = self.catalog.current_snapshot_id(table)
                    except (KeyError, OSError):
                        memo[table] = None
                return memo[table]

            hit_tier = "ram+spill" if spill_bytes else ("ram" if bytes_from_cache else "store")
            self.explainer.classify_scan(
                explain,
                table=table,
                window=window,
                residual=plan.residual,
                columns=tuple(phys),
                elements=elem_views,
                snapshot=snapshot,
                current_id=current_id,
                rows=residual_rows,
                tier=hit_tier,
                quarantined=quarantined,
            )

        with self.tracer.span("scan.union", table=table, chunks=len(chunks)):
            out = ChunkedTable(chunks)
            if predicate is not None:
                out = ChunkedTable([c.filter(predicate(c)) for c in out.chunks])
            # sort while the sort key is still physically present, THEN
            # project it away unless requested — sorted_output must hold even
            # when the key is not among the projections
            if sorted_output and out.chunks:
                out = ChunkedTable([out.combine().sort_by(meta.sort_key)])
            out = out.select(proj)
            if dev_ok and dev_runs:
                # assemble the UNION on device too: run layout mirrors the
                # host chunk order exactly, so device_columns[c] is
                # bitwise-equal to to_device(out.column(c)) —
                # property-checked in test_torch_device
                from repro_torch.core.device import DeviceChunkedTable, device_union

                arrays = device_union(dev_runs, proj, ledger=dev_ledger)
                r = self.reports[-1]
                r.gather_fast = dev_ledger.get("gather_fast", 0)
                r.gather_fallbacks = dev_ledger.get("gather_fallbacks", 0)
                r.device_union_bytes = dev_ledger.get("device_union_bytes", 0)
                out = DeviceChunkedTable(out.chunks, arrays)
        return out

    @staticmethod
    def _to_device(
        fresh: Table, columns: Sequence[str], ledger: Dict[str, int], device
    ):
        """Upload a fresh residual's columns (the one H2D transfer the
        residual ever pays: the tensors are handed to the cache insert so
        future consumers — including post-merge ones — hit device).  None
        when any column's dtype has no device analog."""
        from repro_torch.core.device import DeviceTier, to_device

        if not all(DeviceTier.supported(fresh.column(c).dtype) for c in columns):
            return None
        out = {}
        for c in columns:
            arr = to_device(fresh.column(c), device)
            ledger["bytes_h2d"] = ledger.get("bytes_h2d", 0) + int(arr.nbytes)
            out[c] = arr
        return out

    # -- accounting ----------------------------------------------------------
    def total_bytes_processed(self) -> int:
        return sum(r.bytes_from_store for r in self.reports)

    def reset_reports(self) -> None:
        self.reports.clear()


class ResultCachingExecutor:
    """The paper's *result cache* baseline: memoize the fully-assembled output
    under the hash of the exact inputs (predicate identity included).

    ``max_bytes`` bounds the memo with LRU eviction — an unbounded memo would
    hand the baseline infinite memory on long workloads and skew
    Table-II-style comparisons against the (byte-budgeted) scan caches."""

    def __init__(
        self, store: ObjectStore, catalog: Catalog, max_bytes: Optional[int] = None
    ):
        self.inner = ScanExecutor(store, catalog, cache=NoCache())
        self.max_bytes = max_bytes
        self._memo: "OrderedDict[tuple, ChunkedTable]" = OrderedDict()
        self._bytes = 0  # running memo size: eviction must not be O(n²)
        self.lookups = 0
        self.hits = 0
        self.evictions = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    @property
    def reports(self) -> List[ScanReport]:
        return self.inner.reports

    def scan(
        self,
        table: str,
        columns: Sequence[str],
        window: Optional[IntervalSet] = None,
        snapshot_id: Optional[str] = None,
        predicate: Optional[Predicate] = None,
        sorted_output: bool = False,
    ) -> ChunkedTable:
        self.lookups += 1
        snapshot = (
            self.inner.catalog.snapshot(table, snapshot_id)
            if snapshot_id
            else self.inner.catalog.current_snapshot(table)
        )
        # key on the predicate OBJECT, not id(): the tuple key holds a strong
        # reference, so a memo hit implies the very same (still-alive)
        # callable — id() alone gives false hits once a collected
        # predicate's id is recycled for a new one
        key = (
            table,
            snapshot.snapshot_id,
            tuple(sorted(columns)),
            (window or IntervalSet.everything()).to_pairs(),
            predicate,
            sorted_output,
        )
        if key in self._memo:
            self.hits += 1
            self._memo.move_to_end(key)  # LRU freshness
            # record a zero-byte report so workload traces stay comparable
            self.inner.reports.append(
                ScanReport(table, snapshot.snapshot_id, tuple(sorted(columns)),
                           key[3], 0, self._memo[key].nbytes, 0,
                           len(self._memo[key].chunks), True, 0.0)
            )
            return self._memo[key]
        out = self.inner.scan(table, columns, window, snapshot_id, predicate, sorted_output)
        if self.max_bytes is not None and out.nbytes > self.max_bytes:
            # a result bigger than the whole budget is not retained — and it
            # must not churn out every hot entry on its way through
            return out
        self._memo[key] = out
        self._bytes += out.nbytes
        if self.max_bytes is not None:
            while self._bytes > self.max_bytes:  # evict LRU-first
                _, evicted = self._memo.popitem(last=False)
                self._bytes -= evicted.nbytes
                self.evictions += 1
        return out

    def total_bytes_processed(self) -> int:
        return self.inner.total_bytes_processed()
