"""The differential cache — the paper's primary contribution (§III).

Design choices reproduced exactly:

1. **Scans as primary cache objects** (not `input → result` pairs): a
   :class:`CacheElement` is the materialized result of one physical scan —
   `(table, projection set, sort-key window, fragment set)` plus the columnar
   rows.  New scans are served by *greedily subtracting* cached elements from
   the requested window (paper Listing 3) and fetching only the residual.

2. **Columnar physical representation with zero-copy views**: element rows are
   :class:`~repro_torch.core.columnar.Table`s sorted by the sort key; serving a
   window is two `searchsorted`s and an O(1) slice — the Arrow-view sharing of
   §III-A.  The element's buffers are shared by every consumer.

3. **"Free" invalidation via fragment pinning**: elements record the
   `(fragment_id, key_min, key_max)` triples they were assembled from.  Under
   a new snapshot, an element stays valid wherever its fragment set still
   matches; windows touched by *dropped* or *newly added* fragments are
   subtracted (this is slightly stronger than the paper, which invalidates
   whole entries — we invalidate differentially, see ``usable_window``).

4. **Merging**: elements with identical projection sets and touching windows
   are combined (paper: "cache elements with overlapping or adjacent filters
   can then be combined"), keeping the element count small so future scans
   need small UNIONs.

The greedy window-subtraction machinery is NOT scan-specific: any node whose
output is addressable by `(signature, sort-key window)` can be cached
differentially.  :class:`DifferentialStore` is that generalization — elements
are grouped by an arbitrary hashable *signature* (what identifies the
computation: for table scans the table name, for pipeline model nodes the
`(fn code hash, runtime, upstream signatures)` digest), and planning/insertion
work per signature group exactly as Listing 3 works per table.
:class:`DifferentialCache` is the table-scan specialization the paper
describes; the pipeline executor uses a second `DifferentialStore` to cache
intermediate `@model` outputs (see ``repro_torch.pipeline.executor``).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.columnar import Table, concat_tables
from repro_torch.core.intervals import Interval, IntervalSet
from repro_torch.core.scan import Scan, scan_cost_bytes
from repro_torch.obs.metrics import MetricAttr, Metrics
from repro_torch.obs.trace import Tracer, get_tracer

if TYPE_CHECKING:  # annotation-only: a runtime import would close the
    # lake -> fragments -> core -> ... -> lake.catalog package cycle
    from repro_torch.lake.catalog import Snapshot


__all__ = [
    "CacheElement",
    "CachePlan",
    "CacheHit",
    "DifferentialStore",
    "DifferentialCache",
    "FragmentPin",
    "multi_pins_for",
    "next_elem_id",
    "pins_for",
    "snapshot_usable_window",
    "snapshots_usable_window",
]

_ID = itertools.count()


def next_elem_id() -> int:
    """Fresh element id (shared counter, so restored spill elements can't
    collide with elements created in-process)."""
    return next(_ID)

# Validity policy: which part of an element's window may still be served.
# Scans check fragment pins against a snapshot; model nodes whose staleness is
# fully encoded in the signature use the default (the whole window).
UsableFn = Callable[["CacheElement"], IntervalSet]


@dataclass(frozen=True)
class FragmentPin:
    """What an element remembers about a source fragment (enough to detect
    staleness even after the fragment vanishes from the catalog).

    ``table`` labels which source table the fragment belongs to; ``None``
    means the element's own ``table`` (the single-leaf case, which keeps old
    pins — and old spill manifests — valid unchanged).  Multi-input nodes pin
    fragments of *several* leaf tables in one element, so their pins carry
    the label explicitly."""

    fragment_id: str
    key_min: int
    key_max: int
    table: Optional[str] = None

    @property
    def window(self) -> Interval:
        return Interval(self.key_min, self.key_max + 1)


@dataclass
class CacheElement:
    elem_id: int
    table: str  # provenance label: source table (scans) / pin table (models)
    sort_key: str
    columns: Tuple[str, ...]  # physical columns (includes sort key)
    window: IntervalSet
    pins: Tuple[FragmentPin, ...]
    data: Optional[Table]  # sorted by sort_key; None while demoted to spill
    last_used: int = 0
    signature: Hashable = None  # group key in the DifferentialStore
    owner: Optional[str] = None  # tenant that paid for these bytes (service)
    spill: Optional[object] = None  # SpillEntry when a spill copy exists

    def __post_init__(self) -> None:
        if self.signature is None:
            self.signature = self.table

    @property
    def resident(self) -> bool:
        """Whether the payload is in the RAM tier (demoted elements keep
        window/pins/columns in RAM — enough to plan against — but their rows
        live only in the spill tier until promoted)."""
        return self.data is not None

    @property
    def nbytes(self) -> int:
        """RAM-tier bytes: a demoted element holds no payload in memory."""
        return self.data.nbytes if self.data is not None else 0

    @property
    def payload_nbytes(self) -> int:
        """Payload bytes wherever they live (RAM or spill)."""
        if self.data is not None:
            return self.data.nbytes
        return self.spill.nbytes if self.spill is not None else 0

    @property
    def pin_ids(self) -> frozenset:
        return frozenset(p.fragment_id for p in self.pins)

    def window_runs(self, window: IntervalSet) -> List[Tuple[Interval, int, int]]:
        """The contiguous row runs of this element's payload inside
        ``window``: ``(interval, lo, hi)`` half-open row bounds per
        non-empty interval, in window order.  This is the single place the
        interval→row mapping is computed — host slicing and device gather
        assembly both derive from it, so they cannot disagree."""
        if self.data is None:
            raise RuntimeError(
                f"element {self.elem_id} is demoted; the planner promotes "
                f"hits before handing them out — slicing a demoted element "
                f"is a store-discipline bug"
            )
        keys = self.data.column(self.sort_key)
        runs: List[Tuple[Interval, int, int]] = []
        for iv in window:
            lo = int(np.searchsorted(keys, iv.lo, side="left"))
            hi = int(np.searchsorted(keys, iv.hi, side="left"))
            if hi > lo:
                runs.append((iv, lo, hi))
        return runs

    def slice_window(self, window: IntervalSet, columns: Sequence[str]) -> List[Table]:
        """Zero-copy chunks of this element's rows inside ``window``."""
        view = None
        chunks: List[Table] = []
        for _iv, lo, hi in self.window_runs(window):
            if view is None:
                view = self.data.select(list(columns))
            chunks.append(view.slice(lo, hi))
        return chunks


@dataclass(frozen=True)
class CacheHit:
    element: CacheElement
    window: IntervalSet  # the part of the scan this element serves


@dataclass
class CachePlan:
    """Output of the greedy planner: which windows come from which cached
    elements, and what residual must be fetched/recomputed."""

    hits: List[CacheHit]
    residual: IntervalSet
    residual_cost_bytes: int
    baseline_cost_bytes: int  # cost had there been no cache
    promoted_spill_bytes: int = 0  # payload bytes promoted spill -> RAM for hits
    bytes_h2d: int = 0  # host->device bytes for spill->device straight promotion

    @property
    def fully_cached(self) -> bool:
        return self.residual.empty

    @property
    def bytes_saved(self) -> int:
        return self.baseline_cost_bytes - self.residual_cost_bytes


def pins_for(snapshot: Snapshot, window: IntervalSet) -> Tuple[FragmentPin, ...]:
    """The fragment pins an element covering ``window`` under ``snapshot``
    must carry — the single place the pin shape (inclusive ``key_max``) is
    defined, shared by leaf-scan inserts and model-output inserts so
    :func:`snapshot_usable_window`'s invariants cannot drift."""
    from repro_torch.core.scan import fragments_overlapping

    return tuple(
        FragmentPin(f.fragment_id, f.key_min, f.key_max)
        for f in fragments_overlapping(snapshot, window)
    )


def multi_pins_for(
    snapshots: Dict[str, Snapshot], window: IntervalSet
) -> Tuple[FragmentPin, ...]:
    """Pins for an element derived from *several* leaf tables (a multi-input
    node): each table's overlapping fragments, labeled with the table so
    :func:`snapshots_usable_window` can check each against its own
    snapshot.  Tables are visited in sorted order for determinism."""
    from repro_torch.core.scan import fragments_overlapping

    pins: List[FragmentPin] = []
    for table in sorted(snapshots):
        pins.extend(
            FragmentPin(f.fragment_id, f.key_min, f.key_max, table)
            for f in fragments_overlapping(snapshots[table], window)
        )
    return tuple(pins)


def snapshot_usable_window(elem: CacheElement, snapshot: Snapshot) -> IntervalSet:
    """Differential invalidation against a snapshot (design choice 3).

    Valid window = element window
      − key ranges of element fragments *dropped* by the snapshot
      − key ranges of snapshot fragments the element never saw.

    This is the validity policy for any element whose rows were derived from
    the fragments it pins — leaf scans, and model outputs pinning the leaf
    fragments their residual was computed from.
    """
    return snapshots_usable_window(elem, {elem.table: snapshot})


def snapshots_usable_window(
    elem: CacheElement, snapshots: Dict[str, Snapshot]
) -> IntervalSet:
    """:func:`snapshot_usable_window` generalized to elements whose rows
    were derived from several leaf tables (multi-input nodes): the usable
    window is the element window minus every table's stale/unseen ranges —
    a window is only served if it is still valid under ALL the snapshots
    its rows were zipped from.  Unlabeled pins belong to ``elem.table``, so
    single-leaf elements behave exactly as before."""
    usable = elem.window
    seen_by_table: Dict[str, set] = {}
    for p in elem.pins:
        seen_by_table.setdefault(p.table or elem.table, set()).add(p.fragment_id)
    for table, snapshot in snapshots.items():
        live_ids = snapshot.fragment_ids
        stale = IntervalSet(
            [
                p.window
                for p in elem.pins
                if (p.table or elem.table) == table
                and p.fragment_id not in live_ids
            ]
        )
        seen = seen_by_table.get(table, ())
        unseen = IntervalSet(
            [
                Interval(f.key_min, f.key_max + 1)
                for f in snapshot.fragments
                if f.fragment_id not in seen
                and elem.window.intersects(
                    IntervalSet([Interval(f.key_min, f.key_max + 1)])
                )
            ]
        )
        usable = usable.difference(stale).difference(unseen)
    return usable


class DifferentialStore:
    """Greedy differential window store: a RAM tier with LRU byte-budget
    eviction over an optional **spill tier** of IPC files in object storage.

    Elements are grouped by *signature*; within a group, :meth:`plan_window`
    runs the paper's Listing 3 greedy subtraction and :meth:`insert_window`
    stores a fresh residual and merges touching windows.  The store is policy-
    free about validity: callers pass ``usable_fn`` (e.g. fragment-pin checks
    against the current snapshot) and ``cost_fn`` (the `compute_cost` bound of
    Listing 3) per call, so one store serves both table scans and
    intermediate model outputs.

    With a ``spill`` tier (:class:`~repro_torch.core.spill.SpillTier`), eviction
    *demotes* payloads to object storage instead of dropping them: the
    element stays in the index (window/pins/columns are tiny), its rows move
    to an IPC file, and a later plan that hits it promotes the payload back
    via mmap — zero-copy until touched.  The effective cache capacity is
    therefore the spill store, not RAM, and a fresh store over a populated
    spill root starts warm (the tier rebuilds the index from manifests).
    """

    # observability counters (surface in benchmarks / EXPERIMENTS.md).
    # Each is a registry-backed attribute: ``self.lookups += 1`` call sites
    # and ``stats()`` readers are unchanged, but the values live in the
    # store's Metrics registry — the single source of truth a service
    # scrape (``ServiceReport.metrics_text()``) reads.
    lookups = MetricAttr("cache_lookups")
    full_hits = MetricAttr("cache_full_hits")
    partial_hits = MetricAttr("cache_partial_hits")
    evictions = MetricAttr("cache_evictions")
    demotions = MetricAttr("cache_demotions")
    promotions = MetricAttr("cache_promotions")
    # cumulative payload bytes promoted from spill = hit bytes served by
    # the spill tier (the RAM-tier analog is emitted by the executors)
    bytes_from_spill = MetricAttr("cache_hit_bytes", tier="spill")
    spill_restored = MetricAttr("spill_restored")
    # crash-warmness + robustness ledgers: payload bytes parked by the
    # write-through/checkpoint modes, and elements quarantined out of a plan
    # because their spilled payload failed integrity verification
    writethrough_bytes = MetricAttr("spill_writethrough_bytes")
    plan_quarantines = MetricAttr("plan_quarantines")

    def __init__(
        self,
        max_bytes: Optional[int] = None,
        spill=None,
        device=None,
        metrics: Optional[Metrics] = None,
        metrics_labels: Optional[Dict[str, str]] = None,
        tracer: Optional[Tracer] = None,
        spill_mode: Optional[str] = None,
        checkpoint_every: int = 8,
        spill_failure_threshold: int = 3,
    ):
        assert spill_mode in (None, "write_through", "checkpoint")
        assert spill_mode is None or spill is not None, "spill_mode needs a spill tier"
        self.max_bytes = max_bytes
        self.spill = spill
        # crash-warmness discipline: "write_through" parks a spill copy of
        # every element as it lands (a crash loses at most the in-flight
        # insert); "checkpoint" parks resident un-spilled elements every
        # ``checkpoint_every`` inserts; None (default) spills only on
        # eviction/demote_all — the pre-existing clean-shutdown behavior.
        self.spill_mode = spill_mode
        self.checkpoint_every = int(checkpoint_every)
        self._inserts_since_checkpoint = 0
        # graceful degradation: after ``spill_failure_threshold`` CONSECUTIVE
        # spill-write failures the store flips to RAM-only (degraded=True,
        # ``cache_degraded`` gauge) — evictions drop instead of demoting, and
        # write-through stops paying the failing tier. A cache that cannot
        # spill serves smaller windows; it does not crash runs.
        self.spill_failure_threshold = int(spill_failure_threshold)
        self._spill_failures = 0
        self.degraded = False
        # obs wiring must precede any counter use below
        self.metrics = metrics if metrics is not None else Metrics()
        self.metrics_labels = dict(metrics_labels or {})
        self.tracer = tracer if tracer is not None else get_tracer()
        if spill is not None:
            # adopt the tier into this store's registry/tracer (unless it
            # was wired explicitly) so one scrape covers both tiers
            if spill._metrics is None:
                spill._metrics = self.metrics
                spill.metrics_labels = dict(self.metrics_labels)
            if spill._tracer is None:
                spill._tracer = self.tracer
        # optional device tier (repro_torch.core.device.DeviceTier): an advisory
        # cache of element columns as jax device arrays.  The RAM tier stays
        # authoritative; the device copy exists so jax consumers skip the
        # H2D transfer.  Set here or attached later (Workspace/service).
        self.device = device
        if device is not None:
            device.adopt_obs(self.metrics, self.tracer)
        self._elements: Dict[Hashable, List[CacheElement]] = {}
        self._clock = 0
        # The store's concurrency discipline lives HERE, not in its callers:
        # every executor sharing this store must plan+slice (and insert)
        # under this one lock, so two Workspaces injected with the same
        # store serialize correctly.  Reentrant because service-layer
        # subclasses compose base operations while already holding it.
        self.lock = threading.RLock()
        if spill is not None:
            for elem in spill.restore():
                self._elements.setdefault(elem.signature, []).append(elem)
                self.spill_restored += 1

    # -- public API ----------------------------------------------------------
    def elements(self, signature: Optional[Hashable] = None) -> List[CacheElement]:
        if signature is not None:
            return list(self._elements.get(signature, ()))
        return [e for lst in self._elements.values() for e in lst]

    @property
    def nbytes(self) -> int:
        """RAM-tier bytes (demoted payloads count 0 — see ``spill_nbytes``)."""
        return sum(e.nbytes for e in self.elements())

    @property
    def spill_nbytes(self) -> int:
        """Payload bytes currently demoted to the spill tier."""
        return sum(
            e.spill.nbytes for e in self.elements()
            if e.data is None and e.spill is not None
        )

    def plan_window(
        self,
        signature: Hashable,
        window: IntervalSet,
        columns: Sequence[str],
        cost_fn: Callable[[IntervalSet], int],
        usable_fn: Optional[UsableFn] = None,
        tenant: Optional[str] = None,
        device_consumer: bool = False,
    ) -> CachePlan:
        """Paper Listing 3, iterated to a fixpoint.

        Candidates: same signature, columns ⊇ requested columns, non-empty
        usable window.  Each round picks the element whose subtraction lowers
        the residual cost the most (`compute_cost`); rounds stop when no
        element reduces cost — the greedy choice keeps the element count (and
        hence the final UNION) small, exactly the paper's argument.
        """
        from repro_torch.core.spill import SpillCorruption  # deferred: spill imports cache

        self.lookups += 1
        self._clock += 1
        need = set(columns)
        baseline = cost_fn(window)

        # plan → promote, replanned from scratch whenever a chosen element's
        # spilled payload fails integrity verification: the element is
        # quarantined (GC'd, counted) and the next round simply cannot pick
        # it — its window falls into the residual and is recomputed instead
        # of ever serving the corrupt bytes
        while True:
            candidates: List[Tuple[CacheElement, IntervalSet]] = []
            for e in self._elements.get(signature, ()):  # pre-filter (paper: namespace/table/projection match)
                if not need.issubset(set(e.columns)):
                    continue
                usable = usable_fn(e) if usable_fn is not None else e.window
                if usable.empty:
                    continue
                candidates.append((e, usable))

            remaining = window
            cost = baseline
            hits: List[CacheHit] = []
            used_ids: set = set()
            while True:
                best: Optional[Tuple[CacheElement, IntervalSet, IntervalSet, int]] = None
                for e, usable in candidates:
                    if e.elem_id in used_ids:
                        continue
                    covered = remaining.intersect(usable)
                    if covered.empty:
                        continue
                    new_remaining = remaining.difference(covered)
                    new_cost = cost_fn(new_remaining)
                    if new_cost < cost and (best is None or new_cost < best[3]):
                        best = (e, covered, new_remaining, new_cost)
                if best is None:
                    break
                e, covered, remaining, cost = best
                used_ids.add(e.elem_id)
                e.last_used = self._clock
                hits.append(CacheHit(e, covered))
                if remaining.empty:
                    break

            # spilled windows ARE hits: promote the chosen elements' payloads
            # back into the RAM tier (mmap — zero-copy until touched) so the
            # caller can slice them under the same lock acquisition
            promoted = 0
            bytes_h2d = 0
            corrupt: Optional[CacheElement] = None
            for h in hits:
                e = h.element
                if e.data is None:
                    try:
                        if device_consumer and self.device is not None:
                            # the plan's consumer is a jax node: promote straight to
                            # device — the mmap'd IPC pages are uploaded once (H2D)
                            # while the RAM tier gets its usual zero-copy mmap view
                            before_h2d = self.device.bytes_h2d
                            e.data = self.spill.load_to_device(e.spill, e, self.device)
                            bytes_h2d += self.device.bytes_h2d - before_h2d
                        else:
                            e.data = self.spill.load(e.spill)
                    except (SpillCorruption, FileNotFoundError):
                        corrupt = e
                        break
                    self.promotions += 1
                    promoted += e.data.nbytes
                    self.bytes_from_spill += e.data.nbytes
            if corrupt is not None:
                self._quarantine_element(corrupt)
                continue
            break

        if hits and remaining.empty:
            self.full_hits += 1
        elif hits:
            self.partial_hits += 1
        if promoted:
            # promotions grew the RAM tier: demote back down to budget, but
            # never THIS plan's hits — the caller slices them right after,
            # so the budget is soft by the plan's working set (same
            # discipline as read-pinned signatures in the shared store)
            self._evict(protect=frozenset(h.element.elem_id for h in hits))
        return CachePlan(
            hits=hits,
            residual=remaining,
            residual_cost_bytes=cost,
            baseline_cost_bytes=baseline,
            promoted_spill_bytes=promoted,
            bytes_h2d=bytes_h2d,
        )

    def insert_window(
        self,
        signature: Hashable,
        table: str,
        sort_key: str,
        window: IntervalSet,
        data: Table,
        pins: Tuple[FragmentPin, ...] = (),
        usable_fn: Optional[UsableFn] = None,
        tenant: Optional[str] = None,
        device_arrays: Optional[Dict] = None,
    ) -> Optional[CacheElement]:
        """Store a freshly computed residual as a new element, then merge
        touching same-column windows within the signature group.

        ``device_arrays`` (column → jax array, already on device) registers
        the residual's payload with the device tier under the new element's
        id BEFORE merging, so a merge of two pinned elements can replicate
        device→device instead of re-uploading the merged payload."""
        if window.empty:
            return None
        self._clock += 1
        elem = CacheElement(
            elem_id=next(_ID),
            table=table,
            sort_key=sort_key,
            columns=tuple(sorted(data.column_names)),
            window=window,
            pins=pins,
            data=data,
            last_used=self._clock,
            signature=signature,
            owner=tenant,
        )
        if device_arrays is not None and self.device is not None:
            self.device.adopt(elem.elem_id, device_arrays, data.num_rows)
        self._elements.setdefault(signature, []).append(elem)
        self._merge_group(signature, usable_fn)
        self._checkpoint_group(signature)
        self._evict()
        return elem

    def invalidate(self, signature: Hashable) -> None:
        for e in self._elements.pop(signature, ()):
            self._drop_spill_entry(e)
            self._drop_device(e)

    def clear(self) -> None:
        for e in self.elements():
            self._drop_spill_entry(e)
            self._drop_device(e)
        self._elements.clear()

    def demote_all(self) -> None:
        """Park every resident payload in the spill tier (no-op without
        one).  A service calls this at shutdown so the next process over the
        same spill root restarts warm; elements already spilled just drop
        their RAM reference (the spill copy is still authoritative)."""
        if self.spill is None:
            return
        with self.lock:
            for e in self.elements():
                if e.data is not None:
                    self._demote(e)

    def _checkpoint_group(self, signature: Hashable) -> None:
        """Crash-warmness pass after an insert: park spill *copies* of
        resident elements (payloads stay in RAM — re-demotion is then free
        and a crash restart rebuilds the index from the manifests).
        ``write_through`` covers the inserted signature every time;
        ``checkpoint`` sweeps every signature each ``checkpoint_every``-th
        insert.  Spill failures degrade (see :meth:`_spill_elem`), never
        raise — crash-warmness is best-effort by design."""
        if self.spill is None or self.spill_mode is None or self.degraded:
            return
        if self.spill_mode == "write_through":
            todo = self._elements.get(signature, ())
        else:
            self._inserts_since_checkpoint += 1
            if self._inserts_since_checkpoint < self.checkpoint_every:
                return
            self._inserts_since_checkpoint = 0
            todo = self.elements()
        for e in list(todo):
            if e.data is None or e.spill is not None or not self.spill.spillable(e):
                continue
            if self._spill_elem(e):
                self.writethrough_bytes += int(e.data.nbytes)
            elif self.degraded:
                return  # the tier just failed out from under us; stop paying it

    # -- internals -----------------------------------------------------------
    def _merge_group(self, signature: Hashable, usable_fn: Optional[UsableFn]) -> None:
        """Combine elements with identical projections and touching windows
        (validity re-checked through ``usable_fn`` so merged rows agree).

        Only RESIDENT pairs merge: merging a demoted element would force a
        promotion on every insert, and leaving it un-merged is always
        correct — the greedy planner handles overlapping elements."""
        elems = self._elements.get(signature, [])
        by_cols: Dict[Tuple[str, ...], List[CacheElement]] = {}
        for e in elems:
            by_cols.setdefault(e.columns, []).append(e)
        out: List[CacheElement] = []
        for cols, group in by_cols.items():
            merged = True
            while merged and len(group) > 1:
                merged = False
                for i in range(len(group)):
                    for j in range(i + 1, len(group)):
                        a, b = group[i], group[j]
                        if (
                            a.data is not None
                            and b.data is not None
                            and self._touches(a.window, b.window)
                        ):
                            group.pop(j)
                            group.pop(i)
                            group.append(self._merge_pair(a, b, usable_fn))
                            # the sides' spill copies (if any) no longer
                            # describe a live element — GC them (device
                            # pins were dropped by _merge_pair after
                            # replicating into the merged element)
                            self._drop_spill_entry(a)
                            self._drop_spill_entry(b)
                            merged = True
                            break
                    if merged:
                        break
            out.extend(group)
        # a merge of two fully-invalidated elements leaves an empty window;
        # such an element can never serve anything again — drop it
        dropped = [e for e in out if e.window.empty]
        for e in dropped:
            self._drop_spill_entry(e)
            self._drop_device(e)
        self._elements[signature] = [e for e in out if not e.window.empty]

    @staticmethod
    def _touches(a: IntervalSet, b: IntervalSet) -> bool:
        for ia in a:
            for ib in b:
                if ia.touches(ib):
                    return True
        return False

    def _merge_pair(
        self, a: CacheElement, b: CacheElement, usable_fn: Optional[UsableFn]
    ) -> CacheElement:
        with self.tracer.span("cache.merge", signature=str(a.signature)[:16]) as sp:
            out = self._merge_pair_inner(a, b, usable_fn)
            sp.attrs["bytes"] = out.nbytes
        return out

    def _merge_pair_inner(
        self, a: CacheElement, b: CacheElement, usable_fn: Optional[UsableFn]
    ) -> CacheElement:
        # The two sides may have been assembled under DIFFERENT snapshots, so
        # each contributes only its usable window under the current one —
        # merging raw windows would let rows from dropped fragments (or
        # windows missing newly added rows) survive inside the merged
        # element with pins that make them look valid.  Inside the usable
        # overlap the rows are identical (same live fragments), so take b
        # only where a does not already cover.
        a_use = usable_fn(a) if usable_fn is not None else a.window
        b_use = usable_fn(b) if usable_fn is not None else b.window
        b_only = b_use.difference(a_use)
        window = a_use.union(b_use)
        parts = a.slice_window(a_use, a.columns) + b.slice_window(b_only, b.columns)
        if parts:
            data = concat_tables(parts).sort_by(a.sort_key)
        else:
            data = a.data.slice(0, 0)
        # keep only pins that back rows a side actually CONTRIBUTED: a pin of
        # a's for a region a did not contribute (its usable window excluded
        # it — e.g. the fragment was dropped by a newer snapshot) must not
        # survive into the merged element, or it would keep re-invalidating
        # a window whose rows b just recomputed against the live fragments —
        # the merged element could then never serve that window again
        merged: Dict[str, FragmentPin] = {}
        for p in a.pins:
            if a_use.intersects(IntervalSet([p.window])):
                merged[p.fragment_id] = p
        for p in b.pins:
            if b_use.intersects(IntervalSet([p.window])):
                merged.setdefault(p.fragment_id, p)
        pins = tuple(merged.values())
        self._clock += 1
        out = CacheElement(
            elem_id=next(_ID),
            table=a.table,
            sort_key=a.sort_key,
            columns=a.columns,
            window=window,
            pins=pins,
            data=data,
            last_used=self._clock,
            signature=a.signature,
            # merged bytes stay attributed to the side that inserted first;
            # exact split accounting is not worth tracking per-row owners
            owner=a.owner if a.owner is not None else b.owner,
        )
        if self.device is not None:
            # rebuild the merged payload's device copy by gathering from the
            # parents' pins (device→device, zero H2D) — a warm jax loop then
            # keeps hitting device across merges, uploading only residuals.
            # Best-effort: with either parent unpinned the merged element
            # just re-pins lazily on its next device consumer.
            self.device.replicate_merge(a, b, out, a_use, b_only)
            self._drop_device(a)
            self._drop_device(b)
        return out

    def _drop_device(self, elem: CacheElement) -> None:
        """Forget an element's device pins (it merged away or left the
        index).  Demotion to spill does NOT drop pins — the payload's
        values are unchanged, so the device copy stays valid and a demoted
        element can still serve jax consumers without a re-upload."""
        if self.device is not None:
            self.device.drop_element(elem.elem_id)

    def _drop_spill_entry(self, elem: CacheElement) -> None:
        """GC an element's spill objects (it is leaving the index, or its
        spill copy no longer describes a live element)."""
        if elem.spill is not None and self.spill is not None:
            self.spill.drop(elem.spill)
            elem.spill = None

    def _quarantine_element(self, elem: CacheElement) -> None:
        """Remove an element whose spilled payload failed verification: GC
        its spill objects (``spill_quarantined``), forget its device pins,
        and drop it from the index so no later plan can choose it.  Its
        window simply recomputes as a miss — corrupt bytes are never
        served."""
        self.plan_quarantines += 1
        if elem.spill is not None and self.spill is not None:
            self.spill.quarantine(elem.spill)
            elem.spill = None
        group = self._elements.get(elem.signature)
        if group is not None and elem in group:
            group.remove(elem)
        self._drop_device(elem)

    def _spill_elem(self, elem: CacheElement) -> bool:
        """One guarded spill write: counts consecutive failures and flips the
        store into ``degraded`` (RAM-only) past the threshold.  Returns
        whether the element now has a spill copy."""
        try:
            elem.spill = self.spill.spill(elem)
        except Exception:
            self._spill_failures += 1
            self.metrics.counter("spill_write_failures").inc()
            if (
                not self.degraded
                and self._spill_failures >= self.spill_failure_threshold
            ):
                self.degraded = True
                self.metrics.gauge("cache_degraded").set(1)
            return False
        self._spill_failures = 0
        return True

    def _demote(self, elem: CacheElement) -> None:
        """Move ``elem``'s payload out of the RAM tier.  With a spill tier
        (and a spillable element) the payload is parked as an IPC file — or
        simply dereferenced when a clean spill copy already exists; without
        one — or once the spill tier is ``degraded`` — the element is dropped
        entirely (the pre-spill behavior).

        Always safe for concurrent readers: handed-out slices are views over
        immutable buffers that outlive the store's reference."""
        if (
            self.spill is not None
            and not (self.degraded and elem.spill is None)
            and (elem.spill is not None or self.spill.spillable(elem))
        ):
            if elem.spill is None and not self._spill_elem(elem):
                # the tier refused the payload: fall back to dropping (the
                # degradation ladder, not an error — the run goes on)
                self._elements[elem.signature].remove(elem)
                self._drop_spill_entry(elem)
                self._drop_device(elem)
                return
            elem.data = None
            self.demotions += 1
        else:
            self._elements[elem.signature].remove(elem)
            self._drop_spill_entry(elem)
            self._drop_device(elem)

    def _evict(self, protect: frozenset = frozenset()) -> None:
        if self.max_bytes is None:
            return
        # LRU over RESIDENT elements only — demoted ones hold no RAM
        while self.nbytes > self.max_bytes:
            resident = [
                e for e in self.elements()
                if e.data is not None and e.elem_id not in protect
            ]
            if not resident:
                return
            victim = min(resident, key=lambda e: e.last_used)
            self._demote(victim)
            self.evictions += 1


class DifferentialCache(DifferentialStore):
    """The paper's differential *scan* cache: a :class:`DifferentialStore`
    whose signatures are table names, whose validity policy is fragment-pin
    invalidation against the scan's snapshot, and whose cost bound is the
    physical bytes a residual scan would move from object storage."""

    def usable_window(self, elem: CacheElement, snapshot: Snapshot) -> IntervalSet:
        """Differential invalidation (design choice 3) — see
        :func:`snapshot_usable_window`."""
        return snapshot_usable_window(elem, snapshot)

    def plan(
        self,
        scan: Scan,
        snapshot: Snapshot,
        sort_key: str,
        tenant: Optional[str] = None,
        device_consumer: bool = False,
    ) -> CachePlan:
        phys = scan.physical_columns(sort_key)
        return self.plan_window(
            signature=scan.table,
            window=scan.window,
            columns=phys,
            cost_fn=lambda w: scan_cost_bytes(snapshot, w, phys),
            usable_fn=lambda e: snapshot_usable_window(e, snapshot),
            tenant=tenant,
            device_consumer=device_consumer,
        )

    def insert(
        self,
        scan: Scan,
        snapshot: Snapshot,
        sort_key: str,
        window: IntervalSet,
        data: Table,
        tenant: Optional[str] = None,
        device_arrays: Optional[Dict] = None,
    ) -> Optional[CacheElement]:
        """Store a freshly fetched residual as a new element, then merge."""
        pins = pins_for(snapshot, window)
        return self.insert_window(
            signature=scan.table,
            table=scan.table,
            sort_key=sort_key,
            window=window,
            data=data,
            pins=pins,
            usable_fn=lambda e: snapshot_usable_window(e, snapshot),
            tenant=tenant,
            device_arrays=device_arrays,
        )

    def invalidate_table(self, table: str) -> None:
        self.invalidate(table)
