"""The process-wide differential store behind the multi-tenant service.

A :class:`~repro_torch.core.cache.DifferentialStore` already carries the locking
discipline (callers plan+slice and insert under ``store.lock``), a global
LRU byte budget and the optional spill tier.  :class:`SharedStore` adds what
a *service* needs on top:

- **tenant attribution** — every inserted element records the tenant that
  paid for its bytes (``CacheElement.owner``); hits against another tenant's
  elements are counted as *cross-tenant reuse*, the paper's headline win of
  a cache "shared transparently across users, schemas and time windows";
- **per-tenant byte quotas** — a tenant over its (RAM-tier) quota loses its
  own least-recently-used elements first, so one heavy tenant cannot starve
  the others out of the global budget (with a spill tier the loser's bytes
  demote to object storage rather than vanish);
- **per-signature reader counts** — an in-flight run holds a read pin on the
  signature group it executes against (:meth:`reading`); pinned groups are
  exempt from every eviction path, so a concurrent tenant's insert can never
  reclaim the group mid-run;
- **signature-liveness eviction** — signatures no plan has referenced for
  ``liveness_runs`` runs are reclaimed wholesale, spill copies included
  (ROADMAP (e): elements under superseded code versions used to linger
  until the byte budget happened to push them out);
- **in-flight residual coalescing** — when two concurrent runs plan the same
  ``(signature, window)`` residual, the second *subscribes* to the first's
  in-flight claim (:meth:`claim_residual`) instead of recomputing: it waits,
  replans, and is served the winner's freshly inserted element.  Without
  this, both of BENCH_4's ``widened`` tenants paid the identical residual.

Thread safety: every public method takes the store's reentrant lock, and the
executors that share the store hold the same lock across their plan+slice
and insert critical sections, so plans never reference merged-away or
evicted elements ("no torn reads").  Claim waits happen with NO lock held.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cache import (
    CacheElement,
    CachePlan,
    DifferentialCache,
    DifferentialStore,
    UsableFn,
)
from repro_torch.core.columnar import Table
from repro_torch.core.intervals import IntervalSet
from repro_torch.core.spill import SpillTier
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.obs.metrics import MetricAttr, Metrics
from repro_torch.obs.trace import Tracer

__all__ = ["SharedStore", "SharedScanCache", "ResidualClaim"]


@dataclass
class ResidualClaim:
    """One in-flight residual computation: ``(signature, kind, window,
    columns, snapshot)`` plus the event concurrent planners of an
    overlapping residual wait on.

    ``kind`` names the claim's addressing contract — ``"scan"`` for leaf
    scans, ``"rowwise"``/``"keyed"`` for model residuals (``"window"`` is
    the legacy default).  Two claims only coalesce within one kind: a keyed
    residual's window is in key-group space and a rowwise one's in row
    space, so a window overlap between different kinds is a coordinate
    coincidence, not the same computation."""

    signature: Hashable
    window: IntervalSet
    columns: frozenset
    thread: int
    snapshot_id: Optional[str] = None
    kind: str = "window"
    event: threading.Event = field(default_factory=threading.Event)
    # lease clock: claims older than the store's claim_timeout are treated
    # as dead (owner crashed / hung) and may be taken over by a planner
    created: float = field(default_factory=time.monotonic)


class SharedStore(DifferentialStore):
    """A :class:`DifferentialStore` hardened for concurrent multi-tenant use.

    ``tenant_quota_bytes`` is either one uniform per-tenant cap or a
    ``{tenant: cap}`` mapping (missing tenants are uncapped).  Budgets are
    *soft* while signatures hold read pins: bytes pinned by in-flight runs
    are never reclaimed, so the store can transiently exceed its budgets by
    the pinned working set.
    """

    # service observability (surfaced in ServiceReport / BENCH_4/5);
    # registry-backed — see DifferentialStore's counters
    liveness_evictions = MetricAttr("cache_liveness_evictions")
    quota_evictions = MetricAttr("cache_quota_evictions")
    cross_tenant_hits = MetricAttr("cache_cross_tenant_hits")
    cross_tenant_rows = MetricAttr("cache_cross_tenant_rows")
    coalesced_waits = MetricAttr("coalesced_waits")
    claim_timeouts = MetricAttr("claim_timeouts")  # dead claims taken over

    def __init__(
        self,
        max_bytes: Optional[int] = None,
        liveness_runs: Optional[int] = None,
        tenant_quota_bytes: Optional[Union[int, Dict[str, int]]] = None,
        spill: Optional[SpillTier] = None,
        spill_root: Optional[str] = None,
        coalesce: bool = True,
        device=None,
        claim_timeout: float = 60.0,
        metrics: Optional[Metrics] = None,
        metrics_labels: Optional[Dict[str, str]] = None,
        tracer: Optional[Tracer] = None,
        spill_mode: Optional[str] = None,
        checkpoint_every: int = 8,
        spill_failure_threshold: int = 3,
    ):
        # spill_root is the standalone convenience: a directory-backed
        # object store owned by this SharedStore.  Services pass `spill`
        # (a tier over THEIR object store) so spill traffic lands on the
        # same ledger as everything else.
        if spill is None and spill_root is not None:
            spill = SpillTier(ObjectStore(spill_root))
        super().__init__(
            max_bytes=max_bytes,
            spill=spill,
            device=device,
            metrics=metrics,
            metrics_labels=metrics_labels,
            tracer=tracer,
            spill_mode=spill_mode,
            checkpoint_every=checkpoint_every,
            spill_failure_threshold=spill_failure_threshold,
        )
        self.liveness_runs = liveness_runs
        self.tenant_quota_bytes = tenant_quota_bytes
        self.coalesce = coalesce
        # max seconds a residual claim may stay unreleased before planners
        # treat the owner as dead; also the executors' per-round wait bound
        self.claim_timeout = float(claim_timeout)
        self._readers: Dict[Hashable, int] = {}  # signature -> active readers
        self._last_seen: Dict[Hashable, int] = {}  # signature -> run_seq
        self._claims: Dict[Hashable, List[ResidualClaim]] = {}
        self.run_seq = 0

    # -- run lifecycle -------------------------------------------------------
    def begin_run(self) -> None:
        """Called once per pipeline run (the executor's hook).  Advances the
        liveness clock and reclaims signature groups absent from any plan or
        insert for ``liveness_runs`` runs — unless a reader pins them."""
        with self.lock:
            self.run_seq += 1
            if self.liveness_runs is None:
                return
            horizon = self.run_seq - self.liveness_runs
            for sig in list(self._elements):
                if self._readers.get(sig):
                    continue
                if self._last_seen.setdefault(sig, self.run_seq) <= horizon:
                    self.liveness_evictions += len(self._elements[sig])
                    # a liveness-dead signature is reclaimed from BOTH tiers
                    # (else a restart would resurrect zombie code versions)
                    self.invalidate(sig)
                    self._last_seen.pop(sig, None)

    @contextmanager
    def reading(self, signature: Hashable):
        """Pin ``signature`` for the duration of a run's node execution: no
        eviction path (LRU, quota, liveness) may reclaim a pinned group."""
        with self.lock:
            self._readers[signature] = self._readers.get(signature, 0) + 1
        try:
            yield
        finally:
            with self.lock:
                n = self._readers.get(signature, 1) - 1
                if n > 0:
                    self._readers[signature] = n
                else:
                    self._readers.pop(signature, None)

    # -- residual coalescing -------------------------------------------------
    def claim_residual(
        self,
        signature: Hashable,
        window: IntervalSet,
        columns: Sequence[str] = (),
        snapshot_id: Optional[str] = None,
        kind: str = "window",
    ) -> Tuple[Optional[ResidualClaim], Optional[threading.Event]]:
        """Atomically either claim ``(signature, kind, window)`` for this
        run or subscribe to an overlapping in-flight claim.

        Returns ``(claim, None)`` when this caller now owns the residual
        (it MUST call :meth:`release_residual` when the computed rows are
        inserted — or on failure), or ``(None, event)`` when another run is
        already computing an overlapping residual of the SAME kind whose
        columns cover this caller's AND whose snapshot matches: wait on the
        event (with no lock held), then REPLAN — the winner's insert turns
        the overlap into cache hits.  A snapshot mismatch never subscribes:
        the owner's rows would fail the subscriber's fragment-pin check
        anyway, so waiting could only add latency.  A *kind* mismatch never
        subscribes either — claim windows of different contracts live in
        different coordinate spaces (row windows vs key-group ranges), so
        an overlap between kinds is meaningless and waiting on one would
        coalesce two unrelated computations.  With coalescing disabled the
        call is a no-op ``(None, None)``: no claim is registered and
        callers skip the release entirely.

        Callers invoke this under ``store.lock`` in the same critical
        section as the plan, so two planners of the same residual serialize:
        exactly one claims, the rest subscribe.
        """
        if not self.coalesce:
            return None, None
        with self.lock:
            # lease expiry: a claim unreleased for claim_timeout seconds is
            # dead (its owner crashed or hung past the wait bound).  Retire
            # it and wake its subscribers — they replan with the dead claim
            # gone, so the first one through takes the residual over.
            lst = self._claims.get(signature)
            if lst is not None:
                now = time.monotonic()
                for c in [c for c in lst if now - c.created > self.claim_timeout]:
                    lst.remove(c)
                    self.claim_timeouts += 1
                    c.event.set()
                if not lst:
                    del self._claims[signature]
            need = frozenset(columns)
            me = threading.get_ident()
            for c in self._claims.get(signature, ()):
                if (
                    c.thread != me
                    and c.kind == kind
                    and c.snapshot_id == snapshot_id
                    and need.issubset(c.columns)
                    and c.window.intersects(window)
                ):
                    self.coalesced_waits += 1
                    return None, c.event
            claim = ResidualClaim(
                signature,
                window,
                frozenset(columns),
                threading.get_ident(),
                snapshot_id,
                kind,
            )
            self._claims.setdefault(signature, []).append(claim)
            return claim, None

    def release_residual(self, claim: ResidualClaim) -> None:
        """Retire a claim (rows inserted, or the computation failed) and wake
        every subscriber — they replan against the store's new state."""
        with self.lock:
            lst = self._claims.get(claim.signature)
            if lst is not None:
                try:
                    lst.remove(claim)
                except ValueError:  # pragma: no cover - double release
                    pass
                if not lst:
                    del self._claims[claim.signature]
        claim.event.set()

    # -- store surface (tenant-aware) ---------------------------------------
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
        with self.lock:
            self._last_seen[signature] = self.run_seq
            plan = super().plan_window(
                signature,
                window,
                columns,
                cost_fn,
                usable_fn,
                tenant=tenant,
                device_consumer=device_consumer,
            )
            if tenant is not None:
                for hit in plan.hits:
                    owner = hit.element.owner
                    if owner is not None and owner != tenant:
                        self.cross_tenant_hits += 1
                        self.cross_tenant_rows += self._hit_rows(hit)
            return plan

    @staticmethod
    def _hit_rows(hit) -> int:
        """Exact rows a hit serves (window.measure() would count key extent,
        which is astronomically wrong for unbounded no-filter windows)."""
        keys = hit.element.data.column(hit.element.sort_key)
        return sum(
            int(np.searchsorted(keys, iv.hi, side="left"))
            - int(np.searchsorted(keys, iv.lo, side="left"))
            for iv in hit.window
        )

    def insert_window(
        self,
        signature: Hashable,
        table: str,
        sort_key: str,
        window: IntervalSet,
        data: Table,
        pins: Tuple = (),
        usable_fn: Optional[UsableFn] = None,
        tenant: Optional[str] = None,
        device_arrays: Optional[Dict] = None,
    ) -> Optional[CacheElement]:
        with self.lock:
            self._last_seen[signature] = self.run_seq
            elem = super().insert_window(
                signature,
                table,
                sort_key,
                window,
                data,
                pins,
                usable_fn,
                tenant=tenant,
                device_arrays=device_arrays,
            )
            self._enforce_tenant_quota(tenant)
            return elem

    # -- accounting ----------------------------------------------------------
    def tenant_bytes(self, tenant: str) -> int:
        with self.lock:
            return sum(e.nbytes for e in self.elements() if e.owner == tenant)

    def stats(self) -> Dict[str, int]:
        with self.lock:
            per_tenant: Dict[str, int] = {}
            for e in self.elements():  # one pass, not one per tenant
                if e.owner is not None:
                    per_tenant[e.owner] = per_tenant.get(e.owner, 0) + e.nbytes
            return {
                "nbytes": self.nbytes,
                "spill_nbytes": self.spill_nbytes,
                "elements": len(self.elements()),
                "lookups": self.lookups,
                "full_hits": self.full_hits,
                "partial_hits": self.partial_hits,
                "evictions": self.evictions,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "bytes_from_spill": self.bytes_from_spill,
                "spill_restored": self.spill_restored,
                "quota_evictions": self.quota_evictions,
                "liveness_evictions": self.liveness_evictions,
                "cross_tenant_hits": self.cross_tenant_hits,
                "cross_tenant_rows": self.cross_tenant_rows,
                "coalesced_waits": self.coalesced_waits,
                "claim_timeouts": self.claim_timeouts,
                # robustness ledger (repro_torch.lake.faults / integrity layer)
                "degraded": self.degraded,
                "spill_quarantined": self.spill.quarantined if self.spill else 0,
                "corruption_detected": self.spill.corruption if self.spill else 0,
                "writethrough_bytes": self.writethrough_bytes,
                "tenant_bytes": dict(sorted(per_tenant.items())),
                # device tier (zeros when no tier is attached)
                **(
                    self.device.stats()
                    if self.device is not None
                    else {
                        "device_nbytes": 0,
                        "device_entries": 0,
                        "bytes_h2d": 0,
                        "device_hits": 0,
                        "device_evictions": 0,
                        "device_pins": 0,
                        "bytes_replicated": 0,
                    }
                ),
            }

    # -- eviction ------------------------------------------------------------
    def _quota_for(self, tenant: Optional[str]) -> Optional[int]:
        if tenant is None:
            return None
        if isinstance(self.tenant_quota_bytes, dict):
            return self.tenant_quota_bytes.get(tenant)
        return self.tenant_quota_bytes

    def _enforce_tenant_quota(self, tenant: Optional[str]) -> None:
        quota = self._quota_for(tenant)
        if quota is None:
            return
        # one scan, then decrement while evicting — this runs under the
        # store-wide lock, so a per-victim rescan would stall every tenant.
        # Quotas bound the RAM tier: with a spill tier the victim's bytes
        # demote instead of vanishing (e.nbytes is 0 once demoted).
        owned_bytes = 0
        evictable: List[CacheElement] = []
        for e in self.elements():
            if e.owner != tenant or e.data is None:
                continue
            owned_bytes += e.nbytes
            if not self._readers.get(e.signature):
                evictable.append(e)
        evictable.sort(key=lambda e: e.last_used)  # LRU first
        for victim in evictable:
            if owned_bytes <= quota:
                return
            owned_bytes -= victim.nbytes
            self._demote(victim)
            self.quota_evictions += 1
            self.evictions += 1

    def _evict(self, protect: frozenset = frozenset()) -> None:
        # global LRU across ALL tenants, skipping read-pinned signatures and
        # the current plan's hits (called by the base class inside
        # insert_window and after promotions, lock already held); one scan
        # then decrement, like _enforce_tenant_quota
        if self.max_bytes is None:
            return
        total = 0
        evictable: List[CacheElement] = []
        for e in self.elements():
            if e.data is None:
                continue
            total += e.nbytes
            if not self._readers.get(e.signature) and e.elem_id not in protect:
                evictable.append(e)
        evictable.sort(key=lambda e: e.last_used)  # LRU first
        for victim in evictable:
            if total <= self.max_bytes:
                return
            total -= victim.nbytes
            self._demote(victim)
            self.evictions += 1


class SharedScanCache(SharedStore, DifferentialCache):
    """The service's *scan* cache: :class:`DifferentialCache` semantics
    (table-name signatures, fragment-pin invalidation, physical-byte cost)
    over the shared store's machinery.  Tenant sessions each own a
    :class:`~repro_torch.core.planner.ScanExecutor` but all executors share this
    one object — and therefore its lock, budget and liveness clock."""
