"""The FaaS control plane: admission queue + worker pool over shared state.

:class:`PipelineService` is the process that the paper's setting implies but
the single-user :class:`~repro_torch.pipeline.executor.Workspace` could not
express: many data scientists submit pipeline runs against one lakehouse,
and the service executes them concurrently over ONE object store, ONE
catalog, ONE differential scan cache and ONE differential model store — so
a window one tenant paid to compute is served for free to every other
tenant whose plan subtracts it.

Scheduling discipline:

- **bounded in-flight runs** — ``workers`` threads is the concurrency cap;
  ``max_queued`` (optional) bounds admission, rejecting with
  :class:`QueueFull` beyond it;
- **per-tenant fairness** — runnable tenants are served round-robin, one
  in-flight run per tenant (which also keeps each session's ledger
  attributable), so a tenant submitting 100 runs cannot starve one
  submitting 1;
- **run states** — ``QUEUED → RUNNING → DONE | FAILED`` on the
  :class:`RunHandle`; ``FAILED`` carries the exception (after the session's
  commit-retry budget is exhausted, for writing runs).

In the port every tenant workspace runs its torch-runtime nodes on one
``torch_device``: the CUDA card unless the caller asks for the CPU.  A
shared device tier is attached through the stores, before the first
session: ``svc.scan_cache.device = svc.model_store.device = tier``; each
tenant workspace then adopts it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Union

from repro_torch.lake.catalog import Catalog
from repro_torch.lake.faults import FaultPlan, FaultyObjectStore, RetryPolicy
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.obs import Metrics, Tracer, get_tracer
from repro_torch.pipeline.dsl import Project
from repro_torch.pipeline.executor import RunResult, Workspace
from repro_torch.core.device import resolve_device
from repro_torch.core.spill import SpillTier
from repro_torch.service.session import TenantSession
from repro_torch.service.store import SharedScanCache, SharedStore

__all__ = ["PipelineService", "RunHandle", "ServiceReport", "QueueFull",
           "QUEUED", "RUNNING", "DONE", "FAILED"]

QUEUED, RUNNING, DONE, FAILED = "QUEUED", "RUNNING", "DONE", "FAILED"


class QueueFull(RuntimeError):
    """Admission rejected: the service's queue is at ``max_queued``."""


def _is_transient(exc: Optional[BaseException]) -> bool:
    """Is this failure rooted in a retryable store error?  Walks the cause/
    context chain for the duck-typed ``retryable`` marker (see
    :class:`~repro_torch.lake.s3sim.TransientStoreError`) — a giveup surfaces
    wrapped in whatever layer it unwound through, so the root, not the
    surface type, carries the classification."""
    seen: set = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if getattr(exc, "retryable", False):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


@dataclass
class RunHandle:
    """One submitted pipeline run; the service's unit of scheduling."""

    run_id: int
    tenant: str
    project: Project
    state: str = QUEUED
    result: Optional[RunResult] = None
    error: Optional[BaseException] = None
    wall_seconds: float = 0.0
    # graceful-degradation ledger: how many attempts this run took, and the
    # user-function rows each attempt fed (a transient retry against the
    # cache the failed attempt partially warmed feeds strictly fewer rows)
    attempts: int = 0
    attempt_fresh_rows: List[int] = field(default_factory=list)
    # admission timestamp (perf_counter_ns, comparable across threads):
    # the worker that dequeues this handle turns it into the queue-wait
    # histogram observation and trace span
    admit_ns: int = 0
    _done: threading.Event = field(default_factory=threading.Event, repr=False)

    def wait(self, timeout: Optional[float] = None) -> "RunHandle":
        if not self._done.wait(timeout):
            raise TimeoutError(f"run {self.run_id} still {self.state}")
        return self

    @property
    def done(self) -> bool:
        return self._done.is_set()


@dataclass
class ServiceReport:
    """What the service did: per-run ledgers plus cross-tenant reuse."""

    runs: List[Dict[str, Any]]
    tenants: Dict[str, Dict[str, int]]
    model_store: Dict[str, Any]
    scan_cache: Dict[str, Any]
    commit_conflicts: int
    # the service's live metrics registry (repro_torch.obs.Metrics) — the single
    # source the per-store stats above are derived from
    metrics: Optional[Any] = None

    def metrics_text(self) -> str:
        """Prometheus text exposition of the service's whole registry —
        both stores, their spill/device tiers, the queue and the run loop."""
        if self.metrics is None:
            return ""
        return self.metrics.to_text()

    def to_json(self) -> Dict[str, Any]:
        return {
            "runs": self.runs,
            "tenants": self.tenants,
            "model_store": self.model_store,
            "scan_cache": self.scan_cache,
            "commit_conflicts": self.commit_conflicts,
        }


class PipelineService:
    """A multi-tenant pipeline service over one shared differential cache.

    ``tenant_quota_bytes`` / ``model_cache_bytes`` / ``scan_cache_bytes``
    bound the shared stores' RAM tiers (global LRU spans tenants);
    ``liveness_runs`` reclaims signatures absent from any plan for that many
    runs.  ``spill=True`` backs both stores with IPC spill tiers under the
    service's object store: eviction demotes instead of dropping, capacity
    exceeds RAM, and a new service over the same root starts warm (clean
    shutdown flushes every resident element).  ``coalesce`` (default on)
    makes concurrent runs planning the same residual compute it exactly
    once.  Use as a context manager or call :meth:`shutdown`.

    Chaos/robustness knobs: ``fault_plan`` swaps in a fault-injecting store
    (``repro_torch.lake.faults``), ``store_retry`` bounds per-request retries
    below every consumer, ``max_run_attempts`` + ``run_retry`` retry whole
    transient-failed runs with backoff (exhausted runs are quarantined),
    and ``spill_mode`` ("write_through" | "checkpoint") makes the spill
    tiers crash-warm instead of flush-on-shutdown-warm.  Startup recovers
    the catalog's publish journal (``journal_recovery`` holds the tally).

    ``torch_device`` is where every tenant's torch-runtime nodes run (the
    CUDA card by default).  It is resolved here, so a service asked for the
    card on a machine without one raises at construction, not later in a
    worker thread.
    """

    def __init__(
        self,
        root: str,
        workers: int = 4,
        rows_per_fragment: int = 1 << 16,
        *,
        scan_cache_bytes: Optional[int] = None,
        model_cache_bytes: Optional[int] = None,
        tenant_quota_bytes: Optional[Union[int, Dict[str, int]]] = None,
        liveness_runs: Optional[int] = None,
        max_queued: Optional[int] = None,
        max_commit_retries: int = 5,
        max_run_history: int = 4096,
        spill: bool = False,
        coalesce: bool = True,
        enforce_scopes: bool = False,
        claim_timeout: float = 60.0,
        tracer: Optional[Tracer] = None,
        fault_plan: Optional[FaultPlan] = None,
        store_retry: Optional[RetryPolicy] = None,
        max_run_attempts: int = 1,
        run_retry: Optional[RetryPolicy] = None,
        spill_mode: Optional[str] = None,
        torch_device=None,
    ):
        self.torch_device = resolve_device(torch_device)
        # chaos wiring: a FaultPlan swaps in the fault-injecting store (its
        # default RetryPolicy absorbs transients below every consumer);
        # store_retry also applies to plain stores (flaky real backends)
        if fault_plan is not None:
            self.store: ObjectStore = FaultyObjectStore(
                root, plan=fault_plan, retry=store_retry
            )
        else:
            self.store = ObjectStore(root, retry=store_retry)
        self.catalog = Catalog(self.store, rows_per_fragment=rows_per_fragment)
        # ONE registry and tracer for the whole service: both shared stores,
        # their spill tiers, every tenant workspace and the queue all record
        # into it, so report().metrics_text() is one consistent scrape
        self.metrics = Metrics()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.store.metrics = self.metrics
        self.store.tracer = self.tracer
        self.catalog.metrics = self.metrics
        # restart recovery, before any traffic: roll forward / GC publish
        # intents a crashed predecessor left in the journal
        self.journal_recovery = self.catalog.recover_journal()
        # run-level degradation: transient-rooted failures are retried with
        # backoff up to max_run_attempts; runs still failing then are
        # quarantined (counted, FAILED) instead of wedging a worker
        self.max_run_attempts = int(max_run_attempts)
        self.run_retry = (
            run_retry
            if run_retry is not None
            else RetryPolicy(max_attempts=max(self.max_run_attempts, 1))
        )
        # spill tiers live behind the SERVICE's object store (under _spill/),
        # so spill traffic is on the same ledger as everything else and a
        # new service over the same root restores the tiers' manifests and
        # starts warm (clean shutdown demotes every resident element)
        self._spill_enabled = spill
        self.scan_cache = SharedScanCache(
            max_bytes=scan_cache_bytes,
            liveness_runs=liveness_runs,
            spill=SpillTier(self.store, prefix="_spill/scan") if spill else None,
            coalesce=coalesce,
            claim_timeout=claim_timeout,
            metrics=self.metrics,
            metrics_labels={"store": "scan"},
            tracer=self.tracer,
            spill_mode=spill_mode if spill else None,
        )
        self.model_store = SharedStore(
            max_bytes=model_cache_bytes,
            liveness_runs=liveness_runs,
            tenant_quota_bytes=tenant_quota_bytes,
            spill=SpillTier(self.store, prefix="_spill/model") if spill else None,
            coalesce=coalesce,
            claim_timeout=claim_timeout,
            metrics=self.metrics,
            metrics_labels={"store": "model"},
            tracer=self.tracer,
            spill_mode=spill_mode if spill else None,
        )
        self.max_queued = max_queued
        self.max_commit_retries = max_commit_retries
        # default admission policy for tenant sessions: an enforcing
        # service rejects, at plan time, any node whose plan requests
        # columns outside its verified/declared read scope — the entry
        # point for untrusted (e.g. agent-authored) pipelines.  Override
        # per session via session(..., untrusted=...)
        self.enforce_scopes = enforce_scopes
        self._sessions: Dict[str, TenantSession] = {}
        self._sessions_lock = threading.Lock()
        self._cond = threading.Condition()
        self._queues: Dict[str, Deque[RunHandle]] = {}
        self._rr: Deque[str] = deque()  # round-robin order over tenants
        self._active: set = set()  # tenants with an in-flight run
        self._queued_count = 0
        # a long-running service must not retain every RunHandle (each holds
        # the run's full output tables): completed handles leave _pending and
        # only a bounded, compact ledger survives for report()
        self._pending: List[RunHandle] = []
        self._run_log: Deque[Dict[str, Any]] = deque(maxlen=max_run_history)
        self._tenant_totals: Dict[str, Dict[str, int]] = {}
        self._seq = 0
        self._shutdown = False
        self._workers = [
            threading.Thread(target=self._worker, name=f"repro-service-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._workers:
            t.start()

    # -- sessions ------------------------------------------------------------
    def session(
        self,
        tenant_id: str,
        pin_tables: bool = True,
        untrusted: Optional[bool] = None,
    ) -> TenantSession:
        """The tenant's session, created (and its snapshots pinned) on first
        use.  All sessions share the service's store, catalog and caches —
        only pins and ledgers are per-tenant.  ``untrusted=True`` makes
        this tenant's workspace enforce read scopes at plan time
        regardless of the service default (``None`` inherits it)."""
        with self._sessions_lock:
            if tenant_id not in self._sessions:
                ws = Workspace(
                    self.store.root,
                    cache=self.scan_cache,
                    store=self.store,
                    catalog=self.catalog,
                    model_store=self.model_store,
                    tenant=tenant_id,
                    enforce_scopes=(
                        self.enforce_scopes if untrusted is None else untrusted
                    ),
                    metrics=self.metrics,
                    tracer=self.tracer,
                    torch_device=self.torch_device,
                )
                self._sessions[tenant_id] = TenantSession(
                    tenant_id,
                    ws,
                    pin_tables=pin_tables,
                    max_commit_retries=self.max_commit_retries,
                )
            return self._sessions[tenant_id]

    # -- submission ----------------------------------------------------------
    def submit(self, tenant_id: str, project: Project) -> RunHandle:
        """Queue a run for ``tenant_id``; returns immediately with a
        :class:`RunHandle` (``.wait()`` blocks until DONE/FAILED)."""
        with self._cond:
            if self._shutdown:
                raise RuntimeError("service is shut down")
            if self.max_queued is not None and self._queued_count >= self.max_queued:
                self.metrics.counter("queue_rejected", tenant=tenant_id).inc()
                raise QueueFull(
                    f"admission queue at max_queued={self.max_queued}"
                )
            self._seq += 1
            handle = RunHandle(
                run_id=self._seq,
                tenant=tenant_id,
                project=project,
                admit_ns=time.perf_counter_ns(),
            )
            self.metrics.counter("queue_submitted", tenant=tenant_id).inc()
            if tenant_id not in self._queues:
                self._queues[tenant_id] = deque()
                self._rr.append(tenant_id)
            self._queues[tenant_id].append(handle)
            self._queued_count += 1
            self._pending.append(handle)
            self._cond.notify()
        return handle

    def run(self, tenant_id: str, project: Project) -> RunResult:
        """Submit + wait; raises the run's error on failure."""
        handle = self.submit(tenant_id, project).wait()
        if handle.state == FAILED:
            raise handle.error
        return handle.result

    # -- worker loop ---------------------------------------------------------
    def _next_runnable(self) -> Optional[RunHandle]:
        """Round-robin pick: first tenant in rr order with queued work and no
        in-flight run; that tenant rotates to the back.  Caller holds _cond."""
        for _ in range(len(self._rr)):
            tenant = self._rr[0]
            self._rr.rotate(-1)
            if tenant not in self._active and self._queues.get(tenant):
                handle = self._queues[tenant].popleft()
                self._active.add(tenant)
                self._queued_count -= 1
                return handle
        return None

    def _worker(self) -> None:
        while True:
            with self._cond:
                handle = self._next_runnable()
                while handle is None:
                    if self._shutdown:
                        return
                    self._cond.wait()
                    handle = self._next_runnable()
                handle.state = RUNNING
            # the queue wait is recorded BEFORE the run span opens so it
            # lands as its own root interval (it is not part of the run)
            sched_ns = time.perf_counter_ns()
            if handle.admit_ns:
                self.metrics.histogram(
                    "queue_wait_seconds", tenant=handle.tenant
                ).observe((sched_ns - handle.admit_ns) / 1e9)
                self.tracer.add_span(
                    "service.queue_wait",
                    handle.admit_ns,
                    sched_ns,
                    tenant=handle.tenant,
                    run_id=handle.run_id,
                )
            t0 = time.perf_counter()
            try:
                self._execute(handle)
            finally:
                handle.wall_seconds = time.perf_counter() - t0
                self.metrics.counter(
                    "service_runs_total", state=handle.state
                ).inc()
                with self._cond:
                    self._active.discard(handle.tenant)
                    # retire the handle into the compact ledger; the caller's
                    # own reference (with .result) stays valid
                    self._run_log.append(self._summary(handle))
                    if handle.result is not None:
                        r = handle.result
                        t = self._tenant_totals.setdefault(
                            handle.tenant,
                            {"runs": 0, "bytes_from_store": 0,
                             "rows_to_user_fns": 0, "bytes_from_model_cache": 0,
                             "bytes_from_spill": 0, "coalesced_waits": 0},
                        )
                        t["runs"] += 1
                        t["bytes_from_store"] += int(r.bytes_from_store)
                        t["rows_to_user_fns"] += int(r.rows_to_user_fns)
                        t["bytes_from_model_cache"] += int(r.bytes_from_model_cache)
                        t["bytes_from_spill"] += int(r.bytes_from_spill)
                        t["coalesced_waits"] += int(r.coalesced_waits)
                    try:
                        self._pending.remove(handle)
                    except ValueError:  # pragma: no cover - defensive
                        pass
                    self._cond.notify_all()
                handle._done.set()

    def _execute(self, handle: RunHandle) -> None:
        """Run the handle to DONE or FAILED, retrying transient-rooted
        failures (a store giveup after its own retry budget) with backoff
        up to ``max_run_attempts``.  Each failed attempt's partial work is
        not wasted: residuals it inserted before dying are cache hits for
        the retry, which therefore feeds strictly fewer rows to the user
        functions.  A run still transient-failing at the budget is *poison*
        — counted ``runs_quarantined`` and FAILED, never requeued — so one
        wedged input cannot occupy a worker forever.  Deterministic
        failures (user bugs, contract violations) fail on attempt one."""
        rows_metric = lambda: self.metrics.total("residual_rows")
        while True:
            handle.attempts += 1
            rows0 = rows_metric()
            try:
                with self.tracer.span(
                    "service.run",
                    tenant=handle.tenant,
                    run_id=handle.run_id,
                    attempt=handle.attempts,
                ):
                    session = self.session(handle.tenant)
                    handle.result = session.run(handle.project)
                handle.attempt_fresh_rows.append(
                    int(handle.result.rows_to_user_fns)
                )
                handle.state = DONE
                return
            except BaseException as exc:  # a failed run must never kill a worker
                handle.attempt_fresh_rows.append(rows_metric() - rows0)
                transient = _is_transient(exc)
                if transient and handle.attempts < self.max_run_attempts:
                    self.metrics.counter("run_retries", tenant=handle.tenant).inc()
                    delay = self.run_retry.delay(handle.attempts)
                    with self.tracer.span(
                        "run.retry",
                        tenant=handle.tenant,
                        run_id=handle.run_id,
                        attempt=handle.attempts,
                    ) as sp:
                        sp.attrs["delay_s"] = round(delay, 6)
                        self.run_retry.sleep(delay)
                    continue
                if transient and self.max_run_attempts > 1:
                    self.metrics.counter(
                        "runs_quarantined", tenant=handle.tenant
                    ).inc()
                handle.error = exc
                handle.state = FAILED
                return

    @staticmethod
    def _summary(h: RunHandle) -> Dict[str, Any]:
        entry: Dict[str, Any] = {
            "run_id": h.run_id,
            "tenant": h.tenant,
            "state": h.state,
            "wall_seconds": round(h.wall_seconds, 6),
        }
        if h.attempts > 1:
            entry["attempts"] = h.attempts
        if h.result is not None:
            r = h.result
            entry.update(
                bytes_from_store=int(r.bytes_from_store),
                bytes_from_scan_cache=int(r.bytes_from_cache),
                bytes_from_model_cache=int(r.bytes_from_model_cache),
                bytes_from_spill=int(r.bytes_from_spill),
                rows_to_user_fns=int(r.rows_to_user_fns),
                coalesced_waits=int(r.coalesced_waits),
            )
        if h.error is not None:
            entry["error"] = repr(h.error)
        return entry

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted run has finished."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            pending = list(self._pending)
        for h in pending:
            h.wait(None if deadline is None else max(0.0, deadline - time.monotonic()))

    def shutdown(self, wait: bool = True) -> None:
        if wait:
            self.drain()
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        for t in self._workers:
            t.join(timeout=10)
        if wait and self._spill_enabled:
            # park every resident element in the spill tier so the NEXT
            # service over this root restores the full working set and
            # starts warm (crash restarts recover only what eviction
            # already demoted — flush-on-shutdown, not write-through)
            self.model_store.demote_all()
            self.scan_cache.demote_all()

    def __enter__(self) -> "PipelineService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=exc == (None, None, None))

    # -- reporting -----------------------------------------------------------
    def report(self) -> ServiceReport:
        """Completed runs come from the bounded ledger (oldest entries roll
        off past ``max_run_history``); queued/running runs are listed live."""
        with self._cond:
            runs = list(self._run_log) + [self._summary(h) for h in self._pending]
            tenants = {t: dict(v) for t, v in self._tenant_totals.items()}
        with self._sessions_lock:  # workers create sessions concurrently
            conflicts = sum(s.commit_conflicts for s in self._sessions.values())
        return ServiceReport(
            runs=runs,
            tenants=tenants,
            model_store=self.model_store.stats(),
            scan_cache=self.scan_cache.stats(),
            commit_conflicts=conflicts,
            metrics=self.metrics,
        )
