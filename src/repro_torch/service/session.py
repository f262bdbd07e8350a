"""Tenant sessions: a pinned view of the lake plus commit-retry writes.

A session is one tenant's execution context inside the service:

- **snapshot pinning (time travel per tenant)** — at creation the session
  freezes ``{table: snapshot_id}`` for the catalog's tables; every run
  executes against that frozen view regardless of commits landing meanwhile
  (an explicit ``Model(snapshot_id=…)`` in user code still wins).  Pins are
  an execution-time choice, not part of node signatures, so two sessions on
  different snapshots coexist in one shared store and serve each other's
  windows wherever their snapshots' fragments agree.
- **commit-retry for writing runs** — a run that materializes a model (or a
  session-level ``append``/``overwrite_range``) commits optimistically; when
  it loses the catalog CAS to a concurrent writer the
  :class:`~repro_torch.lake.catalog.CommitConflict` is caught here and the run is
  replayed.  Replays are cheap by construction: everything the lost attempt
  computed is already in the shared caches, so the retry pays only the
  residual created by the winning commit.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

from repro_torch.core.columnar import Table
from repro_torch.lake.catalog import CommitConflict, Snapshot
from repro_torch.pipeline.dsl import Project
from repro_torch.pipeline.executor import RunResult, Workspace

__all__ = ["TenantSession"]


class TenantSession:
    """One tenant's handle on the shared service state.

    ``workspace`` must be a :class:`Workspace` wired to the service's shared
    store/catalog/caches (see :meth:`PipelineService.session`); the session
    adds the tenant's snapshot pins and the retry discipline.  Runs through
    one session are serialized (one in-flight run per tenant) so the
    session's per-run ledger stays attributable.
    """

    def __init__(
        self,
        tenant_id: str,
        workspace: Workspace,
        pin_tables: bool = True,
        max_commit_retries: int = 5,
    ):
        self.tenant_id = tenant_id
        self.workspace = workspace
        self.max_commit_retries = max_commit_retries
        self.pins: Dict[str, str] = {}
        self.commit_conflicts = 0  # observability: lost CAS races, all retried
        # tiered-cache observability, aggregated across this tenant's runs:
        # payload bytes served by promoting spilled elements, and residuals
        # this tenant did NOT recompute because it subscribed to another
        # run's in-flight claim (see SharedStore.claim_residual)
        self.bytes_from_spill = 0
        self.coalesced_waits = 0
        self._run_lock = threading.Lock()
        if pin_tables:
            self.refresh_pins()

    # -- pin management ------------------------------------------------------
    def refresh_pins(self, tables: Optional[Iterable[str]] = None) -> None:
        """(Re-)freeze the session's view to the current snapshots.  Tables
        created after the last refresh are picked up; tables passed
        explicitly refresh selectively."""
        catalog = self.workspace.catalog
        for t in tables if tables is not None else catalog.list_tables():
            self.pins[t] = catalog.current_snapshot(t).snapshot_id

    def pin(self, table: str, snapshot_id: str) -> None:
        """Time travel: point the session's view of ``table`` at any
        historical snapshot."""
        self.pins[table] = snapshot_id

    # -- running -------------------------------------------------------------
    def run(self, project: Project, verbose: bool = False) -> RunResult:
        """Execute ``project`` against the session's pinned view, replaying
        on :class:`CommitConflict` (writing runs racing another tenant)."""
        tracer = self.workspace.tracer
        with self._run_lock:
            for attempt in range(self.max_commit_retries + 1):
                try:
                    with tracer.span(
                        "session.attempt",
                        tenant=self.tenant_id,
                        attempt=attempt,
                    ):
                        result = self.workspace.run(
                            project, verbose=verbose, snapshot_pins=self.pins
                        )
                except CommitConflict:
                    self.commit_conflicts += 1
                    self.workspace.metrics.counter(
                        "commit_conflicts", tenant=self.tenant_id
                    ).inc()
                    if attempt == self.max_commit_retries:
                        raise
                    continue
                self.bytes_from_spill += int(result.bytes_from_spill)
                self.coalesced_waits += int(result.coalesced_waits)
                # a writer reads its own commits: advance the pins of every
                # table this run materialized (same discipline as _write)
                published = [
                    f"models.{s.model}" for s in result.plan.steps if s.materialize
                ]
                if published:
                    self.refresh_pins(published)
                return result
        raise AssertionError("unreachable")

    # -- writing -------------------------------------------------------------
    def append(self, table: str, data: Table) -> Snapshot:
        """Optimistic append with retry; the session's pin follows its own
        write (a writer reads its own commits)."""
        return self._write(table, lambda expected: self.workspace.catalog.append(
            table, data, expected_parent=expected
        ))

    def overwrite_range(
        self, table: str, lo: int, hi: int, data: Optional[Table] = None
    ) -> Snapshot:
        return self._write(table, lambda expected: self.workspace.catalog.overwrite_range(
            table, lo, hi, data, expected_parent=expected
        ))

    def _write(self, table: str, commit_fn) -> Snapshot:
        catalog = self.workspace.catalog
        for attempt in range(self.max_commit_retries + 1):
            expected = catalog.current_snapshot(table).snapshot_id
            try:
                snap = commit_fn(expected)
            except CommitConflict:
                self.commit_conflicts += 1
                if attempt == self.max_commit_retries:
                    raise
                continue
            if table in self.pins:
                self.pins[table] = snap.snapshot_id
            return snap
        raise AssertionError("unreachable")
