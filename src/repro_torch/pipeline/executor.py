"""The data-plane worker: an incremental re-execution engine.

Semantics from the paper (Fig. 2/3):

- system scans run through the shared :class:`ScanExecutor`, i.e. the
  differential cache, and feed user functions as columnar tables;
- model→model handoffs are in-memory and zero-copy;
- the ``torch`` runtime receives ``{column: torch.Tensor}`` on the
  workspace's device — the "second language" demonstrating that the cache
  sits *below* language choice;
- ``materialize=True`` publishes a model's output back to the catalog as an
  Iceberg-style table (a new snapshot), closing the loop for downstream DAGs.

Beyond the paper's leaf scans, the cache sits below EVERY node: a
:class:`Workspace` holds a second :class:`DifferentialStore` for intermediate
``@model`` outputs.  A node declared ``incremental="rowwise"`` (single- or
multi-input) or ``incremental="keyed"`` is planned exactly like a scan —

1. look up cache elements under the node's *signature* (code hash, runtime,
   upstream signatures — computed by ``compile_plan``);
2. serve the cached windows that are still valid under the current leaf
   snapshot (model elements pin the leaf fragments their rows were derived
   from, so append/overwrite invalidation reuses the scan machinery);
3. run the user function only on the *residual* window's rows;
4. UNION hit views + fresh rows zero-copy, store the residual back.

Multi-input rowwise nodes (incremental sort-merge joins) plan ONE joint
window — the intersection of their inputs' windows — and feed the function
the zip-aligned residual slice of EVERY input; their cache elements pin the
fragments of all leaf tables (labeled pins), so either side's append or
overwrite invalidates exactly the touched key ranges.  Keyed nodes
(per-key-group aggregations) reuse the identical machinery because key-range
windows can never split a key group: groups live at single key points, every
boundary the system produces (filter bounds, fragment key-min/max pins) is a
key-range bound, and residual inputs are re-read by key range — so a dirty
leaf fragment maps, via its key stats, to dirty *key groups*, each of which
is re-aggregated whole and UNION-merged with untouched cached groups.

Warm iteration cost is therefore proportional to the *edit* (rows whose
inputs actually changed), not to the pipeline: re-running an unchanged
project recomputes nothing; widening a window or appending upstream rows
recomputes only the delta; editing a function's code changes its signature
and (through signature chaining) recomputes it and its descendants from
scratch — automatically, with no user annotations beyond the contract.

A :class:`Workspace` bundles store+catalog+both caches and persists across
runs — the caches are shared by every user/pipeline in the workspace, which
is what makes the paper's multi-user §III-A workload work.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cache import (
    DifferentialCache,
    DifferentialStore,
    multi_pins_for,
    pins_for,
    snapshots_usable_window,
)
from repro_torch.core.columnar import ChunkedTable, Table, concat_tables
from repro_torch.core.device import DeviceTier, resolve_device, to_device
from repro_torch.core.intervals import NEG_INF, POS_INF, Interval, IntervalSet
from repro_torch.core.planner import ScanExecutor
from repro_torch.lake.catalog import Catalog, Snapshot
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.obs import Decision, Explainer, Metrics, RunExplanation, Tracer, get_tracer
from repro_torch.pipeline.dag import build_dag
from repro_torch.pipeline.dsl import Project
from repro_torch.pipeline.filters import parse_filter
from repro_torch.pipeline.physical import PhysicalPlan, SystemScanStep, UserFnStep, compile_plan

__all__ = ["Workspace", "RunResult", "run_project"]


@dataclass
class RunResult:
    outputs: Dict[str, Table]
    bytes_from_store: int
    bytes_from_cache: int
    simulated_seconds: float
    wall_seconds: float
    plan: PhysicalPlan
    # incremental-engine ledger: how much work the user functions actually did
    rows_to_user_fns: int = 0
    bytes_from_model_cache: int = 0
    node_stats: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # tiered-cache ledger: payload bytes promoted spill -> RAM for this run
    # (scan cache + model store), and residuals this run did NOT compute
    # because it subscribed to another run's in-flight claim
    bytes_from_spill: int = 0
    coalesced_waits: int = 0
    # device-tier ledger (all zero without a device tier / on numpy paths)
    bytes_h2d: int = 0  # host->device bytes this run uploaded
    bytes_d2h: int = 0  # device->host bytes (torch fn outputs landing back)
    device_hits: int = 0  # columns/pins served from resident device arrays
    device_evictions: int = 0  # tier entries LRU-demoted during this run
    gather_fast: int = 0  # fragment_gather block-run fast-path calls
    gather_fallbacks: int = 0  # non-RB-aligned gathers (RB=1)
    device_union_bytes: int = 0  # output bytes assembled on device
    # spill-tier mmap promotions: payload bytes page-faulted in from local
    # spill files instead of travelling through simulated GETs
    bytes_mmap: int = 0
    # the run's cache-decision trail (repro_torch.obs.explain.RunExplanation);
    # None when the workspace's explainer is disabled
    explanation: Optional[Any] = field(default=None, repr=False, compare=False)

    def explain(self) -> str:
        """One line per node/scan decision this run made — the action
        (serve/recompute) and the classified cause — plus the run's single
        highest-precedence primary cause."""
        if self.explanation is None:
            return "explainer disabled"
        return self.explanation.render()


class Workspace:
    """Long-lived execution context: one object store, one catalog, one
    differential scan cache, and one differential *model-output* store,
    shared by all users and languages."""

    def __init__(
        self,
        root: str,
        cache: Optional[Any] = None,
        rows_per_fragment: int = 1 << 16,
        model_cache_bytes: Optional[int] = None,
        *,
        store: Optional[ObjectStore] = None,
        catalog: Optional[Catalog] = None,
        model_store: Optional[DifferentialStore] = None,
        tenant: Optional[str] = None,
        enforce_scopes: bool = False,
        strict_contracts: bool = True,
        device: Optional[Any] = None,
        torch_device: Optional[Union[str, torch.device]] = None,
        metrics: Optional[Metrics] = None,
        tracer: Optional[Tracer] = None,
        explainer: Optional[Explainer] = None,
    ):
        # every collaborator is injectable so repro_torch.service can hand many
        # tenant workspaces ONE object store, ONE catalog, ONE scan cache and
        # ONE model store; defaults keep the single-user construction
        # (`Workspace(root)`) byte-for-byte identical to before
        if catalog is not None and rows_per_fragment != 1 << 16:
            raise ValueError(
                "rows_per_fragment applies to the workspace-built catalog; "
                "an injected catalog keeps its own"
            )
        if model_store is not None and model_cache_bytes is not None:
            raise ValueError(
                "model_cache_bytes applies to the workspace-built model "
                "store; an injected store keeps its own budget"
            )
        self.store = store if store is not None else ObjectStore(root)
        self.catalog = (
            catalog
            if catalog is not None
            else Catalog(self.store, rows_per_fragment=rows_per_fragment)
        )
        if catalog is None:
            # this workspace owns the catalog lifecycle, so restart recovery
            # is its job: resolve publish intents a crashed run left behind
            # (no-op — zero reads — when the journal is empty).  Injected
            # catalogs are recovered by their owner (the service).
            self.catalog.recover_journal()
        # ONE observability registry and tracer span the workspace: an
        # injected store's registry wins (the service wires every tenant
        # workspace to its shared one), so a single scrape covers the scan
        # cache, the model store, their spill/device tiers and the run loop
        self.metrics = (
            metrics
            or getattr(model_store, "metrics", None)
            or getattr(cache, "metrics", None)
            or Metrics()
        )
        self.tracer = (
            tracer
            or getattr(model_store, "tracer", None)
            or getattr(cache, "tracer", None)
            or get_tracer()
        )
        # the explainer is per-workspace by default: its cross-run signature
        # memory is keyed by node name, which is only meaningful within one
        # tenant's pipeline history
        self.explainer = explainer if explainer is not None else Explainer()
        self.scans = ScanExecutor(
            self.store,
            self.catalog,
            cache=(
                cache
                if cache is not None
                else DifferentialCache(
                    metrics=self.metrics,
                    metrics_labels={"store": "scan"},
                    tracer=self.tracer,
                )
            ),
            tenant=tenant,
            tracer=self.tracer,
            metrics=self.metrics,
            explainer=self.explainer,
        )
        # intermediate @model outputs, keyed by node signature; windows are
        # sort-key windows of the node's rowwise chain.  Plan+slice and
        # insert happen under the STORE's lock (not a per-workspace one) so
        # a concurrent run's insert — possibly through a different Workspace
        # sharing the store — can't merge/evict an element between planning
        # a hit and taking its views
        self.model_store = (
            model_store
            if model_store is not None
            else DifferentialStore(
                max_bytes=model_cache_bytes,
                metrics=self.metrics,
                metrics_labels={"store": "model"},
                tracer=self.tracer,
            )
        )
        self._model_lock = self.model_store.lock
        # device tier (repro_torch.core.device.DeviceTier): pass an instance,
        # or ``device=True`` for a default-budget tier on the CUDA card.  One
        # tier backs BOTH caches so scan hits and model-output hits share the
        # byte budget.  An injected store that already carries a tier keeps
        # it (service: many tenant workspaces over one device), and this
        # workspace adopts it so its executors see the same ledger.
        if device is True:
            device = DeviceTier()
        self.device = device
        if self.device is not None:
            if (
                isinstance(self.scans.cache, DifferentialStore)
                and self.scans.cache.device is None
            ):
                self.scans.cache.device = self.device
            if self.model_store.device is None:
                self.model_store.device = self.device
        else:
            self.device = getattr(self.model_store, "device", None) or getattr(
                self.scans.cache, "device", None
            )
        if self.device is not None:
            # the tier's spans (its uploads, the UNIONs that replicate a
            # merge) nest in this workspace's trace, not the process's
            self.device.adopt_obs(None, self.tracer)
        # torch-runtime nodes run where the tier pins; without a tier, on
        # ``torch_device`` — the CUDA card unless the caller asks for the CPU
        # (no card raises here rather than carrying on on the CPU)
        if self.device is not None:
            tier_device = self.device.device
            if torch_device is not None and resolve_device(torch_device) != tier_device:
                raise ValueError(
                    f"torch_device={torch_device!r} differs from the device "
                    f"tier's {tier_device}"
                )
            self.torch_device = tier_device
        else:
            self.torch_device = resolve_device(torch_device)
        self.tenant = tenant
        # plan-time scope enforcement (repro_torch.analysis): reject any plan
        # whose scans request columns outside the consumer's verified or
        # declared read scope BEFORE a single byte is read — the service
        # entry point for untrusted tenants.  strict_contracts=False
        # demotes static contract violations to warnings at DAG time.
        self.enforce_scopes = enforce_scopes
        self.strict_contracts = strict_contracts

    # -- running -------------------------------------------------------------
    def run(
        self,
        project: Project,
        verbose: bool = False,
        snapshot_pins: Optional[Dict[str, str]] = None,
    ) -> RunResult:
        """Execute ``project``.  ``snapshot_pins`` maps catalog table names to
        snapshot ids and applies wherever the user did not pin one explicitly
        (``Model(snapshot_id=…)`` wins) — tenant sessions use it to run every
        scan against the session's frozen view of the lake.  Pins are an
        execution-time choice, NOT part of node signatures: two tenants
        running the same DAG under different pins share cache elements
        wherever their snapshots' fragments agree (validity is re-checked
        per run through fragment pins).

        With an enabled tracer the ``run`` span covers the whole call
        (DAG, plan, scope check, nodes, roll-up) and records its store
        ``gets``; each ``node`` span records its own ``gets`` and
        ``bytes_read`` from the thread's store ledger."""
        with self.tracer.span("run", tenant=self.tenant or "") as run_sp:
            if not self.tracer.enabled:
                return self._run(project, verbose, snapshot_pins, run_sp)
            ledger = self.store.thread_stats()
            before = ledger.snapshot()
            result = self._run(project, verbose, snapshot_pins, run_sp)
            run_sp.attrs["gets"] = ledger.delta(before).get_requests
            return result

    def _run(
        self,
        project: Project,
        verbose: bool,
        snapshot_pins: Optional[Dict[str, str]],
        run_sp,
    ) -> RunResult:
        traced = self.tracer.enabled
        dag = build_dag(project, strict=self.strict_contracts)
        sort_keys = {
            t: self.catalog.table(t).sort_key
            for leaves in dag.scan_leaves.values()
            for _arg, ref in leaves
            for t in [ref.name]
        }
        plan = compile_plan(dag, sort_keys)
        run_sp.attrs["nodes"] = len(plan.steps)
        if self.enforce_scopes:
            self._enforce_scopes(dag, plan, sort_keys)
        if verbose:
            print(plan.describe())
        t0 = time.perf_counter()
        # thread-local ledger: exact per-run attribution even when many
        # service workers drive one shared object store concurrently
        ledger = self.store.thread_stats()
        before = ledger.snapshot()
        reports_before = len(self.scans.reports)
        dev_evictions_before = (
            self.device.device_evictions if self.device is not None else 0
        )
        # liveness tick: a shared store reclaims signatures no plan has
        # referenced for N runs (plain stores have no such hook).  The scan
        # cache ticks too — its "signatures" are table names, so tables no
        # run has scanned for N runs are reclaimed the same way
        for shared in (self.model_store, self.scans.cache):
            begin_run = getattr(shared, "begin_run", None)
            if begin_run is not None:
                begin_run()

        results: Dict[str, Table] = {}
        node_stats: Dict[str, Dict[str, int]] = {}
        # resolve each leaf table's snapshot ONCE per run: chained rowwise
        # nodes must plan against the same snapshot their upstream's rows
        # came from, or a commit landing mid-run would let a downstream node
        # pin fragments whose rows its input never contained
        leaf_snapshots: Dict[Tuple[str, Optional[str]], Snapshot] = {}
        pins = snapshot_pins or {}
        expl = self.explainer.begin_run(tenant=self.tenant)
        for step in plan.steps:
            fn = dag.project[step.model].fn
            with self.tracer.span(
                "node", model=step.model, incremental=step.incremental
            ) as node_sp:
                node_before = ledger.snapshot() if traced else None
                if step.incremental in ("rowwise", "keyed"):
                    out, stats = self._run_incremental(
                        step, plan, fn, results, leaf_snapshots, pins, expl
                    )
                else:
                    out, stats = self._run_full(
                        step, plan, fn, results, pins, expl
                    )
                results[step.model] = out
                node_stats[step.model] = stats
                if step.materialize:
                    # the leaf snapshot this run's rows were derived from
                    # is the publication's validity anchor (see
                    # _materialize); the single-leaf provenance property
                    # cannot describe a join, so multi-leaf nodes
                    # republish in full
                    leaf_snap = (
                        self._leaf_snapshot(step, leaf_snapshots, pins)
                        if step.incremental in ("rowwise", "keyed")
                        and len(step.leaf_pairs) == 1
                        else None
                    )
                    with self.tracer.span("publish", model=step.model):
                        self._materialize(step, out, leaf_snap)
                if traced:
                    d = ledger.delta(node_before)
                    node_sp.attrs["gets"] = d.get_requests
                    node_sp.attrs["bytes_read"] = d.bytes_read
        self.explainer.finish_run(expl)

        delta = ledger.delta(before)
        scan_reports = self.scans.reports[reports_before:]
        result = RunResult(
            outputs=results,
            bytes_from_store=delta.bytes_read,
            bytes_from_cache=sum(r.bytes_from_cache for r in scan_reports),
            simulated_seconds=delta.simulated_seconds,
            wall_seconds=time.perf_counter() - t0,
            plan=plan,
            rows_to_user_fns=sum(s["fresh_rows"] for s in node_stats.values()),
            bytes_from_model_cache=sum(
                s["model_cache_bytes"] for s in node_stats.values()
            ),
            node_stats=node_stats,
            bytes_from_spill=sum(
                s.get("bytes_from_spill", 0) for s in node_stats.values()
            )
            + sum(r.bytes_from_spill for r in scan_reports),
            coalesced_waits=sum(
                s.get("coalesced_waits", 0) for s in node_stats.values()
            )
            + sum(r.coalesced_waits for r in scan_reports),
            bytes_h2d=sum(s.get("bytes_h2d", 0) for s in node_stats.values())
            + sum(r.bytes_h2d for r in scan_reports),
            bytes_d2h=sum(s.get("bytes_d2h", 0) for s in node_stats.values()),
            device_hits=sum(s.get("device_hits", 0) for s in node_stats.values())
            + sum(r.device_hits for r in scan_reports),
            device_evictions=(
                self.device.device_evictions - dev_evictions_before
                if self.device is not None
                else 0
            ),
            gather_fast=sum(s.get("gather_fast", 0) for s in node_stats.values())
            + sum(r.gather_fast for r in scan_reports),
            gather_fallbacks=sum(
                s.get("gather_fallbacks", 0) for s in node_stats.values()
            )
            + sum(r.gather_fallbacks for r in scan_reports),
            device_union_bytes=sum(
                s.get("device_union_bytes", 0) for s in node_stats.values()
            )
            + sum(r.device_union_bytes for r in scan_reports),
            bytes_mmap=delta.bytes_mmap,
            explanation=expl if expl.enabled else None,
        )
        # run-level registry rollup: RunResult keeps exact per-run
        # attribution; these counters are the service-wide monotonic view
        # one Prometheus scrape can watch
        m, ten = self.metrics, self.tenant or ""
        m.counter("runs_total", tenant=ten).inc()
        m.counter("run_bytes_from_store", tenant=ten).inc(result.bytes_from_store)
        m.counter("run_bytes_from_cache", tenant=ten).inc(
            result.bytes_from_cache + result.bytes_from_model_cache
        )
        m.counter("run_rows_to_user_fns", tenant=ten).inc(result.rows_to_user_fns)
        m.counter("run_bytes_from_spill", tenant=ten).inc(result.bytes_from_spill)
        m.counter("run_coalesced_waits", tenant=ten).inc(result.coalesced_waits)
        m.counter("run_bytes_mmap", tenant=ten).inc(result.bytes_mmap)
        return result

    # -- plan-time scope enforcement ------------------------------------------
    def _enforce_scopes(self, dag, plan: PhysicalPlan, sort_keys) -> None:
        """Every scan's columns must lie inside the consuming node's
        verified/declared read scope (plus the table's sort key, which the
        platform attaches for windowing, and the filter's predicate
        columns, which the platform — not the function — evaluates).  A
        node whose scope is UNKNOWN and undeclared cannot be admitted at
        all: there is no bound to enforce.  Raises ScopeViolation before
        any byte leaves the store."""
        from repro_torch.analysis import ScopeViolation
        from repro_torch.pipeline.filters import parse_filter as _parse

        for s in plan.scans:
            mdef = dag.project[s.model]
            scope = getattr(mdef, "read_scope", None)
            code = getattr(mdef.fn, "__code__", None)
            loc = dict(
                model=s.model,
                filename=code.co_filename if code else None,
                lineno=code.co_firstlineno if code else None,
            )
            if scope is None:
                raise ScopeViolation(
                    f"read scope is UNKNOWN (analysis could not prove a "
                    f"bound and no reads= declaration was given) — an "
                    f"enforcing workspace admits only scoped nodes",
                    **loc,
                )
            sort_key = sort_keys[s.table]
            parsed = _parse(s.predicate_filter, sort_key)
            allowed = set(scope) | {sort_key} | set(parsed.predicate_columns)
            extra = sorted(set(s.columns) - allowed)
            if extra:
                raise ScopeViolation(
                    f"plan requests column(s) {extra} of {s.table} outside "
                    f"the verified read scope {sorted(scope)}",
                    **loc,
                )

    # -- node execution: full recompute (incremental="none") -----------------
    def _exec_scan(
        self,
        s: SystemScanStep,
        window: Optional[IntervalSet] = None,
        pins: Optional[Dict[str, str]] = None,
        device_consumer: bool = False,
        explain: Optional[RunExplanation] = None,
    ) -> ChunkedTable:
        meta = self.catalog.table(s.table)
        parsed = parse_filter(s.predicate_filter, meta.sort_key)
        snapshot_id = s.snapshot_id
        if snapshot_id is None and pins:
            snapshot_id = pins.get(s.table)
        return self.scans.scan(
            s.table,
            s.columns,
            window=window if window is not None else s.window,
            snapshot_id=snapshot_id,
            predicate=parsed.predicate_fn(),
            device_consumer=device_consumer,
            explain=explain,
        )

    def _run_full(
        self,
        step: UserFnStep,
        plan: PhysicalPlan,
        fn: Callable,
        results: Dict[str, Table],
        pins: Dict[str, str],
        expl: RunExplanation,
    ) -> Tuple[Table, Dict[str, int]]:
        kwargs: Dict[str, Any] = {}
        rows = 0
        use_device = self.device is not None and step.runtime == "torch"
        for arg, (kind, ref) in step.bindings:
            if kind == "scan":
                kwargs[arg] = self._exec_scan(
                    plan.scans[ref],
                    pins=pins,
                    device_consumer=use_device,
                    explain=expl,
                )
            else:
                kwargs[arg] = results[ref]
            rows += kwargs[arg].num_rows
        dev_ledger: Dict[str, int] = {}
        out = _invoke(
            fn, step.runtime, kwargs, self.torch_device, dev_ledger, self.tracer
        )
        if expl.enabled:
            expl.record(
                Decision(
                    run_id=expl.run_id,
                    node=step.model,
                    kind="full",
                    action="recompute",
                    window=step.window.to_pairs(),
                    residual=step.window.to_pairs(),
                    cause="not-incremental",
                    detail="no incremental contract — recomputed in full",
                    root=step.model,
                    rows=rows,
                    signature=str(step.signature or "")[:16],
                )
            )
        stats = {"fresh_rows": rows, "cached_rows": 0, "model_cache_bytes": 0}
        stats.update(dev_ledger)
        return out, stats

    # -- node execution: differential (incremental="rowwise"/"keyed") --------
    def _leaf_snapshot(
        self,
        step: UserFnStep,
        leaf_snapshots: Dict[Tuple[str, Optional[str]], Snapshot],
        pins: Dict[str, str],
    ) -> Snapshot:
        snapshot_id = step.leaf_snapshot_id
        if snapshot_id is None and pins:
            snapshot_id = pins.get(step.leaf_table)
        key = (step.leaf_table, snapshot_id)
        if key not in leaf_snapshots:
            if snapshot_id is not None:
                snap = self.catalog.snapshot(step.leaf_table, snapshot_id)
            else:
                snap = self.catalog.current_snapshot(step.leaf_table)
            leaf_snapshots[key] = snap
        return leaf_snapshots[key]

    def _leaf_snapshots_for(
        self,
        step: UserFnStep,
        leaf_snapshots: Dict[Tuple[str, Optional[str]], Snapshot],
        pins: Dict[str, str],
    ) -> Dict[str, Snapshot]:
        """One resolved snapshot per leaf table under the node's windowed
        chains, shared through the per-run memo (see ``run``)."""
        out: Dict[str, Snapshot] = {}
        for table, snapshot_id in step.leaf_pairs:
            if snapshot_id is None and pins:
                snapshot_id = pins.get(table)
            key = (table, snapshot_id)
            if key not in leaf_snapshots:
                if snapshot_id is not None:
                    snap = self.catalog.snapshot(table, snapshot_id)
                else:
                    snap = self.catalog.current_snapshot(table)
                leaf_snapshots[key] = snap
            out[table] = leaf_snapshots[key]
        return out

    def _residual_input(
        self,
        binding: Tuple[str, object],
        step: UserFnStep,
        plan: PhysicalPlan,
        results: Dict[str, Table],
        residual: IntervalSet,
        snapshots: Dict[str, Snapshot],
        expl: RunExplanation,
    ) -> Table:
        """One input of the node restricted to the residual window, sorted by
        the sort key and always carrying the sort-key column.  For a
        multi-input node this is the zip-aligned slice of that input: every
        input is windowed by the SAME key, so slicing each one to the same
        residual yields exactly the rows the function must align."""
        (kind, ref) = binding
        if kind == "scan":
            s = plan.scans[ref]
            # the sort key must ride along so the engine can window the
            # output; the scan cache itself is below this call
            cols = tuple(sorted(set(s.columns) | {step.sort_key}))
            s_with_key = SystemScanStep(
                model=s.model,
                arg=s.arg,
                table=s.table,
                columns=cols,
                window_pairs=s.window_pairs,
                predicate_filter=s.predicate_filter,
                snapshot_id=snapshots[s.table].snapshot_id,
            )
            chunked = self._exec_scan(s_with_key, window=residual, explain=expl)
            if not chunked.chunks:
                # zero rows in the residual (e.g. a window widened beyond the
                # data): keep the input schema-complete so the fn and the
                # windowing below still see the declared columns
                schema = self.catalog.table(s.table).schema
                dt = lambda n: np.dtype(schema[n]) if n in schema else np.int64
                return Table({n: np.empty(0, dtype=dt(n)) for n in cols})
            return chunked.combine().sort_by(step.sort_key)
        upstream = results[ref]  # windowed upstream: sorted, carries the key
        rows = self._rows_in(upstream, upstream.column(step.sort_key), residual)
        return rows if rows is not None else upstream.slice(0, 0)

    def _residual_inputs(
        self,
        step: UserFnStep,
        plan: PhysicalPlan,
        results: Dict[str, Table],
        residual: IntervalSet,
        snapshots: Dict[str, Snapshot],
        expl: RunExplanation,
    ) -> Dict[str, Table]:
        return {
            arg: self._residual_input(
                binding, step, plan, results, residual, snapshots, expl
            )
            for arg, binding in step.bindings
        }

    def _run_incremental(
        self,
        step: UserFnStep,
        plan: PhysicalPlan,
        fn: Callable,
        results: Dict[str, Table],
        leaf_snapshots: Dict[Tuple[str, Optional[str]], Snapshot],
        snap_pins: Dict[str, str],
        expl: RunExplanation,
    ) -> Tuple[Table, Dict[str, int]]:
        snapshots = self._leaf_snapshots_for(step, leaf_snapshots, snap_pins)
        if step.window.empty:
            # degenerate joint window (e.g. BETWEEN 5 AND 1, or a join of
            # disjoint filters): run the fn once on empty, schema-complete
            # inputs — nothing to cache or serve
            kwargs = self._residual_inputs(
                step, plan, results, IntervalSet.empty_set(), snapshots, expl
            )
            out = _invoke(fn, step.runtime, kwargs, self.torch_device, tracer=self.tracer)
            return self._windowed_output(step, kwargs, out), {
                "fresh_rows": 0,
                "cached_rows": 0,
                "model_cache_bytes": 0,
            }
        usable_fn = lambda e: snapshots_usable_window(e, snapshots)
        # one coalescing identity for the full snapshot vector: claims only
        # match when EVERY leaf snapshot agrees (single-leaf nodes reduce to
        # the plain snapshot id, matching the scan path's convention)
        snapshot_token = ",".join(
            f"{t}:{s.snapshot_id}" for t, s in sorted(snapshots.items())
        )
        # hold a signature read-pin for the whole node execution: a shared
        # store must not liveness/LRU-reclaim the signature group an
        # in-flight run is working against (plain stores: no-op)
        reading = getattr(self.model_store, "reading", None)
        read_pin = reading(step.signature) if reading else contextlib.nullcontext()
        # residual coalescing (shared stores only): claim the residual under
        # the SAME lock acquisition as the plan, so of N concurrent runs
        # planning an overlapping residual exactly one computes it and the
        # rest subscribe to its claim, then replan against the inserted rows
        claimer = getattr(self.model_store, "claim_residual", None)
        claim = None
        waits = 0
        # accumulated across replan rounds: promotions a discarded plan
        # triggered are still this run's doing (the elements stay resident
        # for the final plan, which then reports 0 for them)
        spill_bytes = 0
        # spill payloads the plan quarantined (checksum/size mismatch) and
        # replanned around — the explainer reports those residuals as
        # corruption-driven, not cache-miss-driven
        quarantined = 0
        # device serving: a torch-runtime node consumes the hit∪residual UNION
        # as device arrays (fragment_gather assembly), skipping the H2D copy
        # its _invoke would otherwise pay.  Bails to numpy whenever any hit
        # column has no device analog.
        tier = self.device
        use_device = tier is not None and step.runtime == "torch"
        dev_ledger: Dict[str, int] = {}
        dev_h2d_plans = 0  # spill→device straight-promotion bytes (from plans)
        # immutable pre-plan element views (window, pins, columns, table),
        # captured under the plan lock for the explainer's cause diagnosis
        elem_views: List[Tuple] = []
        try:
            with read_pin:
                while True:
                    hit_chunks: List[Table] = []
                    # (window lo, provider arrays, row lo, row hi) — rebuilt
                    # every replan round, the discarded round's plan is no
                    # longer the store's truth
                    dev_runs: List[Tuple] = []
                    dev_ok = use_device
                    cached_rows = 0
                    cache_bytes = 0
                    wait_event = None
                    with self.tracer.span(
                        "node.plan", model=step.model
                    ), self._model_lock:
                        # cost is row-extent, not fragment bytes: serving ANY
                        # cached rows saves user-function compute, even inside
                        # a partially-covered fragment (unlike a physical
                        # scan, which must re-read the whole fragment's
                        # column chunks either way)
                        q0 = getattr(self.model_store, "plan_quarantines", 0)
                        mplan = self.model_store.plan_window(
                            signature=step.signature,
                            window=step.window,
                            columns=(),
                            cost_fn=lambda w: w.measure(),
                            usable_fn=usable_fn,
                            tenant=self.tenant,
                            device_consumer=use_device,
                        )
                        quarantined += (
                            getattr(self.model_store, "plan_quarantines", 0) - q0
                        )
                        if expl.enabled and not mplan.residual.empty:
                            # pre-insert element views, captured under the
                            # plan's lock acquisition; the explainer only
                            # consults them on the recompute path, so fully-
                            # served runs skip the copy
                            elem_views = [
                                (e.window, e.pins, e.columns, e.table)
                                for e in self.model_store.elements(step.signature)
                            ]
                        if claimer is not None and not mplan.residual.empty:
                            claim, wait_event = claimer(
                                step.signature,
                                mplan.residual,
                                snapshot_id=snapshot_token,
                                kind=step.incremental,
                            )
                        spill_bytes += mplan.promoted_spill_bytes
                        dev_h2d_plans += mplan.bytes_h2d
                        if wait_event is None:
                            for hit in mplan.hits:
                                for view in hit.element.slice_window(
                                    hit.window, hit.element.columns
                                ):
                                    hit_chunks.append(view)
                                    cached_rows += view.num_rows
                                    cache_bytes += view.nbytes
                                if dev_ok:
                                    # pin under the SAME lock the views are
                                    # taken under — a merge after release
                                    # drops this element's pins
                                    arrays = tier.pin_columns(
                                        hit.element,
                                        hit.element.columns,
                                        dev_ledger,
                                    )
                                    if arrays is None:
                                        dev_ok = False
                                        dev_runs = []
                                    else:
                                        dev_runs.extend(
                                            (iv.lo, arrays, lo, hi)
                                            for iv, lo, hi
                                            in hit.element.window_runs(hit.window)
                                        )
                    if wait_event is None:
                        break
                    # another run is computing an overlapping residual: wait
                    # (no lock held) and replan — its insert becomes our hit.
                    # The timeout matches the store's claim lease, so a dead
                    # owner's claim expires before the first waiter gives up;
                    # owners release in a finally.
                    waits += 1
                    t_wait = time.perf_counter()
                    with self.tracer.span("node.claim_wait", model=step.model):
                        wait_event.wait(
                            timeout=float(
                                getattr(self.model_store, "claim_timeout", 60.0)
                            )
                        )
                    self.metrics.histogram(
                        "claim_wait_seconds", kind=step.incremental
                    ).observe(time.perf_counter() - t_wait)

                fresh: Optional[Table] = None
                fresh_rows = 0
                if not mplan.residual.empty:
                    with self.tracer.span(
                        "node.residual", model=step.model
                    ) as res_sp:
                        kwargs = self._residual_inputs(
                            step, plan, results, mplan.residual, snapshots, expl
                        )
                        total_in = sum(t.num_rows for t in kwargs.values())
                        if total_in == 0 and hit_chunks:
                            # nothing to compute; keep the output schema from
                            # a hit view
                            fresh = hit_chunks[0].slice(0, 0)
                        else:
                            fresh_rows = total_in
                            out = _invoke(
                                fn, step.runtime, kwargs, self.torch_device,
                                dev_ledger, self.tracer,
                            )
                            fresh = self._windowed_output(step, kwargs, out)
                        res_sp.attrs["rows"] = fresh_rows
                    fresh_dev = None
                    if dev_ok and fresh.num_rows:
                        fresh_dev = _fresh_to_device(fresh, tier.device, dev_ledger)
                        if fresh_dev is None:
                            dev_ok = False
                    if len(snapshots) == 1:
                        (only_snap,) = snapshots.values()
                        pins = pins_for(only_snap, mplan.residual)
                    else:
                        pins = multi_pins_for(snapshots, mplan.residual)
                    with self.tracer.span(
                        "node.insert", model=step.model
                    ), self._model_lock:
                        # handing the fresh device arrays to the insert lets
                        # the store's merge replicate device→device — warm
                        # runs then upload only the residual, never the
                        # merged payload
                        self.model_store.insert_window(
                            signature=step.signature,
                            table=step.leaf_table,
                            sort_key=step.sort_key,
                            window=mplan.residual,
                            data=fresh,
                            pins=pins,
                            usable_fn=usable_fn,
                            tenant=self.tenant,
                            device_arrays=fresh_dev,
                        )
                    if dev_ok and fresh_dev is not None:
                        # fresh rows interleave with hit windows in key
                        # order: one run per residual interval, like the
                        # host path's post-concat stable sort
                        keys = np.asarray(fresh.column(step.sort_key))
                        for iv in mplan.residual:
                            lo = int(np.searchsorted(keys, iv.lo, side="left"))
                            hi = int(np.searchsorted(keys, iv.hi, side="left"))
                            if hi > lo:
                                dev_runs.append((iv.lo, fresh_dev, lo, hi))
        finally:
            if claim is not None:
                self.model_store.release_residual(claim)

        if expl.enabled:
            def current_ids() -> Dict[str, Optional[str]]:
                # the catalog head is a pointer-only read (unaccounted), so
                # the travel check never perturbs the run's byte ledger;
                # resolved lazily (only a genuine invalidation pays it) and
                # memoized per run (every node asks about the same tables)
                memo = expl.head_ids
                for t in snapshots:
                    if t not in memo:
                        try:
                            memo[t] = self.catalog.current_snapshot_id(t)
                        except (KeyError, OSError):
                            memo[t] = None
                return {t: memo[t] for t in snapshots}

            self.explainer.classify_node(
                expl,
                node=step.model,
                kind=step.incremental,
                sig_parts=step.sig_parts,
                signature=step.signature,
                window=step.window,
                residual=mplan.residual,
                elements=elem_views,
                snapshots=snapshots,
                current_ids=current_ids,
                rows=fresh_rows,
                tier="ram+spill" if spill_bytes else ("ram" if cached_rows else ""),
                quarantined=quarantined,
            )
        self.metrics.counter("residual_rows", kind=step.incremental).inc(
            fresh_rows
        )
        if cache_bytes:
            self.metrics.counter("cache_hit_bytes", tier="ram").inc(cache_bytes)
        if waits:
            self.metrics.counter(
                "coalesced_wait_rounds", kind=step.incremental
            ).inc(waits)

        chunks = hit_chunks + ([fresh] if fresh is not None else [])
        # span the union only when there is one: the single-chunk serve is a
        # zero-copy view and a span around it would just be tracer tax
        union_span = (
            self.tracer.span("node.union", model=step.model, chunks=len(chunks))
            if len(chunks) != 1 or (dev_ok and dev_runs)
            else contextlib.nullcontext()
        )
        with union_span:
            assembled = ChunkedTable(chunks)
            if len(assembled.chunks) == 1:
                # zero-copy fast path: a single chunk (one cache view, or one
                # fresh residual) is already sorted by the key
                out_tbl = assembled.chunks[0]
            else:
                out_tbl = assembled.combine().sort_by(step.sort_key)
            if dev_ok and dev_runs and out_tbl.num_rows:
                # assemble the same UNION on device: hit/residual windows are
                # disjoint and each run is internally key-sorted, so runs
                # ordered by window lo ARE the host stable sort's output —
                # bitwise (device_columns[c] == to_device(out_tbl.column(c)))
                from repro_torch.core.device import DeviceTable, device_union

                dev_runs.sort(key=lambda r: r[0])
                arrays = device_union(
                    [(prov, lo, hi) for _key, prov, lo, hi in dev_runs],
                    list(out_tbl.column_names),
                    ledger=dev_ledger,
                    tracer=self.tracer,
                )
                out_tbl = DeviceTable(out_tbl, arrays)
        stats = {
            "fresh_rows": fresh_rows,
            "cached_rows": cached_rows,
            "model_cache_bytes": cache_bytes,
            "bytes_from_spill": spill_bytes,
            "coalesced_waits": waits,
        }
        stats.update(dev_ledger)
        if dev_h2d_plans:
            stats["bytes_h2d"] = stats.get("bytes_h2d", 0) + dev_h2d_plans
        return out_tbl, stats

    def _windowed_output(
        self, step: UserFnStep, inputs: Dict[str, Table], out: Table
    ) -> Table:
        """Enforce the node's incrementality contract and return the output
        sorted by the sort key, with the key column present.  Columns are put
        in sorted order — the canonical layout cache elements store — so cold
        and warm assemblies are chunk-compatible and byte-identical.

        Single-input rowwise keeps the position-alignment convenience (the
        engine attaches the key when the function did not return it); keyed
        and multi-input rowwise functions must ALWAYS return the key —
        aggregation collapses positions and joins zip inputs of different
        lengths, so position alignment is undefined for both."""
        if step.incremental == "rowwise" and len(inputs) == 1:
            (in_tbl,) = inputs.values()
            return self._windowed_output_rowwise(step, in_tbl, out)
        total_in = sum(t.num_rows for t in inputs.values())
        if out.num_rows > total_in:
            raise ValueError(
                f"{step.model}: incremental={step.incremental!r} functions "
                f"must not create rows ({total_in} in across "
                f"{len(inputs)} input(s), {out.num_rows} out)"
            )
        if step.sort_key not in out.column_names:
            what = (
                "a keyed aggregation"
                if step.incremental == "keyed"
                else "a multi-input rowwise function"
            )
            raise ValueError(
                f"{step.model}: {what} must return the sort key column "
                f"{step.sort_key!r} (the engine cannot position-align it)"
            )
        in_keys = np.concatenate(
            [np.asarray(t.column(step.sort_key)) for t in inputs.values()]
        )
        out_keys = np.asarray(out.column(step.sort_key))
        if out_keys.dtype != in_keys.dtype:
            # a runtime narrowed the key (x32): cast back and verify
            # losslessness — wrapped values cannot address the cache
            cast = out_keys.astype(in_keys.dtype)
            if out_keys.size and not np.isin(cast, in_keys).all():
                raise ValueError(
                    f"{step.model}: sort key {step.sort_key!r} came back as "
                    f"{out_keys.dtype} with values outside the input keys — "
                    f"the runtime truncated it (x32?); keep keys within "
                    f"its integer range"
                )
            cols = {n: out.column(n) for n in out.column_names}
            cols[step.sort_key] = cast
            out = Table(cols)
            out_keys = cast
        if out_keys.size and not np.isin(out_keys, in_keys).all():
            # output keys outside the residual's input keys would land in
            # windows this residual does not own — cached neighbours would
            # then disagree with a cold run
            raise ValueError(
                f"{step.model}: incremental={step.incremental!r} output "
                f"keys must be drawn from the input keys (an output row may "
                f"only derive from input rows at its own key)"
            )
        return out.select(sorted(out.column_names)).sort_by(step.sort_key)

    def _windowed_output_rowwise(
        self, step: UserFnStep, in_tbl: Table, out: Table
    ) -> Table:
        if out.num_rows > in_tbl.num_rows:
            raise ValueError(
                f"{step.model}: incremental='rowwise' functions must not "
                f"create rows ({in_tbl.num_rows} in, {out.num_rows} out)"
            )
        in_keys = in_tbl.column(step.sort_key)
        if out.num_rows == in_tbl.num_rows:
            # rows neither dropped nor reordered (the contract): restore the
            # EXACT input key column position-aligned, whether or not the fn
            # echoed one — runtimes may round-trip dtypes (the torch runtime
            # narrows int64 to int32) and the key is the cache's addressing
            # dimension, so it must stay bit-exact
            cols = {n: out.column(n) for n in out.column_names}
            cols[step.sort_key] = in_keys
            out = Table(cols)
        else:
            if step.sort_key not in out.column_names:
                raise ValueError(
                    f"{step.model}: a rowwise function that drops rows must "
                    f"return the sort key column {step.sort_key!r} (the "
                    f"engine cannot position-align it)"
                )
            out_keys = np.asarray(out.column(step.sort_key))
            if out_keys.dtype != in_keys.dtype:
                # a runtime narrowed the key (x32): cast back and verify
                # losslessness — wrapped values cannot address the cache
                cast = out_keys.astype(in_keys.dtype)
                if out_keys.size and not np.isin(cast, in_keys).all():
                    raise ValueError(
                        f"{step.model}: sort key {step.sort_key!r} came back "
                        f"as {out_keys.dtype} with values outside the input "
                        f"keys — the runtime truncated it (x32?); avoid "
                        f"dropping rows in this runtime or keep keys within "
                        f"its integer range"
                    )
                cols = {n: out.column(n) for n in out.column_names}
                cols[step.sort_key] = cast
                out = Table(cols)
        return out.select(sorted(out.column_names)).sort_by(step.sort_key)

    # -- incremental materialization -----------------------------------------
    @staticmethod
    def _rows_in(table: Table, keys: np.ndarray, window: IntervalSet) -> Optional[Table]:
        """``table``'s rows whose sort key lies inside ``window`` (table is
        sorted by the key); None when the window holds no rows."""
        parts: List[Table] = []
        for iv in window:
            lo = int(np.searchsorted(keys, iv.lo, side="left"))
            hi = int(np.searchsorted(keys, iv.hi, side="left"))
            if hi > lo:
                parts.append(table.slice(lo, hi))
        if not parts:
            return None
        return concat_tables(parts)

    @staticmethod
    def _changed_since_publish(pub_leaf: Snapshot, cur_leaf: Snapshot) -> IntervalSet:
        """Key windows whose leaf fragments differ between the snapshot the
        published rows were derived from and the one this run used — the
        exact regions where published rows may disagree with the run's
        output (same signature implies same values everywhere else)."""
        if pub_leaf.snapshot_id == cur_leaf.snapshot_id:
            return IntervalSet.empty_set()
        pub_ids, cur_ids = pub_leaf.fragment_ids, cur_leaf.fragment_ids
        changed = [
            Interval(int(f.key_min), int(f.key_max) + 1)
            for f in pub_leaf.fragments
            if f.fragment_id not in cur_ids
        ] + [
            Interval(int(f.key_min), int(f.key_max) + 1)
            for f in cur_leaf.fragments
            if f.fragment_id not in pub_ids
        ]
        return IntervalSet(changed)

    def _materialize(
        self, step: UserFnStep, table: Table, leaf_snapshot: Optional[Snapshot]
    ) -> None:
        """Publish a model's output to the catalog *incrementally*.

        The published table mirrors the latest run's output.  For a rowwise
        node whose signature matches the last publish, only the diff is
        committed — instead of re-appending the full output every run (which
        both grew the table unboundedly and duplicated rows):

        - windows whose *leaf fragments* changed between the publication's
          recorded leaf snapshot and this run's are overwritten (keying on
          the published state, not on "recomputed this run", matters: a
          window another run already freshened into the shared cache arrives
          here as a cache hit, yet still must be republished);
        - windows of the run the table never covered are appended;
        - windows the run no longer covers are deleted.

        A signature change (code/schema edit), a non-rowwise node, or a
        publication without recorded provenance republishes in full.  The
        whole diff lands in ONE atomic commit (``overwrite_ranges``) carrying
        the ``signature`` + ``leaf_snapshot`` provenance properties, so
        concurrent readers see either the previous or the new publication —
        never a torn mix — and an interrupted publish leaves provenance
        untouched for the retry to re-derive the same diff.

        The commit is optimistic (``expected_parent``): under the service,
        two tenants materializing the same model race on the catalog CAS and
        the loser's :class:`~repro_torch.lake.catalog.CommitConflict` propagates to
        the session retry loop.
        """
        model_name = step.model
        full = f"models.{model_name}"
        # rowwise outputs are canonicalized to sorted column order, so
        # "first column" is NOT the sort key — use the plan's when present
        sort_key = step.sort_key
        if sort_key is None or sort_key not in table.column_names:
            sort_key = table.column_names[0]
        table = table.sort_by(sort_key)
        sig = step.signature or ""
        try:
            meta = self.catalog.table(full)
            created = False
        except KeyError:
            try:
                meta = self.catalog.create_table(
                    "models", model_name, table.schema(), sort_key
                )
                created = True
            except FileExistsError:
                # lost a concurrent create race: treat the winner's table as
                # pre-existing; the CAS on the commits below still protects
                # the content (losers raise CommitConflict -> session retry)
                meta = self.catalog.table(full)
                created = False
        cur, published = self.catalog.pointer_state(full)
        published_sig = published.get("signature")
        published_leaf_id = published.get("leaf_snapshot")
        props = {"signature": sig}
        if leaf_snapshot is not None:
            props["leaf_snapshot"] = leaf_snapshot.snapshot_id

        if (
            created
            or leaf_snapshot is None
            or published_sig != sig
            or not published_leaf_id
        ):
            # first publish / arbitrary transformation / code or schema edit
            # / unknown provenance: mirror the full output
            if not cur.fragments:
                if table.num_rows:
                    self.catalog.append(
                        full, table, expected_parent=cur.snapshot_id, properties=props
                    )
                return
            new_schema = table.schema()
            self.catalog.overwrite_range(
                full,
                NEG_INF,
                POS_INF,
                data=table,
                expected_parent=cur.snapshot_id,
                properties=props,
                schema=new_schema if new_schema != meta.schema else None,
            )
            return

        # same signature, rowwise, known provenance: differential publish
        # against the windows the current fragment set covers
        pub_window = IntervalSet(
            [Interval(int(f.key_min), int(f.key_max) + 1) for f in cur.fragments]
        )
        new_window = step.window
        keys = table.column(sort_key)
        pub_leaf = self.catalog.snapshot(step.leaf_table, published_leaf_id)
        stale = self._changed_since_publish(pub_leaf, leaf_snapshot)

        # the diff, all of it landing in one commit:
        # - deleted: published but outside this run's output (narrowed filter)
        # - rewritten: published windows whose leaf rows changed since the
        #   recorded publication
        # - added: windows the table never covered (widened filter, appended
        #   upstream rows — whether recomputed or cache-served)
        deleted = pub_window.difference(new_window)
        rewritten = stale.intersect(pub_window).intersect(new_window)
        added = new_window.difference(pub_window)
        rows = self._rows_in(table, keys, rewritten.union(added))
        drop = deleted.union(rewritten)
        if not drop.empty:
            self.catalog.overwrite_ranges(
                full,
                drop.to_pairs(),
                data=rows,
                expected_parent=cur.snapshot_id,
                properties=props,
            )
        elif rows is not None:
            self.catalog.append(
                full, rows, expected_parent=cur.snapshot_id, properties=props
            )


def _to_table(value: Any) -> Table:
    if isinstance(value, Table):
        return value
    if isinstance(value, ChunkedTable):
        return value.combine()
    if isinstance(value, dict):
        cols = {}
        for k, v in value.items():
            arr = np.asarray(v)
            cols[k] = arr
        return Table(cols)
    raise TypeError(f"model must return Table/ChunkedTable/dict, got {type(value)}")


def _fresh_to_device(
    fresh: Table, device: torch.device, ledger: Optional[Dict[str, int]] = None
) -> Optional[Dict[str, torch.Tensor]]:
    """Upload every column of a fresh residual (the one H2D transfer its
    bytes ever pay — the tensors go to the cache insert, so future consumers
    and post-merge elements serve from device).  None when any column's
    dtype has no device analog."""
    if not all(
        DeviceTier.supported(fresh.column(c).dtype) for c in fresh.column_names
    ):
        return None
    out: Dict[str, torch.Tensor] = {}
    h2d = 0
    for c in fresh.column_names:
        arr = to_device(fresh.column(c), device)
        h2d += int(arr.nbytes)
        out[c] = arr
    if ledger is not None:
        ledger["bytes_h2d"] = ledger.get("bytes_h2d", 0) + h2d
    return out


def _invoke(
    fn: Callable,
    runtime: str,
    kwargs: Dict[str, Any],
    device: torch.device,
    ledger: Optional[Dict[str, int]] = None,
    tracer: Optional[Tracer] = None,
) -> Table:
    """Run a user fn on its inputs.  A torch fn's outputs come back to the
    host; where one is on the card and ``tracer`` is enabled, the wait for
    the fn's kernels is a ``device.sync`` span and the copies that follow a
    ``device.d2h`` span with their ``bytes``."""
    if runtime == "numpy":
        prepared = {
            k: (v.combine() if isinstance(v, ChunkedTable) else v)
            for k, v in kwargs.items()
        }
        return _to_table(fn(**prepared))
    if runtime == "torch":

        def _count(key: str, by: int) -> None:
            if ledger is not None:
                ledger[key] = ledger.get(key, 0) + by

        prepared = {}
        for k, v in kwargs.items():
            # device-resident inputs (DeviceTable / DeviceChunkedTable) hand
            # their columns straight to the fn — zero host round-trips.  They
            # go as clones: a union column may be a view of a pinned column,
            # and torch, unlike jax, lets the fn write to its inputs.  Any
            # column without a device copy falls back to the H2D conversion
            devcols = getattr(v, "device_columns", None) or {}
            names = v.column_names
            cols: Dict[str, Any] = {}
            host = None
            for name in names:
                arr = devcols.get(name)
                if arr is not None:
                    arr = arr.clone()
                    _count("device_hits", 1)
                else:
                    if host is None:
                        host = v.combine() if isinstance(v, ChunkedTable) else v
                    arr = to_device(host.column(name), device)
                    _count("bytes_h2d", int(arr.nbytes))
                cols[name] = arr
            prepared[k] = cols
        out = fn(**prepared)
        if not isinstance(out, dict):
            raise TypeError("torch models must return {column: torch.Tensor}")
        card = None
        if tracer is not None and tracer.enabled:
            card = next(
                (v.device for v in out.values() if isinstance(v, torch.Tensor) and v.is_cuda),
                None,
            )
        if card is None:
            return Table(_to_host(out, _count))
        # the copies below wait for the fn's kernels anyway: waiting first
        # splits that wait from the copies and adds no time
        with tracer.span("device.sync"):
            torch.cuda.current_stream(card).synchronize()
        with tracer.span("device.d2h") as sp:
            host_out = _to_host(out, _count)
            sp.attrs["bytes"] = sum(int(a.nbytes) for a in host_out.values())
        return Table(host_out)
    raise ValueError(f"unknown runtime {runtime!r}")


def _to_host(out: Dict[str, Any], count: Callable[[str, int], None]) -> Dict[str, np.ndarray]:
    host_out = {}
    for k, v in out.items():
        # a copy on the host: the output must not alias a tensor the fn
        # (or its caller) can still write to
        if isinstance(v, torch.Tensor):
            arr = v.detach().to("cpu", copy=True).numpy()
        else:
            arr = np.asarray(v)
        count("bytes_d2h", int(arr.nbytes))
        host_out[k] = arr
    return host_out


def run_project(workspace: Workspace, project: Project, **kw) -> RunResult:
    return workspace.run(project, **kw)
