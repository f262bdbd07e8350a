"""Cache-decision explanation: *why* did this run serve or recompute?

For every window the planner resolves — leaf scans in
``core/planner.ScanExecutor`` and incremental model nodes in
``pipeline/executor.Workspace`` — the :class:`Explainer` records a
:class:`Decision` naming the action (serve/recompute) and the *cause*:

========================  =====================================================
cause                     meaning
========================  =====================================================
``cold``                  first run of this node/scan signature
``cached``                every requested window served from cache
``scope-narrowed``        requested columns changed but the node's proven read
                          scope keeps the signature (and the cache) valid
``window-widened``        residual lies outside every cached window (a pure
                          filter widen — nothing was invalidated)
``feature-change``        requested/signature columns changed (projection)
``unknown-scope``         columns changed and the read scope is UNKNOWN —
                          conservative full recompute
``filter-change``         the scan predicate changed
``code-edit``             the node's code fingerprint changed
``upstream-edit``         an input node's signature changed (detail names the
                          root cause node)
``append``                unseen fragments appended to a source table
``overwrite``             cached windows pin fragments the snapshot dropped
                          (pin-stale)
``snapshot-travel``       the run reads a pinned/older snapshot than the
                          catalog head
``evicted``               signature unchanged but no cached windows remain
``spill-corrupt``         a spilled payload failed integrity verification and
                          was quarantined — the window recomputed as a miss
``pin-change``            an explicit snapshot pin in the plan changed
``contract-change``       runtime/incrementality contract changed
``input-change``          inputs were added, removed, or rebound
``not-incremental``       node has no incremental contract; always recomputes
``unknown``               none of the above (bug bait — report it)
========================  =====================================================

Surfaced as ``RunResult.explain()`` and ``python -m repro_torch.explain`` (the
11-edit matrix harness asserts each edit maps to exactly the expected
cause).  ``Explainer(enabled=False)`` records nothing.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # repro_torch.core imports repro_torch.obs — keep this module leaf-free
    from repro_torch.core.intervals import IntervalSet

__all__ = ["Decision", "Explainer", "RunExplanation", "CAUSES"]

CAUSES = (
    "cold",
    "cached",
    "scope-narrowed",
    "window-widened",
    "feature-change",
    "unknown-scope",
    "filter-change",
    "code-edit",
    "upstream-edit",
    "append",
    "overwrite",
    "snapshot-travel",
    "evicted",
    "spill-corrupt",
    "pin-change",
    "contract-change",
    "input-change",
    "not-incremental",
    "unknown",
)

# Higher-precedence causes win when a run recomputes for several reasons at
# once (primary_cause); upstream-edit is attributed to its root instead.
_PRECEDENCE = (
    "spill-corrupt",
    "snapshot-travel",
    "overwrite",
    "append",
    "code-edit",
    "contract-change",
    "input-change",
    "feature-change",
    "unknown-scope",
    "filter-change",
    "pin-change",
    "window-widened",
    "evicted",
    "cold",
    "not-incremental",
    "unknown",
    "scope-narrowed",
    "cached",
)


@dataclass
class Decision:
    """One serve/recompute decision for one node or leaf scan."""

    run_id: int
    node: str  # model name, or the table name for leaf scans
    kind: str  # "scan" | "rowwise" | "keyed" | "full"
    action: str  # "serve" | "recompute"
    window: Tuple[Tuple[int, int], ...]  # requested window pairs
    residual: Tuple[Tuple[int, int], ...]  # recomputed window pairs
    cause: str
    detail: str
    root: str = ""  # root-cause node for upstream-edit chains
    tier: str = ""  # "ram" / "ram+spill" / "store" — where hits came from
    rows: int = 0  # residual rows actually computed/fetched
    signature: str = ""

    def render(self) -> str:
        res = ",".join(f"[{a},{b})" for a, b in self.residual) or "-"
        root = f" (root: {self.root})" if self.root and self.root != self.node else ""
        return (
            f"{self.node:<24} {self.kind:<8} {self.action:<9} "
            f"{self.cause:<16} residual={res:<18} {self.detail}{root}"
        )


class RunExplanation:
    """The decision events of one ``Workspace.run`` (or one scan batch)."""

    def __init__(self, run_id: int, enabled: bool = True, tenant: Optional[str] = None):
        self.run_id = run_id
        self.enabled = enabled
        self.tenant = tenant
        self.events: List[Decision] = []
        # node -> (cause, root_node); lets downstream nodes attribute their
        # upstream-edit to the true root in topological order.
        self.node_causes: Dict[str, Tuple[str, str]] = {}
        # per-run memo for lazy catalog-head reads (table -> snapshot id);
        # one run classifies many nodes over the same few tables
        self.head_ids: Dict[str, Optional[str]] = {}
        self._lock = threading.Lock()

    def record(self, d: Decision) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.events.append(d)
            self.node_causes[d.node] = (d.cause, d.root or d.node)

    def causes(self) -> Dict[str, str]:
        """node -> cause for every recorded decision."""
        return {d.node: d.cause for d in self.events}

    def primary_cause(self) -> str:
        """The single highest-precedence cause of this run's recomputation
        (``upstream-edit`` collapses into its root's cause)."""
        rec = [d.cause for d in self.events if d.action == "recompute" and d.cause != "upstream-edit"]
        pool = rec or [d.cause for d in self.events]
        if not pool:
            return "cached"
        for c in _PRECEDENCE:
            if c in pool:
                return c
        return "unknown"

    def render(self) -> str:
        lines = [f"run {self.run_id}" + (f" tenant={self.tenant}" if self.tenant else "")]
        lines += ["  " + d.render() for d in self.events]
        lines.append(f"  primary cause: {self.primary_cause()}")
        return "\n".join(lines)

    def to_dicts(self) -> List[Dict[str, Any]]:
        return [dict(vars(d)) for d in self.events]


class _NullExplanation(RunExplanation):
    def __init__(self):
        super().__init__(run_id=-1, enabled=False)


_NULL_EXPLANATION = _NullExplanation()


# Indices into the ("scan", table, sig_cols, pred_sig, snap_id, scope_known,
# raw_cols) tuples that compile_plan stores in UserFnStep.sig_parts.  The
# trailing raw_cols entry is NOT part of the signature digest — it exists so
# the explainer can recognize scope-narrowed serves.
_SCAN_TABLE, _SCAN_SIGCOLS, _SCAN_PRED, _SCAN_SNAP, _SCAN_SCOPE, _SCAN_RAW = (
    1,
    2,
    3,
    4,
    5,
    6,
)


def _strip_raw(parts: tuple) -> tuple:
    """sig_parts with the non-signature raw-column entries removed — equal
    iff the two parts produce the same signature digest."""
    out = []
    for k, v in parts:
        if k == "inputs":
            v = tuple(i[:_SCAN_RAW] if i and i[0] == "scan" else i for i in v)
        out.append((k, v))
    return tuple(out)


class Explainer:
    """Per-workspace decision recorder with cross-run signature memory."""

    def __init__(self, enabled: bool = True, max_runs: int = 256):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._runs: deque = deque(maxlen=max_runs)
        self._run_seq = 0
        # node name -> sig_parts from its previous run (cause diagnosis)
        self._last_parts: Dict[str, tuple] = {}

    # -- run lifecycle -------------------------------------------------------
    def begin_run(self, tenant: Optional[str] = None) -> RunExplanation:
        if not self.enabled:
            return _NULL_EXPLANATION
        with self._lock:
            self._run_seq += 1
            return RunExplanation(self._run_seq, enabled=True, tenant=tenant)

    def finish_run(self, expl: RunExplanation) -> None:
        if not expl.enabled:
            return
        with self._lock:
            self._runs.append(expl)

    def runs(self) -> List[RunExplanation]:
        with self._lock:
            return list(self._runs)

    # -- node classification -------------------------------------------------
    def classify_node(
        self,
        expl: RunExplanation,
        *,
        node: str,
        kind: str,
        sig_parts: tuple,
        signature: str,
        window: IntervalSet,
        residual: IntervalSet,
        elements: Sequence[Tuple[IntervalSet, tuple, Tuple[str, ...], str]],
        snapshots: Dict[str, Any],
        current_ids: Any,
        rows: int = 0,
        tier: str = "",
        quarantined: int = 0,
    ) -> str:
        """Classify one incremental model node's plan outcome and record the
        decision.  ``elements`` are immutable views ``(window, pins, columns,
        table)`` captured under the store lock *before* this run's insert —
        callers may pass ``[]`` when the residual is empty (they are only
        consulted on the recompute path); ``snapshots`` are the leaf snapshots
        the run resolved; ``current_ids`` the catalog-head snapshot ids for
        travel detection — a dict, or a zero-arg callable resolved only when
        an invalidation actually needs it (keeps catalog pointer reads off
        the warm serve path).  ``quarantined`` counts spill payloads the plan
        quarantined for failing integrity verification — the definitive cause
        of the recompute when set."""
        if not expl.enabled:
            return ""
        last = self._last_parts.get(node)
        if quarantined and not residual.empty:
            cause = "spill-corrupt"
            detail = (
                f"{quarantined} spilled payload(s) failed integrity "
                "verification and were quarantined — recomputed as a miss"
            )
            action, root = "recompute", node
            self._last_parts[node] = sig_parts
            expl.record(
                Decision(
                    run_id=expl.run_id,
                    node=node,
                    kind=kind,
                    action=action,
                    window=window.to_pairs(),
                    residual=residual.to_pairs(),
                    cause=cause,
                    detail=detail,
                    root=root,
                    tier=tier,
                    rows=rows,
                    signature=str(signature)[:16],
                )
            )
            return cause
        if residual.empty:
            cause, detail = "cached", "every window served from cache"
            if last is not None and last != sig_parts and _strip_raw(last) == _strip_raw(sig_parts):
                cause = "scope-narrowed"
                detail = (
                    "requested columns changed but the proven read scope keeps "
                    "the signature valid — served from cache"
                )
            elif last is None:
                # this workspace never computed the node, yet the whole
                # window served: a shared or restored cache fed it
                detail = "served from shared or restored cache"
            action, root = "serve", node
        else:
            action = "recompute"
            if not elements:
                if last is None:
                    cause, detail, root = "cold", "first run of this node", node
                elif _strip_raw(last) == _strip_raw(sig_parts):
                    cause, detail, root = (
                        "evicted",
                        "signature unchanged but no cached windows remain",
                        node,
                    )
                else:
                    cause, detail, root = self._diff_parts(expl, node, last, sig_parts)
            else:
                cause, detail = _classify_invalidation(
                    residual, elements, snapshots, current_ids
                )
                root = node
        self._last_parts[node] = sig_parts
        expl.record(
            Decision(
                run_id=expl.run_id,
                node=node,
                kind=kind,
                action=action,
                window=window.to_pairs(),
                residual=residual.to_pairs(),
                cause=cause,
                detail=detail,
                root=root,
                tier=tier,
                rows=rows,
                signature=str(signature)[:16],
            )
        )
        return cause

    def classify_scan(
        self,
        expl: RunExplanation,
        *,
        table: str,
        window: IntervalSet,
        residual: IntervalSet,
        columns: Tuple[str, ...],
        elements: Sequence[Tuple[IntervalSet, tuple, Tuple[str, ...], str]],
        snapshot: Any,
        current_id: Any,
        rows: int = 0,
        tier: str = "",
        quarantined: int = 0,
    ) -> str:
        """Classify one leaf-scan plan outcome (cache keyed by table name —
        the signature never changes, so causes are purely window/snapshot/
        projection shaped).  ``current_id`` may be the catalog-head snapshot
        id or a zero-arg callable returning it (resolved lazily, like
        :meth:`classify_node`'s ``current_ids``).  ``quarantined`` marks
        integrity-quarantined spill payloads — the definitive cause."""
        if not expl.enabled:
            return ""
        if residual.empty:
            cause, detail = "cached", "every window served from cache"
            action = "serve"
        else:
            action = "recompute"
            eligible = [e for e in elements if set(columns) <= set(e[2])]
            if quarantined:
                cause = "spill-corrupt"
                detail = (
                    f"{quarantined} spilled payload(s) failed integrity "
                    "verification and were quarantined — recomputed as a miss"
                )
            elif not elements:
                cause, detail = "cold", "first scan of this table"
            elif not eligible:
                missing = sorted(
                    set(columns) - set().union(*(set(e[2]) for e in elements))
                )
                cause = "feature-change"
                detail = f"no cached window carries column(s) {missing}"
            else:
                cause, detail = _classify_invalidation(
                    residual,
                    eligible,
                    {table: snapshot},
                    lambda: {table: current_id() if callable(current_id) else current_id},
                )
        expl.record(
            Decision(
                run_id=expl.run_id,
                node=f"scan:{table}",
                kind="scan",
                action=action,
                window=window.to_pairs(),
                residual=residual.to_pairs(),
                cause=cause,
                detail=detail,
                root=f"scan:{table}",
                tier=tier,
                rows=rows,
            )
        )
        return cause

    def _diff_parts(
        self, expl: RunExplanation, node: str, last: tuple, cur: tuple
    ) -> Tuple[str, str, str]:
        """Diagnose *why* a node's signature changed by diffing the
        structured signature parts against the previous run's."""
        l, c = dict(last), dict(cur)
        if l.get("code") != c.get("code"):
            return "code-edit", f"code edit on node {node}", node
        if l.get("runtime") != c.get("runtime") or l.get("incremental") != c.get("incremental"):
            return "contract-change", "runtime or incrementality contract changed", node
        li, ci = l.get("inputs", ()), c.get("inputs", ())
        if len(li) != len(ci):
            return "input-change", "inputs were added or removed", node
        for a, b in zip(li, ci):
            if a == b:
                continue
            if a[0] != b[0] or a[1] != b[1]:
                return "input-change", f"input rebound {a[1]} -> {b[1]}", node
            if a[0] == "model":
                parent = b[1]
                pcause, proot = expl.node_causes.get(parent, ("unknown", parent))
                return (
                    "upstream-edit",
                    f"input {parent} changed ({pcause})",
                    proot,
                )
            # scan input: ("scan", table, sig_cols, pred_sig, snap, scope_known, raw)
            if a[_SCAN_SIGCOLS] != b[_SCAN_SIGCOLS]:
                if not b[_SCAN_SCOPE]:
                    return (
                        "unknown-scope",
                        f"columns of {b[1]} changed with UNKNOWN read scope — "
                        "conservative full recompute",
                        node,
                    )
                return (
                    "feature-change",
                    f"signature columns of {b[1]}: "
                    f"{sorted(a[_SCAN_SIGCOLS])} -> {sorted(b[_SCAN_SIGCOLS])}",
                    node,
                )
            if a[_SCAN_PRED] != b[_SCAN_PRED]:
                return "filter-change", f"scan predicate on {b[1]} changed", node
            if a[_SCAN_SNAP] != b[_SCAN_SNAP]:
                return "pin-change", f"explicit snapshot pin on {b[1]} changed", node
        return "unknown", "signature changed for an unrecognized reason", node


def _classify_invalidation(
    residual: IntervalSet,
    elements: Sequence[Tuple[IntervalSet, tuple, Tuple[str, ...], str]],
    snapshots: Dict[str, Any],
    current_ids: Any,
) -> Tuple[str, str]:
    """Cached windows exist but a residual remains: widened filter, or an
    invalidation (travel / overwrite pin-stale / append unseen fragments).
    ``current_ids`` may be a dict or a zero-arg callable — the catalog head
    is read only once a genuine invalidation needs the travel check."""
    from repro_torch.core.intervals import Interval, IntervalSet

    raw = IntervalSet([iv for w, _pins, _cols, _tbl in elements for iv in w])
    invalidated = residual & raw
    if invalidated.empty:
        return (
            "window-widened",
            f"residual {residual.to_pairs()} lies outside every cached window",
        )
    if callable(current_ids):
        current_ids = current_ids()
    # the question is why THIS region was invalidated: only elements whose
    # cached window overlaps it can testify, and skipping the rest keeps the
    # pins scan off the O(elements x fragments) cliff as appends accumulate
    elements = [e for e in elements if not (e[0] & invalidated).empty]
    travelled = sorted(
        t
        for t, snap in snapshots.items()
        if snap is not None
        and current_ids.get(t) is not None
        and current_ids[t] != snap.snapshot_id
    )
    if travelled:
        return (
            "snapshot-travel",
            f"run pinned to a non-head snapshot of {', '.join(travelled)}",
        )
    # stale pins: fragments an element saw that the run snapshot dropped
    # (Snapshot.fragment_ids rebuilds a frozenset per access — hoist one
    # set per table or this scan goes O(pins x fragments))
    live_ids = {
        t: snap.fragment_ids for t, snap in snapshots.items() if snap is not None
    }
    dropped = IntervalSet()
    seen_by_table: Dict[str, set] = {}
    for _w, pins, _cols, elem_table in elements:
        for p in pins:
            tbl = p.table or elem_table
            seen_by_table.setdefault(tbl, set()).add(p.fragment_id)
            live = live_ids.get(tbl)
            if live is not None and p.fragment_id not in live:
                dropped = dropped | IntervalSet([p.window])
    if invalidated.intersects(dropped):
        pairs = (invalidated & dropped).to_pairs()
        return "overwrite", f"cached windows pin dropped fragments over {pairs}"
    # unseen fragments: appended since the elements were built
    for tbl, snap in snapshots.items():
        if snap is None:
            continue
        seen = seen_by_table.get(tbl, set())
        unseen = IntervalSet(
            [
                Interval(f.key_min, f.key_max + 1)
                for f in snap.fragments
                if f.fragment_id not in seen
            ]
        )
        hit = invalidated & unseen
        if not hit.empty:
            return "append", f"append to {tbl}: unseen fragments over {hit.to_pairs()}"
    return "unknown", "cached windows invalidated for an unrecognized reason"
