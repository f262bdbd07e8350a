"""Logical DAG → physical plan (paper Fig. 3).

For every scan leaf the control plane inserts a **system scan step** ahead
of the user function — the decoupling that (a) shields users from data
management and (b) is the hook where the differential cache lives.  Model-to-
model edges become zero-copy in-memory handoffs.

The plan also carries each node's *differential identity*:

- ``signature`` — a digest of everything that determines the node's output
  rows other than the upstream data itself: the function's code fingerprint,
  its runtime, its incrementality contract, and the signatures of its inputs
  (for scan leaves: table, projections, canonical filter, snapshot pin).
  A code edit or upstream redefinition changes the signature, which
  invalidates the node — and, by construction, every node downstream of it.
- ``window`` / ``sort_key`` — the sort-key extent the node's output covers,
  propagated up rowwise/keyed chains so the executor can plan intermediate
  outputs like scans (cached windows + residual recompute).  A multi-input
  rowwise node (incremental sort-merge join) takes the *intersection* of its
  inputs' windows — the joint window its zip-aligned output covers — and
  compile-time validation requires all inputs to share one sort key.
- ``leaf_pairs`` — the ``(table, snapshot_id)`` catalog leaves at the roots
  of the node's windowed chains (one for a plain rowwise/keyed chain,
  several for a join).  Model cache elements pin those tables' fragments,
  so append/overwrite invalidation of intermediate outputs reuses the exact
  snapshot logic leaf scans use; ``leaf_table``/``leaf_snapshot_id`` remain
  as the single-leaf convenience (the first pair).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.intervals import IntervalSet
from repro_torch.analysis import ContractError
from repro_torch.pipeline.dag import Dag
from repro_torch.pipeline.dsl import Model, ModelDef, code_fingerprint
from repro_torch.pipeline.filters import ParsedFilter, parse_filter

__all__ = ["SystemScanStep", "UserFnStep", "PhysicalPlan", "compile_plan"]


def _contract_error(mdef: ModelDef, message: str) -> ContractError:
    code = getattr(mdef.fn, "__code__", None)
    return ContractError(
        message,
        model=mdef.name,
        filename=code.co_filename if code else None,
        lineno=code.co_firstlineno if code else None,
    )


def _signature_columns(
    mdef: ModelDef,
    cols: Tuple[str, ...],
    parsed: ParsedFilter,
    sort_key: str,
) -> Tuple[str, ...]:
    """The column set a scan leaf contributes to its consumer's SIGNATURE.

    When the consumer's read scope is proven/declared, the signature keeps
    only the columns the function can actually observe (plus predicate
    columns and the sort key, which shape the rows themselves) — so adding
    or dropping an *unread* column leaves every cached window valid.  With
    an UNKNOWN scope this returns ``cols`` unchanged: byte-identical
    signatures to the pre-analysis behavior.  Only the signature narrows —
    the physical scan still reads exactly what was declared."""
    scope = getattr(mdef, "read_scope", None)
    if scope is None:
        return cols
    return tuple(
        sorted((set(cols) & set(scope)) | set(parsed.predicate_columns) | {sort_key})
    )


@dataclass(frozen=True)
class SystemScanStep:
    """A scan the platform performs on behalf of the user."""

    model: str  # consumer model name
    arg: str  # which argument it feeds
    table: str
    columns: Tuple[str, ...]
    window_pairs: tuple  # IntervalSet as pairs (hashable / serializable)
    predicate_filter: Optional[str]  # original filter string (post-predicates)
    snapshot_id: Optional[str]

    @property
    def window(self) -> IntervalSet:
        return IntervalSet.from_pairs(self.window_pairs)


@dataclass(frozen=True)
class UserFnStep:
    model: str
    runtime: str
    materialize: bool
    # inputs: arg -> ("scan", scan index) or ("model", parent name)
    bindings: Tuple[Tuple[str, Tuple[str, object]], ...]
    # differential identity (see module docstring); populated for every node,
    # consumed by the executor only when incremental != "none"
    incremental: str = "none"
    signature: str = ""
    window_pairs: tuple = ()
    sort_key: Optional[str] = None
    leaf_table: Optional[str] = None
    leaf_snapshot_id: Optional[str] = None
    # every (table, snapshot_id) leaf under the node's windowed chains;
    # (leaf_table, leaf_snapshot_id) is leaf_pairs[0] when non-empty
    leaf_pairs: Tuple[Tuple[str, Optional[str]], ...] = ()
    # structured mirror of the tuple `signature` digests, consumed by
    # repro_torch.obs.explain to diagnose WHICH part changed between runs.  Scan
    # entries carry one trailing non-signature field (the raw requested
    # columns) so scope-narrowed serves are recognizable; everything else
    # maps 1:1 onto the digest inputs.
    sig_parts: tuple = ()

    @property
    def window(self) -> IntervalSet:
        return IntervalSet.from_pairs(self.window_pairs)


@dataclass
class PhysicalPlan:
    scans: List[SystemScanStep]
    steps: List[UserFnStep]  # in executable (topological) order

    def describe(self) -> str:
        lines = []
        for s in self.scans:
            lines.append(
                f"SCAN {s.table} cols={list(s.columns)} window={list(s.window_pairs)}"
                f" -> {s.model}.{s.arg}"
            )
        for st in self.steps:
            srcs = ", ".join(
                f"{arg}<-{kind}:{ref}" for arg, (kind, ref) in st.bindings
            )
            tag = " MATERIALIZE" if st.materialize else ""
            inc = f" INCREMENTAL[{st.incremental}]" if st.incremental != "none" else ""
            lines.append(f"RUN [{st.runtime}] {st.model}({srcs}){tag}{inc}")
        return "\n".join(lines)


def _digest(parts: tuple) -> str:
    return hashlib.sha256(repr(parts).encode()).hexdigest()


def compile_plan(dag: Dag, sort_keys: Dict[str, str]) -> PhysicalPlan:
    """``sort_keys`` maps catalog table full-names to their sort key (the
    control plane fetches this from catalog metadata)."""
    scans: List[SystemScanStep] = []
    steps: List[UserFnStep] = []
    # per-node differential identity, accumulated in topological order so a
    # node's signature can fold in its parents' (the signature chain)
    sigs: Dict[str, str] = {}
    windows: Dict[str, IntervalSet] = {}
    node_sort_key: Dict[str, Optional[str]] = {}
    leaves_of: Dict[str, Tuple[Tuple[str, Optional[str]], ...]] = {}

    for name in dag.order:
        mdef: ModelDef = dag.project[name]
        bindings: List[Tuple[str, Tuple[str, object]]] = []
        sig_inputs: List[tuple] = []
        part_inputs: List[tuple] = []  # named/structured mirror of sig_inputs
        in_windows: List[IntervalSet] = []
        in_sort_keys: List[Optional[str]] = []
        in_leaf_pairs: List[Tuple[str, Optional[str]]] = []
        for arg, ref in mdef.inputs.items():
            if ref.name in dag.project.models:
                bindings.append((arg, ("model", ref.name)))
                sig_inputs.append(("model", sigs[ref.name]))
                part_inputs.append(("model", ref.name, sigs[ref.name]))
                in_windows.append(windows[ref.name])
                in_sort_keys.append(node_sort_key[ref.name])
                in_leaf_pairs.extend(leaves_of[ref.name])
            else:
                sort_key = sort_keys[ref.name]
                parsed = parse_filter(ref.filter, sort_key)
                if ref.columns is None:
                    raise _contract_error(
                        mdef, f"scan of {ref.name} must declare columns="
                    )
                # post-predicates need their columns present in the scan
                cols = tuple(sorted(set(ref.columns) | set(parsed.predicate_columns)))
                step = SystemScanStep(
                    model=name,
                    arg=arg,
                    table=ref.name,
                    columns=cols,
                    window_pairs=parsed.window.to_pairs(),
                    predicate_filter=ref.filter,
                    snapshot_id=ref.snapshot_id,
                )
                bindings.append((arg, ("scan", len(scans))))
                scans.append(step)
                sig_cols = _signature_columns(mdef, cols, parsed, sort_key)
                sig_inputs.append(
                    # NOTE: the window is absent on purpose — it is the
                    # differential dimension, not part of the node identity.
                    # The column set is narrowed to the consumer's verified
                    # read scope (no-op when the scope is UNKNOWN).
                    (
                        "scan",
                        ref.name,
                        sig_cols,
                        parsed.predicate_signature(),
                        ref.snapshot_id,
                    )
                )
                part_inputs.append(
                    (
                        "scan",
                        ref.name,
                        sig_cols,
                        parsed.predicate_signature(),
                        ref.snapshot_id,
                        mdef.read_scope is not None,
                        cols,  # raw requested columns: NOT in the digest
                    )
                )
                in_windows.append(parsed.window)
                in_sort_keys.append(sort_key)
                in_leaf_pairs.append((ref.name, ref.snapshot_id))
        fingerprint = code_fingerprint(mdef.fn)
        sigs[name] = _digest(
            (
                fingerprint,
                mdef.runtime,
                mdef.incremental,
                tuple(sig_inputs),
            )
        )
        sig_parts = (
            ("code", fingerprint),
            ("runtime", mdef.runtime),
            ("incremental", mdef.incremental),
            ("inputs", tuple(part_inputs)),
        )
        if mdef.incremental in ("rowwise", "keyed") and in_windows:
            # an incremental node's output is windowed by the shared sort
            # key; for a multi-input join the joint window is the
            # INTERSECTION of the inputs' windows (zip-aligned residuals
            # are only defined where every input has rows to offer)
            if len(set(in_sort_keys)) > 1:
                raise _contract_error(
                    mdef,
                    f"incremental={mdef.incremental!r} inputs must "
                    f"share one sort key, got {sorted(set(map(str, in_sort_keys)))}",
                )
            window = in_windows[0]
            for w in in_windows[1:]:
                window = window.intersect(w)
            windows[name] = window
            node_sort_key[name] = in_sort_keys[0]
        else:
            # multi-input "none" nodes keep a best-effort window that
            # downstream incremental nodes can never consume anyway
            windows[name] = in_windows[-1] if in_windows else IntervalSet.empty_set()
            node_sort_key[name] = in_sort_keys[-1] if in_sort_keys else None
        # dedupe leaf pairs preserving input order; one table pinned under
        # two snapshots in one incremental node has no single validity
        # answer per fragment, so reject it outright
        pairs: List[Tuple[str, Optional[str]]] = []
        for p in in_leaf_pairs:
            if p not in pairs:
                pairs.append(p)
        if mdef.incremental in ("rowwise", "keyed"):
            by_table: Dict[str, set] = {}
            for t, sid in pairs:
                by_table.setdefault(t, set()).add(sid)
            dup = sorted(t for t, sids in by_table.items() if len(sids) > 1)
            if dup:
                raise _contract_error(
                    mdef,
                    f"incremental={mdef.incremental!r} reads "
                    f"table(s) {dup} under two different snapshot pins — "
                    f"pin one snapshot per table",
                )
        leaves_of[name] = tuple(pairs)
        steps.append(
            UserFnStep(
                model=name,
                runtime=mdef.runtime,
                materialize=mdef.materialize,
                bindings=tuple(bindings),
                incremental=mdef.incremental,
                signature=sigs[name],
                window_pairs=windows[name].to_pairs(),
                sort_key=node_sort_key[name],
                leaf_table=pairs[0][0] if pairs else None,
                leaf_snapshot_id=pairs[0][1] if pairs else None,
                leaf_pairs=tuple(pairs),
                sig_parts=sig_parts,
            )
        )
    return PhysicalPlan(scans=scans, steps=steps)
