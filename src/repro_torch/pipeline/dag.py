"""DAG reconstruction and validation (the control plane's first job)."""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from repro_torch.analysis import ContractError
from repro_torch.pipeline.dsl import Model, ModelDef, Project

__all__ = ["Dag", "build_dag", "DagError"]


class DagError(ValueError):
    pass


@dataclass
class Dag:
    project: Project
    # edges model -> the models it consumes; scan leaves are table refs
    edges: Dict[str, List[str]]
    scan_leaves: Dict[str, List[Tuple[str, Model]]]  # model -> its table refs
    order: List[str]  # topological

    def consumers_of(self, name: str) -> List[str]:
        return [m for m, deps in self.edges.items() if name in deps]

    def sinks(self) -> List[str]:
        consumed = {d for deps in self.edges.values() for d in deps}
        return [m for m in self.project.models if m not in consumed]


def _verify_contracts(project: Project, strict: bool) -> None:
    """Static contract verdicts (repro_torch.analysis) for every incremental
    model: a rowwise/keyed declaration falsified by the bytecode —
    cross-row ops, nondeterminism, hidden state — raises before any
    execution, with the model name and ``file:line``.  ``strict=False``
    demotes violations to warnings (run anyway, eyes open);
    ``verify=False`` on the model opts it out entirely."""
    for name, mdef in project.models.items():
        if mdef.incremental not in ("rowwise", "keyed"):
            continue
        if not getattr(mdef, "verify", True):
            continue
        ana = getattr(mdef, "analysis", None)
        violations = ana.violations if ana is not None else []
        if not violations:
            continue
        detail = "; ".join(f.render() for f in violations)
        if strict:
            first = violations[0]
            raise ContractError(
                f"incremental={mdef.incremental!r} declaration is falsified "
                f"by static analysis: {detail} (demote to a warning with "
                f"strict=False, or mark the model verify=False)",
                model=name,
                filename=first.filename,
                lineno=first.lineno,
                findings=violations,
            )
        warnings.warn(
            f"model {name!r}: contract violations ignored (strict=False): "
            f"{detail}",
            stacklevel=3,
        )


def build_dag(project: Project, strict: bool = True) -> Dag:
    """Reconstruct the DAG from ``Model`` references; reject cycles, dangling
    names are treated as catalog tables iff they are namespaced (contain a
    dot) — the same convention as the paper's ``raw_data`` leaf."""
    _verify_contracts(project, strict)
    edges: Dict[str, List[str]] = {}
    scan_leaves: Dict[str, List[Tuple[str, Model]]] = {}
    for name, mdef in project.models.items():
        deps: List[str] = []
        leaves: List[Tuple[str, Model]] = []
        for arg, ref in mdef.inputs.items():
            if ref.name in project.models:
                if ref.columns is not None or ref.filter is not None:
                    raise DagError(
                        f"{name}: projections/filters belong on scan leaves, "
                        f"but {ref.name!r} is a model"
                    )
                deps.append(ref.name)
            elif "." in ref.name:
                leaves.append((arg, ref))
            else:
                raise DagError(
                    f"{name}: unknown reference {ref.name!r} "
                    f"(not a model; catalog tables are 'namespace.table')"
                )
        edges[name] = deps
        scan_leaves[name] = leaves

        # incrementality contracts are structural, so enforce them here:
        #
        # - rowwise, one input: output window == input window; residuals are
        #   sliced out of the upstream output, so a model input must itself
        #   be *windowed* — rowwise or keyed, both of whose outputs carry a
        #   sort-key window (scan leaves always qualify: the table's sort
        #   key windows them).
        # - rowwise, ≥2 inputs (incremental sort-merge join): every input
        #   must be windowed; the physical plan intersects the inputs'
        #   windows into the node's joint window and validates that all
        #   inputs share one sort key (that needs catalog metadata, so it
        #   lives in compile_plan, not here).
        # - keyed: a per-key-group aggregation addressed by the same sort
        #   key; structurally it takes exactly one windowed input (aggregate
        #   after a multi-input rowwise join, not instead of one).
        if mdef.incremental in ("rowwise", "keyed"):
            if len(mdef.inputs) < 1:
                raise DagError(
                    f"{name}: incremental={mdef.incremental!r} requires at "
                    f"least one input"
                )
            if mdef.incremental == "keyed" and len(mdef.inputs) != 1:
                raise DagError(
                    f"{name}: incremental='keyed' requires exactly one "
                    f"input, got {len(mdef.inputs)} (join upstream with a "
                    f"multi-input rowwise node, then aggregate)"
                )
            for ref in mdef.inputs.values():
                if ref.name in project.models and (
                    project.models[ref.name].incremental not in ("rowwise", "keyed")
                ):
                    raise DagError(
                        f"{name}: incremental={mdef.incremental!r} requires "
                        f"its model input {ref.name!r} to be windowed "
                        f"(rowwise or keyed) — its output has no sort-key "
                        f"window to slice residuals from"
                    )

    # Kahn topological sort
    indeg = {m: len(deps) for m, deps in edges.items()}
    ready = sorted(m for m, d in indeg.items() if d == 0)
    order: List[str] = []
    while ready:
        m = ready.pop(0)
        order.append(m)
        for consumer, deps in edges.items():
            if m in deps:
                indeg[consumer] -= 1
                if indeg[consumer] == 0:
                    ready.append(consumer)
        ready.sort()
    if len(order) != len(project.models):
        cyclic = sorted(set(project.models) - set(order))
        raise DagError(f"cycle detected among models: {cyclic}")
    return Dag(project=project, edges=edges, scan_leaves=scan_leaves, order=order)
