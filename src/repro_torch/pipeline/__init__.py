"""Declarative pipeline abstractions (paper §II): the `@model` DSL, DAG
reconstruction from function inputs, logical→physical plan compilation with
inserted system scans, and the multi-runtime executor."""

from repro_torch.analysis import ContractError, ScopeViolation
from repro_torch.pipeline.dsl import Model, ModelDef, Project, model, runtime
from repro_torch.pipeline.dag import Dag, DagError, build_dag
from repro_torch.pipeline.filters import ParsedFilter, date_ordinal, parse_filter
from repro_torch.pipeline.physical import PhysicalPlan, SystemScanStep, UserFnStep, compile_plan
from repro_torch.pipeline.executor import RunResult, Workspace, run_project

__all__ = [
    "Model",
    "ModelDef",
    "Project",
    "model",
    "runtime",
    "Dag",
    "DagError",
    "ContractError",
    "ScopeViolation",
    "build_dag",
    "ParsedFilter",
    "parse_filter",
    "date_ordinal",
    "PhysicalPlan",
    "SystemScanStep",
    "UserFnStep",
    "compile_plan",
    "Workspace",
    "RunResult",
    "run_project",
]
