"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each is a data file under
``portbench/configs/`` and ``portbench/traffic/``.  Each metric is a small
reader, ``portbench/metrics/<name>.py``, with ``read(run) -> float | None``.
Adding a cell, a mix or a metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
ROOT = os.path.dirname(HERE)  # the checkout


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: Optional[str]  # per-layer metrics only
    workloads: Optional[List[str]]
    end_to_end: bool


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


def load(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: Dict[str, Any], name: str) -> Cell:
    for w in bench["workloads"]:
        if w["name"] == name:
            return Cell(w["name"], w["config"], w["traffic"], int(w["chips"]))
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics(bench: Dict[str, Any]) -> List[Metric]:
    out = []
    for key, e2e in (("end_to_end", True), ("per_layer", False)):
        for m in bench[key]:
            out.append(Metric(m["name"], m["unit"], m["better"], m["source"],
                              m.get("moves"), m.get("workloads"), e2e))
    return out


def end_to_end_of(bench: Dict[str, Any], cell_name: str) -> List[Metric]:
    """The end-to-end metrics a cell reports: those that list it, and those
    that list no cells."""
    return [m for m in metrics(bench)
            if m.end_to_end and (m.workloads is None or cell_name in m.workloads)]


def per_layer_of(bench: Dict[str, Any], cell_name: str) -> List[Metric]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    reported = {m.name for m in end_to_end_of(bench, cell_name)}
    return [m for m in metrics(bench)
            if not m.end_to_end and (cell_name in m.workloads if m.workloads is not None
                                     else m.moves in reported)]


def _data(folder: str, name: str) -> Dict[str, Any]:
    path = os.path.join(HERE, folder, name + ".json")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> Dict[str, Any]:
    return _data("configs", name)


def traffic(name: str) -> Dict[str, Any]:
    return _data("traffic", name)


def _load_file(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[Any], Optional[float]]:
    """The reader of ``metric`` (a name may hold dots, so the file is loaded
    by its path)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    return _load_file(path, "portbench_metric_" + metric.replace(".", "_").replace("-", "_")).read
