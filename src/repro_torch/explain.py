"""``python -m repro_torch.explain`` — the cache-decision explainer, demonstrated.

Drives one warm :class:`~repro_torch.pipeline.executor.Workspace` through the
canonical 11-edit matrix (the same sequence ``tests/edit_matrix.py`` uses
for the bitwise-equivalence gate: cold, rerun, widen, narrow, beyond-data,
feature add/remove, append, overwrite, code edit, snapshot travel) and, for
every edit, prints the run's decision trail plus the **primary cause** the
explainer diagnosed — which must be exactly the cause the edit injected.

``--check`` turns the table into a gate (exit 1 unless 11/11 causes match).
The project is numpy-only, but the port's workspace still names the device
its torch nodes would run on: the CUDA card unless ``--device`` (or
``edit_matrix_demo(..., device=...)``) asks for another, so without a card
the demo raises unless it is given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.columnar import Table
from repro_torch.pipeline import Model, Project, Workspace, model, runtime

__all__ = ["EDITS", "demo_project", "edit_matrix_demo", "main"]

SCHEMA = {"eventTime": "<i8", "c1": "<f8", "c2": "<f8", "c3": "<i8"}


def events_table(lo: int, hi: int, seed: int = 0) -> Table:
    n = hi - lo
    rng = np.random.default_rng(seed + lo)
    return Table(
        {
            "eventTime": np.arange(lo, hi, dtype=np.int64),
            "c1": rng.standard_normal(n),
            "c2": rng.standard_normal(n),
            "c3": rng.integers(0, 100, n).astype(np.int64),
        }
    )


def demo_project(hi: int = 799, columns: Tuple[str, ...] = ("c1",), gain: float = 1.0) -> Project:
    """cleaned (rowwise drop) -> scaled (rowwise map), parameterized along
    the edit axes.  ``reads=`` declares the feature columns inside cleaned's
    scope, so adding one changes the *signature* columns (feature-change
    rather than unknown-scope); ``gain`` lives in scaled's closure, so
    editing it is a code edit."""
    p = Project("explain-demo")
    cols = list(columns)

    @model(project=p, incremental="rowwise", reads=("eventTime", *cols))
    @runtime("numpy")
    def cleaned(
        data=Model("ns.raw", columns=cols, filter=f"eventTime BETWEEN 0 AND {hi}")
    ):
        return data.filter(data.column("eventTime") % 10 != 0)

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def scaled(data=Model("cleaned")):
        out = {n: data.column(n) for n in data.column_names}
        out["score"] = gain * np.asarray(data.column("c1"), dtype=np.float64)
        return out

    return p


def _append(catalog) -> None:
    catalog.append("ns.raw", events_table(1000, 1200))


def _overwrite(catalog) -> None:
    catalog.overwrite_range("ns.raw", 128, 256, data=events_table(128, 256, seed=7))


_BASE = dict(hi=799)
_BEYOND = dict(hi=4999)

# (label, factory params, catalog mutation, travel_to, expected primary cause)
EDITS: List[Tuple[str, Dict, Optional[Callable], Optional[int], str]] = [
    ("cold", _BASE, None, None, "cold"),
    ("rerun", _BASE, None, None, "cached"),
    ("widen", dict(hi=899), None, None, "window-widened"),
    ("narrow", dict(hi=499), None, None, "cached"),
    ("beyond", _BEYOND, None, None, "window-widened"),
    ("feature-add", dict(hi=4999, columns=("c1", "c2")), None, None, "feature-change"),
    ("feature-remove", _BEYOND, None, None, "cached"),
    ("append", _BEYOND, _append, None, "append"),
    ("overwrite", _BEYOND, _overwrite, None, "overwrite"),
    ("code-edit", dict(hi=4999, gain=2.0), None, None, "code-edit"),
    ("travel", _BEYOND, None, 1, "snapshot-travel"),
]


def _snapshot_ids(catalog) -> Dict[str, str]:
    return {
        t: catalog.current_snapshot(t).snapshot_id for t in catalog.list_tables()
    }


def edit_matrix_demo(root: str, device=None):
    """Run the 11-edit matrix against one warm workspace at ``root`` whose
    torch device is ``device`` (``None``: the CUDA card); returns
    ``[(label, expected_cause, got_cause, RunResult), ...]``."""
    ws = Workspace(root, rows_per_fragment=128, torch_device=device)
    ws.catalog.create_table("ns", "raw", SCHEMA, "eventTime")
    ws.catalog.append("ns.raw", events_table(0, 1000))
    mutations = 0
    # snapshot state after the first N mutations, for the travel edit
    snap_ids: Dict[int, Dict[str, str]] = {0: _snapshot_ids(ws.catalog)}
    out = []
    for label, params, mutate, travel_to, expected in EDITS:
        if mutate is not None:
            mutate(ws.catalog)
            mutations += 1
            snap_ids[mutations] = _snapshot_ids(ws.catalog)
        pins = snap_ids[travel_to] if travel_to is not None else None
        res = ws.run(demo_project(**params), snapshot_pins=pins)
        got = res.explanation.primary_cause() if res.explanation else "?"
        out.append((label, expected, got, res))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explain",
        description="run the 11-edit matrix and print the explainer's "
        "diagnosed cause per edit",
    )
    ap.add_argument("--root", default=None, help="workspace root (default: a temp dir)")
    ap.add_argument(
        "--check", action="store_true", help="exit 1 unless all 11 causes match"
    )
    ap.add_argument(
        "-v", "--verbose", action="store_true", help="print each run's full decision trail"
    )
    ap.add_argument(
        "--device", default=None, help="the workspace's torch device (default: the CUDA card)"
    )
    args = ap.parse_args(argv)

    root = args.root or tempfile.mkdtemp(prefix="repro-explain-")
    results = edit_matrix_demo(root, device=args.device)
    ok = 0
    print(f"{'edit':<16} {'expected':<16} {'diagnosed':<16} ")
    for label, expected, got, res in results:
        mark = "ok" if got == expected else "MISMATCH"
        ok += got == expected
        print(f"{label:<16} {expected:<16} {got:<16} {mark}")
        if args.verbose:
            print("  " + res.explain().replace("\n", "\n  "))
    print(f"{ok}/{len(results)} causes diagnosed correctly")
    if args.check and ok != len(results):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
