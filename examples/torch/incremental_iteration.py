"""Incremental re-execution on the PyTorch port: warm iteration cost ∝ the
*edit*, not the DAG.

The paper's core usage pattern is iteration — "adding or removing features,
restricting or relaxing time windows".  With ``@model(incremental="rowwise")``
the differential cache sits below EVERY node, not just leaf scans: re-running
an edited pipeline recomputes only the rows whose inputs actually changed.
The middle node, ``feats``, is a ``@runtime("torch")`` node on the CUDA card
sharing the one model store with its numpy neighbours.

This script runs one pipeline through the canonical edit sequence and prints
the ledger after each run:

  1. cold           — full compute (populates scan cache + model store)
  2. identical rerun— zero store bytes, zero rows through user fns
  3. widen window   — only the newly-exposed rows recompute
  4. append rows    — only the appended rows recompute
  5. edit last fn   — only that node (and its descendants) recompute

Run:  python examples/torch/incremental_iteration.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core.columnar import Table
from repro_torch.pipeline.dsl import Model, Project, model, runtime
from repro_torch.pipeline.executor import Workspace


def events(lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    n = hi - lo
    return Table({
        "eventTime": np.arange(lo, hi, dtype=np.int64),
        "v1": rng.standard_normal(n),
        "v2": rng.standard_normal(n),
        "flag": rng.integers(0, 4, n).astype(np.int64),
    })


def make_project(hi, gain=1.0):
    p = Project("iteration")

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def cleaned(data=Model("ns.events", columns=["v1", "v2", "flag"],
                           filter=f"eventTime BETWEEN 0 AND {hi}")):
        return data.filter(data.column("flag") > 0)

    @model(project=p, incremental="rowwise")
    @runtime("torch")  # second language, same model store
    def feats(data=Model("cleaned")):
        return {k: (torch.where(v >= 0, v, v * 0.5) if v.is_floating_point() else v)
                for k, v in data.items()}

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def scored(data=Model("feats")):
        out = {n: data.column(n) for n in data.column_names}
        out["score"] = gain * (np.asarray(data.column("v1"), np.float64)
                               + np.asarray(data.column("v2"), np.float64))
        return out

    return p


def show(label, res):
    print(f"{label:<28} store {res.bytes_from_store:>9,} B | "
          f"model-cache {res.bytes_from_model_cache:>9,} B | "
          f"rows→fns {res.rows_to_user_fns:>7,} | "
          f"per node { {k: v['fresh_rows'] for k, v in res.node_stats.items()} }")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the torch node (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    ws = Workspace(tempfile.mkdtemp(prefix="repro-incr-"), rows_per_fragment=4096,
                   torch_device=args.device)
    ws.catalog.create_table(
        "ns", "events",
        {"eventTime": "<i8", "v1": "<f8", "v2": "<f8", "flag": "<i8"},
        "eventTime",
    )
    ws.catalog.append("ns.events", events(0, 50_000))

    show("1. cold run", ws.run(make_project(hi=40_000)))
    show("2. identical rerun", ws.run(make_project(hi=40_000)))
    show("3. widen window +25%", ws.run(make_project(hi=50_000)))

    ws.catalog.append("ns.events", events(50_000, 52_000, seed=9))
    show("4. append 2k rows upstream", ws.run(make_project(hi=60_000)))

    last = ws.run(make_project(hi=60_000, gain=2.0))
    show("5. edit last fn (gain=2)", last)

    st = ws.model_store
    print(f"\nmodel store: {len(st.elements())} elements, {st.nbytes:,} bytes "
          f"({st.full_hits} full hits / {st.partial_hits} partial / {st.lookups} lookups)")
    return last


if __name__ == "__main__":
    main()
