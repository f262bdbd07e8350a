"""Quickstart: the paper's programming model + differential cache, end to end,
on the PyTorch port.

Builds the DAG of paper Listing 1 (raw_data → cleaned_data → final_data →
training_data) against a lakehouse in a temp directory, runs it twice with
an overlapping ad-hoc query in between, and prints the byte ledger —
demonstrating the three §III-A behaviours:

  1. the first run pays full object-storage reads,
  2. a *different* scan (fewer columns, wider window) pays only the delta,
  3. the re-run with a narrower window is served entirely from cache.

``training_data`` is a ``@runtime("torch")`` node: it gets its columns as
``{name: torch.Tensor}`` on the CUDA card (narrowed as jax's x32 narrows
them) and returns tensors.  The DAG's model nodes recompute on every run
(the default, ``incremental="none"``); see
``examples/torch/incremental_iteration.py`` for the engine that caches
*intermediate model outputs* differentially too.

Run:  python examples/torch/quickstart.py               (on the CUDA card)
      python examples/torch/quickstart.py --device cpu  (on the CPU)
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core.intervals import IntervalSet
from repro_torch.core.columnar import Table
from repro_torch.pipeline.dsl import Model, Project, model, runtime
from repro_torch.pipeline.executor import Workspace


def make_project():
    """The user's declarative DAG (paper Listing 1)."""
    project = Project("quickstart")

    @model(project=project)
    @runtime("numpy")
    def cleaned_data(
        data=Model("ns.raw_data", columns=["c1", "c2", "c3"],
                   filter="eventTime BETWEEN 0 AND 40000"),
    ):
        keep = ~np.isnan(data.column("c1"))
        return data.filter(keep)

    @model(project=project)
    @runtime("numpy")
    def final_data(data=Model("cleaned_data")):
        c1 = data.column("c1")
        return {
            "c1_norm": (c1 - c1.mean()) / c1.std(),
            "c3": data.column("c3"),
        }

    @model(project=project)
    @runtime("torch")  # the "second language": same cache, zero refactor
    def training_data(data=Model("final_data")):
        x = data["c1_norm"]
        return {"feature": torch.tanh(x), "label": data["c3"]}

    return project


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the torch node (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    tmp = tempfile.mkdtemp(prefix="repro-quickstart-")
    ws = Workspace(tmp, rows_per_fragment=8192, torch_device=args.device)

    # ---- publish a raw events table (the "S3 + Iceberg" side)
    rng = np.random.default_rng(0)
    n = 100_000
    ws.catalog.create_table(
        "ns", "raw_data",
        {"eventTime": "<i8", "c1": "<f8", "c2": "<f8", "c3": "<i8"},
        "eventTime",
    )
    ws.catalog.append(
        "ns.raw_data",
        Table({
            "eventTime": np.arange(n, dtype=np.int64),
            "c1": rng.standard_normal(n),
            "c2": rng.standard_normal(n),
            "c3": rng.integers(0, 100, n).astype(np.int64),
        }),
    )
    project = make_project()

    # ---- run 1: cold
    r1 = ws.run(project)
    print(f"run 1 (cold):        {r1.bytes_from_store:>12,} B from store, "
          f"{r1.bytes_from_cache:>12,} B from cache")

    # ---- user B's ad-hoc scan: fewer columns, WIDER window (paper user B)
    ws.scans.scan("ns.raw_data", ["c1", "c3"], IntervalSet.of((0, 80_000)))
    rep = ws.scans.reports[-1]
    print(f"user B (c1,c3 0-80k): {rep.bytes_from_store:>12,} B from store "
          f"(only the 40k-80k delta), {rep.bytes_from_cache:>12,} B from cache")

    # ---- run 2: same DAG again — fully cached
    r2 = ws.run(project)
    print(f"run 2 (warm):        {r2.bytes_from_store:>12,} B from store, "
          f"{r2.bytes_from_cache:>12,} B from cache")
    assert r2.bytes_from_store == 0, "re-run must be fully served by the cache"

    print("\nfinal training_data columns:", r2.outputs["training_data"].column_names)
    print("cache held", len(ws.scans.cache.elements()), "elements,",
          f"{ws.scans.cache.nbytes:,} bytes")
    return r2


if __name__ == "__main__":
    main()
