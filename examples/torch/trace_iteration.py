"""Observability on the iteration loop, on the PyTorch port: trace it,
scrape it, explain it.

Runs the BENCH_3-style edit loop (cold → rerun → widen → append → code
edit) on a traced workspace, then shows the three ``repro_torch.obs`` surfaces:

  1. **trace**   — every run is a span tree (plan → claim-wait → residual →
     union → insert → publish); saved via ``Tracer.save`` and convertible
     to a Perfetto/chrome://tracing timeline with ``python -m repro_torch.trace``.
  2. **metrics** — the registry every report is derived from, scraped as
     Prometheus text.
  3. **explain** — ``RunResult.explain()`` names the *cause* of every
     serve/recompute decision.  Read this before touching cache internals.

Run:  python examples/torch/trace_iteration.py [--device cpu]
Then: PYTHONPATH=src python -m repro_torch.trace /tmp/repro_torch_iteration_trace.json \
          --chrome /tmp/torch_iteration_perfetto.json
      and load the chrome file in https://ui.perfetto.dev
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core.columnar import Table
from repro_torch.obs import Tracer
from repro_torch.pipeline.dsl import Model, Project, model, runtime
from repro_torch.pipeline.executor import Workspace

TRACE_PATH = os.path.join(tempfile.gettempdir(), "repro_torch_iteration_trace.json")


def events(lo, hi, seed=0):
    rng = np.random.default_rng(seed + lo)
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
    @runtime("numpy")
    def scored(data=Model("cleaned")):
        out = {n: data.column(n) for n in data.column_names}
        out["score"] = gain * (
            np.asarray(data.column("v1"), np.float64)
            + np.asarray(data.column("v2"), np.float64)
        )
        return out

    return p


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the workspace (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    tracer = Tracer()
    with tempfile.TemporaryDirectory() as root:
        ws = Workspace(root, rows_per_fragment=2048, tracer=tracer,
                       torch_device=args.device)
        ws.catalog.create_table("ns", "events", {
            "eventTime": "<i8", "v1": "<f8", "v2": "<f8", "flag": "<i8",
        }, "eventTime")
        ws.catalog.append("ns.events", events(0, 15_000))

        edits = [
            ("cold", 9_999, 1.0, None),
            ("identical rerun", 9_999, 1.0, None),
            ("widen window", 18_999, 1.0, None),
            ("append rows", 18_999, 1.0,  # lands INSIDE the warm window
             lambda: ws.catalog.append("ns.events", events(15_000, 20_000))),
            ("code edit (gain)", 18_999, 2.0, None),
        ]
        for label, hi, gain, mutate in edits:
            if mutate is not None:
                mutate()
            res = ws.run(make_project(hi, gain))
            print(f"=== {label}: {res.rows_to_user_fns} rows through user fns, "
                  f"{res.bytes_from_store} store bytes")
            print(res.explain())
            print()

        tracer.save(TRACE_PATH)
        spans = sum(1 for r in tracer.roots() for _ in r.walk())
        print(f"trace: {spans} spans from {len(tracer.roots())} runs "
              f"-> {TRACE_PATH}")
        print("render a timeline:  PYTHONPATH=src python -m repro_torch.trace "
              f"{TRACE_PATH} --chrome /tmp/torch_iteration_perfetto.json")

        print("\nPrometheus scrape (excerpt):")
        for line in ws.metrics.to_text().splitlines():
            if line.startswith(("runs_total", "run_rows_to_user_fns",
                                "cache_hit_bytes", "residual_rows")):
                print("  " + line)
    return tracer


if __name__ == "__main__":
    main()
