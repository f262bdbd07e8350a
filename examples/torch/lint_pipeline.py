"""Static contracts as an admission gate for untrusted pipeline code, on
the PyTorch port.

A platform running pipelines for many tenants cannot execute arbitrary
submissions and *hope* they honored the `incremental=` contract — a cumsum
in a "rowwise" function silently corrupts every warm window it serves to
other tenants.  `repro_torch.analysis` closes that gap before execution:

  1. a tenant submits pipeline SOURCE (here: a string; in production, a
     file) claiming ``incremental="rowwise"``
  2. the service imports it in a scratch namespace and lints the project —
     cross-row ops (RPR001), nondeterminism (RPR002), hidden state
     (RPR003) and scope violations (RPR004/5) are findings with file:line
  3. dirty submissions are rejected with the findings; clean ones are
     admitted and run in an *untrusted* session, where plan-time scope
     enforcement guarantees the code can only ever observe the columns it
     provably (or declaredly) reads

The violating submission lives in a source string (not module-level code)
precisely so this example itself lints clean:
``python -m repro_torch.lint examples/torch`` is a CI gate.  The bytecode
walker runs on Python 3.10 and 3.11; on later versions it abstains, and
this example's asserts fail there, as its reference's do.

Run:  python examples/torch/lint_pipeline.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core.columnar import Table
from repro_torch.lint import lint_project
from repro_torch.pipeline import ScopeViolation
from repro_torch.service import PipelineService

DIRTY_SUBMISSION = '''
import numpy as np
from repro_torch.pipeline import Model, Project, model

project = Project("dirty")

@model(project=project, incremental="rowwise")
def running_total(
    data=Model("ns.events", columns=["v1"], filter="eventTime BETWEEN 0 AND 9999")
):
    # claims rowwise, computes a running sum: row i depends on rows < i,
    # so any warm window served from cache would be silently wrong
    return {"eventTime": data.column("eventTime"),
            "total": np.cumsum(np.asarray(data.column("v1")))}
'''

CLEAN_SUBMISSION = '''
import numpy as np
from repro_torch.pipeline import Model, Project, model

project = Project("clean")

@model(project=project, incremental="rowwise")
def scored(
    data=Model("ns.events", columns=["v1"], filter="eventTime BETWEEN 0 AND 9999")
):
    return {"eventTime": data.column("eventTime"),
            "score": 2.0 * np.asarray(data.column("v1"), np.float64)}
'''

GREEDY_SUBMISSION = '''
import numpy as np
from repro_torch.pipeline import Model, Project, model

project = Project("greedy")

@model(project=project, incremental="rowwise")
def scored(
    data=Model("ns.events", columns=["v1", "v2"],
               filter="eventTime BETWEEN 0 AND 9999")
):
    # lints clean — but projects v2, which it provably never reads.  The
    # untrusted session's plan-time gate rejects the over-broad scan.
    return {"eventTime": data.column("eventTime"),
            "score": 2.0 * np.asarray(data.column("v1"), np.float64)}
'''


def admit(label, source):
    """The admission gate: import the submission, lint its project."""
    ns = {}
    exec(compile(source, f"<submission:{label}>", "exec"), ns)
    findings = lint_project(ns["project"])
    if findings:
        print(f"  {label}: REJECTED")
        for f in findings:
            print(f"    {f.render()}")
        return None
    print(f"  {label}: admitted (0 findings)")
    return ns["project"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the service (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    print("== admission gate: lint before execute ==")
    dirty = admit("dirty (cumsum as rowwise)", DIRTY_SUBMISSION)
    clean = admit("clean", CLEAN_SUBMISSION)
    greedy = admit("greedy (unread v2 projected)", GREEDY_SUBMISSION)
    assert dirty is None and clean is not None and greedy is not None

    with tempfile.TemporaryDirectory() as tmp:
        with PipelineService(
            os.path.join(tmp, "svc"), workers=2, rows_per_fragment=1024,
            torch_device=args.device,
        ) as svc:
            rng = np.random.default_rng(0)
            svc.catalog.create_table(
                "ns", "events",
                {"eventTime": "<i8", "v1": "<f8", "v2": "<f8"}, "eventTime",
            )
            svc.catalog.append("ns.events", Table({
                "eventTime": np.arange(10_000, dtype=np.int64),
                "v1": rng.standard_normal(10_000),
                "v2": rng.standard_normal(10_000),
            }))

            print("\n== untrusted session: plan-time scope enforcement ==")
            res = svc.session("tenant-a", untrusted=True).run(clean)
            print(f"  clean submission ran: {res.outputs['scored'].num_rows} rows")

            try:
                svc.session("tenant-b", untrusted=True).run(greedy)
                raise AssertionError("over-broad scan was not rejected")
            except ScopeViolation as e:
                print(f"  greedy submission rejected at plan time:")
                print(f"    {e}")
            print(f"  bytes read for the rejected plan: 0 (gate fires pre-scan)")


if __name__ == "__main__":
    main()
