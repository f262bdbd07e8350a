"""Kill a service mid-publish, restart it, and watch everything recover —
on the PyTorch port.

The walk-through for README's "Failure model" section:

  1. a pipeline with ``materialize=True`` runs on a service whose object
     store is rigged (seeded :class:`FaultPlan`) to CRASH the process on a
     fragment upload of the materialized table — after the compute finished
     but before the catalog commit;
  2. the crash leaves real wreckage on disk: an intent in the publish
     journal and orphaned fragment objects no snapshot references;
  3. a fresh service over the same root rolls the journal back (orphans
     GC'd, catalog unchanged) and restarts *warm* from the write-through
     spill copies;
  4. the rerun completes, recomputes (almost) nothing, republishes, and its
     output is bitwise-identical to a service that never crashed.

Run:  python examples/torch/chaos_restart.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import numpy as np

from repro_torch.core.columnar import Table
from repro_torch.lake.catalog import Catalog
from repro_torch.lake.faults import FaultPlan, InjectedCrash, RetryPolicy
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.pipeline.dsl import Model, Project, model, runtime
from repro_torch.service import PipelineService

ROWS = 20_000


def seed_events(root):
    catalog = Catalog(ObjectStore(root), rows_per_fragment=1024)
    catalog.create_table(
        "ns", "events",
        {"eventTime": "<i8", "v1": "<f8", "v2": "<f8"},
        "eventTime",
    )
    rng = np.random.default_rng(0)
    catalog.append(
        "ns.events",
        Table({
            "eventTime": np.arange(ROWS, dtype=np.int64),
            "v1": rng.standard_normal(ROWS),
            "v2": rng.standard_normal(ROWS),
        }),
    )


def scored_project():
    p = Project("chaos")

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def cleaned(
        data=Model("ns.events", columns=["v1", "v2"],
                   filter=f"eventTime BETWEEN 0 AND {ROWS - 1}")
    ):
        return data.filter(data.column("v1") > -3.0)

    @model(project=p, incremental="rowwise", materialize=True)
    @runtime("numpy")
    def scored(data=Model("cleaned")):
        out = {n: data.column(n) for n in data.column_names}
        out["score"] = out["v1"] * 0.5 + out["v2"]
        return out

    return p


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the services (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = args.device

    tmp = tempfile.mkdtemp(prefix="repro-chaos-")
    root = os.path.join(tmp, "svc")
    seed_events(root)

    # -- 1. the doomed run: crash on the 2nd fragment upload of the
    #       materialized table (compute done, commit never reached)
    plan = FaultPlan(seed=4, crash_puts=(1,), key_prefix="data/models.")
    svc = PipelineService(
        root, workers=1, rows_per_fragment=1024,
        fault_plan=plan, spill=True, spill_mode="write_through",
        torch_device=device,
    )
    handle = svc.submit("alice", scored_project()).wait()
    assert handle.state == "FAILED" and isinstance(handle.error, InjectedCrash)
    print(f"run 1: {handle.state} — {handle.error}")
    svc.shutdown(wait=False)  # the process "dies"; no clean demote-all flush

    journal = os.path.join(root, "_catalog", "_journal")
    print(f"wreckage: {len(os.listdir(journal))} publish intent(s) in the journal")

    # -- 2. restart: the journal is resolved before the service serves
    svc2 = PipelineService(
        root, workers=1, rows_per_fragment=1024,
        store_retry=RetryPolicy(), spill=True, spill_mode="write_through",
        torch_device=device,
    )
    rec = svc2.journal_recovery
    print(
        f"restart: rolled_back={rec['rolled_back']} "
        f"orphans_deleted={rec['orphans_deleted']} "
        f"(journal now {len(os.listdir(journal))} entries); "
        f"spill restored {svc2.model_store.spill_restored} model + "
        f"{svc2.scan_cache.spill_restored} scan elements"
    )

    # -- 3. the rerun: warm from the write-through spill copies
    result = svc2.run("alice", scored_project())
    print(
        f"run 2: DONE — {result.rows_to_user_fns} rows recomputed, "
        f"{result.bytes_from_spill} B promoted from spill"
    )
    published = svc2.catalog.table("models.scored")
    svc2.shutdown()

    # -- 4. the oracle: a service that never crashed
    ref_root = os.path.join(tmp, "ref")
    seed_events(ref_root)
    with PipelineService(ref_root, workers=1, rows_per_fragment=1024,
                         torch_device=device) as ref:
        ref_result = ref.run("alice", scored_project())
        for name, table in result.outputs.items():
            other = ref_result.outputs[name]
            for col in table.column_names:
                np.testing.assert_array_equal(table.column(col), other.column(col))
    print(f"published table {published.full_name!r}; outputs bitwise-equal "
          f"to a never-crashed service — recovery cost warmth, not answers")
    return result


if __name__ == "__main__":
    main()
