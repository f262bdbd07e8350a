"""Multi-tenant service on the PyTorch port: two sessions sharing warm cache
across windows.

The paper's differential cache pays off because it is SHARED: many data
scientists iterate against one lakehouse, and windows one tenant computed
serve every other tenant's overlapping plans.  `repro_torch.service` is that
service — one object store, one catalog, one scan cache, one model store,
with tenant sessions (pinned snapshots, commit-retry) scheduled through an
admission queue + worker pool.  Every tenant's ``@runtime("torch")`` node
runs on the service's ``torch_device`` (the CUDA card by default).

This script walks the headline scenario:

  1. alice (cold)      — runs a 2-stage pipeline over [0, 40k]; pays full price
  2. bob (shared-warm) — IDENTICAL code over the overlapping [0, 50k]:
                         pays only (40k, 50k] — alice's windows serve the rest
  3. bob narrows       — [0, 20k]: fully served, zero bytes, zero rows
  4. a third tenant appends rows; alice's pinned session still sees her
     frozen snapshot (time travel per tenant), until she refreshes
  5. a concurrent burst through the scheduler, then the ServiceReport with
     the cross-tenant reuse counters

Run:  python examples/torch/multi_tenant_service.py [--device cpu]
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
from repro_torch.service import DONE, PipelineService


def events(lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    n = hi - lo
    return Table({
        "eventTime": np.arange(lo, hi, dtype=np.int64),
        "v1": rng.standard_normal(n),
        "v2": rng.standard_normal(n),
        "flag": rng.integers(0, 4, n).astype(np.int64),
    })


def make_project(hi):
    """Every tenant builds this from the same code, so every tenant's nodes
    get the same signatures — the precondition for transparent sharing."""
    p = Project("pipeline")

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def cleaned(data=Model("ns.events", columns=["v1", "v2", "flag"],
                           filter=f"eventTime BETWEEN 0 AND {hi}")):
        return data.filter(data.column("flag") > 0)

    @model(project=p, incremental="rowwise")
    @runtime("torch")  # second language, same shared store
    def feats(data=Model("cleaned")):
        return {k: (torch.where(v >= 0, v, v * 0.5) if v.is_floating_point() else v)
                for k, v in data.items()}

    return p


def show(label, res):
    print(f"{label:<34} store {res.bytes_from_store:>9,} B | "
          f"model-cache {res.bytes_from_model_cache:>9,} B | "
          f"rows→fns {res.rows_to_user_fns:>7,}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the torch nodes (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    with PipelineService(
        tempfile.mkdtemp(prefix="repro-svc-"),
        workers=3,
        rows_per_fragment=4096,
        liveness_runs=32,
        torch_device=args.device,
    ) as svc:
        svc.catalog.create_table(
            "ns", "events",
            {"eventTime": "<i8", "v1": "<f8", "v2": "<f8", "flag": "<i8"},
            "eventTime",
        )
        svc.catalog.append("ns.events", events(0, 50_000))

        alice = svc.session("alice")
        bob = svc.session("bob")

        show("1. alice cold [0,40k]", alice.run(make_project(hi=40_000)))
        show("2. bob shared-warm [0,50k]", bob.run(make_project(hi=50_000)))
        show("3. bob narrow [0,20k] (free)", bob.run(make_project(hi=20_000)))

        # 4. a writer commits; alice's pinned view is unaffected until refresh
        writer = svc.session("writer")
        writer.append("ns.events", events(50_000, 52_000, seed=9))
        r = alice.run(make_project(hi=60_000))
        show("4a. alice pinned (no new rows)", r)
        alice.refresh_pins()
        refreshed = alice.run(make_project(hi=60_000))
        show("4b. alice refreshed (delta only)", refreshed)

        # 5. a concurrent burst across four tenants through the scheduler;
        #    its torch nodes run in the scheduler's worker threads
        handles = [
            svc.submit(t, make_project(hi=60_000))
            for t in ("alice", "bob", "carol", "dave")
        ]
        svc.drain()
        print(f"\n5. burst: {[h.state for h in handles]} "
              f"(per-tenant fairness, bounded in-flight)")
        for h in handles:
            if h.state != DONE:
                raise h.error or AssertionError(f"{h.tenant}'s run ended {h.state}")

        rep = svc.report()
        ms = rep.model_store
        print(f"\nshared model store: {ms['elements']} elements, "
              f"{ms['nbytes']:,} B | {ms['full_hits']} full + "
              f"{ms['partial_hits']} partial hits / {ms['lookups']} lookups")
        print(f"cross-tenant reuse: {ms['cross_tenant_hits']} hits, "
              f"{ms['cross_tenant_rows']:,} rows served across tenants")
        print(f"per-tenant bytes: {ms['tenant_bytes']} | "
              f"commit conflicts retried: {rep.commit_conflicts}")
    return refreshed, [h.result for h in handles]


if __name__ == "__main__":
    main()
