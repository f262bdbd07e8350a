"""The paper's §III-A multi-user scenario, operationalized (NYC-taxi-like),
on the PyTorch port.

Three actors share one workspace cache:
  user A runs a Python DAG over (c1,c2,c3) × January;
  user B runs a SQL-ish one-scan query over (c1,c3) × Jan–Feb;
  user A reruns with projection c2 × one day.

Prints the byte ledger per step and verifies: B pays only February, A's
rerun pays nothing (paper Fig. 4), and the total equals the hand-computed
optimum (paper §III-C).

Run:  python examples/torch/multi_user_cache.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import numpy as np

from repro_torch.core.intervals import IntervalSet
from repro_torch.core.columnar import Table
from repro_torch.pipeline.dsl import Model, Project, model, runtime
from repro_torch.pipeline.executor import Workspace

JAN = (0, 44_640)         # minutes of January 2023
JANFEB = (0, 84_960)      # Jan + Feb
DAY = (0, 1_440)          # one day


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the workspace (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    ws = Workspace(tempfile.mkdtemp(prefix="repro-3a-"), rows_per_fragment=4096,
                   torch_device=args.device)
    rng = np.random.default_rng(0)
    n = 300_000
    ws.catalog.create_table(
        "nyc", "taxi",
        {"pickup_datetime": "<i8", "hvfhs_license_num": "<i4",
         "PULocationID": "<i4", "DOLocationID": "<i4"},
        "pickup_datetime",
    )
    ws.catalog.append("nyc.taxi", Table({
        "pickup_datetime": np.sort(rng.integers(0, 130_000, n)).astype(np.int64),
        "hvfhs_license_num": rng.integers(1, 7, n).astype(np.int32),
        "PULocationID": rng.integers(1, 266, n).astype(np.int32),
        "DOLocationID": rng.integers(1, 266, n).astype(np.int32),
    }))
    cols3 = ["hvfhs_license_num", "PULocationID", "DOLocationID"]

    # ---- user A: declarative Python DAG over 3 columns × January
    proj_a = Project("userA")

    @model(project=proj_a)
    @runtime("numpy")
    def features(
        data=Model("nyc.taxi", columns=cols3,
                   filter=f"pickup_datetime BETWEEN {JAN[0]} AND {JAN[1]}"),
    ):
        return {
            "license": data.column("hvfhs_license_num"),
            "route": data.column("PULocationID") * 1000 + data.column("DOLocationID"),
        }

    r = ws.run(proj_a)
    b1 = r.bytes_from_store
    print(f"1) user A  (c1,c2,c3 × Jan):      {b1:>11,} B from store  (cold)")

    # ---- user B: one-scan "SQL" query, 2 columns × Jan-Feb
    before = ws.store.stats.bytes_read
    ws.scans.scan("nyc.taxi", [cols3[0], cols3[2]], IntervalSet.of(JANFEB))
    b2 = ws.store.stats.bytes_read - before
    print(f"2) user B  (c1,c3 × Jan-Feb):     {b2:>11,} B from store  (Feb only)")

    # ---- user A again: c2 × one day — must be FREE
    before = ws.store.stats.bytes_read
    ws.scans.scan("nyc.taxi", [cols3[1]], IntervalSet.of(DAY))
    b3 = ws.store.stats.bytes_read - before
    print(f"3) user A' (c2 × one day):        {b3:>11,} B from store  (cache hit)")
    assert b3 == 0, "request #3 requires no scan (paper Fig. 4)"

    # ---- hand-computed optimum (paper §III-C)
    from repro_torch.core.baselines import NoCache
    from repro_torch.core.planner import ScanExecutor

    opt_ex = ScanExecutor(ws.store, ws.catalog, cache=NoCache())
    before = ws.store.stats.bytes_read
    opt_ex.scan("nyc.taxi", cols3, IntervalSet.of(JAN))
    opt_ex.scan("nyc.taxi", [cols3[0], cols3[2]], IntervalSet.of((JAN[1], JANFEB[1])))
    optimum = ws.store.stats.bytes_read - before
    total = b1 + b2 + b3
    print(f"\ntotal bytes: {total:,} | theoretical optimum: {optimum:,} "
          f"-> {'MATCHES' if total == optimum else 'MISMATCH'}")
    assert total == optimum
    return total


if __name__ == "__main__":
    main()
