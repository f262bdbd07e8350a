"""Keyed & multi-input incrementality: joins and per-key aggregations that
recompute only the touched keys, on the PyTorch port.

Two tables share the sort key ``user``: ``ns.orders`` (several rows per
user) and ``ns.profile`` (one row per user).  The pipeline is

  enriched  — ``incremental="rowwise"`` over BOTH tables: an incremental
              sort-merge join.  Its window is the INTERSECTION of the input
              windows, and its cache elements pin fragments of *both*
              tables — an append to one side re-joins only that side's key
              range.
  peruser   — ``incremental="keyed"``: per-user aggregation cached at
              key-group granularity.  An append touching a handful of users
              re-aggregates exactly those groups (whole: old rows + new)
              and UNIONs them with the cached groups.

The script prints the ledger after each edit; note how "rows→fns" tracks
the touched keys, not the table size.

Run:  python examples/torch/incremental_join.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.core.columnar import Table
from repro_torch.pipeline.dsl import Model, Project, model, runtime
from repro_torch.pipeline.executor import Workspace

USERS = 10_000


def orders(lo_u, hi_u, per_user=4, seed=0):
    rng = np.random.default_rng(seed + lo_u)
    n = (hi_u - lo_u) * per_user
    return Table({
        "user": np.repeat(np.arange(lo_u, hi_u, dtype=np.int64), per_user),
        "amount": np.abs(rng.standard_normal(n)) * 100,
    })


def profiles(lo_u, hi_u, seed=1):
    rng = np.random.default_rng(seed + lo_u)
    return Table({
        "user": np.arange(lo_u, hi_u, dtype=np.int64),
        "tier": rng.integers(1, 4, hi_u - lo_u).astype(np.int64),
    })


def make_project(hi, bonus=1.0):
    p = Project("join-demo")

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def enriched(
        left=Model("ns.orders", columns=["amount"], filter=f"user BETWEEN 0 AND {hi}"),
        right=Model("ns.profile", columns=["tier"], filter=f"user BETWEEN 0 AND {hi}"),
    ):
        # sort-merge inner join on the shared sort key: each order row picks
        # up its user's tier (both inputs arrive sorted by `user`)
        lk = np.asarray(left.column("user"))
        rk = np.asarray(right.column("user"))
        idx = np.searchsorted(rk, lk)
        idx = np.clip(idx, 0, max(rk.size - 1, 0))
        has = rk.size > 0
        mask = (rk[idx] == lk) if has else np.zeros(lk.size, bool)
        return {
            "user": lk[mask],
            "amount": np.asarray(left.column("amount"))[mask],
            "tier": (np.asarray(right.column("tier"))[idx][mask]
                     if has else np.zeros(0, np.int64)),
        }

    @model(project=p, incremental="keyed")
    @runtime("numpy")
    def peruser(data=Model("enriched")):
        users = np.asarray(data.column("user"))
        spend = np.asarray(data.column("amount"), np.float64) * bonus
        uniq, starts = np.unique(users, return_index=True)
        if uniq.size == 0:
            return {"user": uniq, "spend": np.zeros(0), "n": np.zeros(0, np.int64)}
        return {
            "user": uniq,
            "spend": np.add.reduceat(spend, starts),
            "n": np.diff(np.append(starts, users.size)).astype(np.int64),
        }

    return p


def show(label, res):
    print(f"{label:<34} store {res.bytes_from_store:>9,} B | "
          f"rows→fns {res.rows_to_user_fns:>7,} | "
          f"per node { {k: v['fresh_rows'] for k, v in res.node_stats.items()} }")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the workspace (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    ws = Workspace(tempfile.mkdtemp(prefix="repro-join-"), rows_per_fragment=4096,
                   torch_device=args.device)
    ws.catalog.create_table("ns", "orders", {"user": "<i8", "amount": "<f8"}, "user")
    ws.catalog.create_table("ns", "profile", {"user": "<i8", "tier": "<i8"}, "user")
    ws.catalog.append("ns.orders", orders(0, USERS))
    ws.catalog.append("ns.profile", profiles(0, USERS))

    show("1. cold run", ws.run(make_project(hi=USERS - 1)))
    show("2. identical rerun", ws.run(make_project(hi=USERS - 1)))

    # 50 users (0.5% of the keys) place new orders: ONLY their groups
    # re-join and re-aggregate — whole (old orders + new)
    ws.catalog.append("ns.orders", orders(4_000, 4_050, per_user=1, seed=9))
    show("3. 50 users place new orders", ws.run(make_project(hi=USERS - 1)))

    # one side only: new profiles beyond every order's key — the joint
    # window (intersection) still ends at the orders, nothing recomputes
    ws.catalog.append("ns.profile", profiles(USERS, USERS + 500))
    show("4. append profiles (other side)", ws.run(make_project(hi=USERS - 1)))

    # a code edit on the aggregation recomputes peruser, NOT the join
    last = ws.run(make_project(hi=USERS - 1, bonus=1.1))
    show("5. edit aggregation (bonus=1.1)", last)

    st = ws.model_store
    print(f"\nmodel store: {len(st.elements())} elements, {st.nbytes:,} bytes "
          f"({st.full_hits} full hits / {st.partial_hits} partial / {st.lookups} lookups)")
    return last


if __name__ == "__main__":
    main()
