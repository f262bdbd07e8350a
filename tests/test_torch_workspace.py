"""The slice as a whole: the port's ``Workspace.run`` against the
reference's on twin lakes with one seeded history.

- BENCH_8's project and nine edits (the main path ``chip_smoke.py`` drives
  on the card), with and without the device tier: every edit bitwise-equal
  outputs and equal device ledgers.
- The edit matrix (``tests/edit_matrix.py``) with a torch-warm, tier-backed
  port workspace against numpy-path cold replays (as ``test_device`` does
  for the reference).
- State carried across: the port opens a lake and spill manifests the
  reference wrote and serves bitwise-equal outputs warm from them.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax.numpy as jnp

import chip_smoke
from benchmarks.bench8_device import device_project as ref_device_project
from edit_matrix import standard_matrix, sweep
from repro.core.cache import DifferentialCache as RefCache
from repro.core.cache import DifferentialStore as RefStore
from repro.core.spill import SpillTier as RefSpill
from repro.lake.s3sim import ObjectStore as RefObjectStore
from repro.pipeline import dsl as ref_dsl
from repro.pipeline.executor import Workspace as RefWorkspace
from repro_torch.core.cache import DifferentialCache, DifferentialStore
from repro_torch.core.columnar import Table
from repro_torch.core.device import DeviceTier
from repro_torch.core.spill import SpillTier
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.pipeline import dsl
from repro_torch.pipeline.executor import Workspace
from test_device import SCHEMA, events_table
from test_torch_device import torch_feature_project
from torch_parity import TwinLakes, assert_tables_bitwise, ledger

FRAG = 256
ROWS = 12 * FRAG


@pytest.mark.parametrize("tier", [True, False], ids=["device-tier", "no-tier"])
def test_bench8_edits_match_reference(tmp_path, tier):
    """Each of BENCH_8's edits: bitwise-equal outputs and equal
    bytes_h2d/d2h, device_hits, gather_fast/fallbacks, device_union_bytes
    and rows_to_user_fns (TwinLakes.run asserts both)."""
    tw = TwinLakes(str(tmp_path), rows_per_fragment=FRAG, device=tier)
    tw.write_events(ROWS)
    port = []
    for label, windows, append in chip_smoke.bench_edits(ROWS, FRAG):
        if append is not None:
            tw.write_events(**append)
        where = chip_smoke.where_of(windows)
        _rres, pres = tw.run(
            ref_device_project(where), chip_smoke.device_project(where), label
        )
        port.append(ledger(pres))
    if tier:
        warm = port[1:]
        assert sum(p["gather_fast"] for p in warm) >= 1
        assert sum(p["device_hits"] for p in warm) > 0


def test_chip_smoke_main_path_on_cpu(tmp_path):
    """The smoke script's main path itself, small and on the CPU: every edit
    bitwise against the no-tier workspace and the numpy reference, and the
    gates it applies on the card hold."""
    result = chip_smoke.main_path(ROWS, FRAG, str(tmp_path), device="cpu")
    assert result["h2d_ratio"] >= 5
    assert result["gather_fast"] >= 1
    assert len(result["iterations"]) == 9


# ----------------------------------------------------- the edit-matrix contract
def test_edit_matrix_torch_warm_vs_numpy_cold(tmp_path):
    """A tier-backed torch-warm workspace through the full edit matrix stays
    bitwise-equal to cold replays that take the host path (no tier)."""

    def setup(root):
        warm = root.endswith("em-warm")
        ws = Workspace(
            root,
            rows_per_fragment=128,
            device=DeviceTier(device="cpu") if warm else None,
            torch_device="cpu",
        )
        ws.catalog.create_table("ns", "raw", SCHEMA, "eventTime")
        ws.catalog.append("ns.raw", _port_table(events_table(0, 1024)))
        return ws

    def factory(hi=499, columns=("c1", "c3"), gain=1.0):
        return torch_feature_project(
            f"(eventTime >= 0 AND eventTime < {hi + 1})",
            columns=columns, gain=gain, scaled_mode="rowwise",
        )

    append = lambda c: c.append("ns.raw", _port_table(events_table(1024, 1124, seed=9)))
    overwrite = lambda c: c.overwrite_range(
        "ns.raw", 128, 256, _port_table(events_table(128, 256, seed=77))
    )
    edits = standard_matrix(
        base=dict(hi=499),
        widen=dict(hi=1023),
        narrow=dict(hi=299),
        beyond=dict(hi=4999),
        feature_add=dict(hi=4999, columns=("c1", "c2", "c3")),
        feature_remove=dict(hi=4999),
        code_edit=dict(hi=4999, gain=2.0),
        append=append,
        overwrite=overwrite,
    )
    results = sweep(tmp_path, setup, factory, edits)
    assert any(w.device_hits > 0 for _l, w, _c in results[1:])


def _port_table(t):
    return Table({c: t.column(c) for c in t.column_names})


# ----------------------------------------------------- state carried across
def _project(pkg, where):
    """raw -> clean (numpy rowwise, identical code in both packages, so its
    signature is too) -> feats (the package's device runtime), plus a
    full-window numpy scan consumer."""
    p = pkg.Project("carried")

    def clean(data=pkg.Model("ns.raw", columns=["c1", "c3"], filter=where)):
        return {"c1": np.where(data["c1"] >= 0, data["c1"], 0.0), "c3": data["c3"]}

    def total(data=pkg.Model("ns.raw", columns=["c2"], filter=where)):
        return {"c2": data["c2"] * 2.0}

    pkg.model(project=p, incremental="rowwise")(pkg.runtime("numpy")(clean))
    pkg.model(project=p)(pkg.runtime("numpy")(total))
    if pkg is dsl:

        @pkg.model(project=p, incremental="rowwise")
        @pkg.runtime("torch")
        def feats(data=pkg.Model("clean")):
            return {k: (v * 3.0 if v.is_floating_point() else v) for k, v in data.items()}

    else:

        @pkg.model(project=p, incremental="rowwise")
        @pkg.runtime("jax")
        def feats(data=pkg.Model("clean")):
            return {
                k: (v * jnp.float32(3.0) if v.dtype.kind == "f" else v)
                for k, v in data.items()
            }

    return p


def test_port_serves_warm_from_reference_lake_and_spill(tmp_path):
    root = str(tmp_path / "lake")
    where = "eventTime >= 0 AND eventTime < 900"
    store = RefObjectStore(root)
    ref = RefWorkspace(
        root,
        rows_per_fragment=128,
        store=store,
        cache=RefCache(spill=RefSpill(store, prefix="_spill/scan")),
        model_store=RefStore(spill=RefSpill(store, prefix="_spill/model")),
    )
    ref.catalog.create_table("ns", "raw", SCHEMA, "eventTime")
    ref.catalog.append("ns.raw", events_table(0, 1024))
    rres = ref.run(_project(ref_dsl, where))
    ref.scans.cache.demote_all()
    ref.model_store.demote_all()

    pstore = ObjectStore(root)
    port = Workspace(
        root,
        rows_per_fragment=128,
        store=pstore,
        cache=DifferentialCache(spill=SpillTier(pstore, prefix="_spill/scan")),
        model_store=DifferentialStore(spill=SpillTier(pstore, prefix="_spill/model")),
        device=DeviceTier(device="cpu"),
    )
    assert port.scans.cache.spill_restored > 0 and port.model_store.spill_restored > 0
    pres = port.run(_project(dsl, where))
    for name in rres.outputs:
        assert_tables_bitwise(rres.outputs[name], pres.outputs[name], name)
    # what the store still serves is spill manifests and IPC headers: the
    # column bytes come from the reference's spilled payloads
    assert pres.bytes_from_store * 5 < rres.bytes_from_store
    assert pres.bytes_from_spill > 0
    assert pres.node_stats["clean"]["fresh_rows"] == 0
    assert os.path.isdir(os.path.join(root, "_spill"))
