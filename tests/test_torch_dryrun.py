"""The port's dry-run (``repro_torch.launch.dryrun``) and its registry
stand-ins against the reference's, on the CPU.

- ``input_specs``: every (arch × shape) cell's inputs, decode caches
  included, have the shapes and dtypes of the reference's
  ``ShapeDtypeStruct``s, as tensors on the meta device.
- ``cell_is_runnable``: the same 40 decisions and reasons.
- ``model_flops`` and ``model_min_bytes``: equal for all 40 cells.
- ``run_cell`` on a ``fake`` process group of world 256 (a subprocess,
  ``device="cpu"``): a full-size cell ends ``ok`` with the reference's
  record keys, a ``long_500k`` cell of a full-attention arch writes the
  SKIP record, and ``benchmarks/roofline_table`` reads both unchanged.
- ``run_pipeline_cells`` on two CPU ranks writes the reference's pipeline
  record, with each rank's peak memory.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from benchmarks import roofline_table
from repro.models.registry import ARCH_IDS
from repro.models.registry import cell_is_runnable as ref_cell_is_runnable
from repro.models.registry import get_config as ref_get_config
from repro.models.registry import input_specs as ref_input_specs
from repro_torch.launch import dryrun
from repro_torch.models import SHAPES, cell_is_runnable, get_config, input_specs

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def _ref_dryrun():
    """The reference's dry-run module, whose import sets ``XLA_FLAGS`` for
    its own process: the backend is started first and the variable put
    back, so neither this process nor its children see it."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


@pytest.mark.parametrize("arch, shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_the_reference(arch, shape):
    want = _flat(ref_input_specs(ref_get_config(arch), shape))
    got = _flat(input_specs(get_config(arch), shape))
    assert set(got) == set(want)
    for k, sds in want.items():
        t = got[k]
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(sds.shape), k
        assert t.dtype == getattr(torch, sds.dtype.name), k


def test_cell_decisions_equal_the_reference():
    decisions = [cell_is_runnable(get_config(a), s) for a, s in CELLS]
    assert decisions == [ref_cell_is_runnable(ref_get_config(a), s) for a, s in CELLS]
    assert sum(ok for ok, _ in decisions) == 33  # 7 full-attention archs skip long_500k


def test_model_flops_and_min_bytes_equal_the_reference():
    ref = _ref_dryrun()
    for arch, shape in CELLS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        assert dryrun.model_flops(cfg, SHAPES[shape]) == ref.model_flops(rcfg, ref.SHAPE_MAP[shape]), (arch, shape)
        assert dryrun.model_min_bytes(cfg, SHAPES[shape]) == ref.model_min_bytes(rcfg, ref.SHAPE_MAP[shape]), \
            (arch, shape)
    assert dryrun.DEFAULT_OPT == ref.DEFAULT_OPT


_CELLS = textwrap.dedent(
    """
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.dryrun import run_cell

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    out = sys.argv[1]
    recs = [run_cell("granite-3-2b", "decode_32k", "single", out, device="cpu"),
            run_cell("granite-3-2b", "long_500k", "single", out, device="cpu")]
    print("RESULT " + json.dumps([r["status"] for r in recs]))
    """
)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_torch"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    proc = subprocess.run([sys.executable, "-c", _CELLS, out], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return out, json.loads(line[len("RESULT "):])


def test_run_cell_writes_the_reference_record(cells):
    out, statuses = cells
    assert statuses == ["ok", "SKIP(full-attention @ 500k context)"]
    with open(os.path.join(out, "granite-3-2b__decode_32k__single.json")) as f:
        rec = json.load(f)
    for k in ("arch", "shape", "mesh", "n_chips", "kind", "seq_parallel", "microbatches", "remat", "status",
              "flops_per_device", "bytes_per_device", "collectives", "roofline", "memory"):
        assert k in rec, k
    assert rec["n_chips"] == 256 and rec["mesh"] == "data=16xmodel=16" and rec["kind"] == "decode"
    assert set(rec["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                       "collective-permute", "total", "count"}
    assert rec["collectives"]["total"] > 0 and rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    want = set(dryrun.roofline_report(flops_per_device=1.0, hbm_bytes_per_device=1.0,
                                      collective_bytes_per_device=1.0, n_chips=256, model_flops_total=1.0,
                                      model_min_bytes_total=1.0))
    assert set(rec["roofline"]) == want
    mem = rec["memory"]
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "code_bytes"} <= set(mem)
    assert mem["code_bytes"] is None and mem["alias_bytes"] > 0  # the cache is updated in place
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0


def test_roofline_table_reads_the_records(cells):
    out, _ = cells
    rows = roofline_table.load(out)
    assert sorted(r["shape"] for r in rows) == ["decode_32k", "long_500k"]
    table = roofline_table.format_table(rows)
    assert "| granite-3-2b | decode_32k | data=16xmodel=16 |" in table
    assert "SKIP(full-attention @ 500k context)" in table


def test_pipeline_cells_write_the_reference_record(tmp_path):
    recs = dryrun.run_pipeline_cells(str(tmp_path / "out"), 2, [2], workdir=str(tmp_path / "ranks"))
    (rec,) = recs
    assert rec["kind"] == "pipeline" and rec["n_stages"] == 2 and rec["n_micro"] == 2
    assert set(rec["schedules"]) == {"gpipe", "1f1b"}
    for sched, entry in rec["schedules"].items():
        assert entry["bubble"] == rec["schedule_report"][f"bubble_{sched}"]
        assert entry["peak_stash_bytes"] == rec["schedule_report"][f"peak_stash_bytes_{sched}"]
        assert len(entry["peak_bytes_per_rank"]) == 2 and min(entry["peak_bytes_per_rank"]) > 0
    assert os.path.exists(tmp_path / "out" / "pipeline__s2_m2.json")


def test_grid_table_has_a_row_a_record(cells):
    out, _ = cells
    lines = dryrun.grid_table(out).splitlines()
    assert len(lines) == 2 + 1 + 2
    assert lines[2].startswith("| granite-3-2b | decode_32k | ok / - | ")
    assert lines[4] == "SKIP(full-attention @ 500k context) / -: granite-3-2b long_500k."
