"""The program's own spans as the benchmark's cells produce them, rehearsed
on the CPU at a tiny size: the pretrain window's ``data.wait`` and
``data.batch`` readers, and in the pipeline cells the ``device.union``
spans against the benchmark's UNION count and the ``scan.residual`` GETs
against the edit script's fragment and column arithmetic."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import lake, manifest
from portbench.run import measure
from portbench.test_portbench_edits import tiny as tiny_pipeline
from portbench.test_portbench_pretrain import tiny as tiny_pretrain


def test_the_pretrain_window_reports_its_data_spans():
    config, traffic = tiny_pretrain()
    traffic.update(corpus_steps=400)
    line, rec = measure("granite-3-2b.pretrain", 2**31 + 23, 0.3, False, "cpu", config, traffic)
    assert line["correct"], line["checks"]
    assert rec.steps > 0
    queue = manifest.reader("data.queue_wait_ms.train")(rec)
    batch = manifest.reader("data.batch_ms.train")(rec)
    assert queue is not None and batch is not None
    assert 0 <= queue and 0 < batch
    # the harness's timer holds the span's wait and shard_batch's placement
    assert queue <= manifest.reader("data.wait_ms.train")(rec)


def test_an_empty_window_reports_no_data_spans():
    config, traffic = tiny_pretrain()
    _line, rec = measure("granite-3-2b.pretrain", 5, 0.0, False, "cpu", config, traffic)
    assert rec.steps == 0
    assert manifest.reader("data.queue_wait_ms.train")(rec) is None
    assert manifest.reader("data.batch_ms.train")(rec) is None


def _traced(monkeypatch):
    """Every ``Tracer`` the harness builds, kept for the test."""
    from repro_torch.obs import trace

    made = []

    class Kept(trace.Tracer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(trace, "Tracer", Kept)
    return made


def _spans(tracers, name):
    return [sp for t in tracers for r in t.roots() for sp in r.walk() if sp.name == name]


@pytest.mark.parametrize("cell", ["fhvhv-month.iterate", "fhvhv-month.tenants"])
def test_the_unions_spans_count_the_benchmarks_union_bytes(monkeypatch, cell):
    made = _traced(monkeypatch)
    config, traffic = tiny_pipeline(cell)
    line, rec = measure(cell, 29, 0.0, False, "cpu", config, traffic)
    assert line["correct"], line["checks"]
    unions = _spans(made, "device.union")
    assert any(sp.attrs["launched"] for sp in unions)
    # the benchmark counts each launched UNION's bytes read once and written once
    assert 2 * sum(sp.attrs["bytes"] for sp in unions if sp.attrs["launched"]) == rec.union_bytes > 0
    parents = {sp.name for t in made for root in t.roots() for sp in root.walk()
               if any(c.name == "device.union" for c in sp.children)}
    assert parents <= {"node.union", "scan.union", "cache.merge"} and "cache.merge" in parents


def _fragments(config, lo_day: float, hi_day: float) -> int:
    keys = lake.key_grid(config, int(config["rows"]))
    frag = int(config["rows_per_fragment"])
    lo, hi = lake.key_of_day(config, lo_day), lake.key_of_day(config, hi_day)
    firsts, lasts = keys[::frag], keys[frag - 1::frag]
    return int(np.count_nonzero((firsts < hi) & (lasts >= lo)))


def test_the_iterate_sessions_refetch_share_is_its_gets_arithmetic(monkeypatch):
    """The session reads 5 columns over the cold 14 days, all 6 again when
    ``tips`` is added (5 of them held), and 6 over the 7 relaxed days; no
    other edit reads the store."""
    made = _traced(monkeypatch)
    config, traffic = tiny_pipeline()
    _line, rec = measure("fhvhv-month.iterate", 31, 0.0, False, "cpu", config, traffic)
    cols = 1 + len(traffic["base_columns"])
    cold, relaxed = _fragments(config, 0, 14), _fragments(config, 14, 21)
    gets = cols * cold + (cols + 1) * cold + (cols + 1) * relaxed
    residuals = _spans(made, "scan.residual")
    assert sum(sp.attrs["gets"] for sp in residuals) == gets
    assert sum(sp.attrs["refetch_gets"] for sp in residuals) == cols * cold
    # a fresh workspace's first node also reads the table's pointer: the
    # nodes hold every GET of their runs, the residual reads all but that one
    runs = _spans(made, "run")
    assert [sp.attrs["gets"] for sp in runs] == [e["gets"] for e in rec.edits]
    assert sum(sp.attrs["gets"] for sp in _spans(made, "node")) == sum(e["gets"] for e in rec.edits) == gets + 1
