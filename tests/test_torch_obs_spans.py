"""The port's own spans and counters, on the CPU with a ``DeviceTier`` there:
``device.union`` under ``node.union``, ``scan.union`` and ``cache.merge``
with the ledger's bytes; the store GETs on every ``node`` and ``run`` span;
the re-read column chunks on ``scan.residual``; the token pipeline's
``data.wait`` and ``data.batch``; and a disabled tracer that changes
nothing and records nothing.  One test, marked ``cuda``, runs the UNION
and the copy back on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import refetch
from repro_torch.core.cache import DifferentialCache
from repro_torch.core.columnar import Table
from repro_torch.core.device import DeviceTier
from repro_torch.core.intervals import IntervalSet
from repro_torch.core.planner import ScanExecutor
from repro_torch.data import TokenBatchPipeline, write_token_corpus
from repro_torch.lake.catalog import Catalog
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.obs import Tracer
from repro_torch.pipeline.dsl import Model, Project, model, runtime
from repro_torch.pipeline.executor import Workspace

ROWS, FRAG = 4096, 256
TABLE = "ns.t"
SCHEMA = {"k": "<i8", "a": "<f8", "b": "<f8", "c": "<f8"}
# (label, window, columns): cold, widen, add a column, split (hits only)
SCRIPT = [
    ("cold", [(0, 1024)], ("a",)),
    ("widen", [(0, 2048)], ("a",)),
    ("add_column", [(0, 2048)], ("a", "b")),
    ("split", [(0, 512), (1024, 1536)], ("a", "b")),
]


def rows(lo: int, hi: int) -> Table:
    rng = np.random.default_rng(lo)
    n = hi - lo
    return Table({"k": np.arange(lo, hi, dtype=np.int64), "a": rng.standard_normal(n),
                  "b": rng.standard_normal(n), "c": rng.standard_normal(n)})


def lake(root: str, tracer: Tracer, device: str = "cpu") -> Workspace:
    ws = Workspace(root, rows_per_fragment=FRAG, tracer=tracer,
                   device=DeviceTier(device=device))
    ws.catalog.create_table("ns", "t", SCHEMA, "k")
    ws.catalog.append(TABLE, rows(0, ROWS))
    return ws


def project(windows, columns) -> Project:
    p = Project("obs")
    where = " OR ".join(f"(k >= {lo} AND k < {hi})" for lo, hi in windows)

    @model(project=p, incremental="rowwise")
    @runtime("torch")
    def feats(data=Model(TABLE, columns=list(columns), filter=where)):
        return {k: (v * 2.0 if v.is_floating_point() else v) for k, v in data.items()}

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def final(data=Model("feats")):
        out = {n: data.column(n) for n in data.column_names}
        out["s"] = np.asarray(data.column("a"), np.float64) + 1.0
        return out

    # not incremental: its scan hands the UNION to the fn on the device
    @model(project=p)
    @runtime("torch")
    def totals(data=Model(TABLE, columns=list(columns), filter=where)):
        return {"t": data["a"] + 1.0}

    return p


def every(tracer: Tracer, name: str):
    return [sp for r in tracer.roots() for sp in r.walk() if sp.name == name]


def parents(tracer: Tracer):
    return {id(c): sp for r in tracer.roots() for sp in r.walk() for c in sp.children}


def run_script(ws: Workspace):
    results = []
    for _label, windows, columns in SCRIPT:
        before = ws.store.stats.snapshot()
        res = ws.run(project(windows, columns))
        results.append((res, ws.store.stats.delta(before).get_requests))
    return results


def test_device_union_nests_in_each_union_and_counts_the_ledgers_bytes(tmp_path):
    tracer = Tracer()
    ws = lake(str(tmp_path), tracer)
    tracer.clear()
    results = run_script(ws)
    up = parents(tracer)
    unions = every(tracer, "device.union")
    assert {up[id(sp)].name for sp in unions} == {"node.union", "scan.union", "cache.merge"}
    assert all(sp.attrs["launched"] in (0, 1) and sp.attrs["runs"] >= 1 for sp in unions)
    assert any(sp.attrs["launched"] for sp in unions)
    # the UNIONs a run's nodes and scans make are its ledger; merges are not
    served = [sp for sp in unions if up[id(sp)].name != "cache.merge"]
    by_run = [sum(sp.attrs["bytes"] for sp in served if root in _ancestors(sp, up))
              for root in every(tracer, "run")]
    assert by_run == [res.device_union_bytes for res, _gets in results]
    assert sum(by_run) > 0


def _ancestors(sp, up):
    out = []
    while id(sp) in up:
        sp = up[id(sp)]
        out.append(sp)
    return out


def test_node_and_run_spans_count_the_store_gets(tmp_path):
    tracer = Tracer()
    ws = lake(str(tmp_path), tracer)
    tracer.clear()
    results = run_script(ws)
    runs = every(tracer, "run")
    assert [r.attrs["gets"] for r in runs] == [gets for _res, gets in results]
    for r, (res, gets) in zip(runs, results):
        nodes = [c for c in r.children if c.name == "node"]
        assert sum(n.attrs["gets"] for n in nodes) == gets
        assert sum(n.attrs["bytes_read"] for n in nodes) == res.bytes_from_store
        assert r.attrs["nodes"] == len(nodes) == 3
    assert sum(gets for _res, gets in results) > 0
    # a node's GETs are its scans' residual reads
    for n in every(tracer, "node"):
        assert n.attrs["gets"] == sum(sp.attrs["gets"] for sp in n.walk() if sp.name == "scan.residual")


def _scans(root: str, tracer: Tracer):
    store = ObjectStore(root)
    catalog = Catalog(store, rows_per_fragment=FRAG)
    catalog.create_table("ns", "t", SCHEMA, "k")
    catalog.append(TABLE, rows(0, ROWS))
    return catalog, ScanExecutor(store, catalog, cache=DifferentialCache(tracer=tracer), tracer=tracer)


def _residual(tracer: Tracer):
    (sp,) = [s for s in tracer.roots()[-1].walk() if s.name == "scan.residual"]
    return sp.attrs["gets"], sp.attrs["refetch_gets"]


def test_a_scan_that_adds_a_column_counts_the_chunks_it_fetches_again(tmp_path):
    tracer = Tracer()
    catalog, scans = _scans(str(tmp_path), tracer)
    window = IntervalSet.of((0, 1024))
    frags = 1024 // FRAG
    scans.scan(TABLE, ["a"], window=window)  # (k, a) cached over the window
    assert _residual(tracer) == (2 * frags, 0)
    scans.scan(TABLE, ["a", "b"], window=window)  # every chunk again, and b
    assert _residual(tracer) == (3 * frags, 2 * frags)
    scans.scan(TABLE, ["a", "b"], window=IntervalSet.of((0, 1536)))  # the new rows only
    assert _residual(tracer) == (3 * (512 // FRAG), 0)
    # a window edge inside a fragment: the rows the cache lacks are read, the
    # rows it holds are not counted for that fragment
    scans.scan(TABLE, ["a", "b"], window=IntervalSet.of((0, 1600)))
    assert _residual(tracer) == (3, 0)


def test_rows_an_append_invalidates_are_not_counted(tmp_path):
    tracer = Tracer()
    catalog, scans = _scans(str(tmp_path), tracer)
    window = IntervalSet.of((0, 1024))
    scans.scan(TABLE, ["a", "b"], window=window)
    # keys 300..309 land again inside the second fragment's range
    extra = rows(300, 310)
    catalog.append(TABLE, extra)
    scans.scan(TABLE, ["a", "b", "c"], window=window)
    gets, refetched = _residual(tracer)
    frags = 1024 // FRAG
    assert gets == 4 * (frags + 1)
    # the fragment under the appended keys and the new fragment count nothing
    assert refetched == 3 * (frags - 1)


@pytest.mark.parametrize("depth", [0, 2])
def test_the_pipeline_spans_its_waits_and_its_batches(tmp_path, depth):
    tracer = Tracer()
    store = ObjectStore(str(tmp_path / "s3"))
    catalog = Catalog(store, rows_per_fragment=4096)
    write_token_corpus(catalog, "data.corpus", 20_000, 128, seed=7, mean_doc_len=100)
    scans = ScanExecutor(store, catalog, cache=DifferentialCache(tracer=tracer), tracer=tracer)
    pipe = TokenBatchPipeline(scans, "data.corpus", global_batch=4, seq_len=128, prefetch_depth=depth)
    it = iter(pipe)
    for _ in range(3):
        next(it)
    it.close()
    pipe.close()
    if pipe._thread is not None:
        pipe._thread.join(timeout=30)
        assert not pipe._thread.is_alive()
    waits, batches = every(tracer, "data.wait"), every(tracer, "data.batch")
    assert len(waits) == 3
    assert [b.attrs["step"] for b in batches][:3] == [0, 1, 2]
    assert all(any(c.name == "scan" for c in b.children) for b in batches)
    if depth == 0:
        assert [c.name for w in waits for c in w.children] == ["data.batch"] * 3
    else:
        assert all(not w.children for w in waits)


def _ledgers(res):
    skip = {"outputs", "wall_seconds", "plan", "explanation"}
    return {k: v for k, v in vars(res).items() if k not in skip}


def test_a_disabled_tracer_changes_nothing_and_records_nothing(tmp_path, monkeypatch):
    calls = []
    real_refetch = refetch.refetch_gets

    def counted(*a, **kw):
        calls.append(1)
        return real_refetch(*a, **kw)

    monkeypatch.setattr(refetch, "refetch_gets", counted)
    on = Tracer()
    ws_on = lake(str(tmp_path / "on"), on)
    got_on = run_script(ws_on)
    assert calls

    def refuse(*a, **kw):
        raise AssertionError("traced work ran with the tracer off")

    monkeypatch.setattr(refetch, "refetch_gets", refuse)
    off = Tracer(enabled=False)
    ws_off = lake(str(tmp_path / "off"), off)
    got_off = run_script(ws_off)
    assert off.roots() == []
    for (a, gets_a), (b, gets_b) in zip(got_on, got_off):
        assert gets_a == gets_b
        assert _ledgers(a) == _ledgers(b)
        assert a.node_stats == b.node_stats
        assert set(a.outputs) == set(b.outputs)
        for name in a.outputs:
            for c in a.outputs[name].column_names:
                assert np.array_equal(np.asarray(a.outputs[name].column(c)),
                                      np.asarray(b.outputs[name].column(c))), (name, c)
    assert ws_on.metrics.to_text() == ws_off.metrics.to_text()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the UNION launches and the copy back are the card's")


@pytest.mark.cuda
def test_the_union_and_the_copy_back_on_the_card(card, tmp_path):
    """On the card the launched ``device.union`` spans hold the ledger's
    UNION bytes, and a torch node's outputs come back under ``device.sync``
    and ``device.d2h`` with the ledger's D2H bytes."""
    tracer = Tracer()
    ws = lake(str(tmp_path), tracer, device="cuda")
    tracer.clear()
    results = run_script(ws)
    torch.cuda.synchronize()
    unions = every(tracer, "device.union")
    assert any(sp.attrs["launched"] for sp in unions)
    up = parents(tracer)
    served = [sp for sp in unions if up[id(sp)].name != "cache.merge"]
    assert sum(sp.attrs["bytes"] for sp in served) == sum(res.device_union_bytes for res, _gets in results) > 0
    d2h = every(tracer, "device.d2h")
    assert len(every(tracer, "device.sync")) == len(d2h) > 0
    assert sum(sp.attrs["bytes"] for sp in d2h) == sum(res.bytes_d2h for res, _gets in results)
