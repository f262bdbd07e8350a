"""The port's multi-tenant pipeline service (``repro_torch.service``).

- BENCH_4's tenants at CI scale (t0 cold over [0, 0.8R], t1 widened, t2
  nested, t3 split into two windows) through a reference and a port
  service over twin lakes, with and without a shared device tier: every
  run bitwise-equal, equal store and device ledgers, equal cross-tenant
  reuse.  The reference runs ``benchmarks.workloads.iteration_project``
  (jax ``feats``), the port its torch mirror in ``chip_smoke``.
- ``chip_smoke.service_phase`` itself, small and on the CPU.
- The behaviours ``tests/test_service.py`` pins on the reference, held on
  the port with a torch node: SharedStore LRU, quotas, liveness and reader
  pins; session pins; scheduler states, admission and fairness; racing
  writers; the incremental materializer; the threaded stress test, also
  over one shared device tier.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks.workloads import EVENTS_TABLE
from benchmarks.workloads import iteration_project as ref_iteration_project
from repro_torch.core.baselines import NoCache
from repro_torch.core.columnar import Table
from repro_torch.core.device import DeviceTier
from repro_torch.core.intervals import IntervalSet
from repro_torch.core.planner import ScanExecutor
from repro_torch.lake.catalog import Catalog, CommitConflict
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.pipeline import Model, Project, Workspace, model, runtime
from repro_torch.service import (
    DONE,
    FAILED,
    RUNNING,
    PipelineService,
    QueueFull,
    SharedStore,
    TenantSession,
)
from torch_parity import TwinServices

ROWS = 20_000
FRAG = max(256, ROWS // 10)  # BENCH_4's fragment size at this scale


# ------------------------------------------------ BENCH_4 against the reference
def ref_split_project(where: str):
    """``benchmarks.workloads.iteration_project`` with its key window as a
    filter text (t3's two windows).  The bodies are the workload's, so the
    nodes' signatures equal those of the workload's projects."""
    from repro.pipeline.dsl import Model, Project, model, runtime

    p = Project("iteration")
    cols = ["v1", "v2"]
    gain = 1.0

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def cleaned(data=Model(EVENTS_TABLE, columns=cols + ["flag"], filter=where)):
        return data.filter(data.column("flag") > 0)

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def enriched(data=Model("cleaned")):
        out = {n: data.column(n) for n in data.column_names}
        feats = [data.column(c) for c in data.column_names if c.startswith("v")]
        out["mag"] = np.sqrt(sum(f * f for f in feats))
        return out

    @model(project=p, incremental="rowwise")
    @runtime("jax")
    def feats(data=Model("enriched")):
        import jax.numpy as jnp

        return {
            k: (jnp.where(v >= 0, v, v * jnp.float32(0.5)) if v.dtype.kind == "f" else v)
            for k, v in data.items()
        }

    @model(project=p, incremental="rowwise", materialize=False)
    @runtime("numpy")
    def final(data=Model("feats")):
        out = {n: data.column(n) for n in data.column_names}
        out["score"] = gain * np.asarray(data.column("mag"), dtype=np.float64)
        return out

    return p


def _ref_project(kw: dict):
    if "windows" in kw:
        return ref_split_project(chip_smoke.where_of(kw["windows"]))
    return ref_iteration_project(hi=kw["hi"])


@pytest.mark.parametrize("tiers", [True, False], ids=["tiers", "no-tier"])
def test_bench4_tenants_match_reference(tmp_path, tiers):
    """Tenants in sequence through ``session(...).run``: TwinServices.run
    asserts bitwise outputs and equal bytes_from_store, rows_to_user_fns,
    bytes_from_model_cache, bytes_from_cache and the device ledger."""
    with TwinServices(str(tmp_path), rows_per_fragment=FRAG, tiers=tiers, workers=1) as tw:
        tw.write_events(ROWS)
        port = {}
        for name, kind, kw in chip_smoke.service_tenants(ROWS, FRAG):
            _rres, port[name] = tw.run(
                name, _ref_project(kw), chip_smoke.iteration_project(**kw), f"{name} ({kind})"
            )
        ref_rep, port_rep = tw.ref.report(), tw.port.report()
        for store in ("model_store", "scan_cache"):
            assert (
                getattr(port_rep, store)["cross_tenant_hits"]
                == getattr(ref_rep, store)["cross_tenant_hits"]
            ), store
        assert port_rep.model_store["cross_tenant_hits"] > 0
    assert port["t1"].bytes_from_store * 3 <= port["t0"].bytes_from_store
    for name in ("t2", "t3"):
        assert port[name].rows_to_user_fns == 0 and port[name].bytes_from_store == 0
        if tiers:
            assert port[name].device_hits > 0
    if tiers:
        # t3's two windows of one element: one gather a column
        assert port["t3"].gather_fast + port["t3"].gather_fallbacks == 5


def test_chip_smoke_service_phase_on_cpu(tmp_path):
    """The smoke script's service phase itself, small and on the CPU: it
    raises at any failed gate; the gates it applies hold."""
    result = chip_smoke.service_phase(ROWS, FRAG, str(tmp_path), device="cpu")
    tenants = result["tenants"]
    assert min(tenants[n]["bytes_ratio"] for n in ("t1", "t2", "t3")) >= 3
    assert tenants["t3"]["gather_fast"] + tenants["t3"]["gather_fallbacks"] > 0
    assert result["restart_ratio"] >= 5
    assert result["duplicate_rows"] == 0
    assert result["cross_tenant_hits"] > 0


# ------------------------------------------------------------------ helpers
SCHEMA = {"eventTime": "<i8", "v1": "<f8", "v2": "<f8", "flag": "<i8"}
TABLE = "ns.events"


def events_table(lo, hi, seed=0):
    n = hi - lo
    rng = np.random.default_rng(seed + lo)
    return Table(
        {
            "eventTime": np.arange(lo, hi, dtype=np.int64),
            "v1": rng.standard_normal(n),
            "v2": rng.standard_normal(n),
            "flag": rng.integers(0, 4, n).astype(np.int64),
        }
    )


def write_events(catalog, lo, hi, seed=0):
    try:
        catalog.table(TABLE)
    except KeyError:
        catalog.create_table("ns", "events", SCHEMA, "eventTime")
    catalog.append(TABLE, events_table(lo, hi, seed))


def pipeline_project(hi, gain=1.0, materialize=False):
    """cleaned (numpy rowwise drop) -> scored (torch rowwise map): identical
    code across calls, so every tenant constructing it gets the identical
    signature."""
    p = Project("svc")

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def cleaned(
        data=Model(TABLE, columns=["v1", "v2", "flag"],
                   filter=f"eventTime BETWEEN 0 AND {hi}")
    ):
        return data.filter(data.column("flag") > 0)

    @model(project=p, incremental="rowwise", materialize=materialize)
    @runtime("torch")
    def scored(data=Model("cleaned")):
        out = dict(data)
        out["score"] = gain * (data["v1"] + data["v2"])
        return out

    return p


def service(tmp_path, name="svc", **kw):
    kw.setdefault("rows_per_fragment", 256)
    return PipelineService(str(tmp_path / name), torch_device="cpu", **kw)


def workspace(root, **kw):
    return Workspace(str(root), torch_device="cpu", **kw)


def assert_outputs_bitwise_equal(res_a, res_b):
    assert set(res_a.outputs) == set(res_b.outputs)
    for name in res_a.outputs:
        a, b = res_a.outputs[name], res_b.outputs[name]
        assert a.column_names == b.column_names, name
        for col in a.column_names:
            x, y = np.asarray(a.column(col)), np.asarray(b.column(col))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f"{name}:{col}"


def cold_reference(tmp_path, name, project, rows=2000):
    ws = workspace(tmp_path / name, rows_per_fragment=256)
    write_events(ws.catalog, 0, rows)
    return ws.run(project)


# ------------------------------------------------------------ SharedStore unit
def _elem(lo, hi):
    return Table(
        {"k": np.arange(lo, hi, dtype=np.int64), "x": np.arange(lo, hi, dtype=np.float64)}
    )


def _insert(store, sig, tenant=None, lo=0, hi=100):
    store.insert_window(sig, "t", "k", IntervalSet.of((lo, hi)), _elem(lo, hi), tenant=tenant)


def _cost(w):
    return w.measure()


def test_shared_store_global_lru_spans_tenants():
    store = SharedStore(max_bytes=2 * _elem(0, 100).nbytes)
    for sig, tenant in (("a", "t1"), ("b", "t2"), ("c", "t1")):
        _insert(store, sig, tenant)
    assert store.nbytes <= 2 * _elem(0, 100).nbytes
    assert store.elements("a") == []  # LRU victim regardless of owner
    assert store.elements("b") and store.elements("c")


def test_shared_store_tenant_quota_evicts_own_elements_only():
    store = SharedStore(tenant_quota_bytes=2 * _elem(0, 100).nbytes)
    _insert(store, "x", "t2")
    for sig in ("a", "b", "c"):
        _insert(store, sig, "t1")
    assert store.tenant_bytes("t1") <= 2 * _elem(0, 100).nbytes
    assert store.quota_evictions == 1
    assert store.elements("a") == []
    assert store.elements("x"), "another tenant's bytes must survive t1's quota"


def test_shared_store_liveness_reclaims_stale_signatures():
    store = SharedStore(liveness_runs=3)
    _insert(store, "old", hi=50)
    for _ in range(5):
        store.begin_run()
        store.plan_window("hot", IntervalSet.of((0, 50)), (), _cost)
    assert store.elements("old") == []
    assert store.liveness_evictions == 1
    _insert(store, "hot", hi=50)
    for _ in range(2):
        store.begin_run()
        store.plan_window("hot", IntervalSet.of((0, 50)), (), _cost)
    assert store.elements("hot")


def test_shared_store_reader_pin_blocks_every_eviction_path():
    elem_bytes = _elem(0, 100).nbytes
    store = SharedStore(max_bytes=elem_bytes, liveness_runs=1)
    _insert(store, "pinned")
    with store.reading("pinned"):
        _insert(store, "other")
        assert store.elements("pinned")
        for _ in range(5):
            store.begin_run()
        assert store.elements("pinned")
    _insert(store, "third")
    assert store.nbytes <= elem_bytes


def test_shared_store_counts_cross_tenant_reuse():
    store = SharedStore()
    _insert(store, "s", "alice")
    plan = store.plan_window("s", IntervalSet.of((0, 80)), (), _cost, tenant="bob")
    assert plan.fully_cached
    assert (store.cross_tenant_hits, store.cross_tenant_rows) == (1, 80)
    store.plan_window("s", IntervalSet.of((0, 80)), (), _cost, tenant="alice")
    assert store.cross_tenant_hits == 1


def test_scan_cache_policies_are_live_in_the_service(tmp_path):
    with service(tmp_path, workers=1, liveness_runs=2) as svc:
        write_events(svc.catalog, 0, 500)
        svc.session("alice").run(pipeline_project(hi=499))
        assert svc.scan_cache.run_seq > 0
        elems = svc.scan_cache.elements(TABLE)
        assert elems and all(e.owner == "alice" for e in elems)
        scan_only = Project("scanonly")

        @model(project=scan_only)
        @runtime("torch")
        def reader(data=Model(TABLE, columns=["v1"], filter="eventTime BETWEEN 0 AND 299")):
            return {"v1": data["v1"] * 1.0}

        rb = svc.session("bob").run(scan_only)
        assert rb.bytes_from_store == 0 and rb.bytes_from_cache > 0
        assert svc.scan_cache.cross_tenant_hits > 0
        other = Project("other")

        @model(project=other)
        def nothing(data=Model("ns.unused", columns=["v1"])):
            return data

        svc.catalog.create_table("ns", "unused", SCHEMA, "eventTime")
        svc.session("alice").refresh_pins(["ns.unused"])
        for _ in range(4):
            svc.session("alice").run(other)
        assert svc.scan_cache.elements(TABLE) == []
        assert svc.scan_cache.liveness_evictions > 0


# --------------------------------------------------- cross-tenant cache reuse
def test_second_tenant_pays_only_residual(tmp_path):
    with service(tmp_path, workers=2) as svc:
        write_events(svc.catalog, 0, 2000)
        ra = svc.session("alice").run(pipeline_project(hi=1599))
        rb = svc.session("bob").run(pipeline_project(hi=1999))
        assert rb.node_stats["cleaned"]["fresh_rows"] == 400
        assert rb.bytes_from_model_cache > 0
        assert svc.model_store.cross_tenant_hits > 0
        assert 0 < rb.bytes_from_store < ra.bytes_from_store / 2
    assert_outputs_bitwise_equal(rb, cold_reference(tmp_path, "cold", pipeline_project(hi=1999)))


def test_nested_window_tenant_is_fully_served(tmp_path):
    with service(tmp_path, workers=2) as svc:
        write_events(svc.catalog, 0, 2000)
        svc.session("alice").run(pipeline_project(hi=1999))
        rb = svc.session("bob").run(pipeline_project(hi=999))
        assert rb.rows_to_user_fns == 0 and rb.bytes_from_store == 0
    assert_outputs_bitwise_equal(rb, cold_reference(tmp_path, "cold", pipeline_project(hi=999)))


# ------------------------------------------------------------ tenant sessions
def test_session_pins_freeze_the_lake_view(tmp_path):
    with service(tmp_path, workers=1) as svc:
        write_events(svc.catalog, 0, 1000)
        alice = svc.session("alice")  # pins at 1000 rows
        svc.catalog.append(TABLE, events_table(1000, 1500, seed=5))
        r1 = alice.run(pipeline_project(hi=1999))
        r2 = svc.session("bob").run(pipeline_project(hi=1999))
        assert r1.outputs["scored"].num_rows < r2.outputs["scored"].num_rows
        alice.refresh_pins()
        r3 = alice.run(pipeline_project(hi=1999))
        assert r3.outputs["scored"].num_rows == r2.outputs["scored"].num_rows
        assert r3.rows_to_user_fns == 0  # bob already paid for the delta


def test_explicit_model_snapshot_beats_session_pin(tmp_path):
    with service(tmp_path, workers=1) as svc:
        write_events(svc.catalog, 0, 500)
        old = svc.catalog.current_snapshot(TABLE).snapshot_id
        svc.catalog.append(TABLE, events_table(500, 800, seed=2))
        session = svc.session("alice")
        p = Project("tt")

        @model(project=p, incremental="rowwise")
        @runtime("torch")
        def pinned(data=Model(TABLE, columns=["v1"], filter="eventTime BETWEEN 0 AND 999",
                              snapshot_id=old)):
            return dict(data)

        assert session.run(p).outputs["pinned"].num_rows == 500  # user pin wins


# ----------------------------------------------------------------- scheduler
def test_scheduler_states_and_failure_isolation(tmp_path):
    with service(tmp_path, workers=2) as svc:
        write_events(svc.catalog, 0, 500)
        ok = svc.submit("alice", pipeline_project(hi=499))
        p_bad = Project("bad")

        @model(project=p_bad)
        @runtime("torch")
        def broken(data=Model(TABLE, columns=["v1"], filter="eventTime < 100")):
            raise RuntimeError("user code exploded")

        bad = svc.submit("bob", p_bad)
        ok.wait(30)
        bad.wait(30)
        assert ok.state == DONE and ok.result is not None
        assert bad.state == FAILED and isinstance(bad.error, RuntimeError)
        assert svc.submit("bob", pipeline_project(hi=499)).wait(30).state == DONE


def test_scheduler_admission_bound(tmp_path):
    with service(tmp_path, workers=1, max_queued=2) as svc:
        write_events(svc.catalog, 0, 500)
        release = threading.Event()
        p_slow = Project("slow")

        @model(project=p_slow)
        def blocker(data=Model(TABLE, columns=["v1"], filter="eventTime < 10")):
            release.wait(30)
            return data

        h = svc.submit("alice", p_slow)
        while h.state != RUNNING:
            time.sleep(0.005)
        svc.submit("bob", pipeline_project(hi=99))
        svc.submit("carol", pipeline_project(hi=99))
        with pytest.raises(QueueFull):
            svc.submit("dave", pipeline_project(hi=99))
        release.set()


def test_scheduler_fairness_many_vs_one(tmp_path):
    """Round-robin pick: bob's single run is dispatched no later than
    alice's second queued run."""
    with service(tmp_path, workers=1) as svc:
        write_events(svc.catalog, 0, 500)
        order, lock = [], threading.Lock()

        def tracked(tag, hi):
            p = Project(f"t{tag}{hi}")

            @model(project=p)
            def track(data=Model(TABLE, columns=["v1"], filter=f"eventTime < {hi}")):
                with lock:
                    order.append(tag)
                return data

            return p

        gate = threading.Event()
        p_gate = Project("gate")

        @model(project=p_gate)
        def hold(data=Model(TABLE, columns=["v1"], filter="eventTime < 5")):
            gate.wait(30)
            return data

        svc.submit("alice", p_gate)
        for i in range(4):
            svc.submit("alice", tracked("a", 20 + i))
        svc.submit("bob", tracked("b", 50))
        gate.set()
        svc.drain(60)
        assert order.index("b") <= 1, order


def test_service_without_a_card_raises_at_construction(monkeypatch, tmp_path):
    """The torch device resolves at ``PipelineService(...)``: no card raises
    there, not in a worker thread; ``torch_device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineService(str(tmp_path / "a"))
    with service(tmp_path, "b", workers=1) as svc:
        assert svc.torch_device == torch.device("cpu")
        assert svc.session("alice").workspace.torch_device == torch.device("cpu")


# ------------------------------------------------------------ racing commits
def test_two_racing_writers_surface_exactly_one_conflict(tmp_path):
    catalog = Catalog(ObjectStore(str(tmp_path / "lake")), rows_per_fragment=256)
    write_events(catalog, 0, 100)
    parent = catalog.current_snapshot(TABLE).snapshot_id
    barrier = threading.Barrier(2)
    outcomes, olock = [], threading.Lock()

    def writer(lo):
        barrier.wait()
        try:
            catalog.append(TABLE, events_table(lo, lo + 50), expected_parent=parent)
            result = "ok"
        except CommitConflict:
            result = "conflict"
        with olock:
            outcomes.append(result)

    threads = [threading.Thread(target=writer, args=(lo,)) for lo in (100, 200)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(outcomes) == ["conflict", "ok"]


def test_session_retry_converges_with_both_snapshots_in_chain(tmp_path):
    store = ObjectStore(str(tmp_path / "lake"))
    catalog = Catalog(store, rows_per_fragment=256)
    write_events(catalog, 0, 100)
    base = catalog.current_snapshot(TABLE)
    sessions = [
        TenantSession(n, workspace(store.root, store=store, catalog=catalog, tenant=n))
        for n in ("w1", "w2")
    ]
    barrier = threading.Barrier(2)
    errors = []

    def writer(session, lo):
        barrier.wait()
        try:
            session.append(TABLE, events_table(lo, lo + 50))
        except BaseException as e:  # pragma: no cover - diagnostic
            errors.append(e)

    threads = [
        threading.Thread(target=writer, args=(s, lo)) for s, lo in zip(sessions, (100, 200))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    head = catalog.history(TABLE)[-1]
    assert head.sequence == base.sequence + 2  # both commits landed
    assert sum(f.row_count for f in head.fragments) == 200


# ---------------------------------------------- incremental materialization
def read_published(catalog, store, name="scored"):
    """The models.<name> table's full current content, sorted by key."""
    ex = ScanExecutor(store, catalog, cache=NoCache())
    cols = sorted(catalog.table(f"models.{name}").schema)
    return ex.scan(f"models.{name}", cols, sorted_output=True).combine()


def assert_published_mirrors(ws, res, name="scored"):
    pub = read_published(ws.catalog, ws.store, name)
    out = res.outputs[name]
    assert pub.num_rows == out.num_rows
    for col in out.column_names:
        np.testing.assert_array_equal(np.asarray(pub.column(col)), np.asarray(out.column(col)), err_msg=col)


def _lake(tmp_path, rows=1000):
    ws = workspace(tmp_path / "lake", rows_per_fragment=256)
    write_events(ws.catalog, 0, rows)
    return ws


def _materialize_rerun(tmp_path):
    ws = _lake(tmp_path)
    ws.run(pipeline_project(hi=799, materialize=True))
    seq = ws.catalog.current_snapshot("models.scored").sequence
    assert_published_mirrors(ws, ws.run(pipeline_project(hi=799, materialize=True)))
    assert ws.catalog.current_snapshot("models.scored").sequence == seq  # nothing committed


def _materialize_widen(tmp_path):
    ws = _lake(tmp_path)
    ws.run(pipeline_project(hi=499, materialize=True))
    before = read_published(ws.catalog, ws.store).num_rows
    res = ws.run(pipeline_project(hi=999, materialize=True))
    snap = ws.catalog.current_snapshot("models.scored")
    assert snap.operation == "append"
    assert sum(f.row_count for f in snap.fragments) - before == res.outputs["scored"].num_rows - before
    assert_published_mirrors(ws, res)


def _materialize_upstream_overwrite(tmp_path):
    ws = _lake(tmp_path)
    ws.run(pipeline_project(hi=999, materialize=True))
    seq = ws.catalog.current_snapshot("models.scored").sequence
    ws.catalog.overwrite_range(TABLE, 300, 400, events_table(300, 400, seed=42))
    assert_published_mirrors(ws, ws.run(pipeline_project(hi=999, materialize=True)))
    assert ws.catalog.current_snapshot("models.scored").sequence == seq + 1  # one atomic diff


def _materialize_narrow(tmp_path):
    ws = _lake(tmp_path)
    ws.run(pipeline_project(hi=999, materialize=True))
    assert_published_mirrors(ws, ws.run(pipeline_project(hi=399, materialize=True)))
    assert_published_mirrors(ws, ws.run(pipeline_project(hi=999, materialize=True)))


def _materialize_code_edit(tmp_path):
    ws = _lake(tmp_path)
    ws.run(pipeline_project(hi=999, materialize=True))
    res = ws.run(pipeline_project(hi=999, gain=2.0, materialize=True))
    assert ws.catalog.current_snapshot("models.scored").operation == "overwrite"
    assert_published_mirrors(ws, res)


def _materialize_upstream_append(tmp_path):
    ws = _lake(tmp_path)
    ws.run(pipeline_project(hi=1999, materialize=True))
    write_events(ws.catalog, 1000, 1200, seed=4)
    assert_published_mirrors(ws, ws.run(pipeline_project(hi=1999, materialize=True)))


def _materialize_freshened_by_other_runs(tmp_path):
    """Another tenant's non-materializing run freshens an overwritten window
    into the shared cache; the publisher's run is then a pure hit and must
    still republish it."""
    with service(tmp_path, workers=1) as svc:
        write_events(svc.catalog, 0, 1000)
        publisher = svc.session("publisher")
        assert_published_mirrors(publisher.workspace, publisher.run(pipeline_project(hi=999, materialize=True)))
        svc.catalog.overwrite_range(TABLE, 300, 400, events_table(300, 400, seed=9))
        svc.session("other").run(pipeline_project(hi=999))
        publisher.refresh_pins([TABLE])
        res = publisher.run(pipeline_project(hi=999, materialize=True))
        assert res.rows_to_user_fns == 0
        assert_published_mirrors(publisher.workspace, res)


def _materialize_concurrent_new_model(tmp_path):
    """Two tenants race on create_table and on content commits; both
    converge."""
    with service(tmp_path, workers=2) as svc:
        write_events(svc.catalog, 0, 1000)
        h1 = svc.submit("alice", pipeline_project(hi=999, materialize=True))
        h2 = svc.submit("bob", pipeline_project(hi=999, materialize=True))
        for h in (h1.wait(60), h2.wait(60)):
            assert h.state == DONE, h.error
        assert_published_mirrors(svc.session("alice").workspace, h1.result)


MATERIALIZE_CASES = {
    "rerun-does-not-duplicate": _materialize_rerun,
    "widen-appends-residual-only": _materialize_widen,
    "upstream-overwrite-rewrites-window": _materialize_upstream_overwrite,
    "narrow-deletes-stale-rows": _materialize_narrow,
    "code-edit-republishes-in-full": _materialize_code_edit,
    "upstream-append-into-covered-range": _materialize_upstream_append,
    "republishes-windows-freshened-by-other-runs": _materialize_freshened_by_other_runs,
    "concurrent-materialize-of-new-model-converges": _materialize_concurrent_new_model,
}


@pytest.mark.parametrize("case", list(MATERIALIZE_CASES))
def test_materialize(tmp_path, case):
    MATERIALIZE_CASES[case](tmp_path)


def test_session_reads_its_own_publishes(tmp_path):
    with service(tmp_path, workers=1) as svc:
        write_events(svc.catalog, 0, 1000)
        svc.session("bootstrap").run(pipeline_project(hi=299, materialize=True))
        alice = svc.session("alice")  # pins models.scored at the 300-row publish
        res = alice.run(pipeline_project(hi=999, materialize=True))
        consumer = Project("consumer")

        @model(project=consumer)
        @runtime("torch")
        def reader(d=Model("models.scored", columns=["score"])):
            return {"score": d["score"]}

        assert alice.run(consumer).outputs["reader"].num_rows == res.outputs["scored"].num_rows


# ------------------------------------------------------- threaded stress test
@pytest.mark.parametrize("tier", [False, True], ids=["no-tier", "shared-tier"])
def test_threaded_stress_no_torn_reads(tmp_path, tier):
    """Concurrent runs of a torch-node pipeline + catalog appends + forced
    evictions on ONE SharedStore (and, with ``tier``, one device tier behind
    both stores): every run bitwise-equal to a cold run of the same project
    against the session's pinned snapshot."""
    rows = 1200
    with service(
        tmp_path, workers=4, rows_per_fragment=128,
        # well under the working set (the torch node's outputs are x32, half
        # the reference's numpy widths): eviction churn
        model_cache_bytes=25_000,
        liveness_runs=4,
    ) as svc:
        if tier:
            svc.scan_cache.device = svc.model_store.device = DeviceTier(device="cpu")
        write_events(svc.catalog, 0, rows)
        readers = [svc.session(t) for t in ("alice", "bob")]
        stop = threading.Event()

        def appender():
            session = svc.session("writer")
            lo = rows
            while not stop.is_set():
                session.append(TABLE, events_table(lo, lo + 64, seed=7))
                lo += 64
                time.sleep(0.002)

        wt = threading.Thread(target=appender)
        wt.start()
        try:
            his = [399, 799, 1199, 599, 999, 1199, 399, 1099]
            handles = [
                svc.submit(readers[i % 2].tenant_id, pipeline_project(hi=hi))
                for i, hi in enumerate(his)
            ]
            svc.drain(120)
        finally:
            stop.set()
            wt.join()
        refs = {}
        for hi, h in zip(his, handles):
            assert h.state == DONE, h.error
            if hi not in refs:
                refs[hi] = cold_reference(tmp_path, f"cold-{hi}", pipeline_project(hi=hi), rows=rows)
            assert_outputs_bitwise_equal(h.result, refs[hi])
        assert svc.model_store.evictions > 0, "stress must actually evict"
        assert svc.report().model_store["cross_tenant_hits"] > 0
        if tier:
            assert sum(h.result.device_hits for h in handles) > 0
