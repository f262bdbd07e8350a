"""The port's differential cache and service under an object store that
fails (``tests/test_chaos.py`` held on the port), every pipeline with a
torch node: the edit matrix under transient faults and latency spikes,
corrupted and torn spill payloads, a crash mid-append and mid-publish with
restart recovery, run-level retry of store giveups, poison quarantine, a
spill tier that keeps failing, write-through spill across a crash, and
four tenants under faults.  Outputs stay bitwise-equal to fault-free runs;
a failure of the torch node itself (a CUDA error on the card) is never
retried.  Plans are seeded, and backoff runs on the port's ``SimClock``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from edit_matrix import assert_outputs_bitwise_equal, standard_matrix, sweep
from repro_torch.core.cache import DifferentialStore
from repro_torch.core.columnar import Table
from repro_torch.core.device import DeviceTier
from repro_torch.core.spill import SpillTier
from repro_torch.dist.fault import SimClock
from repro_torch.lake import FaultPlan, FaultyObjectStore, InjectedCrash, RetryPolicy
from repro_torch.lake.catalog import Catalog
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.obs import Metrics
from repro_torch.pipeline import Model, Project, Workspace, model, runtime
from repro_torch.service import DONE, FAILED, PipelineService
from test_torch_device import torch_feature_project
from test_torch_service import TABLE, cold_reference, pipeline_project, write_events

SCHEMA = {"eventTime": "<i8", "c1": "<f8", "c2": "<f8", "c3": "<i8"}


def events_table(lo, hi, seed=0):
    """``tests/test_incremental.py``'s rows, as a port table."""
    n = hi - lo
    rng = np.random.default_rng(seed + lo)
    return Table(
        {
            "eventTime": np.arange(lo, hi, dtype=np.int64),
            "c1": rng.standard_normal(n),
            "c2": rng.standard_normal(n),
            "c3": rng.integers(0, 100, n).astype(np.int64),
        }
    )


def feature_project(hi=799, columns=("c1", "c3"), gain=1.0):
    """cleaned -> scaled, both torch rowwise, over the key window [0, hi]."""
    return torch_feature_project(
        f"(eventTime >= 0 AND eventTime < {hi + 1})",
        columns=columns, gain=gain, scaled_mode="rowwise",
    )


def _retry(clock, attempts=6):
    """Store-level retry with an instant simulated clock."""
    return RetryPolicy(max_attempts=attempts, base_delay_s=0.001, clock=clock)


def _seed_catalog(catalog):
    catalog.create_table("ns", "raw", SCHEMA, "eventTime")
    catalog.append("ns.raw", events_table(0, 1000))


def _matrix():
    return standard_matrix(
        base=dict(hi=499),
        widen=dict(hi=999),
        narrow=dict(hi=299),
        beyond=dict(hi=4999),
        feature_add=dict(hi=4999, columns=("c1", "c2", "c3")),
        feature_remove=dict(hi=4999),
        code_edit=dict(hi=4999, gain=2.0),
        append=lambda c: c.append("ns.raw", events_table(1000, 1100, seed=9)),
        overwrite=lambda c: c.overwrite_range(
            "ns.raw", 100, 200, events_table(100, 200, seed=77)
        ),
    )


def _svc(root, **kw):
    return PipelineService(root, workers=kw.pop("workers", 1), rows_per_fragment=256,
                           torch_device="cpu", **kw)


def _lake(root, rows):
    write_events(Catalog(ObjectStore(root), rows_per_fragment=256), 0, rows)


# ------------------------------------------------------------ fault plan unit
def test_retry_absorbs_transients_on_the_sim_clock(tmp_path):
    clock = SimClock()
    plan = FaultPlan(seed=5, transient_rate=0.4)
    store = FaultyObjectStore(str(tmp_path), plan=plan, retry=_retry(clock))
    store.metrics = m = Metrics()
    for i in range(30):
        store.put(f"k/{i}", b"x" * 64)
    for i in range(30):
        assert store.get_range(f"k/{i}", 0, 64) == b"x" * 64
    assert plan.transients_injected > 0
    assert m.total("store_retries") == plan.transients_injected
    assert m.total("store_giveups") == 0
    assert clock.time() > 0  # backoff elapsed on the simulated clock only


# ------------------------------------------- the 11-edit matrix under faults
def test_edit_matrix_under_transient_faults(tmp_path):
    """The warm workspace (with a device tier) lives on a faulted store and
    every cold reference on a plain one: the retry layer absorbs every
    fault, and each edit stays bitwise-equal."""
    clock = SimClock()
    plan = FaultPlan(seed=42, transient_rate=0.15, latency_spike_rate=0.1)

    def setup(root):
        warm = root.endswith("em-warm")
        store = FaultyObjectStore(root, plan=plan, retry=_retry(clock)) if warm else ObjectStore(root)
        ws = Workspace(
            root, store=store, torch_device="cpu",
            device=DeviceTier(device="cpu") if warm else None,
        )
        _seed_catalog(ws.catalog)
        return ws

    results = sweep(tmp_path, setup, feature_project, _matrix())
    assert plan.transients_injected > 0, "the chaos schedule never fired"
    assert plan.spikes_injected > 0
    assert any(w.device_hits > 0 for _l, w, _c in results[1:])


def test_edit_matrix_with_corrupted_and_torn_spill(tmp_path):
    """Mid-sweep one spilled payload of the torch nodes rots at rest and one
    tears: both are quarantined and recomputed, every answer bitwise."""
    root = str(tmp_path / "em-warm")
    store = ObjectStore(root)
    metrics = Metrics()
    model_store = DifferentialStore(
        spill=SpillTier(store, prefix="_spill/model"),
        metrics=metrics,
        metrics_labels={"store": "model"},
    )

    def setup(r):
        if r == root:
            ws = Workspace(r, store=store, model_store=model_store, torch_device="cpu")
        else:
            ws = Workspace(r, torch_device="cpu")
        try:
            _seed_catalog(ws.catalog)
        except FileExistsError:
            pass  # the warm root persists across the two half-sweeps
        return ws

    edits = _matrix()
    sweep(tmp_path, setup, feature_project, edits[:5])
    model_store.demote_all()
    payloads = [k for k in store.list("_spill/model") if not k.endswith(".json")]
    assert len(payloads) >= 2, payloads
    flip_path = store.local_path(payloads[0])
    with open(flip_path, "r+b") as f:
        f.seek(os.path.getsize(flip_path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x01]))
    torn_path = store.local_path(payloads[1])
    with open(torn_path, "r+b") as f:
        f.truncate(os.path.getsize(torn_path) // 2)

    before = metrics.total("corruption_detected")
    sweep(tmp_path, setup, feature_project, edits[5:])
    assert metrics.total("corruption_detected") >= before + 2
    assert metrics.total("spill_quarantined") >= 2
    left = set(store.list("_spill/model"))
    assert payloads[0] not in left and payloads[1] not in left


def test_crash_restart_mid_sequence(tmp_path):
    """A crash mid-append leaves the lake as before the edit; restart
    recovery GCs the orphans and the replayed edit runs bitwise-equal to a
    lake that never crashed."""
    root = str(tmp_path / "em-warm")
    plan = FaultPlan(seed=2, crash_puts=(8,), key_prefix="data/")
    store = FaultyObjectStore(root, plan=plan, retry=_retry(SimClock()))
    ws = Workspace(root, store=store, rows_per_fragment=128, torch_device="cpu")
    _seed_catalog(ws.catalog)
    ws.run(feature_project(hi=499))
    ws.run(feature_project(hi=999))
    with pytest.raises(InjectedCrash):
        ws.catalog.append("ns.raw", events_table(1000, 1100, seed=9))
    assert plan.crashes_injected == 1
    journal = os.path.join(root, "_catalog", "_journal")
    assert os.listdir(journal), "the wounded publish must leave its intent"

    ws2 = Workspace(root, torch_device="cpu")
    assert not os.listdir(journal)
    assert ws2.catalog.current_snapshot("ns.raw").sequence == 1  # seed only
    ws2.catalog.append("ns.raw", events_table(1000, 1100, seed=9))
    warm = ws2.run(feature_project(hi=4999))
    cold = Workspace(str(tmp_path / "cold"), torch_device="cpu")
    _seed_catalog(cold.catalog)
    cold.catalog.append("ns.raw", events_table(1000, 1100, seed=9))
    assert_outputs_bitwise_equal(warm, cold.run(feature_project(hi=4999)))


def test_crash_mid_materialize_publish_rolls_back(tmp_path):
    """Kill the torch node's materialize publish mid-fragment-write; the
    restarted service's recovery rolls it back and the replay publishes
    what a service that never crashed publishes."""
    root = str(tmp_path / "svc")
    _lake(root, 2000)
    plan = FaultPlan(seed=4, crash_puts=(2,), key_prefix="data/models.")
    with _svc(root, fault_plan=plan, store_retry=_retry(SimClock())) as svc:
        h = svc.submit("alice", pipeline_project(hi=1599, materialize=True)).wait()
        assert h.state == FAILED and isinstance(h.error, InjectedCrash)
        assert plan.crashes_injected == 1
    with _svc(root) as svc2:
        rec = svc2.journal_recovery
        assert rec["rolled_back"] == 1 and rec["orphans_deleted"] >= 1
        assert svc2.submit("alice", pipeline_project(hi=1599, materialize=True)).wait().state == DONE
        published = svc2.catalog.current_snapshot("models.scored")
    ref_root = str(tmp_path / "ref")
    _lake(ref_root, 2000)
    with _svc(ref_root) as ref:
        ref.submit("alice", pipeline_project(hi=1599, materialize=True)).wait()
        ref_pub = ref.catalog.current_snapshot("models.scored")
    assert sum(f.row_count for f in published.fragments) == sum(
        f.row_count for f in ref_pub.fragments
    )


# --------------------------------------------------- service-level degradation
def test_run_level_retry_recovers_store_giveups(tmp_path):
    root = str(tmp_path / "svc")
    _lake(root, 2000)
    clock = SimClock()
    plan = FaultPlan(seed=8, transient_rate=0.02, key_prefix="data/")
    with _svc(
        root, fault_plan=plan,
        store_retry=RetryPolicy(max_attempts=1, clock=clock),  # giveup per fault
        max_run_attempts=10,
        run_retry=RetryPolicy(max_attempts=10, base_delay_s=0.001, clock=clock),
    ) as svc:
        h = svc.submit("alice", pipeline_project(hi=1599)).wait()
        assert h.state == DONE
        assert h.attempts > 1, "the schedule must actually force a retry"
        assert svc.metrics.total("run_retries") == h.attempts - 1
        assert svc.metrics.total("runs_quarantined") == 0
    assert_outputs_bitwise_equal(h.result, cold_reference(tmp_path, "ref", pipeline_project(hi=1599)))


def _raising_project(exc: BaseException) -> Project:
    p = Project("bad")

    @model(project=p, incremental="rowwise")
    @runtime("torch")
    def boom(data=Model(TABLE, columns=["v1"], filter="eventTime <= 10")):
        raise exc

    return p


def test_poison_run_quarantined(tmp_path):
    root = str(tmp_path / "svc")
    _lake(root, 500)
    clock = SimClock()
    plan = FaultPlan(seed=0, transient_rate=1.0, key_prefix="data/")
    with _svc(
        root, fault_plan=plan,
        store_retry=RetryPolicy(max_attempts=2, clock=clock),
        max_run_attempts=3,
        run_retry=RetryPolicy(max_attempts=3, base_delay_s=0.001, clock=clock),
    ) as svc:
        h = svc.submit("alice", pipeline_project(hi=399)).wait()
        assert h.state == FAILED and h.attempts == 3
        assert svc.metrics.total("runs_quarantined") == 1


@pytest.mark.parametrize(
    "exc",
    [ValueError("user bug"), RuntimeError("CUDA error: an illegal memory access was encountered")],
    ids=["user-bug", "cuda-error"],
)
def test_torch_node_failures_are_not_retried(tmp_path, exc):
    """A deterministic failure of the torch node, a user bug or a CUDA
    error, fails on attempt one: it carries no retryable marker, so no run
    is replayed (and none moves to the CPU)."""
    with _svc(
        str(tmp_path / "svc"), max_run_attempts=3,
        run_retry=RetryPolicy(max_attempts=3, base_delay_s=0.001, clock=SimClock()),
    ) as svc:
        write_events(svc.catalog, 0, 500)
        h = svc.submit("alice", _raising_project(exc)).wait()
        assert h.state == FAILED and h.attempts == 1
        assert h.error is exc
        assert svc.metrics.total("runs_quarantined") == 0
        assert svc.metrics.total("run_retries") == 0


def test_degraded_ram_only_fallback_when_spill_keeps_failing(tmp_path):
    root = str(tmp_path / "svc")
    _lake(root, 1000)
    clock = SimClock()
    plan = FaultPlan(seed=0, transient_rate=1.0, key_prefix="_spill/")
    with _svc(
        root, fault_plan=plan,
        store_retry=RetryPolicy(max_attempts=2, clock=clock),
        spill=True, spill_mode="write_through",
    ) as svc:
        h = svc.submit("alice", pipeline_project(hi=799)).wait()
        assert h.state == DONE
        h2 = svc.submit("alice", pipeline_project(hi=999)).wait()
        assert h2.state == DONE
        assert svc.model_store.degraded, "spill writes all fail => degraded"
        assert svc.metrics.total("cache_degraded") >= 1
        assert svc.metrics.total("spill_write_failures") >= 3
        assert svc.model_store.stats()["degraded"] is True
    assert_outputs_bitwise_equal(
        h.result, cold_reference(tmp_path, "ref", pipeline_project(hi=799), rows=1000)
    )


@pytest.mark.parametrize("tier", [False, True], ids=["no-tier", "tier"])
def test_write_through_spill_survives_crash_restart(tmp_path, tier):
    """A service killed without its demote-all shutdown restarts warm from
    the write-through copies; with a tier attached to the new service the
    torch node's spilled element is promoted straight to it."""
    root = str(tmp_path / "svc")
    _lake(root, 2000)
    svc = _svc(root, spill=True, spill_mode="write_through")
    r1 = svc.submit("alice", pipeline_project(hi=1599)).wait().result
    assert svc.metrics.total("spill_writethrough_bytes") > 0
    svc.shutdown(wait=False)  # crash: no demote_all flush

    with _svc(root, spill=True) as svc2:
        if tier:
            svc2.scan_cache.device = svc2.model_store.device = DeviceTier(device="cpu")
        h = svc2.submit("bob", pipeline_project(hi=1599)).wait()
        assert h.state == DONE
        assert svc2.metrics.total("spill_restored") > 0
        assert h.result.rows_to_user_fns == 0
        assert h.result.bytes_from_spill > 0
        if tier:
            assert svc2.model_store.spill.device_promotions > 0
    assert_outputs_bitwise_equal(r1, h.result)


# -------------------------------------------------- threaded multi-tenant chaos
def test_multi_tenant_threaded_chaos(tmp_path):
    root = str(tmp_path / "svc")
    _lake(root, 2000)
    clock = SimClock()
    plan = FaultPlan(seed=13, transient_rate=0.1, latency_spike_rate=0.05)
    runs = [(t, hi) for t, hi in zip(["alice", "bob", "carol", "dave"], [799, 999, 1199, 1599])
            for _ in range(2)]
    with _svc(
        root, workers=4, fault_plan=plan, store_retry=_retry(clock, attempts=8),
        max_run_attempts=4,
        run_retry=RetryPolicy(max_attempts=4, base_delay_s=0.001, clock=clock),
    ) as svc:
        svc.scan_cache.device = svc.model_store.device = DeviceTier(device="cpu")
        handles = [svc.submit(t, pipeline_project(hi=hi)) for t, hi in runs]
        for h in handles:
            h.wait(timeout=120)
            assert h.state == DONE, repr(h.error)
    assert plan.transients_injected > 0
    for (t, hi), h in zip(runs, handles):
        ref = cold_reference(tmp_path, f"ref-{t}-{h.run_id}", pipeline_project(hi=hi))
        assert_outputs_bitwise_equal(h.result, ref)
