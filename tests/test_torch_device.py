"""The port's device tier against the reference's (``tests/test_device.py``,
mirrored test by test): pinning, device UNION assembly, LRU demotion,
spill→device promotion, merge replication and fallback accounting.  Where
both packages can run the same inputs they do, and the columns must be
bitwise-equal and the ledgers equal — int64/uint64/float64 inputs included,
which both sides narrow (jax's x32 mode; the port mirrors it).  The port's
tier lives on the CPU here, where its gathers take the plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from repro.core import device as ref_device
from repro.core.cache import DifferentialStore as RefStore
from repro.core.columnar import Table as RefTable
from repro.core.intervals import Interval as RefInterval
from repro.core.intervals import IntervalSet as RefIntervalSet
from repro_torch.core.cache import DifferentialStore
from repro_torch.core.columnar import ChunkedTable, Table
from repro_torch.core.device import (
    ROW_BLOCK,
    DeviceChunkedTable,
    DeviceTier,
    _pad_rows,
    device_union,
    to_device,
)
from repro_torch.core.intervals import Interval, IntervalSet
from repro_torch.core.spill import ObjectStore, SpillTier
from repro_torch.kernels.fragment_gather import fragment_gather, gather_ref
from repro_torch.pipeline.dsl import Model, Project, model, runtime
from repro_torch.pipeline.executor import Workspace
from test_device import SCHEMA, events_table, jax_feature_project
from torch_parity import TwinLakes, assert_same_bits

CPU = torch.device("cpu")


def _cols(table):
    return {c: table.column(c) for c in table.column_names}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _port_pin(h: np.ndarray) -> torch.Tensor:
    return _pad_rows(to_device(h, CPU))


def _ref_pin(h: np.ndarray):
    return ref_device._pad_rows(jnp.asarray(h))


def torch_feature_project(where="eventTime >= 0 AND eventTime < 800",
                          columns=("c1", "c3"), gain=1.0, scaled_mode="none"):
    """``test_device.jax_feature_project`` in torch: the same exactly-rounded
    elementwise ops (compare, select, multiply)."""
    p = Project("devfeat")
    cols = list(columns)

    @model(project=p, incremental="rowwise")
    @runtime("torch")
    def cleaned(data=Model("ns.raw", columns=cols, filter=where)):
        return {
            k: (torch.where(v >= 0, v, v * 0.5) if v.is_floating_point() else v)
            for k, v in data.items()
        }

    @model(project=p, incremental=scaled_mode)
    @runtime("torch")
    def scaled(data=Model("cleaned")):
        return {k: (v * float(gain) if v.is_floating_point() else v) for k, v in data.items()}

    return p


# ---------------------------------------------------- device_union: property
@settings(max_examples=20, deadline=None)
@given(
    st.integers(0, 2**31 - 1),
    st.sampled_from(["<f4", "<i8", "<i1", "<u8", "<f8", "|b1", "<u2"]),
    st.integers(0, 5),
    st.booleans(),
)
def test_device_union_bitwise_equals_reference(seed, dtype, n_runs, aligned):
    """The port's device_union and the reference's on the same providers and
    runs: the same bits (x32 narrowing included) and the same ledger, across
    dtypes, run counts, empty and single-fragment shapes, and alignment."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    providers = []
    for _ in range(int(rng.integers(1, 4))):
        rows = int(rng.integers(1, 300))
        if dt.kind == "f":
            host = rng.standard_normal(rows).astype(dt)
        elif dt.kind == "b":
            host = rng.integers(0, 2, rows).astype(dt)
        else:
            host = rng.integers(0, 100, rows).astype(dt)
        providers.append(host)
    ref_prov = [{"x": _ref_pin(h)} for h in providers]
    port_prov = [{"x": _port_pin(h)} for h in providers]
    ref_runs, port_runs = [], []
    for _ in range(n_runs):
        i = int(rng.integers(len(providers)))
        n = len(providers[i])
        lo = int(rng.integers(0, n + 1))
        hi = int(rng.integers(lo, n + 1))
        if aligned:
            lo, hi = (lo // ROW_BLOCK) * ROW_BLOCK, (hi // ROW_BLOCK) * ROW_BLOCK
        ref_runs.append((ref_prov[i], lo, hi))
        port_runs.append((port_prov[i], lo, hi))
    ref_ledger, port_ledger = {}, {}
    want = ref_device.device_union(ref_runs, ["x"], interpret=True, ledger=ref_ledger)
    got = device_union(port_runs, ["x"], ledger=port_ledger)
    assert port_ledger == ref_ledger
    if not port_runs:
        assert got == want == {}
        return
    assert_same_bits(np.asarray(want["x"]), _host(got["x"]), dtype)


def test_device_union_single_fragment_is_a_slice():
    host = np.arange(64, dtype=np.float32)
    ledger = {}
    got = device_union([({"x": _port_pin(host)}, 8, 40)], ["x"], ledger=ledger)
    np.testing.assert_array_equal(_host(got["x"]), host[8:40])
    assert "gather_fast" not in ledger and "gather_fallbacks" not in ledger
    assert ledger["device_unions"] == 1


def test_device_union_multi_interval_hits_fast_path():
    host = np.arange(512, dtype=np.float32)
    prov = {"x": _port_pin(host)}
    ledger = {}
    got = device_union([(prov, 0, 128), (prov, 256, 512)], ["x"], ledger=ledger)
    np.testing.assert_array_equal(
        _host(got["x"]), np.concatenate([host[0:128], host[256:512]])
    )
    assert ledger["gather_fast"] == 1
    assert "gather_fallbacks" not in ledger


@pytest.mark.parametrize("bounds", [((3, 130), (259, 500)), ((1, 900), (901, 2000))])
def test_device_union_non_aligned_counts_fallback_downgrade(bounds):
    """Off-alignment runs still serve, at and above FALLBACK_KERNEL_MAX_ROWS,
    and the downgrade is counted exactly as the reference counts it."""
    host = np.arange(2048, dtype=np.float64)
    prov, ref_prov = {"x": _port_pin(host)}, {"x": _ref_pin(host)}
    ledger, ref_ledger = {}, {}
    got = device_union([(prov, lo, hi) for lo, hi in bounds], ["x"], ledger=ledger)
    want = ref_device.device_union(
        [(ref_prov, lo, hi) for lo, hi in bounds], ["x"], interpret=True, ledger=ref_ledger
    )
    assert_same_bits(np.asarray(want["x"]), _host(got["x"]))
    assert ledger == ref_ledger
    assert ledger["gather_fallbacks"] == 1 and "gather_fast" not in ledger


def test_device_union_empty_runs_yield_empty_columns():
    prov = {"x": _port_pin(np.arange(16, dtype=np.float32))}
    got = device_union([(prov, 4, 4), (prov, 9, 9)], ["x"])
    assert tuple(got["x"].shape) == (0,)


# ------------------------------------------------- fragment_gather regressions
def test_fragment_gather_tail_not_padded_into_output():
    src = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 4)).astype(np.float32))
    idx = np.arange(13, dtype=np.int32)
    out = fragment_gather(src, idx, row_block=8)
    assert tuple(out.shape) == (13, 4)
    np.testing.assert_array_equal(out.numpy(), gather_ref(src, torch.from_numpy(idx)).numpy())


def test_fragment_gather_rejects_out_of_range_indices():
    src = torch.zeros((10, 4), dtype=torch.float32)
    with pytest.raises(IndexError):
        fragment_gather(src, np.array([0, 10], np.int32), row_block=8)


# ----------------------------------------------------- ChunkedTable column memo
def test_chunked_table_column_memoized_and_frozen():
    chunks = [Table(_cols(events_table(0, 100))), Table(_cols(events_table(100, 200)))]
    ct = ChunkedTable(chunks)
    a = ct.column("c1")
    assert ct.column("c1") is a
    with pytest.raises(ValueError):
        a[0] = 99.0


def test_chunked_table_single_chunk_column_is_zero_copy():
    t = Table(_cols(events_table(0, 50)))
    ct = ChunkedTable([t])
    assert np.shares_memory(ct.column("c1"), t.column("c1"))


# -------------------------------------------------------------- DeviceTier unit
class _Elem:
    _next = iter(range(10_000, 20_000))

    def __init__(self, data):
        self.elem_id = next(self._next)
        self.data = data


def test_device_tier_pin_hit_and_lru_eviction_match_reference():
    """The same pin/hit/evict sequence on both tiers: equal stats (bytes,
    entries, hits, evictions — padded and narrowed alike) and equal bits."""
    col = np.arange(256, dtype=np.float64)
    elem_bytes = int(_port_pin(col).nbytes)
    assert elem_bytes == int(_ref_pin(col).nbytes)
    port = DeviceTier(max_bytes=2 * elem_bytes, device="cpu")
    ref = ref_device.DeviceTier(max_bytes=2 * elem_bytes, interpret=True)
    for tier, table_cls in ((port, Table), (ref, RefTable)):
        elems = [_Elem(table_cls({"x": col + i})) for i in range(3)]
        for e in elems[:2]:
            assert tier.pin(e, "x") is not None
        assert tier.pin(elems[0], "x") is not None
        assert tier.stats()["device_hits"] == 1
        assert tier.pin(elems[2], "x") is not None
        assert tier.get(elems[1].elem_id, "x") is None
        assert tier.get(elems[0].elem_id, "x") is not None
        assert tier.stats()["device_evictions"] == 1
        assert tier.nbytes <= 2 * elem_bytes
        tier.elems = elems
    assert port.stats() == ref.stats()
    for pe, re_ in zip(port.elems, ref.elems):
        p, r = port.get(pe.elem_id, "x"), ref.get(re_.elem_id, "x")
        assert (p is None) == (r is None)
        if p is not None:
            assert_same_bits(np.asarray(r), _host(p))


@pytest.mark.parametrize("dtype", ["<i8", "<u8", "<f8", "<i4", "<u2", "|b1", "<f2", "|i1"])
def test_pin_and_pin_table_narrow_like_reference(dtype):
    """x32: int64→int32, uint64→uint32, float64→float32 on pin and on the
    spill tier's pin_table; h2d counts the narrowed itemsize times the real
    rows; pins are zero-padded to ROW_BLOCK — all as the reference."""
    rng = np.random.default_rng(3)
    host = (rng.standard_normal(37) * 1e3).astype(dtype)
    port, ref = DeviceTier(device="cpu"), ref_device.DeviceTier(interpret=True)
    cols = {"x": host, "y": host[::-1].copy()}
    pe, re_ = _Elem(Table(cols)), _Elem(RefTable(cols))
    assert_same_bits(np.asarray(ref.pin(re_, "x")), _host(port.pin(pe, "x")), "pin")
    assert port.pin_table(pe.elem_id + 5000, pe.data)
    assert ref.pin_table(re_.elem_id + 5000, re_.data)
    for c in ("x", "y"):
        assert_same_bits(
            np.asarray(ref.get(re_.elem_id + 5000, c)),
            _host(port.get(pe.elem_id + 5000, c)),
            f"pin_table:{c}",
        )
    assert port.stats() == ref.stats()


def test_device_tier_unsupported_dtype_falls_back():
    tier = DeviceTier(device="cpu")
    e = _Elem(Table({"s": np.array(["a", "b"], dtype="<U1")}))
    assert tier.pin(e, "s") is None
    assert tier.pin_columns(e, ["s"]) is None
    assert len(tier) == 0


def test_device_tier_drop_element_forgets_all_pins():
    tier = DeviceTier(device="cpu")
    e = _Elem(Table(_cols(events_table(0, 32))))
    assert tier.pin_columns(e, ["c1", "c3"]) is not None
    assert len(tier) == 2
    tier.drop_element(e.elem_id)
    assert len(tier) == 0
    assert tier.get(e.elem_id, "c1") is None


def test_pin_never_aliases_the_ram_tier():
    """torch.from_numpy would share memory with the authoritative RAM
    column; the tier must hold a copy even where no narrowing happens."""
    col = np.arange(64, dtype=np.float32)
    e = _Elem(Table({"x": col}))
    pin = DeviceTier(device="cpu").pin(e, "x")
    assert not np.shares_memory(pin.numpy(), e.data.column("x"))


# ----------------------------------------- store integration: merge replication
def _insert(store, interval_set, interval, table_cls, sig, lo, hi, seed=0, **kw):
    return store.insert_window(
        signature=sig, table="t", sort_key="k",
        window=interval_set([interval(lo, hi)]),
        data=table_cls({
            "k": np.arange(lo, hi, dtype=np.int64),
            "x": np.random.default_rng(seed + lo).standard_normal(hi - lo),
        }),
        **kw,
    )


def test_merge_replicates_pins_device_to_device_like_reference():
    """Merging two pinned elements rebuilds the merged pin by a device→device
    gather: zero new H2D, bytes_replicated > 0 — and the port's merged pins
    and tier ledger equal the reference's."""
    sides = {}
    for name, tier, store_cls, table_cls, iset, iv, up in (
        ("port", DeviceTier(device="cpu"), DifferentialStore, Table, IntervalSet, Interval,
         lambda a: to_device(a, CPU)),
        ("ref", ref_device.DeviceTier(interpret=True), RefStore, RefTable, RefIntervalSet,
         RefInterval, jnp.asarray),
    ):
        store = store_cls(device=tier)
        a = _insert(store, iset, iv, table_cls, "s", 0, 64)
        tier.pin_columns(a, ["k", "x"])
        h2d_before = tier.stats()["bytes_h2d"]
        plan = store.plan_window(
            "s", iset([iv(0, 128)]), (), lambda w: w.measure(), device_consumer=True
        )
        assert plan.residual.to_pairs() == ((64, 128),)
        fresh = table_cls({
            "k": np.arange(64, 128, dtype=np.int64),
            "x": np.random.default_rng(1).standard_normal(64),
        })
        store.insert_window(
            signature="s", table="t", sort_key="k",
            window=iset([iv(64, 128)]), data=fresh,
            device_arrays={c: up(fresh.column(c)) for c in fresh.column_names},
        )
        (merged,) = store.elements("s")
        assert merged.window.to_pairs() == ((0, 128),)
        stats = tier.stats()
        assert stats["bytes_h2d"] == h2d_before, "merge must not upload"
        assert stats["bytes_replicated"] > 0
        sides[name] = (tier, tier.element_arrays(merged, ["k", "x"]), stats)
    (_pt, parr, pstats), (_rt, rarr, rstats) = sides["port"], sides["ref"]
    assert pstats == rstats
    for c in ("k", "x"):
        assert_same_bits(np.asarray(rarr[c]), _host(parr[c]), c)


def test_spill_promotion_goes_straight_to_device(tmp_path):
    tier = DeviceTier(device="cpu")
    spill = SpillTier(ObjectStore(str(tmp_path / "obj")))
    store = DifferentialStore(spill=spill, device=tier)
    _insert(store, IntervalSet, Interval, Table, "s", 0, 64)
    store.demote_all()
    assert store.nbytes == 0
    plan = store.plan_window(
        "s", IntervalSet([Interval(0, 64)]), (), lambda w: w.measure(),
        device_consumer=True,
    )
    assert plan.hits
    assert spill.device_promotions == 1
    assert plan.bytes_h2d > 0
    assert tier.get(plan.hits[0].element.elem_id, "x") is not None


def test_store_and_tier_stats_carry_device_ledger():
    """The port has no service layer yet (SharedStore): the store-level
    ledger it would surface is the tier's own stats, wired through the
    store's registry."""
    tier = DeviceTier(device="cpu")
    store = DifferentialStore(device=tier)
    keys = ("device_nbytes", "device_entries", "bytes_h2d", "device_hits",
            "device_evictions", "device_pins", "bytes_replicated")
    assert all(tier.stats()[k] == 0 for k in keys)
    _insert(store, IntervalSet, Interval, Table, "s", 0, 32)
    tier.pin_columns(store.elements("s")[0], ["k", "x"])
    s = tier.stats()
    assert s["device_entries"] == 2 and s["bytes_h2d"] > 0
    assert tier.metrics is store.metrics


# ------------------------------------------------- executor: end-to-end serving
def _twins(tmp_path, device=True):
    tw = TwinLakes(str(tmp_path), rows_per_fragment=128, device=device)

    def seed(catalog, table_cls):
        catalog.create_table("ns", "raw", SCHEMA, "eventTime")
        catalog.append("ns.raw", table_cls(_cols(events_table(0, 1024))))

    tw.replay(seed)
    return tw


def _w(lo, hi):
    return f"(eventTime >= {lo} AND eventTime < {hi})"


def test_warm_run_serves_from_device_like_reference(tmp_path):
    tw = _twins(tmp_path / "tw")
    for where in (_w(0, 1024), _w(0, 1024)):
        _rres, pres = tw.run(jax_feature_project(where), torch_feature_project(where), where)
    assert pres.bytes_h2d == 0, "warm rerun must not touch the host link"
    assert pres.device_hits > 0
    assert tw.port.device.stats() == tw.ref.device.stats()


def test_multi_interval_window_takes_gather_fast_path(tmp_path):
    tw = _twins(tmp_path / "tw")
    tw.run(jax_feature_project(_w(0, 1024)), torch_feature_project(_w(0, 1024)))
    where = f"{_w(0, 256)} OR {_w(512, 1024)}"
    _rres, pres = tw.run(jax_feature_project(where), torch_feature_project(where))
    assert pres.gather_fast >= 1
    assert pres.bytes_h2d == 0


def test_non_aligned_window_counts_fallback_downgrade(tmp_path):
    tw = _twins(tmp_path / "tw")
    tw.run(jax_feature_project(_w(0, 1024)), torch_feature_project(_w(0, 1024)))
    where = f"{_w(3, 259)} OR {_w(515, 1019)}"
    _rres, pres = tw.run(jax_feature_project(where), torch_feature_project(where))
    assert pres.gather_fallbacks >= 1


def test_device_chunked_table_select_keeps_device_columns():
    t = Table(_cols(events_table(0, 64)))
    dct = DeviceChunkedTable([t], {"c1": to_device(t.column("c1"), CPU)})
    sel = dct.select(["c1", "c3"])
    assert isinstance(sel, DeviceChunkedTable)
    assert set(sel.device_columns) == {"c1"}


# ------------------------------------------------------------- mutability
def _inplace_project(where):
    """``bump`` writes its input in place; ``keep`` reads the same upstream
    after it in the same run and must still see the untouched values.  Both
    are full-window consumers, so both receive ``cleaned``'s device columns
    (a rowwise consumer re-slices its input on the host)."""
    p = Project("inplace")

    @model(project=p, incremental="rowwise")
    @runtime("torch")
    def cleaned(data=Model("ns.raw", columns=["c1", "c3"], filter=where)):
        return {k: v for k, v in data.items()}

    @model(project=p)
    @runtime("torch")
    def bump(data=Model("cleaned")):
        for v in data.values():
            if v.is_floating_point():
                v.mul_(2.0)
                v[0] = -1.0
        return data

    @model(project=p)
    @runtime("torch")
    def keep(data=Model("cleaned")):
        return data

    return p


def test_inplace_user_fn_cannot_corrupt_a_warm_pin(tmp_path):
    ws = Workspace(str(tmp_path / "dev"), rows_per_fragment=128, device=DeviceTier(device="cpu"))
    ws.catalog.create_table("ns", "raw", SCHEMA, "eventTime")
    ws.catalog.append("ns.raw", Table(_cols(events_table(0, 1024))))
    cold = ws.run(_inplace_project(_w(0, 512)))
    pins_before = {k: e.arr.clone() for k, e in ws.device._entries.items()}
    for _ in range(2):  # warm: every input now comes from device pins
        warm = ws.run(_inplace_project(_w(0, 512)))
        assert warm.node_stats["cleaned"]["fresh_rows"] == 0
        assert warm.device_hits > 0
        for name in ("cleaned", "bump", "keep"):
            for c in cold.outputs[name].column_names:
                assert_same_bits(
                    cold.outputs[name].column(c), warm.outputs[name].column(c), f"{name}:{c}"
                )
    for k, arr in pins_before.items():
        assert torch.equal(ws.device._entries[k].arr, arr), f"pin {k} was written"
    c1 = warm.outputs["keep"].column("c1")
    assert_same_bits(c1, warm.outputs["cleaned"].column("c1"))
    assert c1[0] != -1.0


@pytest.mark.parametrize("dtype", ["<i8", "<u8", "<f8", "<i4", "|b1", "<f2"])
def test_to_device_lands_on_the_requested_device(dtype):
    """Narrowed or not, an upload ends on the tier's device (a narrowed
    column once stayed on the host); ``meta`` stands in for the card."""
    host = np.arange(8).astype(dtype)
    t = to_device(host, torch.device("meta"))
    assert t.device.type == "meta"
    assert t.dtype == to_device(host, CPU).dtype
