"""The ``edit_sessions`` cells rehearsed on the CPU at a tiny size: the run
as the harness drives it (everything but the look for a card), the
seed-independent edit script, the reference against the port, and the
faults and control that must come out as not correct."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from portbench.harness import lake, manifest
from portbench.reference import fhvhv_iterate
from portbench.run import measure

CELL = "fhvhv-month.iterate"


def tiny(name: str = CELL):
    bench = manifest.load()
    cell = manifest.cell(bench, name)
    config, traffic = manifest.config(cell.config), manifest.traffic(cell.traffic)
    config.update(rows=1 << 14, rows_per_fragment=1 << 10)
    return config, traffic


def test_two_seeds_ask_the_same_of_the_store():
    config, traffic = tiny()
    lines, recs = zip(*(measure(CELL, seed, 0.0, False, "cpu", config, traffic)
                        for seed in (7, 2**31 + 11)))
    script = [[(e["label"], e["gets"], e["bytes_read"]) for e in r.edits] for r in recs]
    assert script[0] == script[1]
    assert [e["label"] for e in recs[0].edits] == [e["label"] for e in traffic["script"]]
    values = [line["metrics"]["store_s_per_edit"]["value"] for line in lines]
    assert values[0] == values[1] > 0
    assert all(line["correct"] for line in lines)
    assert list(lines[0])[-1] == "checks"
    assert set(lines[0]["metrics"]) == {"store_s_per_edit", "setup_s"}


def test_traced_metrics_need_the_card():
    config, traffic = tiny()
    line, rec = measure(CELL, 3, 0.0, False, "cpu", config, traffic)
    # without a profile the device metrics are left out, never read as 0
    assert manifest.reader("device.idle_share.edit")(rec) is None
    assert manifest.reader("fragment_union.roofline")(rec) is None
    assert 0 < manifest.reader("scan.cache_byte_share")(rec) < 100
    assert rec.union_bytes > 0  # the script's UNIONs copied


@pytest.mark.parametrize("cell", [CELL, "fhvhv-month.tenants"])
def test_an_altered_answer_is_not_correct(monkeypatch, cell):
    from portbench.harness import project

    config, traffic = tiny(cell)
    real = project.trips_project

    def altered(*args, **kw):
        p = real(*args, **kw)
        node = p["feats"]
        inner = node.fn

        def fn(data):
            out = inner(data)
            v = out["fare_per_mile"]
            v[len(v) // 2] += 1.0
            return out

        node.fn = fn
        return p

    monkeypatch.setattr(project, "trips_project", altered)
    line, rec = measure(cell, 5, 0.0, False, "cpu", config, traffic)
    assert not line["correct"]
    assert line["checks"]["mismatched_values"]["value"] > 0


def test_the_float16_control_fails_and_the_reference_agrees_with_itself():
    config, traffic = tiny()
    raw = lake.table(config, 9, config["rows"])
    for edit in traffic["script"]:
        windows = [(lake.key_of_day(config, a), lake.key_of_day(config, b)) for a, b in edit["days"]]
        cols = traffic["base_columns"] + edit["columns"]
        want = fhvhv_iterate.expected(raw, config["sort_key"], windows, cols, edit["gain"])
        again = fhvhv_iterate.expected(raw, config["sort_key"], windows, cols, edit["gain"])
        control = fhvhv_iterate.expected(raw, config["sort_key"], windows, cols, edit["gain"], "float16")
        assert sum(fhvhv_iterate.mismatches(again[n], want[n]) for n in want) == 0
        assert sum(fhvhv_iterate.mismatches(control[n], want[n]) for n in want) > 0


def test_the_key_grid_is_even_and_does_not_overflow():
    config, _ = tiny()
    rows = 1 << 24
    keys = lake.key_grid(config, rows)
    span = config["month_days"] * lake.US_PER_DAY
    for i in (0, 1, 3_440_000, rows - 1):
        assert keys[i] - config["month_start_us"] == i * span // rows
    assert np.all(np.diff(keys[:: 1 << 12]) > 0)


def test_mismatches_counts_values_columns_and_shapes():
    a = {"x": np.arange(4, dtype=np.float32), "k": np.arange(4)}
    b = {"x": np.array([0, 1, 2, 5], dtype=np.float32), "k": np.arange(4)}
    assert fhvhv_iterate.mismatches(a, a) == 0
    assert fhvhv_iterate.mismatches(a, b) == 1
    assert fhvhv_iterate.mismatches(a, {"x": a["x"]}) == 4
    assert fhvhv_iterate.mismatches({"x": a["x"].astype(np.float64), "k": a["k"]}, a) == 4


@pytest.mark.parametrize("kind", ["choice", "lognormal", "fare"])
def test_every_column_is_drawn_from_the_seed_alone(kind):
    config, _ = tiny()
    one, two, other = (lake.table(config, s, 256) for s in (1, 1, 2))
    for spec in config["columns"]:
        if spec["gen"]["kind"] == kind:
            assert np.array_equal(one[spec["name"]], two[spec["name"]])
            assert not np.array_equal(one[spec["name"]], other[spec["name"]])
            assert one[spec["name"]].dtype == np.dtype(spec["dtype"])


def test_the_tenants_rounds_are_correct():
    config, traffic = tiny("fhvhv-month.tenants")
    line, rec = measure("fhvhv-month.tenants", 13, 0.0, False, "cpu", config, traffic)
    assert line["correct"], line["checks"]
    assert rec.attempted == 1 + sum(len(t["script"]) for t in traffic["tenants"])
    assert {e["tenant"] for e in rec.edits} == {t["name"] for t in traffic["tenants"]}
    assert 0 < line["metrics"]["store_s_per_edit"]["value"]
    # the tenants' shared hits are node outputs from the model store
    assert sum(e["bytes_from_model_cache"] for e in rec.edits) > 0
    assert 0 < manifest.reader("scan.cache_byte_share")(rec) < 100


class Ticks:
    """A clock for a driver module that moves a millisecond a reading, so
    that a window holds the same number of sessions or rounds however busy
    the machine is: 14 readings a session of 7 edits, 54 a round of 27."""

    def __init__(self) -> None:
        self._n = itertools.count()

    def perf_counter(self) -> float:
        return next(self._n) * 1e-3


WINDOW_OF_TWO = {CELL: ("edit_sessions", 0.025), "fhvhv-month.tenants": ("service_rounds", 0.08)}


@pytest.mark.parametrize("cell", [CELL, "fhvhv-month.tenants"])
def test_nothing_is_compared_inside_the_window(monkeypatch, cell):
    import importlib

    from portbench.harness import edit_sessions

    config, traffic = tiny(cell)
    driver, seconds = WINDOW_OF_TWO[cell]
    monkeypatch.setattr(importlib.import_module("portbench.harness." + driver), "time", Ticks())
    closed, compared = [], []
    exit_ = edit_sessions.UnionCounter.__exit__
    compare = fhvhv_iterate.mismatches

    def window_closes(self, *exc):
        closed.append(len(compared))
        return exit_(self, *exc)

    def counted(got, want):
        compared.append(closed[:])
        return compare(got, want)

    monkeypatch.setattr(edit_sessions.UnionCounter, "__exit__", window_closes)
    monkeypatch.setattr(fhvhv_iterate, "mismatches", counted)
    line, rec = measure(cell, 17, seconds, False, "cpu", config, traffic)
    assert len({e["session"] for e in rec.edits}) == 2
    assert line["correct"], line["checks"]
    assert closed == [0] and compared and all(c == [0] for c in compared)


def test_an_answer_altered_in_a_later_session_is_not_correct(monkeypatch):
    from portbench.harness import edit_sessions

    config, traffic = tiny()
    real = edit_sessions.outputs_of
    calls = {"n": 0}
    first_session = len(traffic["script"])

    def altered(res):
        out = real(res)
        calls["n"] += 1
        if calls["n"] > first_session:
            v = out["final"]["score"].copy()
            v[len(v) // 2] += 1.0
            out["final"]["score"] = v
        return out

    monkeypatch.setattr(edit_sessions, "outputs_of", altered)
    monkeypatch.setattr(edit_sessions, "time", Ticks())
    line, rec = measure(CELL, 19, WINDOW_OF_TWO[CELL][1], False, "cpu", config, traffic)
    assert len({e["session"] for e in rec.edits}) == 2
    assert not line["correct"]
    assert rec.failed >= 1 and line["checks"]["mismatched_values"]["value"] > 0
