"""``BENCHMARK.json`` against the benchmark's contract and the files it
names: names, units and lengths, one reader a metric, the cells' metrics,
the configurations' cuts and the run length."""

from __future__ import annotations

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expan", "experts_per")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _metrics(bench):
    return bench["end_to_end"] + bench["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128


def test_names_and_units_use_the_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in _metrics(bench)]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in _metrics(bench):
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    assert len({m["name"] for m in _metrics(bench)}) == len(_metrics(bench))
    for text in [c["why"] for c in bench["configs"]] + [w["why"] for w in bench["workloads"]] \
            + [c["source"] for c in bench["configs"]] + [m["layer"] for m in bench["per_layer"]]:
        assert _line(text), text


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_file_the_manifest_names_is_there(bench):
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.isfile(os.path.join(ROOT, "portbench", "harness", kind + ".py"))
    for m in _metrics(bench):
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py")), m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    from portbench.harness import manifest

    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])
    for w in bench["workloads"]:
        e2e = {m.name for m in manifest.end_to_end_of(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert manifest.per_layer_of(bench, w["name"]), w["name"]


def test_each_moves_is_reported_by_every_cell_that_reports_the_metric(bench):
    from portbench.harness import manifest

    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        cells = m.get("workloads") or [w["name"] for w in bench["workloads"]]
        for cell in cells:
            assert m["moves"] in {x.name for x in manifest.end_to_end_of(bench, cell)}, (m["name"], cell)
        layers.setdefault(m["layer"].lower(), m["layer"])
    # one spelling a layer
    assert len(layers) == len({m["layer"] for m in bench["per_layer"]})


def test_no_reduced_key_is_a_width(bench):
    for c in bench["configs"]:
        for key in c["reduced"]:
            low = key.lower()
            assert not low.endswith(("_dim", "_rank")), key
            assert not any(w in low for w in WIDTH_WORDS if w != "state"), key
            assert low != "num_experts_per_tok"


def test_the_full_check_fits_its_time_at_24_cells(bench):
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
