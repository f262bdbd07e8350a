"""The port's top-level CLIs against the reference's.

- ``repro_torch.explain``: the 11-edit matrix gives the reference's causes
  edit by edit, with bitwise-equal outputs and equal store ledgers; ``main``
  prints the reference's table and gates with ``--check``.
- ``repro_torch.trace``: on one saved trace, ``summarize`` and every output
  of ``main`` (the summary, ``--chrome -``, ``--chrome FILE``) equal the
  reference's.
- ``repro_torch.lint``: one user module written twice, once over ``repro``
  and once over ``repro_torch``, gives equal exit codes and equal text and
  JSON output.  The analysis abstains outside CPython 3.10/3.11
  (``src/repro/analysis/walker.py:164-167``), so the tests that need
  findings skip there.
"""

from __future__ import annotations

import json
import os
import sys
import textwrap

import pytest

import chip_smoke
import repro.explain as ref_explain
import repro.lint as ref_lint
import repro.trace as ref_trace
import repro_torch.explain as port_explain
import repro_torch.lint as port_lint
import repro_torch.trace as port_trace
from repro_torch.obs.trace import Tracer
from repro_torch.pipeline import Workspace
from torch_parity import assert_tables_bitwise

ANALYSIS_RUNS = sys.implementation.name == "cpython" and (3, 10) <= sys.version_info[:2] <= (3, 11)
NEEDS_FINDINGS = pytest.mark.skipif(
    not ANALYSIS_RUNS,
    reason="the analysis abstains outside CPython 3.10/3.11 (src/repro/analysis/walker.py:164-167)",
)


def _main_output(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


# ----------------------------------------------------------------- explain
def test_explain_matrix_matches_reference(tmp_path):
    ref = ref_explain.edit_matrix_demo(str(tmp_path / "ref"))
    port = port_explain.edit_matrix_demo(str(tmp_path / "port"), device="cpu")
    assert [r[:3] for r in port] == [r[:3] for r in ref]
    assert all(expected == got for _label, expected, got, _res in port)
    for (label, _e, _g, rres), (_l, _e2, _g2, pres) in zip(ref, port):
        assert set(rres.outputs) == set(pres.outputs), label
        for name in rres.outputs:
            assert_tables_bitwise(rres.outputs[name], pres.outputs[name], f"{label}:{name}")
        for key in ("bytes_from_store", "rows_to_user_fns", "bytes_from_model_cache"):
            assert getattr(pres, key) == getattr(rres, key), (label, key)


@pytest.mark.parametrize("extra", [["--check"], ["--check", "-v"]], ids=["check", "verbose"])
def test_explain_main_prints_the_reference_table(tmp_path, capsys, extra):
    ref = _main_output(ref_explain.main, ["--root", str(tmp_path / "ref")] + extra, capsys)
    port = _main_output(
        port_explain.main, ["--root", str(tmp_path / "port"), "--device", "cpu"] + extra, capsys
    )
    assert port == ref
    assert port[0] == 0 and "11/11 causes diagnosed correctly" in port[1]


def test_chip_smoke_explain_phase_on_cpu(tmp_path):
    assert chip_smoke.explain_phase(str(tmp_path), device="cpu") == 11


# ------------------------------------------------------------------- trace
@pytest.fixture(scope="module")
def saved_trace(tmp_path_factory):
    """A trace of two warm-and-cold port runs, saved by ``Tracer.save``."""
    root = tmp_path_factory.mktemp("trace")
    tracer = Tracer()
    ws = Workspace(str(root / "lake"), rows_per_fragment=128, tracer=tracer, torch_device="cpu")
    chip_smoke.write_events(ws.catalog, 1024)
    for windows in ([(0, 512)], [(0, 768)], [(0, 256), (512, 768)]):
        ws.run(chip_smoke.device_project(chip_smoke.where_of(windows)))
    path = str(root / "run.json")
    tracer.save(path)
    empty = str(root / "empty.json")
    Tracer().save(empty)
    return path, empty


def test_trace_summarize_matches_reference(saved_trace):
    path, _empty = saved_trace
    roots = port_trace.load_trace(path)
    assert roots
    assert port_trace.summarize(roots) == ref_trace.summarize(ref_trace.load_trace(path))


@pytest.mark.parametrize("args", [[], ["--chrome", "-"], ["--chrome", "FILE"], ["EMPTY"]],
                         ids=["summary", "chrome-stdout", "chrome-file", "empty"])
def test_trace_main_matches_reference(saved_trace, tmp_path, capsys, args):
    path, empty = saved_trace
    outputs = []
    for name, main in (("ref", ref_trace.main), ("port", port_trace.main)):
        out = str(tmp_path / "chrome.json")
        argv = [empty] if args == ["EMPTY"] else [path] + [out if a == "FILE" else a for a in args]
        code, stdout, err = _main_output(main, argv, capsys)
        chrome = open(out).read() if "FILE" in args else None
        outputs.append((code, stdout, err, chrome))
        if chrome is not None:
            os.remove(out)
    assert outputs[1] == outputs[0]
    if args == ["--chrome", "-"]:
        assert json.loads(outputs[1][1].splitlines()[0])["traceEvents"]


# -------------------------------------------------------------------- lint
USER_MODULE = textwrap.dedent(
    '''
    """A user's pipeline module: one clean model, three seeded violations."""
    import random
    import numpy as np

    from {pkg}.pipeline import Model, Project, model

    project = Project("lint-demo")
    EVENTS = Model("ns.events", columns=["v1"], filter="t BETWEEN 0 AND 9")


    @model(project=project, incremental="rowwise")
    def doubled(data=EVENTS):
        return {{"v": np.asarray(data.column("v1")) * 2.0}}


    @model(project=project, incremental="rowwise")
    def running_total(data=EVENTS):          # RPR001: cross-row cumsum
        return {{"t": np.cumsum(np.asarray(data.column("v1")))}}


    @model(project=project, incremental="rowwise")
    def jittered(data=EVENTS):               # RPR002: unseeded randomness
        return {{"v": np.asarray(data.column("v1")) * random.random()}}


    _SEEN = []


    @model(project=project, incremental="rowwise")
    def logged(data=EVENTS):                 # RPR003: mutates module state
        _SEEN.append(data.num_rows)
        return {{"v": data.column("v1")}}
    '''
)

CLEAN_MODULE = textwrap.dedent(
    '''
    import numpy as np

    from {pkg}.pipeline import Model, Project, model

    project = Project("lint-clean")


    @model(project=project, incremental="rowwise")
    def doubled(data=Model("ns.events", columns=["v1"], filter="t BETWEEN 0 AND 9")):
        return {{"v": np.asarray(data.column("v1")) * 2.0}}
    '''
)

BROKEN_MODULE = "import {pkg}.pipeline\nraise RuntimeError('broken at import')\n"


def _user_modules(tmp_path, source):
    """The module written twice, over each package, under one file name in
    two directories."""
    paths = {}
    for side, pkg in (("ref", "repro"), ("port", "repro_torch")):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        (d / "user_models.py").write_text(source.format(pkg=pkg))
        paths[side] = str(d / "user_models.py")
    return paths


def _lint(main, path, fmt, capsys):
    code, out, err = _main_output(main, ["--format", fmt, path], capsys)
    where = os.path.dirname(path)
    return code, out.replace(where, "<dir>"), err.replace(where, "<dir>")


@pytest.mark.parametrize("source", ["user", "clean", "broken"])
@pytest.mark.parametrize("fmt", ["text", "json"])
def test_lint_matches_reference(tmp_path, capsys, source, fmt):
    src = {"user": USER_MODULE, "clean": CLEAN_MODULE, "broken": BROKEN_MODULE}[source]
    paths = _user_modules(tmp_path, src)
    ref = _lint(ref_lint.main, paths["ref"], fmt, capsys)
    port = _lint(port_lint.main, paths["port"], fmt, capsys)
    assert port == ref
    if source == "broken":
        assert port[0] == 2 and "broken at import" in port[2]
    elif source == "clean" or not ANALYSIS_RUNS:
        assert port[0] == 0
    if fmt == "json" and source != "broken":
        json.loads(port[1])


@NEEDS_FINDINGS
def test_lint_reports_the_seeded_violations_like_reference(tmp_path):
    paths = _user_modules(tmp_path, USER_MODULE)
    ref, ref_errors = ref_lint.lint_targets([paths["ref"]])
    port, port_errors = port_lint.lint_targets([paths["port"]])
    assert ref_errors == port_errors == []
    assert {"RPR001", "RPR002", "RPR003"} <= {f.code for f in port}
    assert [(f.code, f.lineno, f.model) for f in port] == [(f.code, f.lineno, f.model) for f in ref]


@NEEDS_FINDINGS
def test_lint_exit_code_is_1_on_findings(tmp_path, capsys):
    paths = _user_modules(tmp_path, USER_MODULE)
    assert port_lint.main([paths["port"]]) == 1
    assert "RPR001" in capsys.readouterr().out


def test_lint_lints_the_port_package_clean():
    """As ``tests/test_lint_corpus.py`` holds ``src/repro``: every module of
    the port imports under the linter and its models lint clean."""
    findings, errors = port_lint.lint_targets(["src/repro_torch"])
    assert errors == [], errors
    assert findings == [], "\n".join(f.render() for f in findings)
