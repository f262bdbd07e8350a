"""``run.py`` as a process of its own: no result without a card or without
the program, nothing of JAX or the JAX package loaded, and (on the card)
each cell correct in a short run."""

from __future__ import annotations

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")


def _run(args, cwd=ROOT, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def test_without_a_card_there_is_no_result(no_card):
    out = _run(["--workload", "fhvhv-month.iterate", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA card" in out.stderr


def test_a_checkout_of_only_the_benchmark_has_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["--workload", "granite-3-2b.pretrain", "--seed", "1", "--seconds", "1"], cwd=tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


PROBE = r"""
import glob, importlib, json, os, sys
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import portbench.run as run
from portbench.harness import manifest
bench = manifest.load()
for m in manifest.metrics(bench):
    manifest.reader(m.name)
for w in bench["workloads"]:
    cell = manifest.cell(bench, w["name"])
    manifest.config(cell.config)
    kind = manifest.traffic(cell.traffic)["kind"]
    importlib.import_module("portbench.harness." + kind)
for path in sorted(glob.glob("portbench/harness/*.py")):
    importlib.import_module("portbench.harness." + os.path.basename(path)[:-3])
refs = sorted(glob.glob("portbench/reference/*.py"))
for path in refs:
    importlib.import_module("portbench.reference." + os.path.basename(path)[:-3])
after_refs = sorted({n.split(".")[0] for n in sys.modules})
for name in ("repro_torch.pipeline.executor", "repro_torch.service", "repro_torch.train.loop",
             "repro_torch.data.pipeline", "repro_torch.models.registry", "repro_torch.core.device"):
    importlib.import_module(name)
print(json.dumps({"forbidden": run.forbidden_modules(), "after_refs": after_refs}))
"""


def test_nothing_it_loads_is_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == []
    # the references were imported before any of the program was
    assert "repro_torch" not in seen["after_refs"]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "reference", "*.py"))))
def test_the_references_import_nothing_of_the_program(path):
    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax", "portbench"}, tops


def test_forbidden_names_are_compared_whole():
    from portbench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.core", "reprox", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core.cache", "jax.numpy", "flax", "torch"]) == ["flax", "jax", "repro"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fhvhv-month.iterate", "granite-3-2b.pretrain"])
def test_each_cell_is_correct_on_the_card(card, cell):
    out = _run(["--workload", cell, "--seed", "2147483659", "--seconds", "2", "--trace", "0"], timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
