"""Guards for the PyTorch port's boundaries.

- Every module of ``repro_torch`` and ``chip_smoke`` imports with ``jax``
  and ``repro`` poisoned, and no source file names either in an import.
- Modules the port keeps as copies equal their reference modules once
  ``repro.`` is rewritten to ``repro_torch.``, so they cannot drift.
- Without a CUDA card the default device raises instead of carrying on on
  the CPU.
"""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")

# modules the port keeps verbatim (imports rewritten), by path under the
# package root
COPIES = [
    "analysis/__init__.py",
    "analysis/errors.py",
    "analysis/module_scan.py",
    "analysis/walker.py",
    "core/__init__.py",
    "core/baselines.py",
    "core/cache.py",
    "core/columnar.py",
    "core/intervals.py",
    "core/scan.py",
    "core/spill.py",
    "lake/__init__.py",
    "lake/catalog.py",
    "lake/faults.py",
    "lake/fragments.py",
    "lake/s3sim.py",
    "obs/__init__.py",
    "obs/explain.py",
    "obs/metrics.py",
    "obs/trace.py",
    "pipeline/dag.py",
    "pipeline/filters.py",
    "pipeline/physical.py",
]


def _port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), SRC)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def _source_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_with_jax_and_repro_poisoned():
    mods = _port_modules()
    assert "repro_torch.pipeline.executor" in mods
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, v in sys.modules.items()\n"
        "       if v is not None and (m == 'jax' or m.startswith(('jax.', 'repro.')))]\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "imported" in proc.stdout


@pytest.mark.parametrize("path", _source_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_names_jax_or_repro_in_an_import(path):
    """Static: also catches imports inside functions, which a plain import
    of the module never runs."""
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    ref = open(os.path.join(SRC, "repro", rel), encoding="utf-8").read()
    port = open(os.path.join(PORT, rel), encoding="utf-8").read()
    assert re.sub(r"\brepro\.", "repro_torch.", ref) == port, (
        f"repro_torch/{rel} drifted from repro/{rel}"
    )


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from repro_torch.core.device import DeviceTier
    from repro_torch.pipeline.executor import Workspace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Workspace(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Workspace(str(tmp_path / "b"), device=True)
    assert DeviceTier(device="cpu").device == torch.device("cpu")
    assert Workspace(str(tmp_path / "c"), torch_device="cpu").torch_device.type == "cpu"


def test_torch_device_must_match_the_tier(tmp_path):
    from repro_torch.core.device import DeviceTier
    from repro_torch.pipeline.executor import Workspace

    with pytest.raises(ValueError):
        Workspace(str(tmp_path), device=DeviceTier(device="cpu"), torch_device="meta")


def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
