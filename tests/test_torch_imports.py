"""Guards for the PyTorch port's boundaries.

- Every module of ``repro_torch`` and ``chip_smoke`` imports with ``jax``
  and ``repro`` poisoned, and no source file names either in an import.
- ``repro_torch.kernels`` exports the reference package's nine names,
  imported first from any side of the package without a cycle, and its
  import builds nothing.
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
    "checkpoint/__init__.py",
    "configs/__init__.py",
    "configs/granite_3_2b.py",
    "configs/granite_3_8b.py",
    "configs/internvl2_76b.py",
    "configs/llama4_scout_17b_a16e.py",
    "configs/mamba2_780m.py",
    "configs/mixtral_8x22b.py",
    "configs/musicgen_medium.py",
    "configs/nemotron_4_340b.py",
    "configs/phi3_mini_3_8b.py",
    "configs/zamba2_1_2b.py",
    "core/__init__.py",
    "core/baselines.py",
    "core/cache.py",
    "core/columnar.py",
    "core/intervals.py",
    "core/scan.py",
    "core/spill.py",
    "data/__init__.py",
    "data/corpus.py",
    "data/packing.py",
    "dist/__init__.py",
    "dist/fault.py",
    "lake/__init__.py",
    "lake/catalog.py",
    "lake/faults.py",
    "lake/fragments.py",
    "lake/s3sim.py",
    "models/config.py",
    "obs/__init__.py",
    "obs/explain.py",
    "obs/metrics.py",
    "obs/trace.py",
    "pipeline/dag.py",
    "pipeline/filters.py",
    "pipeline/physical.py",
    "service/__init__.py",
    "service/session.py",
    "service/store.py",
    "lint.py",
    "trace.py",
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
    for m in ("repro_torch.dist.pipeline", "repro_torch.dist.sharding", "repro_torch.dist.ranks",
              "repro_torch.launch.mesh", "repro_torch.launch.roofline", "repro_torch.launch.hlo_cost",
              "repro_torch.launch.dryrun"):
        assert m in mods
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


def test_the_scan_covers_every_kernel_package():
    scanned = {os.path.relpath(p, PORT) for p in _source_files() if p.startswith(PORT)}
    for module in ("roofline.py", "hlo_cost.py", "dryrun.py"):
        assert os.path.join("launch", module) in scanned
    for kernel in ("dequant", "flash_attention", "fragment_gather", "mamba2_ssd"):
        for f in ("__init__.py", "kernel.py", "ops.py", "ref.py"):
            assert os.path.join("kernels", kernel, f) in scanned


@pytest.mark.parametrize(
    "first",
    [
        "repro_torch.kernels",
        "repro_torch.kernels.mamba2_ssd.ref",
        "repro_torch.models.ssm",
        "repro_torch.core.device",
        "repro_torch.serve",
    ],
)
def test_kernels_package_exports_the_reference_names_without_a_cycle(first):
    """Imported first from each side of the models/kernels boundary, in a
    fresh process with jax and repro poisoned and nvcc forbidden: the
    package exposes the reference's nine names as functions and builds and
    loads no library."""
    from repro import kernels as ref_kernels

    names = sorted(ref_kernels.__all__)
    code = (
        "import importlib, subprocess, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a build was started')\n"
        "subprocess.Popen = refuse\n"
        f"importlib.import_module({first!r})\n"
        "import repro_torch.kernels as K\n"
        "from repro_torch.kernels import _build\n"
        f"assert sorted(K.__all__) == {names!r}, K.__all__\n"
        "bad = [n for n in K.__all__ if not callable(getattr(K, n)) or isinstance(getattr(K, n), type(K))]\n"
        "assert not bad, bad\n"
        "assert not _build._libs\n"
        "print('exports', len(K.__all__))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "exports 9" in proc.stdout


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    ref = open(os.path.join(SRC, "repro", rel), encoding="utf-8").read()
    port = open(os.path.join(PORT, rel), encoding="utf-8").read()
    assert re.sub(r"\brepro\.", "repro_torch.", ref) == port, (
        f"repro_torch/{rel} drifted from repro/{rel}"
    )


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from repro_torch import explain
    from repro_torch.core.device import DeviceTier
    from repro_torch.models import get_config, get_model
    from repro_torch.pipeline.executor import Workspace
    from repro_torch.serve import ServeEngine
    from repro_torch.service import PipelineService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Workspace(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Workspace(str(tmp_path / "b"), device=True)
    assert DeviceTier(device="cpu").device == torch.device("cpu")
    assert Workspace(str(tmp_path / "c"), torch_device="cpu").torch_device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineService(str(tmp_path / "d"))
    with PipelineService(str(tmp_path / "e"), torch_device="cpu") as svc:
        assert svc.torch_device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        explain.main(["--root", str(tmp_path / "f")])
    assert explain.main(["--root", str(tmp_path / "g"), "--device", "cpu", "--check"]) == 0

    api = get_model(get_config("mamba2-780m").reduced())
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(gen)
    params = api.init_params(gen, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(api, params, slots=1, max_context=16)
    assert ServeEngine(api, params, slots=1, max_context=16, device="cpu").device.type == "cpu"


def test_torch_device_must_match_the_tier(tmp_path):
    from repro_torch.core.device import DeviceTier
    from repro_torch.pipeline.executor import Workspace

    with pytest.raises(ValueError):
        Workspace(str(tmp_path), device=DeviceTier(device="cpu"), torch_device="meta")


def test_index_less_cuda_is_the_current_card(monkeypatch, tmp_path):
    """``"cuda"`` resolves to the current card, so a workspace given
    ``torch_device="cuda:0"`` agrees with a tier built on ``"cuda"`` (a
    service threads one device into workspaces whose stores carry a tier)."""
    from repro_torch.core.device import DeviceTier, resolve_device
    from repro_torch.pipeline.executor import Workspace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    ws = Workspace(str(tmp_path), device=DeviceTier(device="cuda"), torch_device="cuda:0")
    assert ws.torch_device == torch.device("cuda", 0)
    with pytest.raises(ValueError):
        Workspace(str(tmp_path / "b"), device=DeviceTier(device="cuda"), torch_device="cuda:1")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_device("cuda") == torch.device("cuda", 1)


def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
