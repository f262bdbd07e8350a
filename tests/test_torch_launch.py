"""The port's training launcher, ``python -m repro_torch.launch.train``, on
the CPU at reduced size: it trains on the lakehouse corpus through the
differential cache, writes its per-step log, checkpoints and resumes,
compresses gradients, profiles a step, trains the pipeline-parallel stack
over spawned ranks (``--pipeline``, checkpoints the reference reads back),
exits naming the ranks a production mesh needs (``--mesh``), and without
``--device`` needs a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _log(workdir):
    with open(os.path.join(workdir, train.LOG_NAME)) as f:
        return [json.loads(line) for line in f]


def test_trains_checkpoints_and_resumes(tmp_path, capsys):
    work = str(tmp_path / "w")
    args = ["--device", "cpu", "--arch", "granite-3-2b", "--reduced", "--batch", "2", "--seq", "32",
            "--workdir", work, "--ckpt-every", "4"]
    assert train.main(args + ["--steps", "12"]) == 0
    out = capsys.readouterr().out
    assert "ckpts [4, 8, 12]" in out
    log = _log(work)
    assert [r["step"] for r in log] == list(range(1, 13))
    assert log[-1]["loss"] < log[0]["loss"]
    # 12 steps of 2 x 33 tokens over a 198-token corpus: 3 steps an epoch,
    # and every later epoch is served from the differential cache
    assert len({r["store_bytes"] for r in log[3:]}) == 1
    assert train.main(args + ["--steps", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 12" in out
    assert [r["step"] for r in _log(work)[12:]] == [13, 14]


def test_compressed_gradients_and_a_profiled_step(tmp_path, capsys):
    work = str(tmp_path / "w")
    assert train.main(["--device", "cpu", "--arch", "mamba2-780m", "--reduced", "--steps", "10",
                       "--batch", "2", "--seq", "32", "--workdir", work, "--compress-grads",
                       "--profile-step", "3"]) == 0
    out = capsys.readouterr().out
    assert "(EF-int8 grads)" in out and "ckpts []" in out
    assert "profile step 3: wall" in out and "device time not measured" in out
    log = _log(work)
    assert len(log) == 10 and log[-1]["loss"] < log[0]["loss"]


@pytest.mark.parametrize("flag", [["--mesh", "single"], ["--pipeline", "4"]])
def test_mesh_and_pipeline_wait_for_the_dist_slice(flag, tmp_path):
    """The modes the dist slice brought: ``--mesh single`` on a one-rank
    world exits with ``make_mesh``'s message, as the reference raises
    without its fake devices; ``--pipeline 4`` trains over four ranks."""
    if flag[0] == "--mesh":
        with pytest.raises(SystemExit, match=r"needs 256 ranks, found 1 .*torchrun --nproc-per-node=256"):
            train.main(["--device", "cpu", "--reduced", "--workdir", str(tmp_path)] + flag)
        return
    assert train.main(["--device", "cpu", "--steps", "2", "--batch", "1", "--seq", "4",
                       "--workdir", str(tmp_path)] + flag) == 0
    assert [r["step"] for r in _log(str(tmp_path))] == [1, 2]


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_pipeline_trains_and_checkpoints_in_the_reference_format(tmp_path, schedule):
    """``python -m repro_torch.launch.train --pipeline 2``: finite losses,
    the schedule's lines, and checkpoints of the stage-stacked ``(S, L/S,
    ...)`` state that the reference's ``restore_state`` reads."""
    import numpy as np
    from repro.checkpoint import restore_state as ref_restore

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--pipeline", "2", "--pipeline-schedule", schedule,
         "--steps", "4", "--ckpt-every", "2", "--batch", "2", "--seq", "8", "--device", "cpu",
         "--workdir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"[launch] pipeline {schedule}: 2 stages x 2 layers | 4 microbatches" in proc.stdout
    assert "[launch] pipeline ranks: 2 ranks on cpu | backend gloo | hops through host tensors" in proc.stdout
    assert "[launch] 4 pipeline steps in" in proc.stdout and "ckpts [2, 4]" in proc.stdout
    log = _log(str(tmp_path))
    assert [r["step"] for r in log] == [1, 2, 3, 4]
    assert all(np.isfinite([r["loss"] for r in log]))
    step, tree = ref_restore(os.path.join(str(tmp_path), "ckpt"))
    assert step == 4
    params, opt, count = tree["0"], tree["1"], tree["2"]
    assert params["W"].shape == (2, 2, 64, 64) and params["W"].dtype == np.float32
    assert opt["m"]["W"].shape == opt["v"]["W"].shape == (2, 2, 64, 64)
    assert int(count) == 4


def test_needs_a_card_without_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1", "--workdir", str(tmp_path)])


def test_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", "zamba2-1.2b",
         "--reduced", "--steps", "3", "--batch", "2", "--seq", "32", "--workdir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[launch] 3 steps in" in proc.stdout


def test_mesh_single_runs_the_sharded_path_on_a_fake_world(tmp_path):
    """``--mesh single`` with 256 ranks: a ``fake`` process group of world
    256 (one process standing in for rank 0; its collectives move no data,
    so the losses mean nothing) drives the mesh path end to end — the
    16x16 mesh, the state and batches as DTensors under the rules, two
    steps, a checkpoint gathered whole."""
    code = (
        "import sys, torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=256)\n"
        "from repro_torch.launch import train\n"
        f"sys.exit(train.main(['--device', 'cpu', '--reduced', '--mesh', 'single', '--steps', '2', "
        f"'--batch', '16', '--seq', '16', '--ckpt-every', '2', '--workdir', {str(tmp_path)!r}]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[launch] mesh data=16xmodel=16" in proc.stdout
    assert "[launch] 2 steps in" in proc.stdout and "ckpts [2]" in proc.stdout
