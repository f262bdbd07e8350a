"""The port's training launcher, ``python -m repro_torch.launch.train``, on
the CPU at reduced size: it trains on the lakehouse corpus through the
differential cache, writes its per-step log, checkpoints and resumes,
compresses gradients, profiles a step, refuses the reference's mesh and
pipeline modes with a message, and without ``--device`` needs a card."""

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
def test_mesh_and_pipeline_wait_for_the_dist_slice(flag):
    with pytest.raises(SystemExit, match="ROADMAP A8"):
        train.main(["--device", "cpu", "--reduced"] + flag)


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
