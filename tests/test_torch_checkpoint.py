"""The port's checkpointing: the reference's checkpoint tests
(``tests/test_checkpoint.py``, all but the mesh test, which
``tests/test_torch_sharding.py`` replays on gloo ranks) replayed on the port — bit-exact resume, async
save, a snapshot the caller may update in place, retention, atomicity,
``extra`` metadata — and each package restoring the other's checkpoints,
f32 and bf16 leaves.  Then the reference's failure → rollback → exact
replay test (``tests/test_dist_extras.py``), bitwise on the CPU."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_state as ref_restore
from repro.checkpoint import save_state as ref_save
from repro.train.state import TrainState as RefState
from repro_torch.checkpoint import CheckpointManager, restore_state, save_state
from repro_torch.core.cache import DifferentialCache
from repro_torch.core.planner import ScanExecutor
from repro_torch.data import TokenBatchPipeline, write_token_corpus
from repro_torch.dist.fault import HeartbeatMonitor, RestartCoordinator, SimClock, StragglerDetector
from repro_torch.lake.catalog import Catalog
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.models import get_config, get_model
from repro_torch.train import OptimizerConfig, TrainState, make_init_state, make_train_step
from repro_torch.train.state import tree_leaves, tree_map


def _setup_training(tmp_path, *, rows=20_000, batch=4, seq=64, seed=0, dtype=None):
    cfg = get_config("granite-3-2b").reduced()
    if dtype:
        import dataclasses

        cfg = dataclasses.replace(cfg, dtype=dtype)
    api = get_model(cfg)
    opt = OptimizerConfig(kind="adamw", peak_lr=1e-3)
    store = ObjectStore(str(tmp_path / "s3"))
    catalog = Catalog(store, rows_per_fragment=8192)
    write_token_corpus(catalog, "data.c", rows, cfg.vocab_size, seed=3)
    scans = ScanExecutor(store, catalog, cache=DifferentialCache())
    pipe = TokenBatchPipeline(scans, "data.c", global_batch=batch, seq_len=seq, prefetch_depth=0)
    init = make_init_state(api, opt)
    return make_train_step(api, opt), lambda: init(torch.Generator().manual_seed(seed), "cpu"), pipe


def _run_steps(step_fn, state, pipe, start, n):
    losses = []
    for s in range(start, start + n):
        state, m = step_fn(state, pipe.batch_at(s))
        losses.append(float(m["loss"]))
    return state, losses


def _clone(state: TrainState) -> TrainState:
    return tree_map(lambda t: t.clone(), state)


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_bit_exact_resume(tmp_path, dtype):
    """The step updates the state in place, so the uninterrupted run starts
    from a clone.  bf16 exercises the master copy and the 2-byte leaves."""
    step_fn, init, pipe = _setup_training(tmp_path, dtype=dtype)
    state = init()
    ref_state, ref_losses = _run_steps(step_fn, _clone(state), pipe, 0, 5)
    s3, _ = _run_steps(step_fn, state, pipe, 0, 3)
    save_state(str(tmp_path / "ckpt"), 3, s3)
    step, restored = restore_state(str(tmp_path / "ckpt"), target_struct=init())
    assert step == 3 and isinstance(restored, TrainState)
    _trees_equal(s3, restored)
    final, losses = _run_steps(step_fn, restored, pipe, 3, 2)
    _trees_equal(ref_state, final)
    assert losses == ref_losses[3:]


def test_async_save_matches_blocking(tmp_path):
    _fn, init, _pipe = _setup_training(tmp_path)
    state = init()
    save_state(str(tmp_path / "a"), 1, state, blocking=False).join()
    save_state(str(tmp_path / "b"), 1, state, blocking=True)
    _, ra = restore_state(str(tmp_path / "a"), target_struct=state)
    _, rb = restore_state(str(tmp_path / "b"), target_struct=state)
    _trees_equal(ra, rb)
    _trees_equal(ra, state)


def test_async_save_snapshot_isolated_from_in_place_updates(tmp_path):
    """The host snapshot is taken before save() returns: updating the
    tensors in place right after (as the train step does) must not reach
    the checkpoint."""
    state = {"w": torch.arange(8, dtype=torch.float32)}
    want = state["w"].numpy().copy()
    t = save_state(str(tmp_path / "c"), 7, state, blocking=False)
    state["w"].mul_(0).sub_(1)
    t.join()
    _, r = restore_state(str(tmp_path / "c"))
    np.testing.assert_array_equal(r["w"], want)


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(4)})
    assert mgr.steps() == [3, 4]
    assert mgr.latest() == 4


def test_incomplete_tmp_dirs_ignored(tmp_path):
    root = tmp_path / "ck"
    mgr = CheckpointManager(str(root), keep=3, async_save=False)
    mgr.save(1, {"x": torch.ones(2)})
    os.makedirs(root / "step-9.tmp-deadbeef")
    (root / "step-9.tmp-deadbeef" / "junk.npy").write_bytes(b"xx")
    os.makedirs(root / "step-5")  # complete-looking dir without manifest
    assert mgr.steps() == [1]
    step, _ = mgr.restore()
    assert step == 1


def test_extra_metadata_roundtrip(tmp_path):
    save_state(str(tmp_path / "ck"), 2, {"x": torch.zeros(1)}, extra={"data_step": 17})
    with open(tmp_path / "ck" / "step-2" / "manifest.json") as f:
        assert json.load(f)["extra"]["data_step"] == 17


def test_restore_refuses_a_target_of_another_dtype(tmp_path):
    save_state(str(tmp_path / "ck"), 1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="target"):
        restore_state(str(tmp_path / "ck"), target_struct={"x": torch.zeros(3, dtype=torch.bfloat16)})


# ------------------------------------------------------------ across packages
def _mixed_tree(rng):
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((4,)).astype(np.float32)
    return f32, bf


def test_the_port_reads_the_reference_checkpoint(tmp_path):
    """A reference TrainState with f32 and bf16 leaves and a tuple, saved
    by the reference, restores into the port's typed state bit for bit."""
    f32, bf = _mixed_tree(np.random.default_rng(0))
    ref = RefState(
        params={"w": jnp.asarray(f32), "b": jnp.asarray(bf, jnp.bfloat16)},
        opt={"pair": (jnp.asarray(f32), jnp.asarray(bf, jnp.bfloat16))},
        step=jnp.int32(6),
    )
    ref_save(str(tmp_path / "ck"), 6, ref, extra={"data_step": 6})
    target = TrainState(
        params={"w": torch.zeros(3, 5), "b": torch.zeros(4, dtype=torch.bfloat16)},
        opt={"pair": (torch.zeros(3, 5), torch.zeros(4, dtype=torch.bfloat16))},
        step=torch.zeros((), dtype=torch.int32),
    )
    step, got = restore_state(str(tmp_path / "ck"), target_struct=target)
    assert step == 6 and int(got.step) == 6
    assert got.params["b"].dtype == torch.bfloat16
    want_bf = np.asarray(jnp.asarray(bf, jnp.bfloat16)).view(np.uint16)
    for t in (got.params["b"], got.opt["pair"][1]):
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), want_bf)
    for t in (got.params["w"], got.opt["pair"][0]):
        np.testing.assert_array_equal(t.numpy(), f32)
    # without a target: plain containers of numpy leaves, as the reference's
    _, plain = restore_state(str(tmp_path / "ck"))
    assert set(plain) == {"0", "1", "2"} and isinstance(plain["1"]["pair"], tuple)


def test_the_reference_reads_the_port_checkpoint(tmp_path):
    """The port's files and manifest are the reference's: names, shapes and
    dtypes (a bf16 leaf as '<V2'), so the reference restores them into its
    own TrainState bit for bit."""
    f32, bf = _mixed_tree(np.random.default_rng(1))
    port = TrainState(
        params={"w": torch.from_numpy(f32), "b": torch.from_numpy(bf).to(torch.bfloat16)},
        opt={"pair": (torch.from_numpy(f32), torch.from_numpy(bf).to(torch.bfloat16))},
        step=torch.tensor(4, dtype=torch.int32),
    )
    save_state(str(tmp_path / "port"), 4, port)
    ref = RefState(
        params={"w": jnp.asarray(f32), "b": jnp.asarray(bf, jnp.bfloat16)},
        opt={"pair": (jnp.asarray(f32), jnp.asarray(bf, jnp.bfloat16))},
        step=jnp.int32(4),
    )
    ref_save(str(tmp_path / "ref"), 4, ref)
    manifests = [json.load(open(tmp_path / d / "step-4" / "manifest.json")) for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    step, got = ref_restore(str(tmp_path / "port"), target_struct=ref)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# -------------------------------------------------- failure, rollback, replay
def test_failure_rollback_and_exact_replay(tmp_path):
    """Full FT story: train, checkpoint, kill a worker mid-run, roll back,
    replay — the final state equals the never-failed run bit for bit."""
    step_fn, init, pipe = _setup_training(tmp_path, rows=12_000, batch=2, seq=32, seed=1)
    ref = init()
    for s in range(6):
        ref, _ = step_fn(ref, pipe.batch_at(s))

    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, async_save=False)
    clk = SimClock()
    mon = HeartbeatMonitor(["w0", "w1"], deadline_s=10, clock=clk)
    det = StragglerDetector()
    restored_at = []
    state = init()
    data_step = 0

    def on_restore(step):
        nonlocal state, data_step
        _, state = mgr.restore(step, target_struct=state)
        data_step = step
        restored_at.append(step)

    coord = RestartCoordinator(mon, det, latest_checkpoint=mgr.latest, on_restore=on_restore)
    failed_once = False
    while data_step < 6:
        clk.advance(1)
        mon.beat("w0")
        if not (data_step == 5 and not failed_once):
            mon.beat("w1")
        else:
            for _ in range(11):
                clk.advance(1)
                mon.beat("w0")
            failed_once = True
            coord.tick(data_step)
            continue
        state, _ = step_fn(state, pipe.batch_at(data_step))
        data_step += 1
        if data_step % 2 == 0:
            mgr.save(data_step, state, extra={"data_step": data_step})

    assert restored_at == [4], "should roll back to the step-4 checkpoint"
    _trees_equal(ref, state)
