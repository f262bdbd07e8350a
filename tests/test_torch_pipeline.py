"""The port's pipeline parallelism (``repro_torch.dist.pipeline``) against
the reference, on the CPU: four gloo ranks, one a stage, run the 1F1B and
GPipe schedules, the forward stream and six AdamW steps of
``make_pipeline_train_step``; the reference's sequential layer stack
(``jax.value_and_grad`` in this process) gives the bars, at
``tests/test_pipeline_1f1b.py``'s and ``tests/test_dist_extras.py``'s
tolerances.  The weights, inputs and batches are numpy draws handed to
both packages.  The schedules' tick tables and ``schedule_report`` equal
the reference's exactly.

Loss and gradients are held at the reference's own bars twice: in f64
against the reference's sequential stack (XLA's and torch's f32 matmul
and tanh differ in the last bit on the CPU, which at a 1e-7 absolute bar
on gradients of magnitude 10 would test the libraries, not the schedule),
and in f32 against the port's sequential stack (the same libraries)."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro.dist import pipeline as ref_pipeline
from repro.train.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.train.optimizer import make_optimizer as ref_make_optimizer
from repro_torch.dist import pipeline
from repro_torch.dist.ranks import spawn_ranks

S_STAGES, L, D = 4, 8, 16
M, MB, SEQ = 6, 2, 4
N_STEPS, BATCH_SEED = 6, 7


def _draws():
    rng = np.random.default_rng(0)
    Ws = (rng.standard_normal((L, D, D)) * D**-0.5).astype(np.float32)
    x = rng.standard_normal((M, MB, SEQ, D)).astype(np.float32)
    tgt = rng.standard_normal((M, MB, SEQ, D)).astype(np.float32)
    return Ws, x, tgt


def _seq_loss(p, xm, tm):
    def body(c, W):
        return jnp.tanh(c @ W), None

    out, _ = jax.lax.scan(body, xm, p)
    d = (out - tm).astype(jnp.float32)
    return jnp.sum(d * d)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (one spawn for the whole module)."""
    Ws, x, tgt = _draws()
    return spawn_ranks(
        workers.pipeline_suite, S_STAGES, str(tmp_path_factory.mktemp("pp")),
        args=(Ws, x, tgt, N_STEPS, BATCH_SEED, M, MB, SEQ, D), device="cpu", timeout_s=240,
    )


def _gathered(ranks, key, idx):
    return np.concatenate([r[key][idx] for r in ranks]).reshape(L, D, D)


def _reference_sums(n_micro):
    """The reference's summed loss and gradients over the first
    ``n_micro`` microbatches, in f64."""
    Ws, x, tgt = (a.astype(np.float64) for a in _draws())
    with jax.enable_x64(True):
        vg = jax.value_and_grad(_seq_loss)
        l_ref, g_ref = 0.0, np.zeros_like(Ws)
        for m in range(n_micro):
            l, g = vg(jnp.asarray(Ws), jnp.asarray(x[m]), jnp.asarray(tgt[m]))
            l_ref, g_ref = l_ref + float(l), g_ref + np.asarray(g)
    return l_ref, g_ref


def _port_sums(n_micro):
    """The port's own sequential stack (torch autograd), in f32."""
    Ws, x, tgt = _draws()
    W = torch.from_numpy(Ws).requires_grad_()
    loss, grad = torch.zeros((), dtype=torch.float32), torch.zeros_like(W)
    for m in range(n_micro):
        y = torch.from_numpy(x[m])
        for i in range(L):
            y = torch.tanh(y @ W[i])
        d = (y - torch.from_numpy(tgt[m])).float()
        l = torch.sum(d * d)
        (g,) = torch.autograd.grad(l, W)
        loss, grad = loss + l.detach(), grad + g
    return float(loss), grad.numpy()


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_loss_and_gradients_match_the_sequential_reference(ranks, schedule):
    l_ref, g_ref = _reference_sums(M)
    for r in ranks:  # the sums reach every rank
        np.testing.assert_allclose(r[schedule, "float64"][0], l_ref, rtol=1e-6)
        assert r[schedule, "float64"][1] == M * MB * SEQ * D
    np.testing.assert_allclose(_gathered(ranks, (schedule, "float64"), 2), g_ref, rtol=1e-5, atol=1e-7)
    assert ranks[0]["backend"] == "gloo" and ranks[0]["route"] == "host"


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_f32_loss_and_gradients_match_the_ports_sequential_stack(ranks, schedule):
    l_ref, g_ref = _port_sums(M)
    for r in ranks:
        np.testing.assert_allclose(r[schedule, "float32"][0], l_ref, rtol=1e-6)
    np.testing.assert_allclose(_gathered(ranks, (schedule, "float32"), 2), g_ref, rtol=1e-5, atol=1e-7)


def test_fewer_microbatches_than_stages(ranks):
    l_ref, g_ref = _reference_sums(2)
    np.testing.assert_allclose(ranks[0]["small_m", "float64"][0], l_ref, rtol=1e-6)
    got = np.concatenate([r["small_m", "float64"][1] for r in ranks]).reshape(L, D, D)
    np.testing.assert_allclose(got, g_ref, rtol=1e-5, atol=1e-7)
    l32, g32 = _port_sums(2)
    got32 = np.concatenate([r["small_m", "float32"][1] for r in ranks]).reshape(L, D, D)
    np.testing.assert_allclose(got32, g32, rtol=1e-5, atol=1e-7)


def test_one_stage_is_the_sequential_stack(tmp_path):
    """S = 1: stage 0 is also the last stage, stashes its own input and
    seeds the backward from the loss."""
    Ws, x, tgt = _draws()
    (loss, grads), = spawn_ranks(workers.one_stage, 1, str(tmp_path), args=(Ws, x, tgt), device="cpu",
                                 timeout_s=120)
    l_ref, g_ref = _port_sums(M)
    np.testing.assert_allclose(loss, l_ref, rtol=1e-6)
    np.testing.assert_allclose(grads, g_ref, rtol=1e-5, atol=1e-7)


def test_stash_holds_in_flight_microbatches_only(ranks):
    """1F1B preallocates ``min(S, M)`` stash slots on every stage, GPipe
    ``M`` (the reference's ``n_slots``); at M < S both hold M."""
    rep = pipeline.schedule_report(S_STAGES, M, 1)
    for r in ranks:
        assert r["1f1b", "float32"][3] == rep["peak_stash_micro_1f1b"] == min(S_STAGES, M)
        assert r["gpipe", "float32"][3] == rep["peak_stash_micro_gpipe"] == M
        assert r["small_m", "float32"][2] == 2


def test_forward_stream_matches_the_reference(ranks):
    Ws, x, _ = _draws()

    def ref_stack(xm):
        out, _ = jax.lax.scan(lambda c, W: (jnp.tanh(c @ W), None), xm, Ws)
        return out

    want = np.asarray(jax.vmap(ref_stack)(x))
    for r in ranks:
        np.testing.assert_allclose(r["forward"], want, rtol=2e-5, atol=2e-5)


def test_six_adamw_steps_match_the_reference_sequential_step(ranks):
    Ws, _, _ = _draws()
    opt = RefOptimizerConfig(kind="adamw", peak_lr=1e-2, warmup_steps=2)
    init_opt, opt_update = ref_make_optimizer(opt)
    params, state, step = {"W": jnp.asarray(Ws)}, init_opt({"W": jnp.asarray(Ws)}), jnp.zeros((), jnp.int32)
    vgm = jax.value_and_grad(lambda p, xm, tm: _seq_loss(p["W"], xm, tm))
    rng = np.random.default_rng(BATCH_SEED)
    for _ in range(N_STEPS):
        xs = rng.standard_normal((M * MB, SEQ, D)).astype(np.float32).reshape(M, MB, SEQ, D)
        ts = rng.standard_normal((M * MB, SEQ, D)).astype(np.float32).reshape(M, MB, SEQ, D)
        g = {"W": jnp.zeros(Ws.shape, jnp.float32)}
        for m in range(M):
            _, gm = vgm(params, xs[m], ts[m])
            g = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), g, gm)
        g = jax.tree.map(lambda a: a / float(M * MB * SEQ * D), g)
        params, state, _ = opt_update(g, state, params, step)
        step = step + 1
    for r in ranks:
        assert r["step"] == N_STEPS
        assert all(np.isfinite(h["loss"]) for h in r["history"])
        assert r["history"] == ranks[0]["history"]  # the same metrics on every rank
    got = np.concatenate([r["trained"] for r in ranks]).reshape(L, D, D)
    np.testing.assert_allclose(got, np.asarray(params["W"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["_sched_1f1b", "_sched_gpipe"])
def test_tick_tables_equal_the_reference(name):
    """Every (fwd_mb, fwd_ok, bwd_mb, bwd_ok) for S 1-5, M 1-8, every stage
    from -1 (the receive side's look at stage s-1) and every tick from -1."""
    port, ref = getattr(pipeline, name), getattr(ref_pipeline, name)
    for S, M_ in itertools.product(range(1, 6), range(1, 9)):
        T = 2 * (M_ + S - 1)
        ticks = jnp.arange(-1, T + 1, dtype=jnp.int32)
        for s in range(-1, S + 1):
            want = [np.asarray(a) for a in ref(S, M_, jnp.int32(s), ticks)]
            for i, t in enumerate(range(-1, T + 1)):
                got = port(S, M_, s, t)
                assert got == (int(want[0][i]), bool(want[1][i]), int(want[2][i]), bool(want[3][i])), (
                    S, M_, s, t)


def test_schedule_report_equals_the_reference():
    for S, M_, v in itertools.product((1, 2, 4, 8), (1, 2, 3, 16), (1, 2)):
        assert pipeline.schedule_report(S, M_, 4096, n_virtual=v) == ref_pipeline.schedule_report(
            S, M_, 4096, n_virtual=v)


def test_schedule_report_memory_and_bubble():
    r = pipeline.schedule_report(n_stages=4, n_micro=16, microbatch_bytes=1 << 20)
    assert r["peak_stash_micro_1f1b"] == 4
    assert r["peak_stash_micro_gpipe"] == 16
    assert r["bubble_1f1b"] == pytest.approx(3 / 19)
    r2 = pipeline.schedule_report(4, 16, 1 << 20, n_virtual=2)
    assert r2["bubble_1f1b_interleaved"] < r["bubble_1f1b"]


def test_schedule_report_degenerate_cases():
    r = pipeline.schedule_report(n_stages=1, n_micro=4, microbatch_bytes=10)
    assert r["bubble_1f1b"] == 0.0
    assert r["peak_stash_micro_1f1b"] == 1
    r = pipeline.schedule_report(n_stages=8, n_micro=2, microbatch_bytes=10)
    assert r["peak_stash_micro_1f1b"] == 2  # M < S: bounded by M
    with pytest.raises(ValueError):
        pipeline.schedule_report(0, 4, 10)


def test_stage_stacking_round_trips_and_matches_the_reference():
    Ws, _, _ = _draws()
    staged = pipeline.stack_stage_params({"W": Ws}, S_STAGES)
    assert np.array_equal(staged["W"], np.asarray(ref_pipeline.stack_stage_params({"W": Ws}, S_STAGES)["W"]))
    assert np.array_equal(pipeline.unstack_stage_params(staged)["W"], Ws)
    with pytest.raises(ValueError, match="cannot split 8 layers into 3"):
        pipeline.stack_stage_params({"W": Ws}, 3)


def test_a_failed_rank_fails_the_call(tmp_path):
    """A rank that raises fails ``spawn_ranks`` with its traceback; the
    others are stopped (bounded join), nothing hangs."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn_ranks(workers.fail_on_rank, 2, str(tmp_path), args=(1,), device="cpu", timeout_s=60)


def test_ranks_need_a_card_unless_the_cpu_is_asked_for(monkeypatch, tmp_path):
    """The ranks default to the card; without one they raise before any
    process starts, and the launcher's ``--pipeline`` does the same."""
    from repro_torch.dist.ranks import backend_for
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_ranks(workers.fail_on_rank, 2, str(tmp_path), args=(0,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--pipeline", "2", "--steps", "1", "--workdir", str(tmp_path)])
    assert backend_for(4, "cpu") == ("gloo", "host")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backend_for(4, "cuda") == ("gloo", "pinned host")  # ranks sharing one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert backend_for(4, "cuda") == ("nccl", "device")
