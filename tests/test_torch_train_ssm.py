"""The port's training path against the reference's, on the CPU, for the
attention-free ``ssm`` family (mamba2-780m) and the ``hybrid`` family
(zamba2-1.2b): one train step from one state at the reference's one-for-one
bar (1e-4, ``tests/test_torch_models.py``), rematerialisation, a five-step
Adafactor trajectory, and layer-stacked parameters unbound once per
forward.  Weights are the reference's own init carried over by
``state_from_reference``; inputs come from numpy seeds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.models import get_config, get_model
from repro_torch.train.loop import value_and_grad
from torch_parity import assert_one_step_matches, token_batch, train_states

SSM = ["mamba2-780m", "zamba2-1.2b"]


@pytest.mark.parametrize("arch_id", SSM)
def test_one_train_step_matches_the_reference(arch_id):
    assert_one_step_matches(arch_id)


@pytest.mark.parametrize("arch_id", SSM)
@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(arch_id, mode):
    """Recomputing the Mamba2 layers in the backward pass gives bitwise the
    gradients of keeping every activation.  The hybrid recomputes them
    wholly under either policy and keeps its shared block, as the
    reference does."""
    cfg = get_config(arch_id).reduced()
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in token_batch(cfg, 2, 40, seed=4).items()}
    outs = {m: value_and_grad(get_model(dataclasses.replace(cfg, remat=m)), params, batch) for m in ("none", mode)}
    assert torch.equal(outs["none"][0], outs[mode][0])
    for a, b in zip(outs["none"][2], outs[mode][2]):
        assert torch.equal(a, b)


def test_five_step_adafactor_trajectory_matches_the_reference():
    """Five Adafactor steps of reduced mamba2-780m on one seeded batch; each
    loss at 1e-5, and the loss falls."""
    rstep, rstate, step, state = train_states(
        "mamba2-780m", dict(kind="adafactor", peak_lr=1e-3, warmup_steps=1, decay_steps=10)
    )
    batch = token_batch(get_config("mamba2-780m").reduced(), 4, 40, seed=11)
    rl, pl = [], []
    for _ in range(5):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        rl.append(float(rm["loss"]))
        pl.append(float(m["loss"]))
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    assert pl[-1] < pl[0]


def test_stacked_leaves_are_unbound_once_per_forward(monkeypatch):
    """Each layer-stacked leaf is split by one ``torch.unbind`` a forward
    (whose backward stacks its gradient once), not indexed layer by layer
    (whose backward writes a zero tensor of the whole stack per layer)."""
    from repro_torch.models import mamba

    cfg = get_config("zamba2-1.2b").reduced()
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = torch.unbind
    monkeypatch.setattr(mamba.torch, "unbind", lambda t, *a: calls.append(t.shape) or real(t, *a))
    nll, _, grads = value_and_grad(get_model(cfg), params, {
        k: torch.from_numpy(v) for k, v in token_batch(cfg, 1, 16, seed=0).items()
    })
    assert len(calls) == len(params["layers"])
    assert all(shape[0] == cfg.num_layers for shape in calls)
    assert torch.isfinite(nll) and all(torch.isfinite(g).all() for g in grads)
