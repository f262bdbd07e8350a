"""The port's training path against the reference's, on the CPU, for the
transformer families (dense, MoE, audio, VLM): the loss, the optimizers and
their schedule, one train step of every reduced transformer arch (granite
with the published ``microbatches=2``), rematerialisation, five-step loss
trajectories, the SSD kernel wrapper's refusal to run under autograd, and
the attention wrapper's gradients on the CPU.

Inputs and weights come from numpy seeds and the reference's own init
carried over by ``state_from_reference``.  The bar is the reference's
one-for-one bar (1e-4, ``tests/test_torch_models.py``) unless a test says
otherwise; the optimizer updates, the schedule and the loss are held at
1e-6 (the same f32 ops in the same order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import layers as RL
from repro.train.optimizer import OptimizerConfig as RefOpt
from repro.train.optimizer import make_optimizer as ref_make_optimizer
from repro.train.optimizer import make_schedule as ref_make_schedule
from repro_torch.models import get_config, get_model
from repro_torch.models import layers as PL
from repro_torch.train import OptimizerConfig, make_optimizer, make_schedule
from repro_torch.train.loop import value_and_grad
from repro_torch.train.state import tree_leaves
from torch_parity import (
    assert_one_step_matches,
    to_numpy as _np,
    to_torch as _t,
    token_batch,
    train_states,
)

TIGHT = dict(rtol=1e-6, atol=1e-6)
DENSE = [
    "musicgen-medium",
    "nemotron-4-340b",
    "phi3-mini-3.8b",
    "granite-3-8b",
    "internvl2-76b",
    "llama4-scout-17b-a16e",
    "mixtral-8x22b",
]


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("bool_mask", [False, True])
def test_cross_entropy_matches_the_reference(softcap, bool_mask):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 33)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = rng.random((2, 7)) > 0.3
    mask = mask if bool_mask else mask.astype(np.float32)
    loss_r, count_r = RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), softcap)
    loss, count = PL.cross_entropy(_t(logits), _t(labels), _t(mask), softcap)
    np.testing.assert_allclose(float(loss), float(loss_r), **TIGHT)
    assert float(count) == float(count_r)
    # bf16 logits are scored in f32, as the reference's are
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    loss_b, _ = PL.cross_entropy(lb, _t(labels), _t(mask), softcap)
    loss_rb, _ = RL.cross_entropy(jnp.asarray(lb.float().numpy(), jnp.bfloat16), jnp.asarray(labels), jnp.asarray(mask), softcap)
    np.testing.assert_allclose(float(loss_b), float(loss_rb), **TIGHT)


def test_cross_entropy_of_an_empty_mask_is_zero_over_one():
    loss, count = PL.cross_entropy(torch.zeros((1, 3, 5)), torch.zeros((1, 3), dtype=torch.int64), torch.zeros((1, 3)))
    assert float(loss) == 0.0 and float(count) == 1.0


# -------------------------------------------------------------- optimizers
def _random_tree(rng, dtype=np.float32):
    return {
        "stack": (rng.standard_normal((3, 16, 160)) * 0.1).astype(dtype),
        "wide": (rng.standard_normal((130, 140)) * 0.1).astype(dtype),
        "bias": (rng.standard_normal((16,)) * 0.1).astype(dtype),
        "inner": {"vec": (rng.standard_normal((5,)) * 0.1).astype(dtype)},
    }


def _tree_pair(tree, bf16: bool):
    ref = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32), tree)
    port = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16 if bf16 else torch.float32), tree)
    return ref, port


def _assert_tree(port_tree, ref_tree, what, **tol):
    paths = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = tree_leaves(port_tree)
    assert len(got) == len(paths), what
    for (path, want), g in zip(paths, got):
        np.testing.assert_allclose(_np(g), np.asarray(want, np.float32), err_msg=f"{what}{jax.tree_util.keystr(path)}", **tol)


@pytest.mark.parametrize(
    "kind,bf16,moments",
    [("adamw", False, "float32"), ("adamw", True, "float32"), ("adamw", True, "bfloat16"), ("adafactor", False, "float32")],
)
def test_optimizer_update_matches_the_reference(kind, bf16, moments):
    """Three updates at steps 4-6 (past a 2-step warmup, so the learning
    rate is not 0) with a clip norm the gradients exceed.  f32 leaves at
    1e-6; a bf16 leaf may round the other way where its f32 source differs
    in the last bit, so bf16 parameters and moments are held at one bf16
    step (2^-8 relative).  With bf16 moments a moment one bf16 step off
    moves that element's update by 2^-8 of the learning rate (3e-2), so
    the f32 master and the parameters take an absolute bar of 1.2e-4."""
    cfg_kw = dict(kind=kind, peak_lr=3e-2, warmup_steps=2, decay_steps=20, grad_clip_norm=0.5,
                  moment_dtype=moments)
    rinit, rupdate = ref_make_optimizer(RefOpt(**cfg_kw))
    init, update = make_optimizer(OptimizerConfig(**cfg_kw))
    rng = np.random.default_rng(1)
    rparams, params = _tree_pair(_random_tree(rng), bf16)
    rstate, state = rinit(rparams), init(params)
    if kind == "adamw":
        assert ("master" in state) == bf16 == ("master" in rstate)
    for step in (4, 5, 6):
        g = _random_tree(rng)
        rparams, rstate, rstats = rupdate(jax.tree.map(jnp.asarray, g), rstate, rparams, jnp.int32(step))
        stats = update(jax.tree.map(torch.from_numpy, g), state, params, torch.tensor(step, dtype=torch.int32))
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(stats[k]), float(rstats[k]), err_msg=k, **TIGHT)
    bf16_step = dict(rtol=2**-8, atol=1e-6)
    moment_step = dict(rtol=2**-8 if bf16 else 1e-6, atol=1.2e-4)
    wide = moments == "bfloat16"
    _assert_tree(params, rparams, "params", **(moment_step if wide else bf16_step if bf16 else TIGHT))
    for key in rstate:
        tol = (bf16_step if key in ("m", "v") else moment_step) if wide else TIGHT
        _assert_tree(state[key], rstate[key], key, **tol)


def test_schedule_matches_the_reference():
    cfg_kw = dict(peak_lr=3e-4, warmup_steps=100, decay_steps=10_000, min_lr_ratio=0.1)
    rs, s = ref_make_schedule(RefOpt(**cfg_kw)), make_schedule(OptimizerConfig(**cfg_kw))
    for step in (0, 1, 50, 99, 100, 101, 5_000, 9_999, 10_000, 20_000):
        np.testing.assert_allclose(float(s(torch.tensor(step, dtype=torch.int32))), float(rs(jnp.int32(step))),
                                   err_msg=str(step), **TIGHT)


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("arch_id", DENSE)
def test_one_train_step_matches_the_reference(arch_id):
    assert_one_step_matches(arch_id)


def test_granite_with_its_published_microbatches_matches_the_reference():
    """granite-3-2b's config accumulates two microbatches a step."""
    assert_one_step_matches("granite-3-2b", microbatches=2)


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_reference_init_loss_matches(arch_id):
    """With the reference's own attention init the gradients are too ill
    conditioned for 1e-4 (``fan_in_d_attention``); the loss still agrees."""
    assert_one_step_matches(arch_id, conditioned=False)


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "mixtral-8x22b"])
@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(arch_id, mode):
    """Recomputing a layer in the backward pass, wholly or all but its
    projections, gives bitwise the gradients of keeping every activation
    (the same ops on the same inputs, on the CPU)."""
    cfg = get_config(arch_id).reduced()
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in token_batch(cfg, 2, 2 * cfg.sliding_window or 24, seed=4).items()}
    outs = {}
    for m in ("none", mode):
        api = get_model(dataclasses.replace(cfg, remat=m, microbatches=2))
        outs[m] = value_and_grad(api, params, batch, 2)
    assert torch.equal(outs["none"][0], outs[mode][0])
    for a, b in zip(outs["none"][2], outs[mode][2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_five_step_trajectory_matches_the_reference(kind):
    """Five steps of reduced granite-3-2b (two microbatches) from one state
    on one seeded batch, whose loss must fall.  Each step's loss is held at
    1e-5 (the two packages differed by at most 1.3e-7 of the loss): the
    schedule's learning rate is 0 at step 0, so the steps after it also
    carry every earlier update's rounding."""
    opt = dict(kind=kind, peak_lr=1e-3, warmup_steps=1, decay_steps=10)
    rstep, rstate, step, state = train_states("granite-3-2b", opt, microbatches=2)
    cfg = get_config("granite-3-2b").reduced()
    rl, pl = [], []
    batch = token_batch(cfg, 4, 32, seed=10)
    for _ in range(5):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        rl.append(float(rm["loss"]))
        pl.append(float(m["loss"]))
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    assert pl[-1] < pl[0]


# ------------------------------------------------------- kernels and grads
def test_kernel_wrappers_raise_under_autograd():
    """The SSD kernel has no backward (the reference cannot differentiate
    its Pallas kernels either), so its wrapper refuses an input that
    requires grad while grad mode is on, on the CPU as on the card; serving
    (no grad) is unaffected.  Attention differentiates
    (``test_flash_attention_wrapper_differentiates_like_the_plain_form``)."""
    from repro_torch.kernels import ssd

    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    bm = torch.randn(1, 8, 3)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ssd(x, torch.ones(1, 8, 2), -torch.ones(2), bm, bm)
    with torch.inference_mode():
        assert ssd(x, torch.ones(1, 8, 2), -torch.ones(2), bm, bm)[0].shape == x.shape
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(), use_pallas_kernels=True)
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in token_batch(cfg, 2, 16, seed=0).items()}
    with pytest.raises(RuntimeError, match="no backward kernel"):
        value_and_grad(api, params, batch)


@pytest.mark.parametrize("window", [0, 5])
def test_flash_attention_wrapper_differentiates_like_the_plain_form(window):
    """The attention wrapper under autograd: on the CPU it takes its plain
    version, whose gradients equal those of the materialised softmax
    written out here (grouped heads repeated), and serving (no grad) is
    unaffected."""
    from repro_torch.kernels import flash_attention

    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 24, 4, 16)).astype(np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 16)).astype(np.float32)).requires_grad_()
            for _ in range(2))
    out = flash_attention(q, k, v, window=window)
    assert out.grad_fn is not None
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    kr, vr = (torch.repeat_interleave(t, 2, dim=2) for t in (k, v))
    scores = torch.einsum("bshk,bthk->bhst", q, kr) * 16**-0.5
    pos = torch.arange(24)
    mask = (pos[None, :] <= pos[:, None]) & ((pos[None, :] > pos[:, None] - window) if window else True)
    plain = torch.einsum("bhst,bthk->bshk", torch.softmax(scores.masked_fill(~mask, -1e30), -1), vr)
    for a, b in zip(grads, torch.autograd.grad((plain * plain).sum(), (q, k, v))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        assert flash_attention(q, k, v, window=window).grad_fn is None


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "mixtral-8x22b"])
def test_kernels_on_model_differentiates_like_the_plain_model(arch_id):
    """A transformer with ``use_pallas_kernels`` trains on the CPU: its
    attention takes the wrapper's plain version, and the loss and gradients
    equal the plain model's (mixtral's over twice its sliding window)."""
    cfg = get_config(arch_id).reduced()
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    seq = 2 * cfg.sliding_window or 16  # mixtral: the plain path's blocked-local form
    batch = {k: torch.from_numpy(v) for k, v in token_batch(cfg, 2, seq, seed=0).items()}
    plain = value_and_grad(get_model(cfg), params, batch)
    on = value_and_grad(get_model(dataclasses.replace(cfg, use_pallas_kernels=True)), params, batch)
    # the file's one-for-one bar: the blocked-local form sums in another order
    np.testing.assert_allclose(float(on[0]), float(plain[0]), rtol=1e-6)
    for a, b in zip(on[2], plain[2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_kernel_wrappers_raise_under_autograd_on_the_card(card):
    """On the card the SSD wrapper used to fill a fresh tensor through
    ctypes and return it without a ``grad_fn``, cutting every gradient; now
    it raises before any launch.  The attention wrapper differentiates
    through its backward kernel (``tests/test_torch_flash_attention_grad.py``
    holds its gradients)."""
    from repro_torch.kernels import flash_attention, ssd
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mamba2_ssd import kernel as ssd_kernel

    before = ssd_kernel.launches
    x = torch.randn(1, 64, 2, 64, device="cuda", requires_grad=True)
    bm = torch.randn(1, 64, 64, device="cuda")
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ssd(x, torch.ones(1, 64, 2, device="cuda"), -torch.ones(2, device="cuda"), bm, bm)
    assert ssd_kernel.launches == before
    q = torch.randn(1, 64, 4, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    bwd = fa_kernel.launches_bwd
    out = flash_attention(q, q.detach(), q.detach())
    out.float().sum().backward()
    assert q.grad is not None and fa_kernel.launches_bwd == bwd + 1


def test_blocked_causal_attention_differentiates_like_the_plain_form():
    """The online-softmax blocked attention (above 8192 positions in a
    model) writes each query block into its output; its gradients equal
    those of the materialised softmax on the same inputs."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4096, 1, 8)).astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = PL._blocked_causal_attention(q, k, v, 8**-0.5)
    gq, gk, gv = torch.autograd.grad((out * out).sum(), (q, k, v))
    scores = torch.einsum("bshk,bthk->bhst", q, k) * 8**-0.5
    mask = torch.ones(4096, 4096, dtype=torch.bool).tril()
    plain = torch.einsum("bhst,bthk->bshk", torch.softmax(scores.masked_fill(~mask, -1e30), -1), v)
    for a, b in zip((gq, gk, gv), torch.autograd.grad((plain * plain).sum(), (q, k, v))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
