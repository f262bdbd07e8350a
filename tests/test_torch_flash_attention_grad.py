"""Training through the flash-attention kernel: the route that
``models.layers.attention_train`` takes under autograd, and the backward
kernel's gradients.

On the CPU: the plain path stays in place wherever the kernel's backward
does not apply (CPU tensors, no grad, DTensors), and the kernel's launch
counters do not move.  On the card (``cuda``): dq, dk and dv of
``FlashAttentionFunction`` against the plain f32 path, the forward's output
unchanged when it also writes the rows' log-sum-exp, and a reduced
granite-3-2b train step through the kernel against the plain path.  This
file imports no jax, so it runs on the card:
``python3 -m pytest -m cuda tests/test_torch_flash_attention_grad.py``.

The gradients' bar comes from a bf16 control: the plain path on the same
bf16 inputs (f32 scores, bf16 probabilities and products), the form the
model trains in without the kernel.  Against the f32 path each of the
kernel's gradients must lie within twice the control's largest error in the
same case, relative to the gradient's largest magnitude.  The two round in
other places (the control rounds dP and the products' outputs to bf16, the
kernel P and dS), so one gradient's error can exceed the control's for that
gradient while the case stays inside the control's range: on the H100 the
kernel's errors were 1.6e-3 to 5.1e-3, the control's 1.6e-3 to 5.2e-3, and
no kernel error exceeded 1.8 times the case's largest control error.
"""

from __future__ import annotations

import dataclasses
import os

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import FlashAttentionFunction
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import get_config, get_model
from repro_torch.models import layers as PL
from repro_torch.train.loop import value_and_grad


def _counters():
    return fa_kernel.launches, dict(fa_kernel.launches_by_route), fa_kernel.launches_bwd


def _layer_inputs(cfg, gen, device="cpu", dtype=torch.float32, B=2, S=24):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    x = torch.randn((B, S, D), generator=gen).to(device, dtype)
    ws = [torch.randn(shape, generator=gen).mul(D**-0.5).to(device, dtype).requires_grad_()
          for shape in ((D, H, hd), (D, KV, hd), (D, KV, hd))]
    wo = torch.randn((H, hd, D), generator=gen).mul((H * hd) ** -0.5).to(device, dtype).requires_grad_()
    return x, ws, wo, torch.arange(S, dtype=torch.int32, device=device)


@pytest.fixture
def no_kernel_function(monkeypatch):
    """Any call of the kernel's autograd Function fails the test."""

    def refuse(*args, **kwargs):
        raise AssertionError("the plain path was expected, the kernel's Function was called")

    monkeypatch.setattr(FlashAttentionFunction, "apply", refuse)


@pytest.mark.parametrize("grad", [True, False])
def test_attention_train_keeps_the_plain_path_on_the_cpu(no_kernel_function, grad):
    """CPU tensors, with and without autograd recording: the plain path,
    bitwise the result of the layer's materialised form, and no launch."""
    cfg = get_config("granite-3-2b").reduced()
    x, (wq, wk, wv), wo, pos = _layer_inputs(cfg, torch.Generator().manual_seed(0))
    before = _counters()
    with torch.set_grad_enabled(grad):
        out = PL.attention_train(cfg, x, wq, wk, wv, wo, pos)
        q = torch.einsum("bsd,dhk->bshk", x, wq)
        assert not PL.trains_on_the_kernel(q, q, q)
    assert (out.grad_fn is not None) == grad
    if grad:
        out.sum().backward()
        assert wq.grad is not None
    assert _counters() == before


def test_attention_train_keeps_the_plain_path_for_a_dtensor(no_kernel_function, tmp_path):
    """Sharded training (DTensors under the model's rules, here on a
    one-rank gloo mesh): the plain path, equal to the whole tensors'
    result, and no launch."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist.sharding import use_rules
    from repro_torch.launch.mesh import make_mesh, rules_for

    cfg = get_config("granite-3-2b").reduced()
    x, ws, wo, pos = _layer_inputs(cfg, torch.Generator().manual_seed(1))
    want = PL.attention_train(cfg, x, *ws, wo, pos)
    before = _counters()
    store = dist.FileStore(os.path.join(tmp_path, "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        dx, dwo, *dws = (distribute_tensor(t.detach(), mesh, [Replicate(), Replicate()]).requires_grad_()
                         for t in (x, wo, *ws))
        with use_rules(rules_for(cfg, mesh)):
            q = torch.einsum("bsd,dhk->bshk", dx, dws[0])
            assert not PL.trains_on_the_kernel(q, q, q)
            got = PL.attention_train(cfg, dx, *dws, dwo, pos)
            got.sum().backward()
        assert dws[0].grad is not None
        torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5, atol=1e-6)
    finally:
        dist.destroy_process_group()
    assert _counters() == before


# ------------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _grad_inputs(B, S, H, KV, hd, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, hd), generator=gen, device="cuda").to(torch.bfloat16) for h in (H, KV, KV))
    dout = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, dout


# (B, S, H, KV, hd, causal, window): granite-3-2b's heads at its training
# length; every built head width at 1, 4 and 8 query heads a KV head, at an S
# that is no multiple of 64; windows (one no multiple of 64); head groups that
# leave rows of the 64-row tile unused (5, 6, 12) and the largest (64); a
# short ragged S; non-causal, with and without a window; two sequences
GRAD_CASES = (
    [(1, 4096, 32, 8, 64, True, 0)]
    + [(1, 1000, 2 * G, 2, hd, True, 0) for hd in fa_kernel.HEAD_DIMS for G in (1, 4, 8)]
    + [(2, 1000, 32, 8, 64, True, 256), (1, 1000, 16, 2, 128, True, 300), (1, 130, 2, 2, 16, True, 0),
       (1, 700, 10, 2, 64, True, 0), (1, 1000, 48, 8, 128, True, 4096), (1, 600, 96, 8, 192, True, 0),
       (2, 64, 64, 1, 32, True, 0), (1, 1000, 8, 2, 64, False, 0), (1, 1000, 8, 2, 64, False, 200)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", GRAD_CASES)
def test_backward_kernel_matches_the_plain_f32_path(card, B, S, H, KV, hd, causal, window):
    q, k, v, dout = _grad_inputs(B, S, H, KV, hd, seed=S + H + hd)
    kw = dict(scale=hd**-0.5, causal=causal, window=window)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, dout.float())
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    control = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, dout)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    bwd = fa_kernel.launches_bwd
    got = torch.autograd.grad(FlashAttentionFunction.apply(*leaves, kw["scale"], causal, window), leaves, dout)
    assert fa_kernel.launches_bwd == bwd + 1

    def err(x, w):
        return float((x.float() - w).abs().max() / w.abs().max())

    bar = 2 * max(err(c, w) for c, w in zip(control, want))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        assert err(g, w) <= bar, f"{name}: {err(g, w):.3e} against the bar {bar:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd,window", [(32, 8, 64, 0), (48, 8, 128, 256), (10, 2, 96, 0)])
def test_forward_output_is_unchanged_when_it_writes_the_lse(card, H, KV, hd, window):
    """The output of a call for autograd is bitwise that of a serving call,
    and the rows' log-sum-exp is the plain one of the scaled scores."""
    q, k, v, _ = _grad_inputs(1, 1000, H, KV, hd, seed=7)
    kw = dict(scale=hd**-0.5, causal=True, window=window)
    out, lse = fa_kernel.flash_attention_call(q, k, v, return_lse=True, **kw)
    assert torch.equal(out.view(torch.int16), fa_kernel.flash_attention_call(q, k, v, **kw).view(torch.int16))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), torch.repeat_interleave(k.float(), H // KV, 2)) * kw["scale"]
    qp, kp = torch.arange(1000, device="cuda")[:, None], torch.arange(1000, device="cuda")[None, :]
    mask = (kp <= qp) & ((kp > qp - window) if window else True)
    want = torch.logsumexp(torch.where(mask, s, -float("inf")), -1)
    assert lse.shape == (1, H, 1000) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


def _leaf_norm_gap(got, want):
    """The benchmark cell's ``grad_norm_gap`` form: the worst leaf's norm
    gap against the larger of its norm and the median leaf's."""
    g = [float(torch.linalg.vector_norm(t.float())) for t in got]
    w = [float(torch.linalg.vector_norm(t.float())) for t in want]
    median = sorted(w)[len(w) // 2]
    return max(abs(a - b) / max(b, median) for a, b in zip(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_train_step_through_the_kernel_matches_the_plain_path(card, monkeypatch, remat):
    """A reduced granite-3-2b (3 layers, 4 query heads on 1 KV head, hd 32)
    in bf16, two microbatches, under ``remat``: every attention call takes
    the kernel (forward once and again in the recomputation, backward
    once), and the loss and the gradients' norms lie within the
    granite-3-2b.pretrain cell's limits of the plain path's (``loss_gap``
    2.5e-3, ``grad_norm_gap`` 2e-3)."""
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), dtype="bfloat16", remat=remat, microbatches=2)
    api = get_model(cfg)
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 513), generator=gen, device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "loss_mask": torch.ones((4, 512), dtype=torch.float32, device="cuda")}
    fwd, bwd = fa_kernel.launches, fa_kernel.launches_bwd
    nll, count, grads = value_and_grad(api, params, batch, 2)
    calls = cfg.num_layers * 2
    assert fa_kernel.launches - fwd == 2 * calls and fa_kernel.launches_bwd - bwd == calls
    monkeypatch.setattr(PL, "trains_on_the_kernel", lambda *a: False)
    fwd = fa_kernel.launches
    p_nll, p_count, p_grads = value_and_grad(api, params, batch, 2)
    assert fa_kernel.launches == fwd
    assert abs(float(nll / count) - float(p_nll / p_count)) <= 2.5e-3
    assert _leaf_norm_gap(grads, p_grads) <= 2e-3
