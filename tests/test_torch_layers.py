"""The port's model building blocks against the reference's, on the CPU:
norm, RoPE, full-sequence and decode attention (kernels on and off), the
MLPs, the SSM pieces and the Mamba2 mixer.  Inputs come from numpy seeds;
the mixer runs on the reference's own weights carried over by
``params_from_reference``.  Where both run the same ops in the same order
the bar is 1e-4; where the reference runs its Pallas kernel in interpret
mode and the port its plain version, it is the reference's own bar for the
kernel path (2e-3, ``tests/test_kernels.py:205-208``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import layers as RL
from repro.models import ssm as RS
from repro.models.registry import get_config as ref_get_config
from repro_torch.models import get_config
from repro_torch.models import layers as PL
from repro_torch.models import ssm as PS
from torch_parity import reduced_pair, to_numpy as _np, to_torch as _t

ONE_FOR_ONE = dict(rtol=1e-4, atol=1e-4)
KERNEL_BAR = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module", params=["zamba2-1.2b", "mamba2-780m"])
def arch(request):
    return reduced_pair(request.param)


def test_unported_layers_raise_naming_the_roadmap():
    cfg = get_config("zamba2-1.2b").reduced()
    for fn, args in [
        (PL.moe_apply, (cfg, None, None)),
        (PL.cross_entropy, (None, None, None)),
        (PL._blocked_causal_attention, (None, None, None, 1.0)),
        (PL._blocked_local_attention, (None, None, None, 64, 1.0)),
    ]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(*args)
    # the dispatch reaches them, as the reference's does
    x = torch.zeros((1, 16, cfg.d_model))
    w = torch.zeros((cfg.d_model, cfg.num_heads, cfg.resolved_head_dim))
    wo = torch.zeros((cfg.num_heads, cfg.resolved_head_dim, cfg.d_model))
    windowed = dataclasses.replace(cfg, sliding_window=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PL.attention_train(windowed, x, w, w, w, wo, torch.arange(16))


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_and_rope_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 12)).astype(np.int32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(PL.rms_norm(tx, torch.from_numpy(scale), 1e-5)),
        np.asarray(RL.rms_norm(jx, jnp.asarray(scale), 1e-5), np.float32), **tol,
    )
    got = PL.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    assert got.dtype == tx.dtype  # the rotation multiplies in x's dtype
    np.testing.assert_allclose(
        _np(got), np.asarray(RL.apply_rope(jx, jnp.asarray(pos), 10_000.0), np.float32), **tol
    )
    np.testing.assert_allclose(_np(PL.rope_freqs(16, 500.0)), np.asarray(RL.rope_freqs(16, 500.0)), rtol=1e-6)
    np.testing.assert_array_equal(_np(PL._causal_mask(7, 9, 2, 3)), np.asarray(RL._causal_mask(7, 9, 2, 3)))


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_attention_train_and_decode_match(flag, kv_heads):
    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(), num_kv_heads=kv_heads, use_pallas_kernels=flag)
    rcfg = dataclasses.replace(ref_get_config("zamba2-1.2b").reduced(), num_kv_heads=kv_heads, use_pallas_kernels=flag)
    D, H, hd, S = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, 24
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * D**-0.5
         for s in [(D, H, hd), (D, kv_heads, hd), (D, kv_heads, hd), (H, hd, D)]]
    pos = np.arange(S, dtype=np.int32)
    want = RL.attention_train(rcfg, jnp.asarray(x), *map(jnp.asarray, w), jnp.asarray(pos), return_kv=True)
    got = PL.attention_train(cfg, _t(x), *map(_t, w), _t(pos), return_kv=True)
    tol = KERNEL_BAR if flag else ONE_FOR_ONE
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), **tol)

    # decode one token per sequence at different depths against a cache
    T = 32
    kc = rng.standard_normal((2, T, kv_heads, hd)).astype(np.float32)
    vc = rng.standard_normal((2, T, kv_heads, hd)).astype(np.float32)
    p = np.array([5, 17], np.int32)
    valid = np.arange(T)[None, :] <= p[:, None]
    xd = rng.standard_normal((2, 1, D)).astype(np.float32)
    want = RL.attention_decode(rcfg, jnp.asarray(xd), *map(jnp.asarray, w), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(p), jnp.asarray(valid), jnp.asarray(p))
    got = PL.attention_decode(cfg, _t(xd), *map(_t, w), _t(kc), _t(vc), _t(p).long(), _t(valid), _t(p))
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), **ONE_FOR_ONE)


@pytest.mark.parametrize("mlp", ["swiglu", "relu2", "gelu"])
def test_mlp_matches(mlp):
    rng = np.random.default_rng(2)
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(), mlp=mlp)
    rcfg = dataclasses.replace(ref_get_config("zamba2-1.2b").reduced(), mlp=mlp)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in [("w1", (cfg.d_model, 64)), ("w3", (cfg.d_model, 64)), ("w2", (64, cfg.d_model))]}
    want = RL.mlp_apply(rcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})
    got = PL.mlp_apply(cfg, _t(x), {k: _t(v) for k, v in w.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), **ONE_FOR_ONE)


def test_ssm_pieces_match():
    rng = np.random.default_rng(3)
    B, S, H, P, N, C, K = 2, 21, 3, 8, 16, 40, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    np.testing.assert_allclose(
        _np(PS.causal_conv(_t(x), _t(w), _t(b))),
        np.asarray(RS.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))), **ONE_FOR_ONE,
    )
    st = rng.standard_normal((B, K - 1, C)).astype(np.float32)
    for g, r in zip(PS.conv_decode_step(_t(x[:, 0]), _t(st), _t(w), _t(b)),
                    RS.conv_decode_step(jnp.asarray(x[:, 0]), jnp.asarray(st), jnp.asarray(w), jnp.asarray(b))):
        np.testing.assert_allclose(_np(g), np.asarray(r), **ONE_FOR_ONE)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    args = (xh, dt, A, Bm, Cm)
    for g, r in zip(PS.ssd_chunked(*map(_t, args), 8, h0=_t(h0)),
                    RS.ssd_chunked(*map(jnp.asarray, args), 8, h0=jnp.asarray(h0))):
        np.testing.assert_allclose(_np(g), np.asarray(r), **ONE_FOR_ONE)
    step = (xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0)
    for g, r in zip(PS.ssd_decode_step(*map(_t, step)), RS.ssd_decode_step(*map(jnp.asarray, step))):
        np.testing.assert_allclose(_np(g), np.asarray(r), **ONE_FOR_ONE)


@pytest.mark.parametrize("flag", [False, True])
def test_mamba2_mixer_matches(arch, flag):
    rcfg, rparams, cfg, params = arch
    rcfg = dataclasses.replace(rcfg, use_pallas_kernels=flag)
    cfg = dataclasses.replace(cfg, use_pallas_kernels=flag)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    rlp = jax.tree.map(lambda a: a[0], rparams["layers"])
    lp = {k: v[0] for k, v in params["layers"].items()}
    tol = KERNEL_BAR if flag else ONE_FOR_ONE
    want = RS.mamba2_forward(rcfg, jnp.asarray(x), rlp)
    got = PS.mamba2_forward(cfg, _t(x), lp)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), **tol)
    # with an initial state both take the chunked path
    h0 = np.asarray(want[1])
    want0 = RS.mamba2_forward(rcfg, jnp.asarray(x[:, :5]), rlp, h0=jnp.asarray(h0))
    got0 = PS.mamba2_forward(cfg, _t(x[:, :5]), lp, h0=_t(h0))
    for g, r in zip(got0, want0):
        np.testing.assert_allclose(_np(g), np.asarray(r), **ONE_FOR_ONE)
    # decode continues from the prefill state
    want_d = RS.mamba2_decode(rcfg, jnp.asarray(x[:, :1]), rlp, want[1], want[2])
    got_d = PS.mamba2_decode(cfg, _t(x[:, :1]), lp, _t(h0), _t(np.asarray(want[2])))
    for g, r in zip(got_d, want_d):
        np.testing.assert_allclose(_np(g), np.asarray(r), **ONE_FOR_ONE)
