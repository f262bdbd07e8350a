"""The port's model building blocks against the reference's, on the CPU:
norm, RoPE, full-sequence and decode attention (kernels on and off), the
blocked causal and sliding-window attentions, the MLPs, the experts and the
MoE layer (with dropped tokens and a shared expert), the SSM pieces and the
Mamba2 mixer.  Inputs come from numpy seeds;
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
    """No layer is left unported: the loss, the last one, now computes (held
    against the reference in ``test_torch_train_dense.py``).  The blocked
    attentions raise where the reference's reshapes fail, instead of
    padding."""
    loss, count = PL.cross_entropy(torch.zeros((1, 2, 4)), torch.zeros((1, 2), dtype=torch.int64), torch.ones((1, 2)))
    assert float(count) == 2.0 and abs(float(loss) - np.log(4.0)) < 1e-6
    q = torch.zeros((1, 96, 2, 16))
    with pytest.raises(ValueError, match="window"):
        PL._blocked_local_attention(q, q, q, 64, 1.0)
    with pytest.raises(ValueError, match="blocks"):
        PL._blocked_causal_attention(torch.zeros((1, 3072, 1, 16)), q, q, 1.0)


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


# ------------------------------------------------- blocked attention, MoE
def _qkv(rng, B, S, H, KV, hd):
    return [rng.standard_normal((B, S, h, hd)).astype(np.float32) for h in (H, KV, KV)]


def test_blocked_causal_attention_matches():
    """Called directly at S 4096: four query blocks of 1024 against two KV
    blocks of 2048, heads already repeated (as attention_train passes
    them)."""
    q, k, v = _qkv(np.random.default_rng(8), 1, 4096, 2, 2, 16)
    want = RL._blocked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25)
    got = PL._blocked_causal_attention(_t(q), _t(k), _t(v), 0.25)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ONE_FOR_ONE)


@pytest.mark.parametrize("kv_heads", [4, 1])
def test_blocked_local_attention_matches(kv_heads):
    """S = 4·W, called directly and through attention_train's sliding-window
    branch with fewer KV heads than query heads (repeated before the
    blocked branch, as the reference does)."""
    rng = np.random.default_rng(9)
    W, S = 16, 64
    q, k, v = _qkv(rng, 2, S, 4, 4, 8)
    want = RL._blocked_local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), W, 0.3)
    got = PL._blocked_local_attention(_t(q), _t(k), _t(v), W, 0.3)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ONE_FOR_ONE)

    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(), sliding_window=W, num_kv_heads=kv_heads)
    rcfg = dataclasses.replace(ref_get_config("mixtral-8x22b").reduced(), sliding_window=W, num_kv_heads=kv_heads)
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * D**-0.5
         for s in [(D, H, hd), (D, kv_heads, hd), (D, kv_heads, hd), (H, hd, D)]]
    pos = np.arange(S, dtype=np.int32)
    want = RL.attention_train(rcfg, jnp.asarray(x), *map(jnp.asarray, w), jnp.asarray(pos), return_kv=True)
    got = PL.attention_train(cfg, _t(x), *map(_t, w), _t(pos), return_kv=True)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), **ONE_FOR_ONE)


def _expert_weights(rng, cfg, scale=0.1):
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    names = ["w1", "w3", "w2"] if cfg.mlp == "swiglu" else ["w1", "w2"]
    shapes = {"w1": (E, D, F_), "w3": (E, D, F_), "w2": (E, F_, D)}
    return {n: rng.standard_normal(shapes[n]).astype(np.float32) * scale for n in names}


@pytest.mark.parametrize("mlp", ["swiglu", "relu2", "gelu"])
def test_expert_ffn_matches(mlp):
    rng = np.random.default_rng(10)
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(), mlp=mlp)
    rcfg = dataclasses.replace(ref_get_config("mixtral-8x22b").reduced(), mlp=mlp)
    w = _expert_weights(rng, cfg)
    xs = rng.standard_normal((cfg.num_experts, 6, cfg.d_model)).astype(np.float32)
    want = RL._expert_ffn(rcfg, jnp.asarray(xs), {k: jnp.asarray(v) for k, v in w.items()})
    got = PL._expert_ffn(cfg, _t(xs), {k: _t(v) for k, v in w.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), **ONE_FOR_ONE)


def _dropped_slots(x, router, cfg) -> int:
    """(token, k) routing slots past their expert's capacity, counted in
    numpy from the router logits: the drops the layer must apply."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    g = min(512, S)
    while S % g:
        g -= 1
    C = max(int(np.ceil(g * K / E * cfg.capacity_factor)), 1)
    ids = np.argsort(-(x.reshape(-1, g, D) @ router), axis=-1, kind="stable")[..., :K]
    counts = np.stack([np.bincount(grp.ravel(), minlength=E) for grp in ids])
    return int(np.clip(counts - C, 0, None).sum())


@pytest.mark.parametrize("arch_id", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_apply_matches_with_dropped_tokens(arch_id):
    """At the production capacity factor 1.25 (reduced() sets a no-drop
    one), with the router tilted towards expert 0 so that its queue
    overflows: the overflow is dropped as the reference drops it.  llama4
    adds its shared expert."""
    rng = np.random.default_rng(11)
    cfg = dataclasses.replace(get_config(arch_id).reduced(), capacity_factor=1.25)
    rcfg = dataclasses.replace(ref_get_config(arch_id).reduced(), capacity_factor=1.25)
    D = cfg.d_model
    x = rng.standard_normal((2, 64, D)).astype(np.float32)
    w = _expert_weights(rng, cfg)
    w["router"] = rng.standard_normal((D, cfg.num_experts)).astype(np.float32) * D**-0.5
    w["router"][:, 0] += x.mean(axis=(0, 1)) * 4.0  # expert 0 wins most tokens
    if cfg.moe_shared_expert:
        F_ = cfg.d_ff
        w["shared"] = {n: rng.standard_normal(s).astype(np.float32) * 0.1
                       for n, s in [("w1", (D, F_)), ("w3", (D, F_)), ("w2", (F_, D))]}
    assert _dropped_slots(x, w["router"], cfg) > 0
    want = RL.moe_apply(rcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, w))
    got = PL.moe_apply(cfg, _t(x), jax.tree.map(_t, w))
    np.testing.assert_allclose(_np(got), np.asarray(want), **ONE_FOR_ONE)
