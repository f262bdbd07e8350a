"""The port's flash attention on the CPU (its plain version) against the
reference's Pallas kernel in interpret mode and the reference's plain
version, over the matrix of ``tests/test_kernels.py``: MHA, GQA, MQA with a
ragged S, a sliding window, tiny shapes, a block sweep and non-causal, in
f32 and bf16, at the reference's tolerances.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention.kernel import query_block

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> dict:
    # tests/test_kernels.py:25-26
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(shape_q, shape_kv, dtype: str, seed: int):
    """The same numbers for both packages: f32 draws rounded once to the
    working dtype (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv)]
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize(
    "B,S,H,KV,hd,window",
    [
        (2, 128, 4, 4, 32, 0),     # MHA
        (1, 256, 8, 2, 64, 0),     # GQA 4:1
        (2, 192, 4, 1, 32, 0),     # MQA, S not a block multiple
        (1, 256, 4, 2, 32, 64),    # sliding window
        (1, 64, 2, 2, 16, 0),      # tiny
    ],
)
def test_flash_attention_matches_reference(B, S, H, KV, hd, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs((B, S, H, hd), (B, S, KV, hd), dtype, seed=0)
    got = flash_attention(q, k, v, window=window, q_block=64, k_block=64)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, S, H, hd)
    kernel = jax_flash_attention(jq, jk, jv, window=window, q_block=64, k_block=64, interpret=True)
    plain = jax_attention_ref(jq, jk, jv, window=window)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(plain), **_tol(dtype))


def test_flash_attention_block_sweep():
    """The reference kernel at every block shape of its sweep against the
    port, whose kernel tiling does not depend on the blocks asked for."""
    B, S, H, KV, hd = 1, 256, 4, 2, 32
    (jq, jk, jv), (q, k, v) = _inputs((B, S, H, hd), (B, S, KV, hd), "float32", seed=1)
    for qb, kb in [(32, 32), (64, 128), (128, 64), (256, 256)]:
        got = flash_attention(q, k, v, q_block=qb, k_block=kb)
        want = jax_flash_attention(jq, jk, jv, q_block=qb, k_block=kb, interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_noncausal():
    B, S, H, KV, hd = 1, 128, 2, 2, 32
    (jq, jk, jv), (q, k, v) = _inputs((B, S, H, hd), (B, S, KV, hd), "float32", seed=2)
    got = flash_attention(q, k, v, causal=False, q_block=64, k_block=64)
    want = jax_flash_attention(jq, jk, jv, causal=False, q_block=64, k_block=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _f32(got), _f32(jax_attention_ref(jq, jk, jv, causal=False)), rtol=2e-5, atol=2e-5
    )


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0), (False, 50)])
def test_plain_version_matches_reference_plain_version(causal, window):
    """The two packages' plain versions, one for one (f32)."""
    (jq, jk, jv), (q, k, v) = _inputs((2, 150, 6, 16), (2, 150, 3, 16), "float32", seed=3)
    got = attention_ref(q, k, v, scale=0.3, causal=causal, window=window)
    want = jax_attention_ref(jq, jk, jv, scale=0.3, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def test_explicit_scale_and_default_scale():
    (jq, jk, jv), (q, k, v) = _inputs((1, 64, 2, 16), (1, 64, 2, 16), "float32", seed=4)
    np.testing.assert_allclose(
        _f32(flash_attention(q, k, v)), _f32(flash_attention(q, k, v, scale=16**-0.5)), rtol=0, atol=0
    )
    want = jax_flash_attention(jq, jk, jv, scale=0.05, q_block=64, k_block=64, interpret=True)
    np.testing.assert_allclose(_f32(flash_attention(q, k, v, scale=0.05)), _f32(want), rtol=2e-5, atol=2e-5)


def test_query_block_folds_the_head_group_into_64_rows():
    assert [query_block(g) for g in (1, 2, 4, 32, 64, 128)] == [64, 32, 16, 2, 1, 1]


def test_bad_arguments_raise_like_the_reference():
    q = torch.zeros((1, 8, 3, 4))
    kv = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv)  # 3 heads do not divide into 2
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :2], kv, kv, q_block=0)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel launcher, which refuses what is not CUDA."""
    q = torch.empty((1, 64, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
