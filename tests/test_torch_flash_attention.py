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
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, check_inputs, query_block, route, tile_rows
from repro_torch.kernels.flash_attention.ref import attention_bf16_tiled_ref

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
    """A query tile holds G heads at query_block(G, rows) positions, row
    pos·G + g.  64 rows (one warpgroup of the bf16 wgmma kernel, 256
    threads x 4 rows of the f32 one): the registry's groups 1, 4, 5
    (llama4-scout), 6 (mixtral), 8 (internvl2) and 12 (nemotron) use 64,
    64, 60, 60, 64 and 60 rows.  128 rows (two consumer warpgroups): bf16
    with 4 or more heads a KV head."""
    assert [query_block(g) for g in (1, 2, 4, 32, 64, 128)] == [64, 32, 16, 2, 1, 1]
    assert [query_block(g) for g in (5, 6, 8, 12)] == [12, 10, 8, 5]
    assert [g * query_block(g) for g in (1, 4, 5, 6, 8, 12)] == [64, 64, 60, 60, 64, 60]
    assert [g * query_block(g, 128) for g in (4, 5, 6, 8, 12)] == [128, 125, 126, 128, 120]
    assert [tile_rows(torch.bfloat16, g) for g in (1, 2, 4, 5, 12)] == [64, 64, 128, 128, 128]
    assert {tile_rows(torch.float32, g) for g in (1, 4, 12)} == {64}


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


# ------------------------------------------------ the tensor-core route on the CPU
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
def test_bf16_tiled_emulation_matches_reference_oracle(B, S, H, KV, hd, window):
    """The bf16 kernel's numerics (64-key online softmax, P rounded to bf16
    before P·V) against the reference's plain version on the reference's
    shapes, at its bf16 bar (tests/test_kernels.py:25-26)."""
    (jq, jk, jv), (q, k, v) = _inputs((B, S, H, hd), (B, S, KV, hd), "bfloat16", seed=0)
    got = attention_bf16_tiled_ref(q, k, v, window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, H, hd)
    np.testing.assert_allclose(_f32(got), _f32(jax_attention_ref(jq, jk, jv, window=window)), **_tol("bfloat16"))


@pytest.mark.parametrize("hd,H,KV", [(96, 4, 4), (192, 12, 1)])
def test_bf16_tiled_emulation_at_the_new_head_widths(hd, H, KV):
    """phi3-mini's head width (96) and nemotron's (192, 12 query heads a KV
    head), with a ragged S, against the reference's plain version."""
    (jq, jk, jv), (q, k, v) = _inputs((1, 130, H, hd), (1, 130, KV, hd), "bfloat16", seed=5)
    np.testing.assert_allclose(
        _f32(attention_bf16_tiled_ref(q, k, v)), _f32(jax_attention_ref(jq, jk, jv)), **_tol("bfloat16")
    )


def test_route_follows_the_dtype():
    assert route(torch.bfloat16) == "tensor_core"
    assert route(torch.float32) == "cuda_core"
    with pytest.raises(TypeError):
        route(torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launcher_checks_accept_every_built_width(dtype):
    for hd in HEAD_DIMS:
        q = torch.zeros((1, 8, 12, hd), dtype=dtype)
        kv = torch.zeros((1, 8, 1, hd), dtype=dtype)
        assert check_inputs(q, kv, kv, window=4) == (1, 8, 12, 1, hd)


def test_launcher_checks_refuse_what_the_kernel_does_not_take():
    kv = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    for hd in (8, 80, 256):  # widths not built
        w = torch.zeros((1, 8, 1, hd), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="hd"):
            check_inputs(torch.zeros((1, 8, 2, hd), dtype=torch.bfloat16), w, w)
    with pytest.raises(ValueError):  # 65 query heads on one KV head exceed a 64-row tile
        check_inputs(torch.zeros((1, 8, 65, 64), dtype=torch.bfloat16), kv, kv)
    with pytest.raises(TypeError):
        check_inputs(torch.zeros((1, 8, 2, 64)), kv, kv)  # mixed dtypes
    with pytest.raises(TypeError):
        half = torch.zeros((1, 8, 1, 64), dtype=torch.float16)
        check_inputs(half.expand(1, 8, 1, 64).clone(), half, half)
    with pytest.raises(ValueError, match="contiguous"):
        q = torch.zeros((1, 8, 64, 2), dtype=torch.bfloat16).transpose(2, 3)
        check_inputs(q, kv, kv)
    with pytest.raises(ValueError, match="16-byte"):  # a bf16 view 2 bytes off
        flat = torch.zeros(8 * 2 * 64 + 1, dtype=torch.bfloat16)
        check_inputs(flat[1:].view(1, 8, 2, 64), kv, kv)
