"""The port's SSD scan on the CPU (its plain version) against the
reference's Pallas kernel in interpret mode and both reference oracles
(chunked and sequential), over the matrix of ``tests/test_kernels.py``:
several chunk and head-block shapes, a ragged S, a single chunk, f32 and
bf16, at the reference's tolerances.  The port's two plain versions are
held against each other and against the reference's one for one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.mamba2_ssd import ssd as jax_ssd
from repro.kernels.mamba2_ssd import ssd_ref_chunked as jax_ref_chunked
from repro.kernels.mamba2_ssd import ssd_ref_sequential as jax_ref_sequential
from repro_torch.kernels.mamba2_ssd import ssd, ssd_ref_chunked, ssd_ref_sequential
from repro_torch.kernels.mamba2_ssd.kernel import WIDTHS, check_inputs, grid_blocks, route, scratch_shapes
from repro_torch.kernels.mamba2_ssd.ref import ssd_ref_three_pass

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, S, H, P, N, dtype: str, seed: int):
    """(jax inputs, torch inputs) from one numpy draw: x, B, C in the
    working dtype, dt (softplus-ed) and A (negative) in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    j = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt))
    t = (
        torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
        torch.from_numpy(Bm).to(tdt), torch.from_numpy(Cm).to(tdt),
    )
    return j, t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk,hb",
    [
        (2, 128, 4, 16, 32, 32, 2),
        (1, 256, 8, 32, 64, 64, 8),
        (1, 96, 6, 16, 16, 32, 3),   # S pad, H odd block
        (2, 64, 2, 8, 16, 64, 2),    # single chunk
    ],
)
def test_ssd_matches_reference_kernel_and_chunked_oracle(B, S, H, P, N, chunk, hb, dtype):
    j, t = _inputs(B, S, H, P, N, dtype, seed=3)
    y, h = ssd(*t, chunk=chunk, head_block=hb)
    assert y.dtype == t[0].dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(h.shape) == (B, H, P, N)
    # tests/test_kernels.py:97-99
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)
    for y_ref, h_ref in (
        jax_ssd(*j, chunk=chunk, head_block=hb, interpret=True),
        jax_ref_chunked(*j, chunk=chunk),
    ):
        np.testing.assert_allclose(_f32(y), _f32(y_ref), **tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-3, atol=1e-3)


def test_ssd_matches_sequential_recurrence():
    """Second, independent oracle: the O(S) per-token definition, in both
    packages."""
    j, t = _inputs(1, 64, 2, 8, 16, "float32", seed=4)
    y, h = ssd(*t, chunk=16, head_block=2)
    for y_seq, h_seq in (ssd_ref_sequential(*t), jax_ref_sequential(*j)):
        np.testing.assert_allclose(_f32(y), _f32(y_seq), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(h.numpy(), _f32(h_seq), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("S,chunk", [(96, 32), (100, 32), (40, 64)])
def test_chunked_plain_version_matches_sequential(S, chunk):
    """Guards against a shared bug in the chunked math itself; a ragged S
    leaves the final state of the unpadded sequence."""
    _, t = _inputs(2, S, 3, 8, 16, "float32", seed=5)
    y_c, h_c = ssd_ref_chunked(*t, chunk=chunk)
    y_s, h_s = ssd_ref_sequential(*t)
    np.testing.assert_allclose(y_c.numpy(), y_s.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_c.numpy(), h_s.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_versions_match_reference_plain_versions(dtype):
    """One for one: the port's chunked and sequential plain versions against
    the reference's (same op order, so tighter than the kernel bars)."""
    j, t = _inputs(2, 80, 3, 8, 16, dtype, seed=6)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    for (y, h), (y_ref, h_ref) in (
        (ssd_ref_chunked(*t, chunk=32), jax_ref_chunked(*j, chunk=32)),
        (ssd_ref_sequential(*t), jax_ref_sequential(*j)),
    ):
        np.testing.assert_allclose(_f32(y), _f32(y_ref), **tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)


def test_bad_arguments_raise():
    _, t = _inputs(1, 16, 2, 4, 8, "float32", seed=7)
    with pytest.raises(ValueError):
        ssd(*t, chunk=0)
    with pytest.raises(ValueError):
        ssd(*t, head_block=0)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel launcher, which refuses what is not CUDA."""
    x = torch.empty((1, 32, 2, 4), device="meta")
    dt = torch.empty((1, 32, 2), device="meta")
    A = torch.empty((2,), device="meta")
    Bm = torch.empty((1, 32, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ssd(x, dt, A, Bm, Bm, chunk=16)


# -------------------------------------------- the kernel's three passes on the CPU
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [
        (2, 128, 4, 16, 32, 32),
        (1, 256, 8, 32, 64, 64),
        (1, 96, 6, 16, 16, 32),   # several chunks, H odd
        (2, 64, 2, 8, 16, 64),    # single chunk
        (1, 100, 3, 8, 16, 32),   # ragged last chunk (100 = 3 x 32 + 4)
    ],
)
def test_three_pass_emulation_matches_reference_oracle(B, S, H, P, N, chunk, dtype):
    """Chunk states -> state passing -> chunk outputs with the bf16 route's
    operand roundings, against the reference's chunked oracle at its bars
    (tests/test_kernels.py:97-99: y 5e-2 bf16 / 2e-4 f32, h 1e-3)."""
    j, t = _inputs(B, S, H, P, N, dtype, seed=3)
    y, h = ssd_ref_three_pass(*t, chunk=chunk)
    assert y.dtype == t[0].dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(h.shape) == (B, H, P, N)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)
    y_ref, h_ref = jax_ref_chunked(*j, chunk=chunk)
    np.testing.assert_allclose(_f32(y), _f32(y_ref), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("S,chunk", [(64, 16), (100, 32)])
def test_three_pass_emulation_matches_sequential_oracle(S, chunk):
    """The reference's sequential recurrence at its bars
    (tests/test_kernels.py:103-115)."""
    j, t = _inputs(1, S, 2, 8, 16, "float32", seed=4)
    y, h = ssd_ref_three_pass(*t, chunk=chunk)
    y_seq, h_seq = jax_ref_sequential(*j)
    np.testing.assert_allclose(_f32(y), _f32(y_seq), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), _f32(h_seq), rtol=1e-3, atol=1e-3)


def test_route_follows_the_dtype():
    assert route(torch.bfloat16) == "tensor_core"
    assert route(torch.float32) == "cuda_core"
    with pytest.raises(TypeError):
        route(torch.float16)


def test_scratch_and_blocks_at_zamba2s_prefill():
    """zamba2-1.2b, S 1536, chunk 256: 6 chunks.  Pass 1 runs 6 x 64 blocks
    (one per chunk and head, against 64 for the whole scan before); pass 3
    in bf16 one per 64-step query tile, chunk and head pair.  The f32
    scratch: 6.3 MB of chunk states."""
    shapes = scratch_shapes(1, 1536, 64, 64, 64, 256)
    assert shapes == {"cs": (1, 64, 1536), "states": (1, 6, 64, 64, 64), "decay": (1, 6, 64)}
    assert 4 * np.prod(shapes["states"]) == 6_291_456
    assert grid_blocks(1, 1536, 64, 64, 64, 256, torch.bfloat16) == (384, 1024, 768)
    assert grid_blocks(1, 1536, 64, 64, 64, 256, torch.float32) == (384, 1024, 384)
    # a ragged S: ceil(1000 / 256) = 4 chunks
    assert scratch_shapes(2, 1000, 48, 64, 128, 256)["states"] == (2, 4, 48, 64, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launcher_checks_accept_every_built_width(dtype):
    for P, N in WIDTHS:
        _, (x, dt, A, Bm, Cm) = _inputs(1, 40, 3, P, N, "float32", seed=8)
        x, Bm, Cm = (a.to(dtype) for a in (x, Bm, Cm))
        assert check_inputs(x, dt, A, Bm, Cm, chunk=16) == (1, 40, 3, P, N)


def test_launcher_checks_refuse_what_the_kernel_does_not_take():
    _, (x, dt, A, Bm, Cm) = _inputs(1, 40, 3, 64, 32, "bfloat16", seed=9)
    with pytest.raises(ValueError, match="built for"):  # (64, 32) is not built
        check_inputs(x, dt, A, Bm, Cm, chunk=16)
    _, (x, dt, A, Bm, Cm) = _inputs(1, 40, 3, 64, 64, "bfloat16", seed=9)
    with pytest.raises(ValueError, match="chunk"):
        check_inputs(x, dt, A, Bm, Cm, chunk=41)
    with pytest.raises(TypeError):
        check_inputs(x, dt.bfloat16(), A, Bm, Cm, chunk=16)
    with pytest.raises(TypeError):
        check_inputs(x, dt, A, Bm.float(), Cm, chunk=16)
    flat = torch.zeros(40 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):  # B 2 bytes off
        check_inputs(x, dt, A, flat[1:].view(1, 40, 64), Cm, chunk=16)
