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
