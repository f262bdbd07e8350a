"""The port's ``fragment_gather`` (plain path, CPU) against the reference's
Pallas kernel in interpret mode: bitwise for every ``fiub`` width, the same
block-run detection and ``GATHER_STATS`` counting, the same edge contract.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.fragment_gather import ops as ref_ops
from repro.kernels.fragment_gather import fragment_gather as ref_gather
from repro_torch.kernels.fragment_gather import fragment_gather, gather_ref
from repro_torch.kernels.fragment_gather import ops as port_ops

DTYPES = ["int8", "int16", "int32", "uint8", "uint16", "uint32", "float16", "float32", "bool"]

# (source rows, columns, index vector, row_block): aligned runs at several
# RB, a non-aligned run set (RB=1 fallback), C = 1 (the main path) and C > 1
LAYOUTS = {
    "aligned-rb8-c1": (64, 1, np.r_[16:40, 0:24], 8),
    "aligned-rb32-c1": (128, 1, np.r_[64:128, 0:32], 32),
    "aligned-rb8-c5": (48, 5, np.r_[40:48, 8:24], 8),
    "nonaligned-c1": (50, 1, np.r_[3:17, 30:49], 8),
    "arbitrary-c3": (33, 3, np.random.default_rng(0).integers(0, 33, 29), 8),
}


def _source(dtype: str, rows: int, cols: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.integers(0, 2, (rows, cols)).astype(bool)
    if dt.kind == "f":
        return rng.standard_normal((rows, cols)).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, (rows, cols), endpoint=True, dtype=dt)


def _stats_delta(stats, fn):
    before = stats.snapshot()
    out = fn()
    after = stats.snapshot()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_bitwise_equals_reference(dtype, layout):
    rows, cols, idx, rb = LAYOUTS[layout]
    src = _source(dtype, rows, cols)
    want, ref_delta = _stats_delta(
        ref_ops.GATHER_STATS,
        lambda: np.asarray(ref_gather(jnp.asarray(src), idx, row_block=rb, interpret=True)),
    )
    got, port_delta = _stats_delta(
        port_ops.GATHER_STATS,
        lambda: fragment_gather(torch.from_numpy(src.copy()), idx, row_block=rb),
    )
    assert got.dtype == torch.from_numpy(src).dtype
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))
    assert port_delta == ref_delta


def test_empty_index_returns_empty_rows():
    src = _source("float32", 16, 3)
    got = fragment_gather(torch.from_numpy(src), np.zeros(0, np.int32))
    want = ref_gather(jnp.asarray(src), np.zeros(0, np.int32), interpret=True)
    assert tuple(got.shape) == want.shape == (0, 3)


def test_tail_not_padded_into_output():
    """R not a multiple of row_block: no padded tail row may leak into the
    output (mirrors the reference's _pad_axis regression test)."""
    src = np.random.default_rng(0).standard_normal((64, 4)).astype(np.float32)
    idx = np.arange(13, dtype=np.int32)  # 13 % 8 != 0
    out = fragment_gather(torch.from_numpy(src), idx, row_block=8)
    assert tuple(out.shape) == (13, 4)
    ref = ref_gather(jnp.asarray(src), idx, row_block=8, interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        out.numpy(), gather_ref(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    )


@pytest.mark.parametrize("bad", [[0, 10], [-1, 2]])
def test_out_of_range_raises_like_reference(bad):
    src = np.zeros((10, 4), np.float32)
    idx = np.array(bad, np.int32)
    with pytest.raises(IndexError):
        ref_gather(jnp.asarray(src), idx, row_block=8, interpret=True)
    with pytest.raises(IndexError):
        fragment_gather(torch.from_numpy(src), idx, row_block=8)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel launcher, which refuses what is not CUDA."""
    src = torch.empty((64, 1), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fragment_gather(src, np.arange(64, dtype=np.int32), row_block=8)
