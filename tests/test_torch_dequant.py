"""The port's dequantize on the CPU (its plain version) against the
reference's Pallas kernel in interpret mode and the reference's plain
version, at ``tests/test_kernels.py``'s shapes, in bf16 and f32.

Parity is bitwise, not the reference's 1e-2: each value is one IEEE f32
multiply of an int8 widened to f32 by an f32 scale, rounded once to the
output dtype, and XLA and torch both round f32 to bf16 to nearest even.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.dequant import dequant as jax_dequant
from repro.kernels.dequant import dequant_ref as jax_dequant_ref
from repro_torch.kernels.dequant import dequant, dequant_ref
from repro_torch.kernels.dequant import ops as dequant_ops

OUT_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _inputs(R: int, C: int, seed: int = 1):
    """tests/test_kernels.py:169-170's draws."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(R, C)).astype(np.int8)
    scale = rng.uniform(0.001, 2.0, size=(C,)).astype(np.float32)
    return x, scale


def _bits(a) -> np.ndarray:
    """The raw bits of a torch tensor or a jax/numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("out_dtype", sorted(OUT_DTYPES))
@pytest.mark.parametrize("R,C", [(16, 32), (100, 70), (256, 512), (1, 5)])
def test_dequant_bitwise_equals_reference(R, C, out_dtype):
    x, scale = _inputs(R, C)
    jdt, tdt = OUT_DTYPES[out_dtype]
    got = dequant(torch.from_numpy(x), torch.from_numpy(scale), out_dtype=tdt, row_block=64, col_block=128)
    assert got.dtype == tdt and tuple(got.shape) == (R, C)
    kernel = jax_dequant(jnp.asarray(x), jnp.asarray(scale), out_dtype=jdt, row_block=64, col_block=128, interpret=True)
    plain = jax_dequant_ref(jnp.asarray(x), jnp.asarray(scale), out_dtype=jdt)
    np.testing.assert_array_equal(_bits(got), _bits(kernel))
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(
        _bits(dequant_ref(torch.from_numpy(x), torch.from_numpy(scale), out_dtype=tdt)), _bits(plain)
    )


def test_dequant_roundtrip_quantize():
    """tests/test_kernels.py:178-186: int8 quantize, then dequantize,
    recovers the original within the per-column quantisation step."""
    rng = np.random.default_rng(2)
    W = rng.standard_normal((64, 48)).astype(np.float32)
    scale = np.abs(W).max(axis=0) / 127.0
    q = np.clip(np.round(W / scale[None, :]), -127, 127).astype(np.int8)
    got = dequant(torch.from_numpy(q), torch.from_numpy(scale), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), W, atol=np.abs(W).max() / 100.0)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_dequant(jnp.asarray(q), jnp.asarray(scale), out_dtype=jnp.float32, interpret=True))
    )


def test_dequant_of_a_view_with_an_offset():
    """A contiguous view whose data does not start at its storage's start
    (the kernel's unaligned path on the card) gives the same bits."""
    x, scale = _inputs(33, 7)
    flat = torch.from_numpy(np.concatenate([np.zeros(3, np.int8), x.ravel()]))
    view = flat[3:].view(33, 7)
    assert view.storage_offset() == 3 and view.is_contiguous()
    got = dequant(view, torch.from_numpy(scale))
    want = jax_dequant_ref(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize(
    "what,x,scale,kw,exc",
    [
        ("x not int8", torch.zeros((4, 3), dtype=torch.int16), torch.ones(3), {}, TypeError),
        ("scale not f32", torch.zeros((4, 3), dtype=torch.int8), torch.ones(3, dtype=torch.float64), {}, TypeError),
        ("out dtype", torch.zeros((4, 3), dtype=torch.int8), torch.ones(3), {"out_dtype": torch.float16}, TypeError),
        ("x 1-D", torch.zeros(12, dtype=torch.int8), torch.ones(12), {}, ValueError),
        ("scale length", torch.zeros((4, 3), dtype=torch.int8), torch.ones(4), {}, ValueError),
        ("row block", torch.zeros((4, 3), dtype=torch.int8), torch.ones(3), {"row_block": 0}, ValueError),
        ("col block", torch.zeros((4, 3), dtype=torch.int8), torch.ones(3), {"col_block": -1}, ValueError),
    ],
)
def test_dequant_refuses(what, x, scale, kw, exc):
    with pytest.raises(exc):
        dequant(x, scale, **kw)


def test_only_cpu_tensors_take_the_plain_version(monkeypatch):
    """A tensor off the CPU goes to the kernel's launcher, which refuses
    anything but CUDA; it never reaches the plain version."""

    def plain_taken(*a, **k):
        raise AssertionError("the plain version was taken")

    monkeypatch.setattr(dequant_ops, "dequant_ref", plain_taken)
    x = torch.zeros((4, 3), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dequant(x, torch.ones(3, device="meta"))
    with pytest.raises(AssertionError, match="plain version"):
        dequant(torch.zeros((4, 3), dtype=torch.int8), torch.ones(3))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,C", [(2048, 1024), (100, 70), (1, 5), (257, 1029), (4096, 8)])
def test_kernel_bitwise_equals_plain_on_the_card(card, R, C, out_dtype):
    x, scale = _inputs(R, C)
    xc, sc = torch.from_numpy(x).cuda(), torch.from_numpy(scale).cuda()
    got = dequant(xc, sc, out_dtype=out_dtype)
    want = dequant_ref(xc, sc, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    flat = torch.zeros(R * C + 1, dtype=torch.int8, device="cuda")
    view = flat[1:].view(R, C)
    view.copy_(xc)
    assert torch.equal(dequant(view, sc, out_dtype=out_dtype), want)
