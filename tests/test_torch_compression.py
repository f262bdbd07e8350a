"""The port's int8 error-feedback gradient compression against the
reference's (``repro.dist.compression``) on the same seeded tensors, and
the reference's own EF-int8 tests (``tests/test_dist_extras.py``) replayed
on the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.dist import compression as RC
from repro_torch.dist.compression import (
    compress_decompress,
    compressed_bytes,
    dequantize_int8,
    init_error_state,
    quantize_int8,
)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_quantize_matches_the_reference(scale):
    """The same int8 codes and scale as the reference, bit for bit, the
    all-zero tensor included."""
    x = (np.random.default_rng(0).standard_normal((37, 5)) * scale).astype(np.float32)
    q_r, s_r = RC.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    assert s.numpy().tobytes() == np.asarray(s_r).tobytes()
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(), np.asarray(RC.dequantize_int8(q_r, s_r)))


def test_compress_decompress_matches_the_reference_over_rounds():
    rng = np.random.default_rng(2)
    shapes = {"a": (8, 3), "b": {"c": (5,)}}
    err_r = RC.init_error_state({"a": jnp.zeros((8, 3)), "b": {"c": jnp.zeros(5)}})
    err = init_error_state({"a": torch.zeros(8, 3), "b": {"c": torch.zeros(5)}})
    for _ in range(6):
        g = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
             "b": {"c": rng.standard_normal(shapes["b"]["c"]).astype(np.float32)}}
        sent_r, err_r = RC.compress_decompress({"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b"]["c"])}}, err_r)
        sent, err = compress_decompress({"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(g["b"]["c"])}}, err)
        for got, want in ((sent["a"], sent_r["a"]), (sent["b"]["c"], sent_r["b"]["c"]),
                          (err["a"], err_r["a"]), (err["b"]["c"], err_r["b"]["c"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    q, s = quantize_int8(x)
    assert (dequantize_int8(q, s) - x).abs().max().item() <= float(s) * 0.5 + 1e-6


def test_error_feedback_unbiased_over_time():
    """The sum of EF-compressed gradients trails the true sum by one
    quantization step, not by the step count."""
    rng = np.random.default_rng(1)
    err = init_error_state({"w": torch.zeros(64)})
    total_true, total_sent = np.zeros(64), np.zeros(64)
    for i in range(50):
        g = {"w": torch.from_numpy((rng.standard_normal(64) * (1 + i % 5)).astype(np.float32))}
        sent, err = compress_decompress(g, err)
        total_true += g["w"].numpy()
        total_sent += sent["w"].numpy()
    assert np.abs(total_true - total_sent).max() < 0.5


def test_ef_sgd_converges_like_uncompressed():
    A = torch.diag(torch.linspace(1.0, 5.0, 16))
    b = torch.arange(16.0) / 10
    w_star = torch.linalg.solve(A, b)
    w_plain, w_comp = torch.zeros(16), torch.zeros(16)
    err = init_error_state({"w": w_comp})
    for _ in range(400):
        w_plain = w_plain - 0.05 * (A @ w_plain - b)
        g, err = compress_decompress({"w": A @ w_comp - b}, err)
        w_comp = w_comp - 0.05 * g["w"]
    assert torch.linalg.norm(w_plain - w_star) < 1e-3
    assert torch.linalg.norm(w_comp - w_star) < 1e-2


def test_compressed_bytes_ratio():
    r = compressed_bytes({"a": torch.zeros((128, 128)), "b": torch.zeros((64,))})
    assert r == RC.compressed_bytes({"a": jnp.zeros((128, 128)), "b": jnp.zeros((64,))})
    assert r["fp32_bytes"] == 4 * (128 * 128 + 64)
    assert 0.24 < r["ratio"] < 0.27
