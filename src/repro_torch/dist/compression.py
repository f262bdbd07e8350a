"""Int8 error-feedback gradient compression (the DP all-reduce wire format).

Per-tensor symmetric quantization: ``q = round(x / s)`` with ``s =
max|x| / 127``, so the round-trip error is at most half a quantization step
elementwise.  On its own that bias would accumulate over training; *error
feedback* (Seide et al. 2014, Karimireddy et al. 2019) adds the previous
step's residual to the gradient before quantizing and carries the new
residual forward, making the compressed-gradient *sum* track the true sum to
within one step — which is what SGD integrates, so convergence matches
uncompressed training on well-conditioned objectives.

The port of ``repro.dist.compression`` on torch tensors;
``compress_decompress`` is the piece the launcher wraps around the gradient
computation when ``--compress-grads`` is set.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.train.state import tree_leaves, tree_map

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "init_error_state",
    "compress_decompress",
    "compressed_bytes",
]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q int8, scale f32)
    with ``|x - q·s| ≤ s/2`` elementwise (s covers max|x|, so no clipping
    error — only rounding)."""
    x32 = torch.as_tensor(x).to(torch.float32)
    amax = torch.max(torch.abs(x32))
    # tiny floor keeps the all-zero tensor well-defined (q = 0, s ~ 0)
    scale = torch.clamp(amax / 127.0, min=torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(x32 / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params: Any) -> Any:
    """Zeroed f32 residual buffer matching the gradient tree."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_decompress(grads: Any, err: Any) -> Tuple[Any, Any]:
    """One EF-compression round: ``(grads, err) -> (sent, new_err)``.

    ``sent`` is what the wire would carry after dequantization on the
    receiver; ``new_err = (grads + err) - sent`` is the residual the NEXT
    round folds back in.  The running sum of ``sent`` therefore trails the
    running sum of ``grads`` by exactly the current residual — bounded by
    one quantization step, never by the step count.
    """

    sent_leaves = []

    def one(g, e):
        corrected = g.to(torch.float32) + e
        sent = dequantize_int8(*quantize_int8(corrected))
        sent_leaves.append(sent)
        return corrected - sent

    new_err = tree_map(one, grads, err)
    sent = iter(sent_leaves)  # tree_map visits the leaves in one fixed order
    return tree_map(lambda _: next(sent), grads), new_err


def compressed_bytes(params: Any) -> Dict[str, float]:
    """Wire-format accounting: fp32 baseline vs int8 payload + one f32
    scale per tensor.  ``ratio`` lands near 0.25 (plus scale overhead)."""
    leaves = tree_leaves(params)
    elems = sum(int(l.numel()) for l in leaves)
    fp32 = 4 * elems
    int8 = elems + 4 * len(leaves)
    return {
        "fp32_bytes": fp32,
        "int8_bytes": int8,
        "ratio": int8 / max(fp32, 1),
        "tensors": len(leaves),
    }
