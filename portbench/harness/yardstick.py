"""The benchmark's frozen arithmetic: the object store's cost model, the
card's published peaks, a dense transformer's FLOPs per token and a UNION's
bytes.  Each is copied here, not imported from the program, so that a
change to the program cannot move the yardstick it is measured by.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Sequence, Tuple

# ``repro_torch.lake.s3sim.LatencyModel``'s defaults: ~30 ms first-byte
# latency a GET and ~5 GB/s aggregate throughput, calibrated there to the
# paper's c5.9xlarge S3 numbers (Table I).
FIRST_BYTE_S = 0.030
STORE_BYTES_PER_S = 5.0e9

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def store_seconds(get_requests: int, bytes_read: int) -> float:
    """Simulated object-store seconds of ``get_requests`` range GETs that
    read ``bytes_read`` bytes: the paper's Table I latency."""
    return get_requests * FIRST_BYTE_S + bytes_read / STORE_BYTES_PER_S


def dense_params(model: Mapping[str, Any]) -> int:
    """Parameters of a decoder-only transformer with SwiGLU and grouped
    query heads, from the HF-style keys of its configuration file (tied
    embeddings counted once)."""
    D, F, V, L = (model[k] for k in ("hidden_size", "intermediate_size", "vocab_size",
                                      "num_hidden_layers"))
    H, KV = model["num_attention_heads"], model["num_key_value_heads"]
    hd = D // H
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    mlp = 3 * D * F
    per_layer = attn + mlp + 2 * D
    head = 0 if model.get("tie_word_embeddings", False) else D * V
    return V * D + head + L * per_layer + D


def train_flops_per_token(model: Mapping[str, Any], seq_len: int) -> float:
    """Model FLOPs a trained token needs: 6 x parameters, plus attention's
    12 x layers x heads x head_dim x sequence (the PaLM paper's convention),
    with no credit for recomputation and none taken for the causal mask."""
    D, H, L = model["hidden_size"], model["num_attention_heads"], model["num_hidden_layers"]
    return 6.0 * dense_params(model) + 12.0 * L * H * (D // H) * seq_len


def union_bytes(runs: Sequence[Tuple[Mapping[str, Any], int, int]], columns: Iterable[str]) -> int:
    """The bytes one UNION must move: each row of each run read once from
    its provider and written once to the output, for every column."""
    total = 0
    for arrays, lo, hi in runs:
        if hi > lo:
            total += sum((hi - lo) * arrays[c].element_size() for c in columns)
    return 2 * total


def copying(runs: Sequence[Tuple[Dict[str, Any], int, int]]) -> bool:
    """A UNION copies (and launches the kernel) when more than one run is
    non-empty; a single run is a slice."""
    return sum(hi > lo for _arrays, lo, hi in runs) > 1
