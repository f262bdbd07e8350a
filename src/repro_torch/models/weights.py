"""Carry the reference's parameters over to the port.

The reference's parameter tree, given as numpy arrays
(``jax.tree.map(np.asarray, params)``), has the port's keys, nesting and
layouts (``(D, H, hd)`` projections, layer-stacked ``(L, …)`` tensors), so
the move is one of dtype and device only.  numpy has no bfloat16 that torch
takes: a bf16 leaf (``ml_dtypes.bfloat16``) goes through f32, which holds it
exactly, and is then cast back to ``torch.bfloat16``.
"""

from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ArchConfig

__all__ = ["params_from_reference"]


def _keys(cfg: ArchConfig) -> set:
    """The top-level keys of the family's parameter tree."""
    if cfg.family == "ssm":
        return {"embed", "layers", "final_norm", "lm_head"}
    if cfg.family == "hybrid":
        return {"embed", "layers", "final_norm", "lm_head", "shared_attn"}
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        # layers hold "mlp" or "moe" (with "shared" for a shared expert)
        keys = {"embed", "layers", "final_norm"}
        return keys if cfg.tie_embeddings else keys | {"lm_head"}
    raise ValueError(f"unknown family {cfg.family!r}")


def _leaf(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def params_from_reference(
    cfg: ArchConfig, tree: Mapping[str, Any], device: Union[None, str, torch.device] = None
) -> dict:
    """The port's parameters from the reference's numpy tree.  ``device``
    ``None`` means the CUDA card (raises without one)."""
    device = resolve_device(device)
    want = _keys(cfg)
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: parameter keys {sorted(tree)} != {sorted(want)}")
    return _convert(tree, device)
