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

# top-level keys of each served family's parameter tree
_KEYS = {
    "ssm": {"embed", "layers", "final_norm", "lm_head"},
    "hybrid": {"embed", "layers", "final_norm", "lm_head", "shared_attn"},
}


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
    want = _KEYS.get(cfg.family)
    if want is None:
        raise NotImplementedError(f"the {cfg.family!r} family is not ported yet: ROADMAP A10")
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: parameter keys {sorted(tree)} != {sorted(want)}")
    return _convert(tree, device)
