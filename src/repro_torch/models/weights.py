"""Carry the reference's parameters over to the port.

The reference's parameter tree, given as numpy arrays
(``jax.tree.map(np.asarray, params)``), has the port's keys, nesting and
layouts (``(D, H, hd)`` projections, layer-stacked ``(L, …)`` tensors), so
the move is one of dtype and device only.  numpy has no bfloat16 that torch
takes: a bf16 leaf (``ml_dtypes.bfloat16``) goes through f32, which holds it
exactly, and is then cast back to ``torch.bfloat16``.  A reference
``TrainState`` comes over the same way, optimizer state and step included,
so both packages can step from one state.
"""

from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ArchConfig

__all__ = ["params_from_reference", "state_from_reference"]


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


def state_from_reference(cfg: ArchConfig, opt_cfg, tree: Any, device: Union[None, str, torch.device] = None):
    """The port's ``TrainState`` from the reference's, given with numpy
    leaves (``jax.tree.map(np.asarray, state)``, or a mapping with the same
    fields): the parameters, the optimizer state of ``opt_cfg.kind`` (AdamW's
    ``m``, ``v`` and ``master`` when the parameters need one, Adafactor's
    factored ``f``) and the step.  ``device`` ``None`` means the CUDA card."""
    from repro_torch.train.state import TrainState

    device = resolve_device(device)
    field = tree.__getitem__ if isinstance(tree, Mapping) else lambda k: getattr(tree, k)
    opt = field("opt")
    want = {"f"} if opt_cfg.kind == "adafactor" else {"m", "v"} | ({"master"} & set(opt))
    if set(opt) != want:
        raise ValueError(f"{opt_cfg.kind}: optimizer state keys {sorted(opt)} != {sorted(want)}")
    return TrainState(
        params=params_from_reference(cfg, field("params"), device),
        opt=_convert(opt, device),
        step=torch.tensor(np.asarray(field("step")), dtype=torch.int32, device=device),
    )
