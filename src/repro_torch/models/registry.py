"""Architecture registry: config lookup and family dispatch.

``get_model(cfg)`` returns a uniform functional API regardless of family:
``transformer`` serves the dense, MoE, audio and VLM families, ``mamba``
the ``ssm`` family and ``hybrid`` the ``hybrid`` family; the API carries
the logical sharding axes of the parameters and of the decode cache.
``input_specs`` gives one (arch × shape) cell's inputs as tensors on the
``meta`` device (the reference's ``ShapeDtypeStruct`` stand-ins; nothing
is allocated) and ``cell_is_runnable`` the 40-cell coverage rule, both for
the dry-run (``launch.dryrun``).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec

__all__ = [
    "ModelAPI",
    "get_model",
    "get_config",
    "list_archs",
    "input_specs",
    "cell_is_runnable",
    "ARCH_IDS",
]

ARCH_IDS = [
    "musicgen-medium",
    "nemotron-4-340b",
    "phi3-mini-3.8b",
    "granite-3-2b",
    "granite-3-8b",
    "internvl2-76b",
    "zamba2-1.2b",
    "llama4-scout-17b-a16e",
    "mixtral-8x22b",
    "mamba2-780m",
]


@dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init_params: Callable
    param_logical_axes: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    init_decode_cache: Callable
    cache_logical_axes: Callable


def _family_module(family: str):
    from repro_torch.models import hybrid, mamba, transformer

    return {
        "dense": transformer,
        "moe": transformer,
        "audio": transformer,
        "vlm": transformer,
        "ssm": mamba,
        "hybrid": hybrid,
    }[family]


def get_model(cfg: ArchConfig) -> ModelAPI:
    mod = _family_module(cfg.family)
    return ModelAPI(
        cfg=cfg,
        init_params=lambda gen, device=None: mod.init_params(cfg, gen, device),
        param_logical_axes=lambda: mod.param_logical_axes(cfg),
        forward=lambda params, tokens, prefix_embeds=None: mod.forward(
            cfg, params, tokens, prefix_embeds
        ),
        prefill=lambda params, tokens, prefix_embeds=None, max_len=None: mod.prefill(
            cfg, params, tokens, prefix_embeds, max_len
        ),
        decode_step=lambda params, tokens, cache: mod.decode_step(cfg, params, tokens, cache),
        init_decode_cache=lambda batch, max_len, device=None: mod.init_decode_cache(
            cfg, batch, max_len, device
        ),
        cache_logical_axes=lambda: mod.cache_logical_axes(cfg),
    )


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def list_archs():
    return list(ARCH_IDS)


# --------------------------------------------------------------- input specs
def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: Union[ShapeSpec, str]) -> Dict[str, Any]:
    """Meta-tensor stand-ins for one (arch × shape) cell.

    train  : tokens/labels (B,S) int32, loss_mask (B,S) f32 [+ prefix embeds]
    prefill: tokens (B,S) int32 [+ prefix embeds]
    decode : tokens (B,1) int32 + a full KV/state cache at seq_len context
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    dtype = getattr(torch, cfg.dtype)
    specs: Dict[str, Any] = {}
    if shape.kind == "train":
        specs["tokens"] = _meta((B, S), torch.int32)
        specs["labels"] = _meta((B, S), torch.int32)
        specs["loss_mask"] = _meta((B, S), torch.float32)
        if cfg.frontend != "none":
            specs["prefix_embeds"] = _meta((B, cfg.prefix_len, cfg.d_model), dtype)
        return specs
    if shape.kind == "prefill":
        specs["tokens"] = _meta((B, S), torch.int32)
        if cfg.frontend != "none":
            specs["prefix_embeds"] = _meta((B, cfg.prefix_len, cfg.d_model), dtype)
        return specs
    if shape.kind == "decode":
        specs["tokens"] = _meta((B, 1), torch.int32)
        specs["cache"] = _family_module(cfg.family).init_decode_cache(cfg, B, S, device="meta")
        return specs
    raise ValueError(f"unknown shape kind {shape.kind}")


def cell_is_runnable(cfg: ArchConfig, shape: Union[ShapeSpec, str]) -> Tuple[bool, str]:
    """The 40-cell coverage rule: ``long_500k`` needs sub-quadratic attention."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "SKIP(full-attention @ 500k context)"
    return True, ""
