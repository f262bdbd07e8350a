"""Architecture registry: config lookup and family dispatch.

``get_model(cfg)`` returns a uniform functional API regardless of family:
``transformer`` serves the dense, MoE, audio and VLM families, ``mamba``
the ``ssm`` family and ``hybrid`` the ``hybrid`` family; the API carries
the logical sharding axes of the parameters and of the decode cache.  The
reference's ``input_specs`` and ``cell_is_runnable`` (dry-run shape
stand-ins) come with the cost-analysis slice of ``launch/``.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable

from repro_torch.models.config import ArchConfig

__all__ = ["ModelAPI", "get_model", "get_config", "list_archs", "ARCH_IDS"]

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
