"""Model zoo of the port: functional torch stacks over plain dicts of
tensors, keyed as the reference's.  Every family of the registry is served:
the transformer families (dense, MoE, audio, VLM), the attention-free
``ssm`` family and the ``hybrid`` family."""

from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec
from repro_torch.models.registry import (
    ARCH_IDS,
    ModelAPI,
    cell_is_runnable,
    get_config,
    get_model,
    input_specs,
    list_archs,
)
from repro_torch.models.weights import params_from_reference, state_from_reference

__all__ = [
    "ArchConfig",
    "ShapeSpec",
    "SHAPES",
    "ARCH_IDS",
    "ModelAPI",
    "get_config",
    "get_model",
    "list_archs",
    "input_specs",
    "cell_is_runnable",
    "params_from_reference",
    "state_from_reference",
]
