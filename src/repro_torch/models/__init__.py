"""Model zoo of the port: functional torch stacks over plain dicts of
tensors, keyed as the reference's.  Served so far: the attention-free
``ssm`` family (mamba2-780m) and the ``hybrid`` family (zamba2-1.2b)."""

from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec
from repro_torch.models.registry import ARCH_IDS, ModelAPI, get_config, get_model, list_archs
from repro_torch.models.weights import params_from_reference

__all__ = [
    "ArchConfig",
    "ShapeSpec",
    "SHAPES",
    "ARCH_IDS",
    "ModelAPI",
    "get_config",
    "get_model",
    "list_archs",
    "params_from_reference",
]
