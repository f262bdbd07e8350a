"""Mesh construction for the production topologies.

The port of ``repro.launch.mesh``.  ``make_production_mesh`` is a FUNCTION
(importing this module never touches the process group): 16×16 = 256
devices per pod (``("data","model")``), or 2×16×16 = 512 across two pods
(``("pod","data","model")``).  A mesh is a ``DeviceMesh`` over the ranks
of the default process group, one device each, so it needs that many
ranks (``torchrun --nproc-per-node``), where the reference forces fake
CPU devices.

``rules_for`` builds the logical-sharding rules for an (arch, mesh) pair:
the production FSDP×TP(+SP) rules, the arch's rule overrides (e.g.
mixtral's experts→TP-within-expert fallback), and the batch axes present
in the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.sharding import MeshRules, _base_rules
from repro_torch.models.config import ArchConfig

__all__ = ["make_production_mesh", "make_mesh", "rules_for", "describe_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks; ``device`` is the mesh's device type (``"cuda"``
    with NCCL, ``"cpu"`` with gloo or the ``"fake"`` test backend)."""
    from torch.distributed.device_mesh import DeviceMesh

    need = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} ranks, found {have} — "
            f"start {need} ranks (torchrun --nproc-per-node={need}, or one "
            f"process group of {need} ranks) before building the mesh"
        )
    return DeviceMesh(device, torch.arange(need).reshape(tuple(shape)), mesh_dim_names=tuple(axes))


def rules_for(
    cfg: Optional[ArchConfig],
    mesh,
    *,
    seq_parallel: bool = True,
) -> MeshRules:
    rules = _base_rules(pod="pod" in mesh.mesh_dim_names)
    if cfg is not None:
        for name, axis in cfg.rule_overrides:
            rules[name] = axis
    return MeshRules(rules=rules, mesh=mesh, shard_seq_activations=seq_parallel)


def describe_mesh(mesh) -> str:
    return "x".join(f"{n}={s}" for n, s in zip(mesh.mesh_dim_names, mesh.shape))
