"""Logical-axis sharding constraints on DTensor.

The port of ``repro.dist.sharding``.  Model code never mentions mesh axes:
every materialized tensor is annotated with *logical* names via
:func:`shard`, e.g. ``shard(q, ("batch", None, "act_heads", None))``.  A
:class:`MeshRules` — built by ``launch.mesh.rules_for`` from
:func:`_base_rules` plus per-arch overrides — maps logical names to the
named dims of a ``DeviceMesh`` and is activated with :func:`use_rules`.
With no rules active, :func:`shard` is the identity, so the same model code
runs unsharded in unit tests and FSDP×TP(+SP) under a mesh.  Under active
rules the state and the batch are DTensors (:func:`distribute_tree`), and
:func:`shard` redistributes a DTensor to the placements the rules give it.

Hazard rules (applied per dim, with the tensor shape in hand), the
reference's:

1. **Size-1 dims DROP their constraint.**  Constraining a length-1 dim onto
   a >1 mesh axis parks the whole buffer on one device.
2. **Non-divisible dims KEEP their constraint.**  DTensor shards unevenly
   (6 heads on a 4-way axis: 2, 2, 2, 0 a rank), as GSPMD pads the last
   shard.  DTensor cannot propagate every op over an uneven shard (it
   refuses to flatten or unflatten one, ``aten.view``), so the model's
   products go through :func:`einsum`, which makes its operands whole over
   a mesh dim that some dim of the product does not divide.
3. Constraints onto axes of size 1 (or axes not in the mesh) are no-ops and
   are dropped.

A tensor dim mapped onto several mesh axes (``batch`` over ``("pod",
"data")``) is sharded over each, in the tuple's order, which is the mesh's
order for every rule here.

``seq`` is special-cased: :class:`MeshRules` gates it behind
``shard_seq_activations`` so sequence parallelism can be toggled per run.

While rules are active, plain tensors that the model code makes (positions,
masks, RoPE frequencies) join DTensor ops as replicated
(``implicit_replication``); a plain tensor given to :func:`shard` raises.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "Axis",
    "MeshRules",
    "_base_rules",
    "current_rules",
    "distribute_tree",
    "einsum",
    "is_dtensor",
    "map_axes",
    "shard",
    "tree_pspecs",
    "use_rules",
]

# A physical assignment for one logical axis: one mesh axis, several (their
# sizes multiply, e.g. batch over ("pod", "data")), or None (replicated).
Axis = Union[str, Tuple[str, ...], None]


def _base_rules(pod: bool = False) -> Dict[str, Axis]:
    """The production FSDP×TP(+SP) rule table (mutable — callers patch it
    with per-arch overrides before freezing it into a :class:`MeshRules`).

    Parameters: every weight's ``embed`` dim is sharded over "data" (FSDP —
    weights are all-gathered just-in-time, gradients reduce-scattered), and
    its TP dim (``heads``/``mlp``/``vocab``) over "model" (Megatron).
    Experts default to expert-parallel over "model" (llama4); mixtral
    overrides to TP-within-expert because 8 experts do not cover a 16-way
    axis.  Activations: batch over the data axes, TP-parallel dims
    (``act_*``) over "model", decode KV cache sequence-sharded over "model"
    (flash-decoding).
    """
    batch: Axis = ("pod", "data") if pod else "data"
    return {
        # ---- parameter axes
        "layers": None,  # scan-stacked layer dim: never sharded
        "embed": "data",  # FSDP
        "heads": "model",  # Megatron TP
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",  # expert-parallel default; mixtral overrides
        "expert_mlp": None,  # TP-within-expert fallback target
        # ---- activation axes
        "batch": batch,
        "seq": "model",  # sequence parallelism (gated by shard_seq_activations)
        "act_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_experts": "model",
        "kv_seq": "model",  # decode cache: shard the sequence, not the heads
        "ssm_heads": "model",
    }


def is_dtensor(x: Any) -> bool:
    return isinstance(x, DTensor)


def einsum(equation: str, *operands):
    """``torch.einsum``; on DTensor operands, hazard rule 2's uneven shards
    are kept out of it.  einsum flattens the dims it batches and contracts
    and unflattens its output through ``aten.view``, which DTensor refuses
    over an uneven shard, and DTensor may shard a flattened dim whose
    leading dim does not divide.  So over each mesh dim that some dim of
    the product (longer than 1) does not divide, the operands are first
    made whole (replicated); the output then carries no shard there, and
    the next :func:`shard` places it.  On plain tensors it is
    ``torch.einsum`` itself."""
    meshes = [t.device_mesh for t in operands if isinstance(t, DTensor)]
    if not meshes:
        return torch.einsum(equation, *operands)
    mesh = meshes[0]
    sizes = {label: n for spec, t in zip(equation.split("->")[0].split(","), operands)
             for label, n in zip(spec.strip(), t.shape)}
    uneven = [i for i in range(mesh.ndim)
              if mesh.size(i) > 1 and any(n > 1 and n % mesh.size(i) for n in sizes.values())]

    def whole(t):
        if not is_dtensor(t) or not uneven:
            return t
        placements = [Replicate() if i in uneven else p for i, p in enumerate(t.placements)]
        return t if placements == list(t.placements) else t.redistribute(mesh, placements)

    return torch.einsum(equation, *(whole(t) for t in operands))


@dataclass
class MeshRules:
    """A frozen (rules, mesh) pair — the unit :func:`use_rules` activates.
    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` with named
    dims."""

    rules: Dict[str, Axis]
    mesh: Any
    shard_seq_activations: bool = True

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    # -- resolution --------------------------------------------------------
    def resolve(self, name: Optional[str]) -> Axis:
        """Logical name -> mesh axes, with unknown names and axes missing
        from this mesh resolving to None (replicated)."""
        if name is None:
            return None
        if name == "seq" and not self.shard_seq_activations:
            return None
        axis = self.rules.get(name)
        if axis is None:
            return None
        present = self.axis_names
        if isinstance(axis, tuple):
            kept = tuple(a for a in axis if a in present)
            if not kept:
                return None
            return kept if len(kept) > 1 else kept[0]
        return axis if axis in present else None

    def axis_size(self, axis: Axis) -> int:
        if axis is None:
            return 1
        names = axis if isinstance(axis, tuple) else (axis,)
        n = 1
        for a in names:
            n *= self.mesh.size(self.axis_names.index(a))
        return n

    def _dedup(self, resolved: "list[Tuple[Optional[str], Axis]]") -> "list[Axis]":
        """One spec may use each mesh axis once.  On conflict, non-``seq``
        dims claim their axes first (sequence parallelism is the filler —
        e.g. logits ``("batch", "seq", "act_vocab")`` keeps the vocab TP
        shard and drops the seq constraint); ties break leftmost-wins."""
        parts: list[Axis] = [None] * len(resolved)
        used: set = set()
        for pass_seq in (False, True):
            for dim, (name, axis) in enumerate(resolved):
                if axis is None or (name == "seq") != pass_seq:
                    continue
                names = axis if isinstance(axis, tuple) else (axis,)
                if any(a in used for a in names):
                    continue
                parts[dim] = axis
                used.update(names)
        return parts

    def pspec(self, logical_axes: Sequence[Optional[str]]) -> Tuple[Axis, ...]:
        """Pure name mapping (no shape hazards): the mesh axes of each dim,
        the reference's ``PartitionSpec`` as a tuple."""
        return tuple(self._dedup([(n, self.resolve(n)) for n in logical_axes]))

    def placements(self, shape: Sequence[int], logical_axes: Sequence[Optional[str]]) -> List[Any]:
        """DTensor placements (one a mesh dim) for a tensor of ``shape``
        annotated ``logical_axes``, after hazard rules 1-3."""
        if len(logical_axes) != len(shape):
            raise ValueError(
                f"logical axes {tuple(logical_axes)} have rank "
                f"{len(logical_axes)}, tensor has rank {len(shape)} ({tuple(shape)})"
            )
        resolved: list = []
        for dim, name in enumerate(logical_axes):
            axis = self.resolve(name)
            if axis is None or self.axis_size(axis) <= 1:
                axis = None  # hazard rule 3: no-op constraint
            elif shape[dim] == 1:
                axis = None  # hazard rule 1: don't park size-1 dims
            # else: hazard rule 2 — keep even if non-divisible (uneven shards)
            resolved.append((name, axis))
        out: List[Any] = [Replicate()] * len(self.axis_names)
        for dim, axis in enumerate(self._dedup(resolved)):
            for a in (axis if isinstance(axis, tuple) else (axis,)) if axis is not None else ():
                out[self.axis_names.index(a)] = Shard(dim)
        return out

    # -- the constraint operator ------------------------------------------
    def constrain(self, x, logical_axes: Sequence[Optional[str]]):
        if not is_dtensor(x):
            raise TypeError(
                f"shard{tuple(logical_axes)} under active rules needs a DTensor, got a plain "
                f"{type(x).__name__} {tuple(x.shape)}: distribute the state and the batch "
                f"(distribute_tree) before running the model under use_rules"
            )
        return x.redistribute(self.mesh, self.placements(x.shape, logical_axes))


# --------------------------------------------------------------------- state
# Active-rules stack.  Thread-local: the data pipeline's prefetch threads and
# async checkpoint writers must never observe the trainer's rules.
class _Active(threading.local):
    def __init__(self) -> None:
        self.stack: list = []


_ACTIVE = _Active()


def current_rules() -> Optional[MeshRules]:
    for rules in reversed(_ACTIVE.stack):
        if rules is not None:
            return rules
    return None


class use_rules:
    """``with use_rules(rules): ...`` — activate a :class:`MeshRules` for
    every :func:`shard`/:func:`tree_pspecs` call in the dynamic extent, with
    plain tensors joining DTensor ops as replicated.  ``use_rules(None)`` is
    an allowed no-op (launcher convenience).  Re-entrant; each thread has
    its own stack."""

    def __init__(self, rules: Optional[MeshRules]):
        self.rules = rules
        self._exits: list = []

    def __enter__(self) -> Optional[MeshRules]:
        stack = contextlib.ExitStack()
        if self.rules is not None:
            from torch.distributed.tensor.experimental import implicit_replication

            stack.enter_context(implicit_replication())
        _ACTIVE.stack.append(self.rules)
        self._exits.append(stack)
        return self.rules

    def __exit__(self, exc_type, exc, tb) -> bool:
        _ACTIVE.stack.pop()
        self._exits.pop().close()
        return False


# ----------------------------------------------------------------- operators
def shard(x, logical_axes: Sequence[Optional[str]]):
    """Constrain ``x`` to the active rules' sharding; identity if none."""
    rules = current_rules()
    if rules is None:
        return x
    return rules.constrain(x, logical_axes)


def _is_axes(node: Any) -> bool:
    return isinstance(node, tuple) and all(a is None or isinstance(a, str) for a in node)


def map_axes(fn, axes_tree: Any, *trees: Any) -> Any:
    """``fn(axes, *leaves)`` over a tree whose leaves are logical-axis tuples
    (``()`` for scalars) and trees of the same structure; dicts and
    dataclass states (``TrainState``) are walked."""
    import dataclasses

    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(t[k] for t in trees)) for k in axes_tree}
    if dataclasses.is_dataclass(axes_tree):
        return dataclasses.replace(axes_tree, **{
            f.name: map_axes(fn, getattr(axes_tree, f.name), *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(axes_tree)
        })
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, a, *(t[i] for t in trees)) for i, a in enumerate(axes_tree))
    raise TypeError(f"not a logical-axes tree node: {axes_tree!r}")


def tree_pspecs(axes_tree: Any, rules: MeshRules) -> Any:
    """Map a tree whose leaves are logical-axis tuples (``()`` for scalars)
    to a matching tree of mesh-axis tuples (:meth:`MeshRules.pspec`)."""
    return map_axes(rules.pspec, axes_tree)


def distribute_tree(tree: Any, axes_tree: Any, rules: MeshRules) -> Any:
    """``tree``'s tensors as DTensors on ``rules.mesh``, each placed by its
    logical axes (params, optimizer state, a batch).  Every rank must hold
    the same full tensors (the same seed): each keeps its own shard, and
    nothing is sent.  Non-tensor leaves (numpy arrays) become tensors
    first."""
    from torch.distributed.tensor import distribute_tensor

    def place(axes, t):
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t))  # a writable copy of a (read-only) scanned array
        return distribute_tensor(t, rules.mesh, rules.placements(t.shape, axes), src_data_rank=None)

    return map_axes(place, axes_tree, tree)
