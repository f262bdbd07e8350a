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
   products go through :func:`einsum`, which runs on the local shards, and
   its reshapes through :func:`reshape`, which makes such a dim whole.
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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = [
    "Axis",
    "MeshRules",
    "_base_rules",
    "current_rules",
    "distribute_tree",
    "einsum",
    "is_dtensor",
    "map_axes",
    "per_shard",
    "reshape",
    "shard",
    "tree_pspecs",
    "use_rules",
    "whole_dims",
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
    """``torch.einsum``; on DTensor operands, a product that the port lays
    out itself, so that DTensor is asked to flatten nothing.

    ``torch.einsum`` flattens the dims it batches and contracts through
    ``aten.view``, and DTensor refuses such a view when a sharded dim does
    not lead its group (torch 2.11: "Attempted to flatten multiple
    dimensions, with dimension 1 being sharded") or is sharded unevenly.
    Sequence parallelism flattens ``(batch, seq)`` and attention ``(batch,
    heads)``, both sharded.  So the operands are contracted in pairs, left
    to right, each pair by :func:`_local_product`: the operands are
    redistributed so that every mesh dim shards the product one way, and
    ``torch.einsum`` runs on the local shards, uneven ones (hazard rule 2)
    included: both operands of a label shared by them are cut alike.  On
    plain tensors it is ``torch.einsum`` itself."""
    meshes = [t.device_mesh for t in operands if isinstance(t, DTensor)]
    if not meshes:
        return torch.einsum(equation, *operands)
    mesh = meshes[0]
    ins, out = equation.replace(" ", "").split("->")
    specs = ins.split(",")
    operands = [t if is_dtensor(t) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                for t in operands]
    y, y_spec = operands[0], specs[0]
    for i in range(1, len(operands)):
        later = set("".join(specs[i + 1:]) + out)
        keep = out if i == len(operands) - 1 else "".join(
            label for label in dict.fromkeys(y_spec + specs[i]) if label in later)
        y = _local_product(y_spec, specs[i], keep, y, operands[i])
        y_spec = keep
    if len(operands) == 1:
        return torch.einsum(equation, y)
    return y


def _local_product(sa: str, sb: str, so: str, a, b):
    """``einsum(f"{sa},{sb}->{so}", a, b)`` of two DTensors on one mesh, run
    on their local shards.  Mesh dim by mesh dim: a label both operands
    shard there stays sharded (batch labels shard the output, contracted
    ones leave it partial); a label one operand shards is sharded in the
    other too when the other has it (a local chunk, no transfer), and
    shards the output when it does not (the other stays whole); two
    different labels cannot both stay, so one operand is made whole there:
    the one whose label the output lacks, else the smaller.  Each operand
    goes through ``redistribute`` (even to its own placements), whose
    backward brings its gradient back to the placements it came with, so
    no partial gradient leaves the product: the gradient of an operand
    kept whole beside a sharded one is partial inside it
    (``to_local(grad_placements=)``) and summed there."""
    mesh = a.device_mesh
    pa, pb = list(a.placements), list(b.placements)
    # a partial or strided placement is made whole
    for p in (pa, pb):
        for m, q in enumerate(p):
            if type(q) is not Shard and not q.is_replicate():
                p[m] = Replicate()
    out: List[Any] = [Replicate()] * mesh.ndim
    for m in range(mesh.ndim):
        la, lb = _label_on(pa, sa, m), _label_on(pb, sb, m)
        if la is not None and lb is not None and la != lb:
            # keep the shard that shards the output (a contracted one would
            # leave the output partial, whole-sized on every device), else
            # the larger operand's
            if (la in so, _shard_bytes(a, pa)) < (lb in so, _shard_bytes(b, pb)):
                pa[m], la = Replicate(), None
            else:
                pb[m], lb = Replicate(), None
        label = la if la is not None else lb
        if label is None:
            continue
        if label in sa and label in sb:  # batch or contracted: both shard it
            pa[m], pb[m] = Shard(sa.index(label)), Shard(sb.index(label))
        out[m] = Shard(so.index(label)) if label in so else Partial()
    ga = [Partial() if q.is_replicate() and type(r) is Shard else q for q, r in zip(pa, pb)]
    gb = [Partial() if q.is_replicate() and type(r) is Shard else q for q, r in zip(pb, pa)]
    la_ = a.redistribute(mesh, pa).to_local(grad_placements=ga)
    lb_ = b.redistribute(mesh, pb).to_local(grad_placements=gb)
    y = torch.einsum(f"{sa},{sb}->{so}", la_, lb_)
    sizes = dict(zip(sa, a.shape)) | dict(zip(sb, b.shape))
    shape = torch.Size(sizes[label] for label in so)
    return DTensor.from_local(y, mesh, out, run_check=False, shape=shape, stride=_dense_stride(y, shape))


def _label_on(placements, spec: str, m: int) -> Optional[str]:
    """The label of the dim that mesh dim ``m`` shards, or None."""
    p = placements[m]
    return spec[p.dim] if type(p) is Shard else None


def _shard_bytes(t, placements) -> float:
    n = 1
    for m, p in enumerate(placements):
        n *= t.device_mesh.size(m) if type(p) is Shard else 1
    return t.numel() * t.element_size() / n


def _dense_stride(local: torch.Tensor, shape: torch.Size) -> Tuple[int, ...]:
    """The strides of a dense tensor of the global ``shape`` laid out in
    ``local``'s dim order (innermost first by stride)."""
    order = sorted(range(local.dim()), key=lambda d: (local.stride(d), -d))
    stride, n = [0] * local.dim(), 1
    for d in order:
        stride[d] = n
        n *= shape[d]
    return tuple(stride)


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
            stack.enter_context(_implicit_replication())
        _ACTIVE.stack.append(self.rules)
        self._exits.append(stack)
        return self.rules

    def __exit__(self, exc_type, exc, tb) -> bool:
        _ACTIVE.stack.pop()
        self._exits.pop().close()
        return False


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, restoring the setting it found.
    torch's resets it to off, which inside a backward (that autograd runs
    with the caller's setting) would switch it off for the rest of the node
    whose saved tensors a rematerialisation recomputes under
    :class:`use_rules` (``models.layers.remat``)."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


# ----------------------------------------------------------------- operators
def shard(x, logical_axes: Sequence[Optional[str]]):
    """Constrain ``x`` to the active rules' sharding; identity if none."""
    rules = current_rules()
    if rules is None:
        return x
    return rules.constrain(x, logical_axes)


def whole_dims(x, dims: Sequence[int]):
    """``x`` with no mesh dim sharding any of its tensor ``dims``; the
    identity on a plain tensor.  Always a ``redistribute`` on a DTensor,
    even to its own placements, so the gradient comes back to these
    placements too before it reaches the op that needs them whole."""
    if not is_dtensor(x):
        return x
    dims = {d % x.dim() for d in dims}
    placements = [Replicate() if type(p) is not Replicate and getattr(p, "dim", None) in dims else p
                  for p in x.placements]
    return x.redistribute(x.device_mesh, placements)


def reshape(x, *shape):
    """``x.reshape(*shape)``; on a DTensor, every dim the view could not
    keep sharded is made whole first (:func:`whole_dims`): a sharded dim
    that does not lead the group it is flattened into (torch 2.11 refuses
    it: "Attempted to flatten multiple dimensions, with dimension 1 being
    sharded"), a leading one sharded unevenly, and one split into parts
    whose first the mesh does not divide ("Cannot unflatten unevenly
    sharded tensor").  A partial sum is summed first (DTensor would turn it
    into a shard of its own choosing to copy a strided tensor).  The result
    goes through ``redistribute`` to its own placements, so its gradient
    reaches the view's backward placed as the forward left it, and the
    inverse view is one DTensor accepts too."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    from torch.distributed.tensor._ops._view_ops import Flatten, InputDim, Split, view_groups

    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    shape = list(shape)
    if -1 in shape:
        shape[shape.index(-1)] = x.numel() // -int(np.prod(shape))
    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    ways: Dict[int, int] = {}  # tensor dim -> how many ways the mesh shards it
    for m, p in enumerate(x.placements):
        if getattr(p, "dim", None) is not None and not p.is_replicate():
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(m)
    bad: set = set()

    def lead(cmd) -> Optional[int]:
        if isinstance(cmd, InputDim):
            return cmd.input_dim
        if isinstance(cmd, Flatten):
            first, *rest = [d.input_dim for d in cmd.input_dims]
            bad.update(d for d in rest if d in ways)
            if first in ways and x.shape[first] % ways[first]:
                bad.add(first)
            return first
        if isinstance(cmd, Split):
            d = lead(cmd.input_dim)
            if d is not None and cmd.split_id == 0 and d in ways and cmd.group_shape[0] % ways[d]:
                bad.add(d)
            return d
        return None

    for cmd in view_groups(list(x.shape), shape):
        lead(cmd)
    y = whole_dims(x, sorted(bad)).reshape(shape)
    return y.redistribute(mesh, y.placements)


def per_shard(fn, x, dims: Sequence[int]):
    """``fn(x)`` for an ``fn`` that keeps ``x``'s shape and works along
    ``dims`` only (a cumulative sum).  On a DTensor it runs on the local
    shard, with ``dims`` made whole first, and its backward runs there too:
    DTensor has no strategy for some ops that such backwards use (torch
    2.11: ``aten.flip``, in ``cumsum``'s)."""
    if not is_dtensor(x):
        return fn(x)
    x = whole_dims(x, dims)
    y = fn(x.to_local())
    return DTensor.from_local(y, x.device_mesh, x.placements, run_check=False, shape=x.shape, stride=x.stride())


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
