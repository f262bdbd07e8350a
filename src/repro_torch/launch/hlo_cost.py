"""Cost model of a torch program, counted op by op under a dispatch mode.

The port of ``repro.launch.hlo_cost``, which reads the three roofline inputs
off a compiled XLA module's text.  A torch program has no HLO: it runs
eagerly, one aten op at a time, so :class:`CostCounter` (a
``TorchDispatchMode``) sees every op that runs, on each device's local
tensors (it lets DTensor unwrap itself first, so the sharded ops it counts
are the per-device ones, and the collectives DTensor issues inside its own
ops are counted too).  The conventions are the reference's:

- **FLOPs**: matmuls, convolutions and attention exactly (2 × output
  elements × contraction), from ``torch.utils.flop_counter``'s formulas,
  those of ``FlopCounterMode``; every other op that computes
  (elementwise, reduce, compare, rng) at 1 FLOP per output element, which
  ``FlopCounterMode`` counts as 0; data movement (copies, casts,
  concatenation, gathers, scatters, padding) at 0.
- **HBM bytes**: operand bytes + output bytes of every op that runs,
  skipping views and metadata-only ops (``empty``, ``detach``, ``view``).
  Eager torch fuses nothing, so every op is "materialised": this counts
  more bytes than XLA's fused program would (an elementwise chain that XLA
  fuses into one pass is one pass per op here).  Row writes and reads are
  counted as the reference counts its dynamic-update-slice, scatter and
  gather: the rows touched, not the whole table.
- **Collective bytes**: ring-model per-device wire traffic with the group
  size g (:class:`CollectiveBytes`):
      all-gather         result × (g-1)/g
      reduce-scatter     result × (g-1)          (operand-sized ring pass)
      all-reduce         2 × result × (g-1)/g    (reduce-scatter + all-gather)
      all-to-all         result × (g-1)/g
      collective-permute result                  (a point-to-point receive)

The reference weights every computation by its execution count, recovering
``while``-loop trip counts from the HLO (``lax.scan`` over layers and
microbatches is counted once by XLA's own ``cost_analysis``).  The port's
layers and microbatches loop in Python, so every execution is an op the
counter sees, and there is no trip-count machinery: ``flops_unweighted``
equals ``flops``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["CollectiveBytes", "CostCounter", "CostModel", "analyze", "in_sharding_propagation"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# functional collective (or c10d point-to-point) -> (kind, wire bytes of
# the op's first tensor ``b`` over a group of ``g``), the reference's ring
# model written on the operand: an all-gather's result is g operands, a
# reduce-scatter's is 1/g of one
_WIRE: Dict[str, tuple] = {
    "all_gather_into_tensor": ("all-gather", lambda b, g: b * (g - 1)),
    "all_reduce": ("all-reduce", lambda b, g: 2.0 * b * (g - 1) / g),
    "reduce_scatter_tensor": ("reduce-scatter", lambda b, g: b / g * (g - 1)),
    "all_to_all_single": ("all-to-all", lambda b, g: b * (g - 1) / g),
    "recv_": ("collective-permute", lambda b, g: b),
}


def in_sharding_propagation() -> bool:
    """Whether the op being dispatched runs inside DTensor's sharding
    propagation, which runs each new op once on fake tensors of the global
    shape to learn its output's shape.  Those ops compute nothing on any
    device, but a dispatch mode below DTensor sees them (under an active
    ``FakeTensorMode`` they even share its fake tensors), so the counters
    skip them."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """The group of a functional collective (named by a string argument) or
    of a c10d point-to-point op (a ``ProcessGroup`` argument)."""
    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group([a for a in args if isinstance(a, str)][-1]).size()
    return 2


class CollectiveBytes(TorchDispatchMode):
    """Counts the wire bytes of the collectives that run under it, one
    rank's view, with the ring model above.  DTensor's redistributions run
    through the functional collectives (``torch.ops._c10d_functional``),
    those it makes inside its own ops included (a DTensor op is let through
    to DTensor, which runs its local ops and collectives under this mode),
    so the count is what a sharded step puts on the wire."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.by_kind: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
        self.count = 0

    def _collective(self, func, args) -> None:
        if func.namespace not in ("_c10d_functional", "c10d"):
            return
        wire = _WIRE.get(func._opname)
        if wire is None:
            return
        tensor = next(t for t in tree_leaves(args) if isinstance(t, torch.Tensor))
        kind, formula = wire
        b = formula(float(_nbytes(tensor)), _group_size(func, args))
        self.bytes += b
        self.by_kind[kind] += b
        self.count += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        if not in_sharding_propagation():
            self._collective(func, args)
        return func(*args, **(kwargs or {}))


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


_aten = torch.ops.aten

# ops that move data but compute nothing (the reference's _DATA_OPS)
_DATA = {
    _aten.copy_, _aten._to_copy, _aten.clone, _aten.contiguous, _aten.cat, _aten.stack,
    _aten.constant_pad_nd, _aten.flip, _aten.roll, _aten.repeat, _aten.where,
    _aten.index, _aten.index_select, _aten.gather, _aten.embedding,
    _aten.index_put, _aten.index_put_, _aten.scatter, _aten.scatter_, _aten.scatter_add,
    _aten.scatter_add_, _aten.slice_scatter, _aten.select_scatter, _aten.masked_fill,
    _aten.masked_fill_, _aten.fill_, _aten.zero_, _aten.zeros, _aten.ones, _aten.full,
    _aten.zeros_like, _aten.ones_like, _aten.full_like, _aten.new_zeros, _aten.new_ones,
    _aten.new_full, _aten.arange, _aten.embedding_dense_backward, _aten.tril, _aten.triu,
    _aten.slice_backward, _aten.select_backward, _aten.expand_copy, _aten.permute_copy,
    _aten.transpose_copy, _aten.view_copy, _aten.unsqueeze_copy, _aten.squeeze_copy,
}
# metadata-only: no bytes, no FLOPs
_FREE = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
    _aten.detach, _aten.alias, _aten._unsafe_view, _aten.lift_fresh, _aten.lift_fresh_copy,
    _aten._local_scalar_dense, _aten.set_, _aten.resize_, _aten.is_same_size, _aten.equal,
}
# writes whose first operand is overwritten, not read
_OVERWRITE = {_aten.copy_, _aten.fill_, _aten.zero_}
# row writes (the reference's dynamic-update-slice and scatter): the
# touched region is the update, not the whole base
_ROW_WRITE = {_aten.index_put, _aten.index_put_, _aten.scatter, _aten.scatter_,
              _aten.scatter_add, _aten.scatter_add_}
# row reads (the reference's gather): the touched rows are the output
_ROW_READ = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}


@dataclass
class CostModel:
    """Per-device FLOPs, HBM bytes and collective wire bytes of one run,
    with the reference's ``HloCostModel`` fields."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = field(default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    collective_count: float = 0.0
    flops_unweighted: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        d = {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collective_count": self.collective_count,
            "flops_unweighted": self.flops_unweighted,
        }
        d.update({f"coll_{k}": v for k, v in self.collective_by_kind.items()})
        return d


class CostCounter(CollectiveBytes):
    """``with CostCounter() as c: ...`` counts FLOPs, HBM bytes and the
    collectives of every op that runs inside; ``c.result()`` is the
    :class:`CostModel`.  Works on real, meta and fake tensors alike (the
    counts read shapes only), so a program costed on fake tensors and run
    on the card counts the same."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not in_sharding_propagation():
            self._collective(func, args)
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        if packet in _FREE or func.is_view or func.namespace not in ("aten", "_c10d_functional", "c10d"):
            return
        if func.namespace != "aten" and func._opname == "wait_tensor":
            return
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif packet not in _DATA and func.namespace == "aten":
            self.flops += float(sum(t.numel() for t in outs))
        ob = sum(_nbytes(t) for t in outs)
        if packet in _OVERWRITE:
            ib = sum(_nbytes(t) for t in ins[1:])
        elif packet in _ROW_WRITE:
            # (base, indices…, values): the update is read and written
            update = _nbytes(ins[-1])
            ib, ob = sum(_nbytes(t) for t in ins[1:]), update
        elif packet in _ROW_READ:
            ib = sum(_nbytes(t) for t in ins[1:]) + ob
        else:
            ib = sum(_nbytes(t) for t in ins)
        self.bytes_accessed += ib + ob

    def result(self) -> CostModel:
        return CostModel(
            flops=self.flops,
            bytes_accessed=self.bytes_accessed,
            collective_bytes=self.bytes,
            collective_by_kind=dict(self.by_kind),
            collective_count=float(self.count),
            flops_unweighted=self.flops,
        )


def analyze(fn: Callable[..., Any], *args, **kwargs) -> CostModel:
    """The :class:`CostModel` of one call ``fn(*args, **kwargs)``: the
    counterpart of the reference's ``analyze_hlo`` for a torch program."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.result()
