"""TrainState: the single tree of tensors that is checkpointed and stepped.

The port of ``repro.train.state``.  A state's trees are nested dicts (and
tuples) of tensors, flattened as jax flattens them: dict keys in sorted
order.  ``state_logical_axes`` waits for the port's ``dist.sharding``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch

__all__ = ["TrainState", "tree_leaves", "tree_map"]


@dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor  # () int32


def _children(tree: Any) -> Optional[List[Any]]:
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    if isinstance(tree, TrainState):
        return [tree.params, tree.opt, tree.step]
    return None


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    """The leaves in jax's order (dict keys sorted)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid, is_leaf)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if isinstance(tree, TrainState):
        return TrainState(*(tree_map(fn, *kids) for kids in zip(*(_children(t) for t in (tree,) + rest))))
    return fn(tree, *rest)
