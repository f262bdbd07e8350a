"""TrainState: the single tree of tensors that is checkpointed and stepped.

The port of ``repro.train.state``.  A state's trees are nested dicts (and
tuples) of tensors, flattened as jax flattens them: dict keys in sorted
order.  ``state_logical_axes`` gives the logical sharding axes of a whole
state (``repro_torch.dist.sharding`` maps them onto a mesh).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["TrainState", "state_logical_axes", "tree_leaves", "tree_map"]


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


def _is_factor_leaf(x: Any) -> bool:
    return isinstance(x, dict) and ("v" in x or "vr" in x)


def state_logical_axes(param_axes: Any, opt_state_shapes: Any) -> TrainState:
    """Logical axes for the full state: optimizer moments/master inherit the
    parameter's axes; factored Adafactor stats drop the reduced dim.

    ``param_axes``: a tree of logical-axis tuples (leaves are tuples);
    ``opt_state_shapes``: the optimizer state (tensors, on any device, the
    meta device included), of which only the structure is read."""

    def fac_axes(shapes, axes):
        # {"vr": shape[:-1], "vc": shape[:-2]+shape[-1:]} or {"v": full}
        out = {}
        if "vr" in shapes:
            out["vr"] = tuple(axes[:-1])
            out["vc"] = tuple(axes[:-2]) + (axes[-1],)
        if "v" in shapes:
            out["v"] = axes
        return out

    def over(sub, axes):
        if _is_factor_leaf(sub):
            return fac_axes(sub, axes)
        return {k: over(sub[k], axes[k]) for k in sub}

    opt_axes_tree: Dict[str, Any] = {}
    for key, sub in opt_state_shapes.items():
        if key in ("m", "v", "master"):
            opt_axes_tree[key] = param_axes
        elif key == "f":
            opt_axes_tree[key] = over(sub, param_axes)
        else:
            opt_axes_tree[key] = tree_map(lambda _: (), sub)
    return TrainState(params=param_axes, opt=opt_axes_tree, step=())
