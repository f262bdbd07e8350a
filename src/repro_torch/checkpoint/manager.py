"""Fault-tolerant checkpointing of trees of tensors.

The port of ``repro.checkpoint.manager``, with the reference's on-disk
format, so each package reads the other's checkpoints:

- **Layout**: one directory per step holding one ``.npy`` blob per tree
  leaf (named by its ``___``-joined path: dict keys, ``idx<i>`` for tuple
  items, the field index for a dataclass such as ``TrainState``, as jax
  names a pytree node's children) plus ``manifest.json`` (leaf names,
  shapes, dtypes, step, ``extra``).  A bf16 leaf is written as the
  reference writes it, as 2-byte void (``'<V2'`` in the manifest), through
  a 16-bit integer view: no ``ml_dtypes`` is needed on either side.
- **Atomicity**: writes go to ``step-N.tmp-<uuid>`` and are published with
  one ``os.replace`` — a crash mid-save can never corrupt the latest
  checkpoint, and ``latest()`` only ever sees complete directories.
- **Async save**: ``save(..., blocking=False)`` copies every tensor to host
  memory synchronously, so the caller may go on updating the tensors in
  place, and writes the files on a background thread.
- **Restore**: ``restore_state`` returns numpy leaves, or, given a
  ``target_struct``, that tree's structure with each leaf as a tensor of
  the target leaf's dtype and device (2-byte void becomes
  ``torch.bfloat16``).
- **Elastic restore**: given ``shardings`` (a tree of ``(DeviceMesh,
  placements)`` matching the state), each leaf comes back as a DTensor on
  that mesh whose local shard is the matching slice of the saved array,
  whatever mesh the state was saved from.  A DTensor leaf is saved whole
  (``full_tensor``, a collective every rank of its mesh joins).
- **Retention**: keep the last ``keep`` checkpoints (garbage-collect the
  rest), never deleting the one being written.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import uuid
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.dist.sharding import is_dtensor

__all__ = ["save_state", "restore_state", "CheckpointManager"]

_STEP_RE = re.compile(r"^step-(\d+)$")
_SEP = "___"  # path separator inside leaf filenames


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(name, child) pairs of a container in jax's flatten order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(f"idx{i}", v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(str(i), getattr(tree, f.name)) for i, f in enumerate(dataclasses.fields(tree))]
    return None


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, kid in kids:
        out += _flatten_with_paths(kid, f"{prefix}{_SEP}{key}" if prefix else key)
    return out


def _unflatten(target: Any, leaves: Iterator[Any]) -> Any:
    """``target``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(target, dict):
        return {k: _unflatten(target[k], leaves) for k in sorted(target)}
    if isinstance(target, (tuple, list)):
        return type(target)(_unflatten(v, leaves) for v in target)
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(
            target, **{f.name: _unflatten(getattr(target, f.name), leaves) for f in dataclasses.fields(target)}
        )
    return next(leaves)


_BF16 = "<V2"  # how numpy names a bf16 leaf (2-byte void)


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf that later in-place updates cannot reach,
    and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        a = t.numpy()
    else:
        a = np.array(leaf, copy=True)
    return a, a.dtype.str


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    """A loaded leaf as a host tensor; 2-byte void is bf16."""
    a = np.asarray(a, order="C")
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_tensor(a: np.ndarray, like: Any) -> Any:
    """A loaded leaf as ``like``'s dtype and device when ``like`` is a
    tensor; 2-byte void is bf16."""
    if not isinstance(like, torch.Tensor):
        return a
    t = _as_tensor(a)
    if t.dtype != like.dtype or tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {t.dtype} {tuple(t.shape)} != target {like.dtype} {tuple(like.shape)}")
    return t.to(like.device)


def _nest_from_names(leaves: Dict[str, np.ndarray]) -> Any:
    """Rebuild a nested dict/tuple tree from path-encoded leaf names.

    Dataclasses (TrainState, …) flatten by field index, so they round-trip
    as plain containers; pass ``target_struct`` to restore_state to get the
    typed object back.
    """
    if list(leaves.keys()) == [""]:
        return leaves[""]
    root: Dict[str, Any] = {}
    for name, arr in leaves.items():
        parts = name.split(_SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr

    def finish(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"idx\d+", k) for k in keys):
            return tuple(
                finish(node[f"idx{i}"]) for i in range(len(keys))
            )
        return {k: finish(v) for k, v in node.items()}

    return finish(root)


def save_state(
    root: str,
    step: int,
    state: Any,
    *,
    extra: Optional[Dict[str, Any]] = None,
    blocking: bool = True,
) -> threading.Thread | None:
    """Write ``state`` (any tree of tensors, arrays or scalars) for ``step``.

    With ``blocking=False`` returns the writer thread (join to fence)."""
    os.makedirs(root, exist_ok=True)
    # 1) snapshot to host — synchronously, so the caller may update the
    #    tensors in place immediately after we return
    named, dtypes = [], []
    for n, v in _flatten_with_paths(state):
        a, dt = _to_host(v)
        named.append((n, a))
        dtypes.append(dt)
    manifest = {
        "step": int(step),
        "leaves": [
            {"name": n, "shape": list(a.shape), "dtype": dt} for (n, a), dt in zip(named, dtypes)
        ],
        "extra": extra or {},
    }

    def write():
        tmp = os.path.join(root, f"step-{step}.tmp-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp, exist_ok=True)
        for n, a in named:
            np.save(os.path.join(tmp, f"{n}.npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(root, f"step-{step}")
        if os.path.exists(final):  # same-step re-save: replace
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True, name=f"ckpt-save-{step}")
    t.start()
    return t


def available_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(root, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)




def _is_sharding(s: Any) -> bool:
    return s is None or (isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], DeviceMesh))


def _place(tree: Any, shardings: Any) -> Any:
    """``tree``'s leaves distributed as ``shardings`` says: a ``(DeviceMesh,
    placements)`` leaf makes a DTensor of the matching slice (no message is
    sent: every rank read the whole array), ``None`` plain tensors for the
    whole subtree."""
    if shardings is None:
        if isinstance(tree, dict):
            return {k: _place(v, None) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(_place(v, None) for v in tree)
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            return dataclasses.replace(tree, **{f.name: _place(getattr(tree, f.name), None)
                                                for f in dataclasses.fields(tree)})
        return tree if isinstance(tree, torch.Tensor) else _as_tensor(np.asarray(tree))
    if _is_sharding(shardings):
        t = tree if isinstance(tree, torch.Tensor) else _as_tensor(tree)
        mesh, placements = shardings
        return distribute_tensor(t, mesh, list(placements), src_data_rank=None)
    if isinstance(shardings, dict):
        return {k: _place(tree[k], shardings[k]) for k in shardings}
    if dataclasses.is_dataclass(shardings) and not isinstance(shardings, type):
        return dataclasses.replace(shardings, **{
            f.name: _place(getattr(tree, f.name), getattr(shardings, f.name))
            for f in dataclasses.fields(shardings)
        })
    if isinstance(shardings, (tuple, list)):
        return type(shardings)(_place(tree[i], s) for i, s in enumerate(shardings))
    raise TypeError(f"not a shardings tree node: {shardings!r}")


def restore_state(
    root: str,
    step: Optional[int] = None,
    *,
    shardings: Optional[Any] = None,
    target_struct: Optional[Any] = None,
) -> Tuple[int, Any]:
    """Load a checkpoint.  ``shardings``: optional tree (matching the
    state) of ``(DeviceMesh, placements)`` or ``None`` leaves — each leaf
    comes back as a DTensor on that mesh (elastic restore onto another
    mesh) or a plain tensor.  ``target_struct``: optional tree whose
    structure is used to rebuild typed containers (e.g. TrainState
    dataclasses) from the saved plain tree; its tensor leaves give each
    loaded leaf its dtype and device."""
    steps = available_steps(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    step = steps[-1] if step is None else step
    d = os.path.join(root, f"step-{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves: Dict[str, np.ndarray] = {}
    for spec in manifest["leaves"]:
        arr = np.load(os.path.join(d, f"{spec['name']}.npy"))
        leaves[spec["name"]] = arr
    tree = _nest_from_names(leaves)
    if target_struct is not None:
        flat = [_to_tensor(leaves[n], like) for n, like in _flatten_with_paths(target_struct)]
        tree = _unflatten(target_struct, iter(flat))
    if shardings is not None:
        tree = _place(tree, shardings)
    return step, tree


class CheckpointManager:
    """Retention + async-save bookkeeping around save/restore."""

    def __init__(self, root: str, *, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    def save(self, step: int, state: Any, extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()  # one in-flight save at a time
        self._pending = save_state(
            self.root, step, state, extra=extra, blocking=not self.async_save
        )
        if not self.async_save:
            self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            self._gc()

    def restore(self, step: Optional[int] = None, **kw) -> Tuple[int, Any]:
        self.wait()
        return restore_state(self.root, step, **kw)

    def steps(self) -> List[int]:
        return available_steps(self.root)

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, f"step-{s}"), ignore_errors=True)
