"""Rank functions for the port's multi-process tests.

Spawned ranks import this module by name, so it imports only torch, numpy
and the port: never jax or the reference, which the tests hold the
results against in their own process."""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.pipeline import (
    StageWire,
    pipeline_forward,
    pipeline_value_and_grad,
    stack_stage_params,
)
from repro_torch.train import (
    OptimizerConfig,
    make_pipeline_init_state,
    make_pipeline_train_step,
    train_loop,
)


def layer_fn(x, lp):
    return torch.tanh(x @ lp["W"])


def loss_fn(y, aux):
    d = (y - aux["tgt"]).float()
    return torch.sum(d * d), float(d.numel())


def _stage(rank, Ws):
    staged = stack_stage_params({"W": torch.from_numpy(Ws)}, rank.world)
    return {"W": staged["W"][rank.rank : rank.rank + 1].to(rank.device)}


def pipeline_suite(rank, Ws, x, tgt, steps, seed, M, MB, SEQ, D):
    """Loss and local gradients of both schedules (all M, then M = 2) in
    f32 and in f64, the stash slots, the forward stream, and the params
    after ``steps`` AdamW steps of ``make_pipeline_train_step`` on batches
    drawn from ``seed``."""
    mesh = init_device_mesh(rank.mesh_device, (rank.world,), mesh_dim_names=("pp",))
    out = {"route": rank.route, "backend": rank.backend}
    wire = StageWire(mesh, "pp", rank.device)
    for dtype in (np.float32, np.float64):
        local = _stage(rank, Ws.astype(dtype))
        xs = torch.from_numpy(x.astype(dtype)).to(rank.device)
        aux = {"tgt": torch.from_numpy(tgt.astype(dtype)).to(rank.device)}
        name = np.dtype(dtype).name
        for sched in ("1f1b", "gpipe"):
            (loss, count), grads = pipeline_value_and_grad(mesh, layer_fn, loss_fn, local, xs, aux,
                                                           schedule=sched, wire=wire)
            out[sched, name] = (float(loss), float(count), grads["W"].cpu().numpy(), wire.stash_shape[0])
        (l2, _), g2 = pipeline_value_and_grad(mesh, layer_fn, loss_fn, local, xs[:2], {"tgt": aux["tgt"][:2]},
                                              wire=wire)
        out["small_m", name] = (float(l2), g2["W"].cpu().numpy(), wire.stash_shape[0])
    local = _stage(rank, Ws)
    xs = torch.from_numpy(x).to(rank.device)
    out["forward"] = pipeline_forward(mesh, layer_fn, local, xs).cpu().numpy()

    opt = OptimizerConfig(kind="adamw", peak_lr=1e-2, warmup_steps=2)
    state = make_pipeline_init_state(opt)(local)
    step = make_pipeline_train_step(mesh, layer_fn, loss_fn, opt, microbatches=M)
    rng = np.random.default_rng(seed)

    def batches():
        for _ in range(steps):
            yield {
                "inputs": rng.standard_normal((M * MB, SEQ, D)).astype(np.float32),
                "aux": {"tgt": rng.standard_normal((M * MB, SEQ, D)).astype(np.float32)},
            }

    state, hist = train_loop(step, state, batches(), steps)
    out["trained"] = state.params["W"].cpu().numpy()
    out["history"] = hist
    out["step"] = int(state.step)
    return out


def sharded_granite(rank, cfg, tokens, batch, ckpt_root):
    """Reduced granite on a (data=2, model=2) mesh of 4 gloo ranks: the
    forward logits and one AdamW step (at step 10, a non-zero learning
    rate) under the sharding rules against the same without rules, on
    every rank; then the checkpoint under ``ckpt_root`` restored with
    ``shardings=``.  Returns the largest differences (logits, loss,
    parameters), the logits' placements, and whether every restored local
    shard equals its slice of the saved array."""
    from repro_torch.dist.sharding import distribute_tree, use_rules
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models import get_model
    from repro_torch.train import make_init_state, make_train_step, state_logical_axes
    from repro_torch.train.state import tree_leaves, tree_map

    api = get_model(cfg)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = rules_for(cfg, mesh)
    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=0)
    plain = make_init_state(api, opt)(torch.Generator().manual_seed(0), "cpu")
    plain.step.fill_(10)
    axes = state_logical_axes(api.param_logical_axes(), plain.opt)
    sharded = distribute_tree(tree_map(lambda t: t.clone(), plain), axes, rules)
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        want = api.forward(plain.params, toks)
        with use_rules(rules):
            got = api.forward(sharded.params, distribute_tree(toks, ("batch", None), rules))
    placements = [str(p) for p in got.placements]
    out = {"logits": float((got.full_tensor() - want).abs().max()), "placements": placements}

    step = make_train_step(api, opt)
    plain, m_plain = step(plain, {k: torch.from_numpy(v) for k, v in batch.items()})
    with use_rules(rules):
        sharded_batch = distribute_tree(dict(batch), {k: ("batch", None) for k in batch}, rules)
        sharded, m_sharded = step(sharded, sharded_batch)
        got_loss = float(m_sharded["loss"].full_tensor())
        params = [p.full_tensor() for p in tree_leaves(sharded.params)]
    out["loss"] = abs(got_loss - float(m_plain["loss"]))
    out["params"] = max(float((a - b).abs().max()) for a, b in zip(params, tree_leaves(plain.params)))
    out["restore"] = restored_shards_match(mesh, rules, api, ckpt_root)
    out["elastic"] = mesh_to_mesh(rank, ckpt_root)
    return out


def mesh_to_mesh(rank, root):
    """``tests/test_checkpoint.py``'s elastic restore on 4 ranks: a (16, 8)
    matrix sharded ("data", "model") on a (4, 1) mesh is saved, and
    restored onto a (1, 4) mesh; the value survives and each rank holds its
    new slice."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.launch.mesh import make_mesh

    w = torch.arange(128, dtype=torch.float32).reshape(16, 8)
    mesh_a = make_mesh((4, 1), ("data", "model"), device="cpu")
    mesh_b = make_mesh((1, 4), ("data", "model"), device="cpu")
    a = distribute_tensor(w, mesh_a, [Shard(0), Shard(1)], src_data_rank=None)
    path = os.path.join(root, "mesh")
    if rank.rank == 0:
        save_state(path, 5, {"w": a})
    else:
        a.full_tensor()  # the save's gather is a collective every rank joins
    torch.distributed.barrier()
    step, tree = restore_state(path, shardings={"w": (mesh_b, (Shard(0), Shard(1)))})
    got = tree["w"]
    return (step == 5 and tuple(got.device_mesh.shape) == (1, 4) and torch.equal(got.full_tensor(), w)
            and torch.equal(got.to_local(), w[:, 2 * rank.rank : 2 * rank.rank + 2]))


def restored_shards_match(mesh, rules, api, root):
    """Restore the plain checkpoint at ``root`` with ``shardings=`` from
    the rules; every leaf a DTensor whose local tensor equals its slice of
    the saved array, bitwise."""
    from torch.distributed.tensor import Shard

    from repro_torch.checkpoint import restore_state
    from repro_torch.dist.sharding import map_axes
    from repro_torch.train.state import tree_leaves

    _, plain = restore_state(root)
    axes = api.param_logical_axes()
    shardings = map_axes(lambda a, leaf: (mesh, rules.placements(leaf.shape, a)), axes, plain["0"])
    _, placed = restore_state(root, shardings={"0": shardings, "1": None, "2": None})
    coord = mesh.get_coordinate()
    ok = True
    for want, got, sh in zip(tree_leaves(plain["0"]), tree_leaves(placed["0"]),
                             tree_leaves(shardings, is_leaf=lambda x: isinstance(x, tuple))):
        piece = torch.from_numpy(np.asarray(want))
        for mesh_dim, p in enumerate(sh[1]):
            if isinstance(p, Shard):
                k = mesh.size(mesh_dim)
                n = piece.shape[p.dim]
                size = -(-n // k)
                piece = piece.narrow(p.dim, min(coord[mesh_dim] * size, n),
                                     max(0, min(size, n - coord[mesh_dim] * size)))
        ok &= got.placements == tuple(sh[1]) and torch.equal(got.to_local(), piece)
    return ok


def fail_on_rank(rank, bad):
    if rank.rank == bad:
        raise ValueError("this rank fails on purpose")
    torch.distributed.barrier()  # the others wait for it, and are stopped
    return rank.rank


def one_stage(rank, Ws, x, tgt):
    """A single stage holding the whole stack: its loss and gradients."""
    mesh = init_device_mesh(rank.mesh_device, (1,), mesh_dim_names=("pp",))
    local = {"W": torch.from_numpy(Ws)[None]}
    (loss, _), grads = pipeline_value_and_grad(mesh, layer_fn, loss_fn, local, torch.from_numpy(x),
                                               {"tgt": torch.from_numpy(tgt)})
    return float(loss), grads["W"][0].numpy()


class StrictViews(TorchDispatchMode):
    """Records every ``aten.view`` / ``aten._unsafe_view`` of a DTensor that
    runs under it and the ones torch 2.11's DTensor refuses (its
    ``propagate_shape_and_sharding`` with ``strict_view``): a flattened
    group whose sharded dim is not its first, or whose first dim is sharded
    unevenly, and a split of a sharded dim whose first part the mesh dim
    does not divide.  torch 2.13 accepts the first kind (as a strided
    shard), so the CPU's torch alone would not show them."""

    _VIEWS = ("aten.view.default", "aten._unsafe_view.default")

    def __init__(self):
        super().__init__()
        self.views = 0
        self.refused: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in self._VIEWS and isinstance(args[0], DTensor):
            self.views += 1
            why = _refused_view(args[0], list(args[1]))
            if why:
                self.refused.append(f"{func}: {tuple(args[0].shape)} {list(args[0].placements)} -> "
                                    f"{list(args[1])}: {why}")
        return func(*args, **(kwargs or {}))


def _refused_view(x, to_shape) -> str:
    from torch.distributed.tensor._ops._view_ops import Flatten, InputDim, Split, view_groups

    mesh = x.device_mesh
    if -1 in to_shape:
        to_shape[to_shape.index(-1)] = x.numel() // -math.prod(to_shape)
    sharded = {p.dim: m for m, p in enumerate(x.placements) if isinstance(p, (Shard, _StridedShard))}

    def lead(cmd):
        if isinstance(cmd, InputDim):
            return cmd.input_dim, ""
        if isinstance(cmd, Flatten):
            for i, d in enumerate(cmd.input_dims):
                m = sharded.get(d.input_dim)
                if m is None:
                    continue
                if i > 0:
                    return None, f"flattens dim {d.input_dim}, sharded, behind dim {cmd.input_dims[0].input_dim}"
                if x.shape[d.input_dim] % mesh.size(m):
                    return None, f"flattens dim {d.input_dim}, sharded unevenly"
            return cmd.input_dims[0].input_dim, ""
        if isinstance(cmd, Split):
            d, why = lead(cmd.input_dim)
            if why or d is None or cmd.split_id:
                return None, why
            m = sharded.get(d)
            if m is not None and cmd.group_shape[0] % mesh.size(m):
                return None, f"splits dim {d}, sharded, into a first part of {cmd.group_shape[0]}"
            return d, ""
        return None, ""

    for cmd in view_groups(list(x.shape), to_shape):
        why = lead(cmd)[1]
        if why:
            return why
    return ""
