"""Optimizers on torch tensors: AdamW and Adafactor, with the memory knobs
large models need (bf16 moments, fp32 master weights, factored second
moments).

The port of ``repro.train.optimizer``: the math is the reference's, term for
term and in the same f32 order.  Unlike the reference, which returns new
trees, ``update`` writes the new parameters and optimizer state into the
given tensors, one leaf at a time, and clips the f32 gradients in place:
at granite-3-2b's size a functional update would hold a second copy of the
parameters, the master and both moments (the reference's launcher donates
them to ``jit`` for the same reason).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.train.state import tree_leaves, tree_map

__all__ = ["OptimizerConfig", "make_optimizer", "make_schedule", "global_norm"]

_F32 = torch.float32


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"  # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"  # bfloat16 halves m/v memory
    master_dtype: str = "float32"  # master copy when params are low-precision
    # adafactor
    factored_min_dim: int = 128


def make_schedule(cfg: OptimizerConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup → cosine decay to ``min_lr_ratio``·peak, in f32 on the
    step's device."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(_F32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0
        )
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        mult = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
        return cfg.peak_lr * warm * mult

    return schedule


def global_norm(tree, sum_over: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The f32 norm of every leaf of ``tree``; ``sum_over`` adds the sum of
    squares over the ranks that hold the other parts of the same tree (the
    pipeline's stages)."""
    sq = sum(torch.sum(torch.square(l.to(_F32))) for l in tree_leaves(tree))
    return torch.sqrt(sq if sum_over is None else sum_over(sq))


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                         sum_over=None) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scales the f32 gradients in place (others are first cast to f32)."""
    norm = global_norm(grads, sum_over)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    grads = [g if g.dtype == _F32 else g.to(_F32) for g in grads]
    for g in grads:
        g.mul_(scale)
    return grads, norm


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is f32 (updated in place), else an f32 copy."""
    return t if t.dtype == _F32 else t.to(_F32)


def _adamw_leaf(cfg: OptimizerConfig, p, g, m, v, master, lr, bc1, bc2) -> None:
    ref = master if master is not None else p
    ref32, m32, v32 = _f32(ref), _f32(m), _f32(v)
    t = torch.mul(g, 1 - cfg.b1)
    m32.mul_(cfg.b1).add_(t)
    torch.mul(g, 1 - cfg.b2, out=t).mul_(g)
    v32.mul_(cfg.b2).add_(t)
    torch.div(v32, bc2, out=t).sqrt_().add_(cfg.eps)
    upd = torch.div(m32, bc1).div_(t)
    if ref.ndim >= 2:  # decoupled weight decay on matrices only
        upd.add_(torch.mul(ref32, cfg.weight_decay, out=t))
    del t
    ref32.sub_(upd.mul_(lr))
    for new, dst in ((ref32, ref), (m32, m), (v32, v)):
        if new is not dst:
            dst.copy_(new)
    if master is not None:
        p.copy_(ref32)


def _adafactor_leaf(cfg: OptimizerConfig, p, g, f, lr, beta2) -> None:
    one_m = 1 - beta2
    if "vr" in f:
        g2 = g * g
        f["vr"].mul_(beta2).add_(one_m * torch.mean(g2, dim=-1))
        f["vc"].mul_(beta2).add_(one_m * torch.mean(g2, dim=-2))
        del g2
        vr, vc = f["vr"], f["vc"]
        rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
        pre = torch.sqrt(rfac)[..., None] * torch.sqrt(vc)[..., None, :]
        pre = torch.div(g, pre.add_(cfg.eps), out=pre)
    else:
        f["v"].mul_(beta2).add_(one_m * g * g)
        pre = torch.div(g, torch.sqrt(f["v"]).add_(cfg.eps))
    # update clipping (Adafactor §5): bound RMS of the update
    rms = torch.sqrt(torch.mean(pre * pre) + 1e-30)
    pre.div_(torch.clamp(rms, min=1.0))
    p32 = _f32(p)
    if p.ndim >= 2:
        pre.add_(cfg.weight_decay * p32)
    p32.sub_(pre.mul_(lr))
    if p32 is not p:
        p.copy_(p32)


def _is_factor_leaf(x: Any) -> bool:
    return isinstance(x, dict) and ("v" in x or "vr" in x)


def make_optimizer(cfg: OptimizerConfig, *, sum_over: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """Returns (init_fn, update_fn).

    init_fn(params) -> opt_state
    update_fn(grads, opt_state, params, step) -> stats

    ``update_fn`` writes the new parameters into ``params`` and the new
    state into ``opt_state``, clips f32 ``grads`` in place, and returns the
    stats ``{"lr", "grad_norm"}`` as 0-dim f32 tensors.  ``opt_state`` is a
    tree of tensors, so it checkpoints like any other state.  Where each
    rank holds a part of the parameters (a pipeline stage), ``sum_over``
    sums the gradients' sum of squares over the ranks, so every rank clips
    by the norm of the whole tree, as the reference's sharded update does.
    """
    schedule = make_schedule(cfg)
    mdt = getattr(torch, cfg.moment_dtype)
    master_dt = getattr(torch, cfg.master_dtype)

    if cfg.kind == "adamw":

        def init(params):
            state = {
                "m": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
            }
            # master copy only when params are lower precision than the master
            # dtype (bf16 params + fp32 master); fp32 params need no copy
            if any(p.dtype != master_dt for p in tree_leaves(params)):
                state["master"] = tree_map(lambda p: p.to(master_dt, copy=True), params)
            return state

        def update(grads, state, params, step) -> Dict[str, torch.Tensor]:
            grads, gnorm = _clip_by_global_norm(tree_leaves(grads), cfg.grad_clip_norm, sum_over)
            lr = schedule(step)
            t = (step + 1).to(_F32)
            bc1 = 1 - torch.pow(cfg.b1, t)
            bc2 = 1 - torch.pow(cfg.b2, t)
            ps = tree_leaves(params)
            masters = tree_leaves(state["master"]) if "master" in state else [None] * len(ps)
            for p, g, m, v, master in zip(
                ps, grads, tree_leaves(state["m"]), tree_leaves(state["v"]), masters
            ):
                _adamw_leaf(cfg, p, g, m, v, master, lr, bc1, bc2)
            return {"lr": lr, "grad_norm": gnorm}

        return init, update

    if cfg.kind == "adafactor":

        def fac_init(p):
            if p.ndim >= 2 and min(p.shape[-2:]) >= cfg.factored_min_dim:
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=_F32, device=p.device),  # row stats
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=_F32, device=p.device),
                }
            return {"v": torch.zeros_like(p, dtype=_F32)}

        def init(params):
            return {"f": tree_map(fac_init, params)}

        def update(grads, state, params, step) -> Dict[str, torch.Tensor]:
            grads, gnorm = _clip_by_global_norm(tree_leaves(grads), cfg.grad_clip_norm, sum_over)
            lr = schedule(step)
            t = (step + 1).to(_F32)
            beta2 = 1.0 - torch.pow(t, -0.8)  # Adafactor's step-dependent decay
            fs = tree_leaves(state["f"], is_leaf=_is_factor_leaf)
            for p, g, f in zip(tree_leaves(params), grads, fs):
                _adafactor_leaf(cfg, p, g, f, lr, beta2)
            return {"lr": lr, "grad_norm": gnorm}

        return init, update

    raise ValueError(f"unknown optimizer {cfg.kind!r}")
