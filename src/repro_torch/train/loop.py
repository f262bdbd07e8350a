"""Training step factory + host-side training loop.

The port of ``repro.train.loop``.  ``make_train_step`` builds the step the
launcher runs: microbatched accumulation of f32 gradients over
``cfg.microbatches`` (mandatory for the big-vocab archs, whose one-batch
logits would not fit), rematerialisation through the model's policy, the
token-mean loss and gradients, clipping, the optimizer update and the
metrics.  It runs eagerly under autograd, so there is no counterpart of
``jax.jit`` and no ``torch.compile``.  The step updates the state's tensors
in place (the reference's launcher donates them to ``jit``) and returns the
same state with its step advanced.  ``make_pipeline_train_step`` is the
pipeline-parallel twin: the same ``(state, batch) -> (state, metrics)``
contract, with the loss and gradients from the 1F1B (or GPipe) schedule of
``repro_torch.dist.pipeline``, each rank stepping its own stage's leaves.
The host loop adds data, checkpointing, straggler and failure hooks, all
pluggable so the FT tests can drive them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.data.pipeline import shard_batch
from repro_torch.dist.sharding import is_dtensor
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import gold_logits
from repro_torch.models.registry import ModelAPI
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.state import TrainState, tree_leaves, tree_map

__all__ = [
    "make_train_step",
    "make_init_state",
    "make_pipeline_train_step",
    "make_pipeline_init_state",
    "train_loop",
    "TrainHooks",
]


def _loss_sum(api: ModelAPI, params, tokens, labels, loss_mask, prefix_embeds):
    logits = api.forward(params, tokens, prefix_embeds)
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = gold_logits(lg, labels)
    nll = (lse - gold) * loss_mask
    return torch.sum(nll), torch.sum(loss_mask)


def make_init_state(api: ModelAPI, opt_cfg: OptimizerConfig):
    """``init_state(gen, device=None) -> TrainState``: parameters drawn from
    the ``torch.Generator`` on ``device`` (``None``: the CUDA card)."""
    init_opt, _ = make_optimizer(opt_cfg)

    def init_state(gen: torch.Generator, device=None) -> TrainState:
        params = api.init_params(gen, device)
        step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
        return TrainState(params=params, opt=init_opt(params), step=step)

    return init_state


def _rows(x: torch.Tensor, rows: slice) -> torch.Tensor:
    """``x[rows]``; a DTensor's microbatch is placed as the batch was.
    DTensor makes a sharded dim whole to slice it, so without this every
    device would run the whole microbatch."""
    part = x[rows]
    return part.redistribute(x.device_mesh, x.placements) if is_dtensor(x) else part


def value_and_grad(api: ModelAPI, params, batch: Dict[str, torch.Tensor], microbatches: int = 1):
    """(nll sum, token count, f32 gradient sums): the loss and gradients of
    ``batch`` summed over its ``microbatches`` slices, each slice's
    gradients added into the f32 sums and dropped before the next slice
    runs.  ``params`` are not modified and need not require grad."""
    tokens, labels, mask = batch["tokens"], batch["labels"], batch["loss_mask"]
    prefix = batch.get("prefix_embeds")
    B, M = tokens.shape[0], microbatches
    if B % M:
        raise ValueError(f"global batch {B} not divisible by microbatches {M}")
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    # zeros_like: a sharded parameter (a DTensor) gets sums sharded alike
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    nll = count = 0.0
    n = B // M
    for i in range(M):
        rows = slice(i * n, (i + 1) * n)
        pre = None if prefix is None else _rows(prefix, rows)
        s, c = _loss_sum(api, live, _rows(tokens, rows), _rows(labels, rows), _rows(mask, rows), pre)
        grads = list(torch.autograd.grad(s, leaves, allow_unused=True))
        for j, a in enumerate(acc):
            if grads[j] is not None:
                a.add_(grads[j])
            grads[j] = None  # free each gradient once it is in the sums
        nll = nll + s.detach()
        count = count + c
    return nll, count, acc


def make_train_step(api: ModelAPI, opt_cfg: OptimizerConfig) -> Callable:
    """(state, batch) -> (state, metrics).  batch: tokens/labels/loss_mask
    (B, S) [+ prefix_embeds (B, P, D)], numpy arrays or tensors — the
    global batch; microbatching is internal (B must be divisible by
    cfg.microbatches).  The state's tensors are updated in place."""
    cfg: ArchConfig = api.cfg
    _, opt_update = make_optimizer(opt_cfg)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        batch = shard_batch(batch, state.step.device)
        nll, count, grads = value_and_grad(api, state.params, batch, cfg.microbatches)
        # token-mean gradients & loss
        for g in grads:
            g.div_(count)
        loss = nll / count
        stats = opt_update(grads, state.opt, state.params, state.step)
        metrics = {
            "loss": loss,
            "tokens": count,
            "grad_norm": stats["grad_norm"],
            "lr": stats["lr"],
        }
        state.step += 1
        return state, metrics

    return train_step


# ------------------------------------------------------- pipeline parallelism
def make_pipeline_init_state(opt_cfg: OptimizerConfig):
    """``init_state(stage_params) -> TrainState`` for a pipeline-parallel
    layer stack: ``stage_params`` are this rank's ``(1, L/S, ...)`` leaves
    (a slice of ``repro_torch.dist.pipeline.stack_stage_params``), on its
    device; the optimizer state is built alike."""
    init_opt, _ = make_optimizer(opt_cfg)

    def init_state(stage_params) -> TrainState:
        step = torch.zeros((), dtype=torch.int32, device=tree_leaves(stage_params)[0].device)
        return TrainState(params=stage_params, opt=init_opt(stage_params), step=step)

    return init_state


def make_pipeline_train_step(
    mesh,
    layer_fn: Callable,
    loss_fn: Callable,
    opt_cfg: OptimizerConfig,
    *,
    microbatches: int,
    axis: str = "pp",
    schedule: str = "1f1b",
) -> Callable:
    """Pipeline-parallel ``(state, batch) -> (state, metrics)``, run by
    every rank of ``mesh``'s ``axis``.

    Same contract as ``make_train_step``, so it drops into ``train_loop``
    and checkpointing unchanged, but the forward and backward run the 1F1B
    (or GPipe) schedule over the ranks:

    - ``state.params``: this rank's ``(1, L/S, ...)`` stage leaves (build
      with ``stack_stage_params`` + ``make_pipeline_init_state``).
    - ``batch``: ``{"inputs": (B, ...), "aux": tree of (B, ...)}`` (numpy
      arrays or tensors, the same on every rank) — split into
      ``microbatches`` microbatches here.
    - ``layer_fn(carry, layer_params) -> carry`` is one layer;
      ``loss_fn(y_mb, aux_mb) -> (loss_sum, count)`` scores the last
      stage's output (the token-mean is formed here).

    Every rank returns the same metrics: loss and count summed over the
    stages, the gradient norm of the whole stack."""
    from repro_torch.dist.pipeline import StageWire, pipeline_value_and_grad

    wire: list = []  # this rank's StageWire, made at the first step on the state's device
    _, opt_update = make_optimizer(opt_cfg, sum_over=lambda t: wire[0].sum(t))

    def train_step(state: TrainState, batch: Dict[str, Any]):
        device = state.step.device
        if not wire:
            wire.append(StageWire(mesh, axis, device))
        inputs = torch.as_tensor(batch["inputs"]).to(device)
        B, M = inputs.shape[0], microbatches
        if B % M:
            raise ValueError(f"global batch {B} not divisible by microbatches {M}")

        def mb(x):
            x = torch.as_tensor(x).to(device)
            return x.reshape((M, B // M) + tuple(x.shape[1:]))

        (nll, count), grads = pipeline_value_and_grad(
            mesh, layer_fn, loss_fn, state.params, mb(inputs), tree_map(mb, batch["aux"]),
            axis=axis, schedule=schedule, wire=wire[0],
        )
        # token-mean gradients & loss, exactly like make_train_step
        for g in tree_leaves(grads):
            g.div_(count)
        loss = nll / count
        stats = opt_update(grads, state.opt, state.params, state.step)
        metrics = {
            "loss": loss,
            "tokens": count,
            "grad_norm": stats["grad_norm"],
            "lr": stats["lr"],
        }
        state.step += 1
        return state, metrics

    return train_step


# ------------------------------------------------------------------ host loop
@dataclass
class TrainHooks:
    """Host-side hooks; all optional.  The FT tests inject failures here."""

    on_step: Optional[Callable[[int, Dict[str, float]], None]] = None
    should_checkpoint: Optional[Callable[[int], bool]] = None
    save_checkpoint: Optional[Callable[[int, TrainState], None]] = None
    on_step_time: Optional[Callable[[int, float], None]] = None  # straggler detector
    preempted: Optional[Callable[[], bool]] = None  # graceful preemption signal


def train_loop(
    train_step: Callable,
    state: TrainState,
    batches: Iterator[Dict[str, Any]],
    num_steps: int,
    hooks: Optional[TrainHooks] = None,
) -> Tuple[TrainState, list]:
    """Run ``num_steps`` steps (or until the data/preemption ends).  A
    step's time runs from its launch until its metrics reach the host."""
    hooks = hooks or TrainHooks()
    history = []
    for _ in range(num_steps):
        if hooks.preempted is not None and hooks.preempted():
            break
        try:
            batch = next(batches)
        except StopIteration:
            break
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        step = int(state.step)
        history.append(metrics)
        if hooks.on_step:
            hooks.on_step(step, metrics)
        if hooks.on_step_time:
            hooks.on_step_time(step, dt)
        if hooks.should_checkpoint and hooks.should_checkpoint(step):
            assert hooks.save_checkpoint is not None
            hooks.save_checkpoint(step, state)
    return state, history
