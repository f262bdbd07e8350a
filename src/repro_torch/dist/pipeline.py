"""Microbatched pipeline parallelism over ranks (GPipe + 1F1B).

The port of ``repro.dist.pipeline``.  ``stack_stage_params`` reshapes a
layer-stacked tree ``(L, ...)`` into per-stage slices ``(S, L/S, ...)``;
each rank of the ``pp`` group holds only its own ``(1, L/S, ...)`` slice.
Two schedules run on top of that layout:

- :func:`pipeline_forward` — the forward-only GPipe stream (fill/drain in
  ``M + S - 1`` ticks, bubble ``(S-1)/(M+S-1)``).
- :func:`pipeline_value_and_grad` — the training schedule with a real
  backward pass and per-stage f32 gradient accumulation: ``"1f1b"``
  (default) stashes only the in-flight microbatch inputs (``min(S, M)``
  slots) and rematerialises the stage forward inside the backward tick;
  ``"gpipe"`` sweeps all forwards, then all backwards, with an ``M``-slot
  stash.

Both equal the sequential layer stack: the backward is the exact gradient
of the stage forward, recomputed from the stashed input under autograd,
and the layer gradients accumulate in f32 in microbatch order.

Tick clock (both schedules, ``T = 2(M + S - 1)`` ticks), the reference's:

- 1F1B: ``F(s, m)`` at tick ``s + m`` while ``m < S - s`` (warmup), then
  ``s + 2m``; ``B(s, k)`` at tick ``2S - 1 - s + 2k``.
- GPipe: ``F(s, m)`` at ``s + m``; ``B(s, k)`` at ``(M+S-1) + (S-1-s) + k``.

The reference is one SPMD program under ``shard_map``: its ``ppermute``
hops run every tick on every stage, and receivers ignore what their
schedule marks invalid.  Here each stage is a process (``dist.ranks``), and
a tick's hops are point-to-point: a stage sends its activation forward and
its cotangent backward only when the receiver's schedule reads them, and
both hops of a tick go as one ``dist.batch_isend_irecv``.  An activation
lands in the receiver's stash slot at the end of the tick it was sent,
where the reference writes it at the start of the next.  The last stage
runs no forward of its own: its output would go nowhere (the reference
sends it round the ring to stage 0, which drops it), and its backward
rematerialises from the stash.  Loss and token count are summed over the
group at the end (the reference's ``psum``).

Over NCCL the hops carry device tensors.  Over gloo (ranks sharing one
card, or on the CPU) they carry host tensors; ranks on a card copy each
message through a pinned host buffer (``dist.ranks.backend_for``).

Interleaved virtual stages are modelled in :func:`schedule_report`, as in
the reference, and not executed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.train.state import tree_leaves, tree_map

__all__ = [
    "stack_stage_params",
    "unstack_stage_params",
    "pipeline_forward",
    "pipeline_value_and_grad",
    "schedule_report",
    "gather_stages",
    "StageWire",
]


def _restack(leaf, n_stages: int):
    L = leaf.shape[0]
    if L % n_stages:
        raise ValueError(f"cannot split {L} layers into {n_stages} equal stages")
    return leaf.reshape((n_stages, L // n_stages) + tuple(leaf.shape[1:]))


def stack_stage_params(params: Any, n_stages: int) -> Any:
    """``(L, ...)`` layer-stacked leaves (tensors or numpy arrays) ->
    ``(S, L/S, ...)`` stage-stacked, contiguous layer ranges per stage."""
    return tree_map(lambda leaf: _restack(leaf, n_stages), params)


def unstack_stage_params(stage_params: Any) -> Any:
    """Inverse of :func:`stack_stage_params`: ``(S, L/S, ...)`` -> ``(L, ...)``."""
    return tree_map(
        lambda leaf: leaf.reshape((leaf.shape[0] * leaf.shape[1],) + tuple(leaf.shape[2:])),
        stage_params,
    )


# ------------------------------------------------------------------- the wire
class StageWire:
    """The hops and sums of one rank in a 1-D stage group.

    ``mesh``: a 1-D ``DeviceMesh`` whose dim ``axis`` orders the stages.
    ``device``: where this rank computes.  Over NCCL a message is the
    device tensor itself; over gloo it is a host tensor, copied through a
    pinned buffer when the rank computes on a card."""

    def __init__(self, mesh, axis: str, device: torch.device):
        self.group = mesh.get_group(axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.stage = self.ranks.index(dist.get_rank())
        self.n_stages = len(self.ranks)
        self.device = device
        self.backend = dist.get_backend(self.group)
        self.via_pinned = device.type == "cuda" and self.backend != "nccl"
        self._pinned: Dict[Tuple[str, Tuple[int, ...], torch.dtype], torch.Tensor] = {}
        if self.backend == "nccl":
            # NCCL needs every rank of a group in its first call, and the
            # first tick's batch holds only stages 0 and 1: a collective
            # of all of them comes first
            dist.all_reduce(torch.zeros(1, device=device), group=self.group)
        self.stash_shape: Tuple[int, ...] = ()  # the input stash of the last training call

    def _buf(self, tag: str, like: torch.Tensor) -> torch.Tensor:
        key = (tag, tuple(like.shape), like.dtype)
        if key not in self._pinned:
            self._pinned[key] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return self._pinned[key]

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
        """Send each ``(tensor, stage)`` and receive into each
        ``(destination, stage)``, all as one batch; returns once every
        message is in place."""
        if not sends and not recvs:
            return
        ops, landings = [], []
        for i, (t, peer) in enumerate(sends):
            if self.via_pinned:
                buf = self._buf(f"send{i}", t)
                buf.copy_(t)
                t = buf
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self.ranks[peer], self.group))
        for i, (dst, peer) in enumerate(recvs):
            buf = self._buf(f"recv{i}", dst) if self.via_pinned else dst
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[peer], self.group))
            if buf is not dst:
                landings.append((dst, buf))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for dst, buf in landings:
            dst.copy_(buf)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group (the reference's ``psum``)."""
        wire = t.to("cpu", copy=True) if self.via_pinned else t.clone()
        dist.all_reduce(wire, group=self.group)
        return wire.to(self.device)

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        wire = t.to("cpu", copy=True) if self.via_pinned else t.contiguous()
        dist.broadcast(wire, self.ranks[stage], group=self.group)
        return wire.to(self.device)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every stage's ``t`` stacked on a new leading dim, on every rank."""
        wire = t.to("cpu", copy=True) if self.via_pinned else t.contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.n_stages)]
        dist.all_gather(parts, wire, group=self.group)
        return torch.stack(parts).to(self.device)


def gather_stages(wire: StageWire, tree: Any) -> Any:
    """A tree of ``(1, L/S, ...)`` stage leaves -> the ``(S, L/S, ...)``
    tree on every rank; 0-dim leaves (the step) are taken as they are."""
    return tree_map(lambda t: t if t.ndim == 0 else wire.gather(t[0]), tree)


# ------------------------------------------------------------------ schedules
def _sched_1f1b(S: int, M: int, s: int, t: int) -> Tuple[int, bool, int, bool]:
    """(fwd_mb, fwd_ok, bwd_mb, bwd_ok) for stage ``s`` at tick ``t``, the
    reference's integer arithmetic (floor division and modulo as Python's).

    Warmup: stage ``s`` forwards microbatches ``m < S - s`` at ticks
    ``s + m``; steady state forwards at ``s + 2m`` and backwards microbatch
    ``k`` at ``2S - 1 - s + 2k`` (one tick after stage ``s+1``'s backward,
    so the cotangent hop is consumed the tick after it is sent)."""
    w = S - s  # in-flight bound for this stage == its warmup depth
    warm_m = t - s
    is_warm = 0 <= warm_m < min(w, M)
    steady_m = (t - s) // 2
    is_steady = (t - s) % 2 == 0 and w <= steady_m < M
    fwd_mb = warm_m if is_warm else steady_m
    b = t - (2 * S - 1 - s)
    bwd_ok = b >= 0 and b % 2 == 0 and b // 2 < M
    return fwd_mb, is_warm or is_steady, b // 2, bwd_ok


def _sched_gpipe(S: int, M: int, s: int, t: int) -> Tuple[int, bool, int, bool]:
    """GPipe on the same clock: forward sweep then mirrored backward sweep."""
    fwd_mb = t - s
    b = t - (M + S - 1) - (S - 1 - s)
    return fwd_mb, 0 <= fwd_mb < M, b, 0 <= b < M


def _rebuild(tree: Any, leaves: Sequence[Any]) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _stage_layers(tree: Any) -> List[Any]:
    """A ``(L/S, ...)`` tree as its per-layer trees (one ``unbind`` a leaf,
    so the backward stacks each leaf's gradient once)."""
    per_leaf = [torch.unbind(leaf) for leaf in tree_leaves(tree)]
    return [_rebuild(tree, [p[i] for p in per_leaf]) for i in range(len(per_leaf[0]))]


def _stage_apply(fn: Callable, layers: Sequence[Any], x: torch.Tensor) -> torch.Tensor:
    for lp in layers:
        x = fn(x, lp)
    return x


def _take(tree: Any, m: int) -> Any:
    return tree_map(lambda a: a[m], tree)


def _local(stage_params: Any) -> Any:
    """The rank's ``(1, L/S, ...)`` leaves without the stage dim."""
    def drop(a):
        if a.shape[0] != 1:
            raise ValueError(f"a rank holds one stage's leaves (1, L/S, ...), got {tuple(a.shape)}")
        return a[0]

    return tree_map(drop, stage_params)


def pipeline_forward(
    mesh,
    fn: Callable[[torch.Tensor, Any], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    axis: str = "pp",
) -> torch.Tensor:
    """Run ``fn`` (one layer: ``(carry, layer_params) -> carry``) over all
    stages for every microbatch.

    ``stage_params``: this rank's ``(1, L/S, ...)`` leaves.  ``x``:
    ``(M, *microbatch_shape)`` microbatches, the same on every rank.
    Returns ``(M, *microbatch_shape)`` on every rank, equal to applying all
    ``L`` layers sequentially to each microbatch."""
    wire = StageWire(mesh, axis, x.device)
    S, s, M = wire.n_stages, wire.stage, x.shape[0]
    layers = _stage_layers(_local(stage_params))
    state = torch.empty_like(x[0])
    outs = torch.zeros_like(x)
    with torch.no_grad():
        for t in range(M + S - 1):
            m = t - s  # the microbatch this stage holds this tick
            sends, recvs = [], []
            if 0 <= m < M:
                y = _stage_apply(fn, layers, x[m] if s == 0 else state)
                if s == S - 1:
                    outs[m] = y
                else:
                    sends.append((y, s + 1))
            if s > 0 and 0 <= t + 1 - s < M:
                recvs.append((state, s - 1))
            wire.exchange(sends, recvs)
    return wire.broadcast(outs, S - 1)  # only the last stage holds the outputs


def pipeline_value_and_grad(
    mesh,
    fn: Callable[[torch.Tensor, Any], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Any]],
    stage_params: Any,
    xs: torch.Tensor,
    aux: Any,
    axis: str = "pp",
    schedule: str = "1f1b",
    wire: Optional[StageWire] = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Any]:
    """Pipeline-parallel loss + parameter gradients with microbatch
    accumulation.

    ``fn``: one layer, ``(carry, layer_params) -> carry``.  ``loss_fn``:
    applied to the LAST stage's output per microbatch, ``(y_mb, aux_mb) ->
    (loss_sum, count)``.  ``stage_params``: this rank's ``(1, L/S, ...)``
    leaves (they need not require grad and are not modified).  ``xs``:
    ``(M, *microbatch_shape)`` microbatches; ``aux``: a tree of ``(M, ...)``
    leaves consumed by ``loss_fn``; both the same on every rank.

    Returns ``((loss_sum, count), grads)`` with the sums over the group on
    every rank and ``grads`` this rank's f32 ``(1, L/S, ...)`` tree — equal
    to the gradient of the summed sequential loss.  ``wire`` reuses a
    rank's pinned buffers across calls."""
    if schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    sched = _sched_1f1b if schedule == "1f1b" else _sched_gpipe
    wire = wire or StageWire(mesh, axis, xs.device)
    S, s, M = wire.n_stages, wire.stage, xs.shape[0]
    first, last = s == 0, s == S - 1
    n_slots = M if schedule == "gpipe" else min(S, M)

    local = _local(stage_params)
    layers = _stage_layers(local)
    live = [p.detach().requires_grad_() for p in tree_leaves(local)]
    live_tree = _rebuild(local, live)
    gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in live]
    stash = torch.zeros((n_slots,) + tuple(xs.shape[1:]), dtype=xs.dtype, device=xs.device)
    wire.stash_shape = tuple(stash.shape)
    cotangent = torch.zeros_like(xs[0])
    lacc = torch.zeros((), dtype=torch.float32, device=xs.device)
    cacc = torch.zeros((), dtype=torch.float32, device=xs.device)

    for t in range(2 * (M + S - 1)):
        fm, f_ok, bm, b_ok = sched(S, M, s, t)
        sends: List[Tuple[torch.Tensor, int]] = []

        # -- forward: stage 0 stashes its own input for the backward remat;
        # the others read what arrived in their stash
        if f_ok:
            slot = fm % n_slots
            if first:
                stash[slot].copy_(xs[fm])
            if not last:
                with torch.no_grad():
                    sends.append((_stage_apply(fn, layers, stash[slot]), s + 1))

        # -- backward: remat the stage forward from the stashed input and
        # pull the arriving cotangent (or the loss seed) through it
        if b_ok:
            x_in = stash[bm % n_slots].detach().requires_grad_(not first)
            wrt = live + ([] if first else [x_in])
            with torch.enable_grad():
                y = _stage_apply(fn, _stage_layers(live_tree), x_in)
                if last:
                    l, c = loss_fn(y, _take(aux, bm))
                    pulled = torch.autograd.grad(l, wrt)
                    lacc += l.detach().float()
                    cacc += torch.as_tensor(c, dtype=torch.float32, device=xs.device)
                else:
                    pulled = torch.autograd.grad(y, wrt, grad_outputs=cotangent)
            for a, g in zip(gacc, pulled[: len(live)]):
                a.add_(g.float())
            if not first:
                sends.append((pulled[-1], s - 1))

        # -- the hops: what the neighbours send this tick lands before the
        # next one (the activation in its microbatch's stash slot)
        recvs: List[Tuple[torch.Tensor, int]] = []
        if not first:
            pm, p_ok, _, _ = sched(S, M, s - 1, t)
            if p_ok:
                recvs.append((stash[pm % n_slots], s - 1))
        if not last and sched(S, M, s + 1, t)[3]:
            recvs.append((cotangent, s + 1))
        wire.exchange(sends, recvs)

    loss = wire.sum(lacc)  # only the last stage contributes
    count = wire.sum(cacc)
    grads = _rebuild(local, [g[None] for g in gacc])
    return (loss, count), grads


# ------------------------------------------------------------------ analysis
def schedule_report(
    n_stages: int,
    n_micro: int,
    microbatch_bytes: int,
    n_virtual: int = 1,
) -> Dict[str, float]:
    """Analytic schedule comparison (the numbers ``train_bench`` prints).

    Bubble fraction counts idle ticks per stage over the whole step; with
    one-tick forward AND backward units both GPipe and non-interleaved 1F1B
    idle ``2(S-1)`` of ``2(M+S-1)`` ticks — 1F1B's win is memory, not
    bubble.  Interleaving ``v`` virtual stages per device divides the
    per-chunk fill time, shrinking the bubble to ``(S-1)/(vM+S-1)``.

    Peak stash = microbatch *inputs* a stage must hold for its backward:
    GPipe stashes all ``M``; 1F1B at stage ``s`` holds only the ``S - s``
    in-flight microbatches (``min(S, M)`` at stage 0).
    """
    S, M, v = n_stages, n_micro, n_virtual
    if S < 1 or M < 1 or v < 1:
        raise ValueError("n_stages, n_micro, n_virtual must be >= 1")
    bubble = (S - 1) / (M + S - 1)
    return {
        "n_stages": S,
        "n_micro": M,
        "ticks": 2 * (M + S - 1),
        "bubble_gpipe": bubble,
        "bubble_1f1b": bubble,
        "bubble_1f1b_interleaved": (S - 1) / (v * M + S - 1),
        "peak_stash_micro_gpipe": M,
        "peak_stash_micro_1f1b": min(S, M),
        "peak_stash_bytes_gpipe": M * microbatch_bytes,
        "peak_stash_bytes_1f1b": min(S, M) * microbatch_bytes,
    }
