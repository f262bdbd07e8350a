"""Training launcher of the port.

Assembles the stack — lakehouse corpus + differential-cache data pipeline,
the eager train step, checkpoint manager, straggler detector — and runs it
on one device: the CUDA card unless ``--device`` names another (the tests
pass ``--device cpu``; without a card and without ``--device`` it raises).

``--mesh single|multi`` builds the production mesh (16x16, or 2x16x16)
over the ranks of the process group and trains under its sharding rules:
the state and every batch are DTensors placed by their logical axes.  It
needs as many ranks as the mesh has devices (``torchrun
--nproc-per-node``); with fewer it exits with ``make_mesh``'s message.

``--pipeline S`` switches to the pipeline-parallel trainer: a residual
tanh stack split into S stages, stepped with the 1F1B (or, with
``--pipeline-schedule gpipe``, GPipe) schedule of
``repro_torch.dist.pipeline`` through the same ``train_loop`` /
checkpoint / straggler plumbing.  Where the reference re-execs itself with
S fake CPU devices, the launcher spawns S ranks (one process each) and
joins them; the backend and hop route it chose (``dist.ranks``) are
printed.

Every step appends one JSON line to ``<workdir>/train_log.jsonl``: the
step, its loss, gradient norm, learning rate and tokens, its seconds (from
launch until its metrics reach the host) and the object-store bytes read so
far.  ``--profile-step N`` runs step N under ``torch.profiler`` and prints
the device's busy time, idle share and top device ops.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch granite-3-2b --reduced --steps 50 --batch 4 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch mamba2-780m --reduced --steps 30 --compress-grads
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 8 --batch 4 --seq 1024       # granite-3-2b whole, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --pipeline 4 --steps 30 \\
        [--pipeline-schedule gpipe] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Dict, List

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.cache import DifferentialCache
from repro_torch.core.device import resolve_device
from repro_torch.core.planner import ScanExecutor
from repro_torch.data import TokenBatchPipeline, shard_batch, write_token_corpus
from repro_torch.dist.compression import compress_decompress, init_error_state
from repro_torch.dist.fault import StragglerDetector
from repro_torch.dist.sharding import distribute_tree, use_rules
from repro_torch.lake.catalog import Catalog
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.models.registry import ARCH_IDS, get_config, get_model
from repro_torch.train.loop import (
    TrainHooks,
    _loss_sum,
    make_init_state,
    make_train_step,
    train_loop,
)
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.state import state_logical_axes, tree_leaves, tree_map

__all__ = ["compressed_step", "main"]

LOG_NAME = "train_log.jsonl"
RANK_TIMEOUT_S = 900.0  # the pipeline's ranks must all finish within this


# ------------------------------------------------------------------ pipeline
def _pipeline_layer(x, lp):
    return x + torch.tanh(x @ lp["W"])


def _pipeline_loss(y, aux):
    d = (y - aux["tgt"]).float()
    return torch.sum(d * d), float(d.numel())


def _pipeline_rank(rank, args, work: str) -> None:
    """One stage of ``--pipeline``: the reference's residual tanh stack
    learning a fixed random linear map (L = 2S layers of width 64, 4
    microbatches), drawn with numpy from ``--seed``.  Rank 0 prints, logs
    and writes the checkpoints (the stage-stacked ``(S, L/S, ...)`` state,
    gathered from every rank, in the reference's format)."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.pipeline import StageWire, gather_stages, schedule_report, stack_stage_params
    from repro_torch.train.loop import make_pipeline_init_state, make_pipeline_train_step

    S, lead = rank.world, rank.rank == 0
    L, D, M = 2 * S, 64, 4  # layers, width, microbatches
    MB, SEQ = args.batch, args.seq
    mesh = init_device_mesh(rank.mesh_device, (S,), mesh_dim_names=("pp",))
    wire = StageWire(mesh, "pp", rank.device)

    draws = np.random.default_rng([args.seed, 1])
    # residual init keeps the L-deep tanh stack near-identity at step 0
    Ws = (draws.standard_normal((L, D, D)) * (0.25 * D**-0.5)).astype(np.float32)
    target_map = (draws.standard_normal((D, D)) * D**-0.5).astype(np.float32)
    staged = stack_stage_params({"W": torch.from_numpy(Ws)}, S)
    local = {"W": staged["W"][rank.rank : rank.rank + 1].to(rank.device)}

    opt = OptimizerConfig(kind=args.opt, peak_lr=args.lr, warmup_steps=10,
                          decay_steps=max(args.steps, 100))
    state = make_pipeline_init_state(opt)(local)
    step_fn = make_pipeline_train_step(mesh, _pipeline_layer, _pipeline_loss, opt, microbatches=M,
                                       schedule=args.pipeline_schedule)
    if lead:
        rep = schedule_report(S, M, MB * SEQ * D * 4)
        print(f"[launch] pipeline {args.pipeline_schedule}: {S} stages x {L // S} "
              f"layers | {M} microbatches | bubble "
              f"{rep['bubble_' + args.pipeline_schedule]:.3f} | peak stash "
              f"{rep['peak_stash_bytes_' + args.pipeline_schedule]:,} B/stage")
        print(f"[launch] pipeline ranks: {rank.describe()}", flush=True)

    rng = np.random.default_rng(args.seed)

    def batches():
        while True:
            x = rng.standard_normal((M * MB, SEQ, D)).astype(np.float32)
            yield {"inputs": x, "aux": {"tgt": x @ target_map}}

    mgr = CheckpointManager(os.path.join(work, "ckpt"), keep=3, async_save=True) if lead else None
    det = StragglerDetector()
    log = open(os.path.join(work, LOG_NAME), "a") if lead else None
    losses: List[float] = []
    last: Dict[str, float] = {}

    def save(s: int, st) -> None:  # every rank takes part in the gather
        stacked = gather_stages(wire, st)
        if mgr is not None:
            mgr.save(s, stacked)

    def record(s: int, dt: float) -> None:
        det.record(f"w{rank.rank}", dt)
        if log is not None:
            log.write(json.dumps({"step": s, **last, "seconds": dt}) + "\n")
            log.flush()

    hooks = TrainHooks(
        on_step=lambda s, m: last.update(m) or losses.append(m["loss"]) or (
            print(f"step {s:>4} | loss {m['loss']:.4f} | lr {m['lr']:.2e}", flush=True)
            if lead and s % 10 == 0 else None
        ),
        on_step_time=record,
        should_checkpoint=lambda s: s % args.ckpt_every == 0,
        save_checkpoint=save,
    )
    t0 = time.perf_counter()
    try:
        state, _ = train_loop(step_fn, state, batches(), args.steps, hooks)
    finally:
        if mgr is not None:
            mgr.wait()
        if log is not None:
            log.close()
    if lead:
        print(f"[launch] {args.steps} pipeline steps in {time.perf_counter() - t0:.1f}s | "
              f"loss {losses[0]:.4f} -> {min(losses):.4f} | ckpts {mgr.steps()}", flush=True)


def _pipeline_main(args) -> int:
    """Spawn the ``--pipeline`` ranks, one a stage, and join them."""
    from repro_torch.dist.ranks import spawn_ranks
    from repro_torch.launch import train as by_name  # pickles by module path under ``-m`` too

    device = resolve_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="repro-pp-")
    os.makedirs(work, exist_ok=True)
    spawn_ranks(by_name._pipeline_rank, args.pipeline, work, args=(args, work), device=device.type,
                timeout_s=RANK_TIMEOUT_S)
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile_line(step: int, prof, wall: float, top_n: int = 6) -> str:
    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0) or 0)

    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    if not ops:
        return f"[launch] profile step {step}: wall {wall:.4f} s, device time not measured"
    busy = sum(dev_us(e) for e in ops) / 1e6
    top = sorted(ops, key=dev_us, reverse=True)[:top_n]
    return (
        f"[launch] profile step {step}: wall {wall:.4f} s, device busy {busy:.6f} s, "
        f"idle share {1 - busy / wall:.4f}; top device ops: "
        + "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in top)
    )


def _profiled(step_fn: Callable, at: int, device: torch.device) -> Callable:
    """``step_fn`` with the call that produces step ``at`` profiled."""
    from torch.profiler import ProfilerActivity, profile

    def run(state, batch):
        if int(state.step) + 1 != at:
            return step_fn(state, batch)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            out = step_fn(state, batch)
            _sync(device)
            wall = time.perf_counter() - t
        print(_profile_line(at, prof, wall))
        return out

    return run


def compressed_step(api, opt: OptimizerConfig, err: List[torch.Tensor]) -> Callable:
    """The reference's ``--compress-grads`` step, ``(state, batch) ->
    (state, metrics)`` with the batch as numpy arrays or tensors: the
    gradient of the batch's token-mean loss, compressed and decompressed with error
    feedback (the DP all-reduce wire format; ``err`` holds the residuals),
    then the optimizer update."""
    _, opt_update = make_optimizer(opt)

    def step_fn(state, batch: Dict[str, torch.Tensor]):
        batch = shard_batch(batch, state.step.device)
        live = tree_map(lambda p: p.detach().requires_grad_(), state.params)
        nll, cnt = _loss_sum(api, live, batch["tokens"], batch["labels"],
                             batch["loss_mask"], batch.get("prefix_embeds"))
        lval = nll / torch.clamp(cnt, min=1.0)
        grads = list(torch.autograd.grad(lval, tree_leaves(live)))
        sent, err[:] = compress_decompress(grads, err)
        del grads
        stats = opt_update(sent, state.opt, state.params, state.step)
        state.step += 1
        return state, {"loss": lval.detach(), **stats, "tokens": 0.0}

    return step_fn


# ---------------------------------------------------------------------- mesh
def _mesh_rules(args, cfg, device: torch.device):
    """The production mesh over the process group's ranks and the arch's
    rules.  A launch under ``torchrun`` (``WORLD_SIZE`` set) joins its
    group first, with the backend ``dist.ranks.backend_for`` picks; with
    fewer ranks than the mesh has devices this exits with ``make_mesh``'s
    message."""
    import torch.distributed as dist

    from repro_torch.dist.ranks import backend_for
    from repro_torch.launch.mesh import describe_mesh, make_production_mesh, rules_for

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        backend, _ = backend_for(world, device.type)
        dist.init_process_group(backend, init_method="env://")
        print(f"[launch] {world} ranks | backend {backend}")
    try:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi", device=device.type)
    except RuntimeError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}") from None
    print(f"[launch] mesh {describe_mesh(mesh)}")
    return rules_for(cfg, mesh)


def _whole(state):
    """``state`` with every DTensor gathered whole (a collective all ranks
    join); the checkpoint then holds the reference's full arrays."""
    from repro_torch.dist.sharding import is_dtensor

    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, state)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--opt", choices=["adamw", "adafactor"], default="adamw")
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--pipeline", type=int, default=0, metavar="S",
                    help="pipeline-parallel 1F1B trainer over S stages")
    ap.add_argument("--pipeline-schedule", choices=["1f1b", "gpipe"],
                    default="1f1b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    ap.add_argument("--profile-step", type=int, default=0, metavar="N",
                    help="run step N under torch.profiler and print its device time")
    args = ap.parse_args(argv)

    if args.pipeline > 1:
        return _pipeline_main(args)
    device = resolve_device(args.device)

    work = args.workdir or tempfile.mkdtemp(prefix="repro-launch-")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    print(f"[launch] {args.arch}{' (reduced)' if args.reduced else ''}: "
          f"{cfg.param_count()/1e6:.1f}M params | {cfg.dtype} on {device} | workdir {work}")

    # ---- mesh + rules (none by default; a production mesh needs its ranks)
    rules = _mesh_rules(args, cfg, device) if args.mesh != "none" else None
    lead = rules is None or rules.mesh.get_rank() == 0

    # ---- lakehouse corpus through the differential cache
    store = ObjectStore(os.path.join(work, "s3"))
    catalog = Catalog(store, rows_per_fragment=1 << 16)
    table = "data.corpus"
    need = args.batch * (args.seq + 1) * max(args.steps // 4, 2)
    # idempotent: a resumed workdir keeps its corpus (no duplicate keys),
    # a larger run tops it up with the missing tail only
    write_token_corpus(catalog, table, need, cfg.vocab_size, seed=args.seed)
    scans = ScanExecutor(store, catalog, cache=DifferentialCache())
    pipe = TokenBatchPipeline(
        scans, table, global_batch=args.batch, seq_len=args.seq, prefetch_depth=2
    )

    # ---- train step (+ optional EF-int8 gradient compression wrapper)
    opt = OptimizerConfig(kind=args.opt, peak_lr=args.lr, warmup_steps=10,
                          decay_steps=max(args.steps, 100))
    state = make_init_state(api, opt)(torch.Generator(device=device).manual_seed(args.seed), device)

    # ---- FT wiring
    mgr = CheckpointManager(os.path.join(work, "ckpt"), keep=3, async_save=True)
    det = StragglerDetector()
    if args.resume and mgr.latest() is not None:
        step0, state = mgr.restore(target_struct=state)
        pipe.step = step0
        print(f"[launch] resumed from step {step0}")
    if rules is not None:  # the state and every batch as DTensors placed by their logical axes
        state = distribute_tree(state, state_logical_axes(api.param_logical_axes(), state.opt), rules)

    losses: List[float] = []
    log = open(os.path.join(work, LOG_NAME), "a")

    def record(step: int, m: Dict[str, float], dt: float) -> None:
        det.record("w0", dt)
        line = {"step": step, **m, "seconds": dt, "store_bytes": store.stats.bytes_read}
        log.write(json.dumps(line) + "\n")
        log.flush()

    batches = (shard_batch(b, device) for b in iter(pipe))
    if rules is not None:
        batches = (distribute_tree(b, {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in b.items()}, rules)
                   for b in batches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.compress_grads:  # as in the reference, this branch does not checkpoint
        step_fn = compressed_step(api, opt, init_error_state(tree_leaves(state.params)))
    else:
        step_fn = make_train_step(api, opt)
    if args.profile_step:
        step_fn = _profiled(step_fn, args.profile_step, device)
    tag = " (EF-int8 grads)" if args.compress_grads else ""
    last: Dict[str, float] = {}
    hooks = TrainHooks(
        on_step=lambda s, m: last.update(m) or losses.append(m["loss"]) or (
            print(f"step {s:>4} | loss {m['loss']:.4f} | lr {m['lr']:.2e}{tag}")
            if s % 10 == 0 else None
        ),
        on_step_time=lambda s, dt: record(s, dict(last), dt),
        should_checkpoint=None if args.compress_grads else (lambda s: s % args.ckpt_every == 0),
        save_checkpoint=lambda s, st: (mgr.save(s, _whole(st)) if lead else _whole(st)),
    )
    t0 = time.perf_counter()
    try:
        with use_rules(rules):
            state, _ = train_loop(step_fn, state, batches, args.steps, hooks)
    finally:
        mgr.wait()
        pipe.close()
        log.close()

    dt = time.perf_counter() - t0
    peak = (f" | peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"
            if device.type == "cuda" else "")
    print(f"[launch] {args.steps} steps in {dt:.1f}s | "
          f"loss {losses[0]:.4f} -> {min(losses):.4f} | "
          f"store bytes {store.stats.bytes_read:,} | ckpts {mgr.steps()}{peak}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
