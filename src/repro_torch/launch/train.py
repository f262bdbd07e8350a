"""Training launcher of the port.

Assembles the stack — lakehouse corpus + differential-cache data pipeline,
the eager train step, checkpoint manager, straggler detector — and runs it
on one device: the CUDA card unless ``--device`` names another (the tests
pass ``--device cpu``; without a card and without ``--device`` it raises).
The reference's ``--mesh single|multi`` and ``--pipeline S`` wait for the
port's ``dist/`` and ``launch/`` slice and exit with a message.

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
from repro_torch.train.state import tree_leaves, tree_map

__all__ = ["compressed_step", "main"]

LOG_NAME = "train_log.jsonl"


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    ap.add_argument("--profile-step", type=int, default=0, metavar="N",
                    help="run step N under torch.profiler and print its device time")
    args = ap.parse_args(argv)

    if args.pipeline > 1:
        raise SystemExit("--pipeline waits for the port's dist/pipeline and launch/ slice (ROADMAP A8, A9)")
    if args.mesh != "none":
        raise SystemExit("--mesh single|multi waits for the port's dist/sharding and launch/ slice (ROADMAP A8, A9)")
    device = resolve_device(args.device)

    work = args.workdir or tempfile.mkdtemp(prefix="repro-launch-")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    print(f"[launch] {args.arch}{' (reduced)' if args.reduced else ''}: "
          f"{cfg.param_count()/1e6:.1f}M params | {cfg.dtype} on {device} | workdir {work}")

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

    losses: List[float] = []
    log = open(os.path.join(work, LOG_NAME), "a")

    def record(step: int, m: Dict[str, float], dt: float) -> None:
        det.record("w0", dt)
        line = {"step": step, **m, "seconds": dt, "store_bytes": store.stats.bytes_read}
        log.write(json.dumps(line) + "\n")
        log.flush()

    batches = (shard_batch(b, device) for b in iter(pipe))
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
        save_checkpoint=lambda s, st: mgr.save(s, st),
    )
    t0 = time.perf_counter()
    try:
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
