"""End-to-end training run on the PyTorch port: lakehouse corpus →
differential cache → packed batches → eager train step on the CUDA card →
checkpoints, with fault-tolerance hooks wired in.

Trains a ~100M-parameter granite-family model for a few hundred steps on
a synthetic corpus (use --steps 30 for a quick look).  Demonstrates:

  - epoch 2+ reads ZERO bytes from object storage (differential cache),
  - checkpoint/restart mid-run (kill -9 safe: atomic publishes; a second
    run on the same --workdir resumes from the newest checkpoint),
  - straggler detection hooks on step times.

The step updates the state's tensors in place (the port's counterpart of
donating them to a jitted step); the asynchronous checkpoint copies the
state to the host before it returns, so the next step may write into it.

Run:  python examples/torch/train_e2e.py --steps 200 [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.cache import DifferentialCache
from repro_torch.core.device import resolve_device
from repro_torch.core.planner import ScanExecutor
from repro_torch.data import TokenBatchPipeline, write_token_corpus
from repro_torch.dist.fault import StragglerDetector
from repro_torch.lake.catalog import Catalog
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.models import get_config, get_model
from repro_torch.train.loop import TrainHooks, make_init_state, make_train_step, train_loop
from repro_torch.train.optimizer import OptimizerConfig


def build_100m_config():
    """~100M params in the granite family (real sizes, CPU-trainable)."""
    base = get_config("granite-3-2b")
    return dataclasses.replace(
        base,
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=2, head_dim=64,
        d_ff=1536, vocab_size=8192, dtype="float32", remat="none", microbatches=1,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    work = args.workdir or tempfile.mkdtemp(prefix="repro-train-")
    cfg = build_100m_config()
    api = get_model(cfg)
    n_params = cfg.param_count()
    print(f"arch: granite-family {n_params/1e6:.0f}M params | "
          f"B={args.batch} S={args.seq} steps={args.steps}")

    # ---- lakehouse corpus (written once; epochs are cache-served scans)
    store = ObjectStore(os.path.join(work, "s3"))
    catalog = Catalog(store, rows_per_fragment=1 << 18)
    need = args.batch * (args.seq + 1) * max(args.steps // 4, 1)
    write_token_corpus(catalog, "data.corpus", need, cfg.vocab_size, seed=0)
    scans = ScanExecutor(store, catalog, cache=DifferentialCache())
    pipe = TokenBatchPipeline(
        scans, "data.corpus", global_batch=args.batch, seq_len=args.seq,
        prefetch_depth=2,
    )
    print(f"corpus: {pipe.total_tokens:,} tokens, {pipe.steps_per_epoch} steps/epoch")

    # ---- train step + state (updated in place by every step)
    opt = OptimizerConfig(kind="adamw", peak_lr=3e-4, warmup_steps=20,
                          decay_steps=args.steps)
    step_fn = make_train_step(api, opt)
    state = make_init_state(api, opt)(torch.Generator().manual_seed(0), device)

    # ---- FT hooks: checkpoints + straggler detection
    mgr = CheckpointManager(os.path.join(work, "ckpt"), keep=2, async_save=True)
    det = StragglerDetector(z_threshold=4.0, patience=3)
    if mgr.latest() is not None:  # restart path
        step0, state = mgr.restore(target_struct=state)
        pipe.step = step0
        print(f"resumed from checkpoint step {step0}")

    losses = []
    step_seconds = []
    t_start = time.perf_counter()

    def on_step(step, metrics):
        losses.append(metrics["loss"])
        if step % 10 == 0 or step == 1:
            ep = (step * pipe.tokens_per_step) // max(pipe.total_tokens, 1)
            print(f"step {step:>4} | loss {metrics['loss']:.4f} | "
                  f"lr {metrics['lr']:.2e} | gnorm {metrics['grad_norm']:.2f} | "
                  f"epoch {ep} | store bytes so far {store.stats.bytes_read:,}")

    def on_step_time(step, dt):
        step_seconds.append(dt)
        det.record("worker0", dt)

    ckpt_every = max(min(50, args.steps // 2), 10)
    hooks = TrainHooks(
        on_step=on_step,
        on_step_time=on_step_time,
        should_checkpoint=lambda s: s % ckpt_every == 0,
        save_checkpoint=lambda s, st: mgr.save(s, st, extra={"data_step": s}),
    )
    state, history = train_loop(step_fn, state, iter(pipe), args.steps, hooks)
    mgr.wait()
    pipe.close()

    dt = time.perf_counter() - t_start
    toks = args.steps * args.batch * args.seq
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"\ndone: {args.steps} steps, {toks/dt:,.0f} tokens/s on {where}")
    print(f"loss: {losses[0]:.4f} -> {min(losses):.4f} (must decrease)")
    print(f"object-store bytes read: {store.stats.bytes_read:,} "
          f"(epoch 2+ served from the differential cache)")
    print(f"checkpoints kept: {mgr.steps()} under {os.path.join(work, 'ckpt')}")
    need_drop = 0.3 if args.steps >= 150 else 0.02
    assert min(losses) < losses[0] - need_drop, "training must make progress"
    return {"losses": losses, "step_seconds": step_seconds, "tokens_per_step": args.batch * args.seq,
            "store_bytes": store.stats.bytes_read, "checkpoints": mgr.steps()}


if __name__ == "__main__":
    main()
