"""Traffic kind ``pretrain``: one training job fed from the lake.

Set-up draws the corpus from the seed and writes it into a lake table,
draws the initial weights on the card, and builds the program's objects as
``launch/train.py`` wires them: a ``ScanExecutor`` over a
``DifferentialCache``, a ``TokenBatchPipeline`` with its prefetching
thread, the state and ``make_train_step``'s step.  It then drives that one
state through its first ``checked_steps`` steps with ``train_loop``, the
window's own call and feed, which warms every shape, and reads what the
check compares: each step's loss, the first gradient as the optimizer
holds it (its first moment over ``1 - b1``), and the change of the master
weights after those steps.  The window hands the same state and feed to
``train_loop`` until ``seconds`` have passed.

The corpus holds more steps than the window could take at the card's
roofline, so no run reaches a second epoch.  Once the window has closed
and the peak memory is read, the program's state is freed and the plain
float32 reference trains the same weights on the same batches.
"""

from __future__ import annotations

import gc
import math
import os
import time
from typing import Any, Dict

import numpy as np

from portbench.harness import corpus, devices, weights, yardstick
from portbench.harness.record import Check, Run
from portbench.harness.trace import DeviceTrace, HostSpans


def arch_config(config: Dict[str, Any]):
    """The port's ``ArchConfig`` for the configuration file's keys."""
    from repro_torch.models.config import ArchConfig

    tr = config["training"]
    return ArchConfig(
        name=config["name"], family="dense",
        num_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"], num_kv_heads=config["num_key_value_heads"],
        head_dim=config["hidden_size"] // config["num_attention_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"], mlp="swiglu",
        rope_theta=config["rope_theta"], norm_eps=config["rms_norm_eps"],
        tie_embeddings=config["tie_word_embeddings"], dtype=tr["dtype"], remat=tr["remat"],
        microbatches=tr["microbatches"],
    )


def optimizer_config(config: Dict[str, Any]):
    from repro_torch.train.optimizer import OptimizerConfig

    o = config["training"]["optimizer"]
    return OptimizerConfig(
        kind=o["kind"], peak_lr=o["peak_lr"], warmup_steps=o["warmup_steps"],
        decay_steps=o["decay_steps"], min_lr_ratio=o["min_lr_ratio"], b1=o["b1"], b2=o["b2"],
        eps=o["eps"], weight_decay=o["weight_decay"], grad_clip_norm=o["grad_clip_norm"],
        moment_dtype=config["training"]["moment_dtype"],
        master_dtype=config["training"]["master_dtype"],
    )


def corpus_steps(config: Dict[str, Any], traffic: Dict[str, Any], seconds: float) -> int:
    """Steps the corpus holds: the traffic's ``corpus_steps`` where it states
    them, else more than the set-up's and the window's could be even at the
    card's roofline, with the prefetcher's lead and a minute's margin."""
    if "corpus_steps" in traffic:
        return int(traffic["corpus_steps"])
    B, S = traffic["global_batch"], traffic["seq_len"]
    bound_s = B * S * yardstick.train_flops_per_token(config, S) / yardstick.BF16_FLOP_PER_S
    return int(math.ceil((seconds + 60.0) / bound_s)) + traffic["checked_steps"] + traffic["prefetch_depth"] + 2


def run(config: Dict[str, Any], traffic: Dict[str, Any], seed: int, seconds: float,
        trace: bool, workdir: str, device: str, clock0: float) -> Run:
    import torch
    from repro_torch.core.cache import DifferentialCache
    from repro_torch.core.columnar import Table
    from repro_torch.core.planner import ScanExecutor
    from repro_torch.data.pipeline import TokenBatchPipeline, shard_batch
    from repro_torch.lake.catalog import Catalog
    from repro_torch.lake.s3sim import ObjectStore
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import TrainHooks, make_train_step, train_loop
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.state import TrainState, tree_leaves

    from portbench.reference.granite import gaps, moved_leaves, train_steps

    cuda = torch.device(device).type == "cuda"
    out = Run("pretrain", config, traffic)
    B, S = traffic["global_batch"], traffic["seq_len"]
    cfg, opt_cfg = arch_config(config), optimizer_config(config)
    api = get_model(cfg)
    dtype = getattr(torch, config["training"]["dtype"])
    names = [n for n, _s, _f in weights.leaves(config)]
    spans = HostSpans()

    # -- set-up: the corpus in the lake, the pipeline, the weights, the state
    steps = corpus_steps(config, traffic, seconds)
    data = corpus.tokens(seed, steps * B * (S + 1), config["vocab_size"],
                         traffic["mean_doc_len"], traffic["eos_id"])
    store = ObjectStore(os.path.join(workdir, "s3"))
    catalog = Catalog(store, rows_per_fragment=traffic["rows_per_fragment"])
    ns, name = traffic["table"].rsplit(".", 1)
    catalog.create_table(ns, name, corpus.SCHEMA, "pos")
    catalog.append(traffic["table"], Table(data))
    scans = ScanExecutor(store, catalog, cache=DifferentialCache())
    pipe = TokenBatchPipeline(scans, traffic["table"], global_batch=B, seq_len=S,
                              prefetch_depth=traffic["prefetch_depth"])
    served = []
    waits = []

    def feed():
        it = iter(pipe)
        try:
            while True:
                t = time.perf_counter()
                with spans.span("data.fetch"):
                    b = next(it)
                    served.append(b)
                    placed = shard_batch(b, device)
                waits.append(time.perf_counter() - t)
                yield placed
        finally:
            it.close()

    params = weights.make(config, seed, device, dtype)
    init_opt, _ = make_optimizer(opt_cfg)
    state = TrainState(params=params, opt=init_opt(params),
                       step=torch.zeros((), dtype=torch.int32, device=device))
    del params
    step_fn = make_train_step(api, opt_cfg)

    def timed_step(st, batch):
        with spans.span("train.step"):
            return step_fn(st, batch)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    batches = feed()
    program: Dict[str, Any] = {"losses": []}
    flat_m = lambda: dict(zip(_flat_names(state.params), tree_leaves(state.opt["m"])))

    def on_step(step: int, metrics: Dict[str, float]) -> None:
        program["losses"].append(metrics["loss"])
        if step == 1:
            program["grad_norms"] = {n: float(torch.linalg.vector_norm(m.float())) / (1 - opt_cfg.b1)
                                     for n, m in flat_m().items()}

    checked = traffic["checked_steps"]
    state, _ = train_loop(timed_step, state, batches, checked, TrainHooks(on_step=on_step))
    # the f32 master weights; parameters stored in f32 are their own master
    masters = dict(zip(_flat_names(state.params), tree_leaves(state.opt.get("master", state.params))))
    program["change_norms"] = {
        n: float(torch.linalg.vector_norm(masters[n] - weights.draw(config, seed, n, device, dtype).float()))
        for n in names
    }
    del masters
    if cuda:
        torch.cuda.synchronize()
    out.setup_s = time.perf_counter() - clock0

    # -- the window
    waits.clear()
    spans.spans.clear()
    prof = DeviceTrace() if trace else None
    count = {"n": 0}

    def on_window_step(step: int, metrics: Dict[str, float]) -> None:
        count["n"] += 1

    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    state, _ = train_loop(timed_step, state, batches, 1 << 30,
                          TrainHooks(on_step=on_window_step,
                                     preempted=lambda: time.perf_counter() >= deadline))
    out.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    out.steps = count["n"]
    out.tokens = out.steps * B * S
    out.data_wait_s = list(waits[: out.steps])
    out.attempted = out.steps
    out.device = devices.describe(1, torch.device(device).type)
    if prof is not None:
        out.trace = prof.summary(spans.spans)
    batches.close()
    pipe.close()
    if pipe._thread is not None:
        pipe._thread.join(timeout=60)
    epochs = pipe.step / pipe.steps_per_epoch
    del state, step_fn, batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if epochs > 1:
        raise RuntimeError(f"the pipeline reached a second epoch ({pipe.step} of "
                           f"{pipe.steps_per_epoch} steps): the corpus is too small")

    # -- correctness, once the window has closed and the state is freed
    bad = 0
    for i, got in enumerate(served):
        want = corpus.batch(data, i, B, S)
        bad += sum(int(np.count_nonzero(np.asarray(got[k]) != want[k])) for k in want)
    out.checks.append(Check("batch_mismatches", float(bad), 0.0))
    ref = train_steps(config, config["training"]["optimizer"],
                      lambda n: weights.draw(config, seed, n, device, dtype), names,
                      [corpus.batch(data, i, B, S) for i in range(checked)], device)
    limits = config["training"]["check_limits"]
    for name, value in gaps(program, ref).items():
        out.checks.append(Check(name, value, limits[name]))
    out.notes.append(("program", program))
    out.notes.append(("reference", ref))
    out.notes.append(("leaves_left_out", sorted(set(names) - set(moved_leaves(ref["grad_norms"])))))
    out.failed = int(bad > 0)
    return out


def _flat_names(tree, prefix: str = ""):
    """Dotted leaf names in ``tree_leaves``' order (dict keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flat_names(v, prefix + k + ".")
        else:
            out.append(prefix + k)
    return out
