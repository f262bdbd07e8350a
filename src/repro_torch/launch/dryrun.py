"""Production-mesh dry-run: cost every (arch × shape × mesh) cell on fake
tensors, without allocating.

The port of ``repro.launch.dryrun``, which forces 512 fake XLA devices,
compiles each cell's sharded step ahead of time and reads XLA's memory and
cost analyses.  Here :func:`main` starts a ``fake`` process group of world
512 (``FakeStore``: collectives return at once, nothing is sent) unless one
exists, and each cell builds the production train/serve step on the
16×16 (or 2×16×16) mesh with its full sharding: the state, parameters,
batch and cache are DTensors over fake tensors (``FakeTensorMode``) placed
by ``rules_for``, so no byte is allocated on any device.  One step runs
eagerly under ``launch.hlo_cost.CostCounter`` (per-device FLOPs, HBM bytes,
collective wire bytes) and ``MemTracker`` (per-device peak memory), the
roofline terms come from ``launch.roofline`` with the H100's rates, and a
JSON record per cell is written under ``experiments/dryrun_torch/``.

The records keep the reference's keys where they mean something.  There
is no HLO, so no ``hlo_path``, ``hlo_bytes`` or ``xla_cost_analysis``; in
``memory``, ``code_bytes`` is null (eager torch compiles no program) and
``temp_bytes`` is the peak above the arguments; ``lower_s`` and
``compile_s`` give way to ``build_s`` (state and mesh) and ``run_s`` (the
costed step).

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --jobs 8 [--device cpu]
    python -m repro_torch.launch.dryrun --pipeline
    python -m repro_torch.launch.dryrun --table --out DIR   # the records as one markdown table
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily

from repro_torch.dist.sharding import MeshRules, is_dtensor, map_axes, use_rules
from repro_torch.launch.hlo_cost import CostCounter, in_sharding_propagation
from repro_torch.launch.mesh import describe_mesh, make_production_mesh, rules_for
from repro_torch.launch.roofline import roofline_report
from repro_torch.models import ARCH_IDS, SHAPES, cell_is_runnable, get_config, get_model, input_specs
from repro_torch.train import OptimizerConfig, make_init_state, make_train_step, state_logical_axes
from repro_torch.train.state import tree_leaves

__all__ = [
    "DEFAULT_OPT",
    "OUT_DIR",
    "build_cell",
    "cost_step",
    "grid_table",
    "memory_tracker",
    "main",
    "model_flops",
    "model_min_bytes",
    "run_cell",
    "run_pipeline_cells",
]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")
WORLD = 512  # the multi-pod mesh's devices; the single-pod mesh takes the first 256

# Per-arch optimizer choice: Adam states for 340B params would not fit 256
# chips; Adafactor (factored stats, no master) keeps it ~2.1 B/param.
DEFAULT_OPT = {"nemotron-4-340b": "adafactor"}


def _checked(rules: MeshRules, shape: Sequence[int], axes) -> List[Any]:
    """Placements for an input of ``shape`` with logical ``axes``, the
    reference's ``_named_checked``: the mesh axes of each dim by name, and
    an axis that does not divide its dim dropped (replicated), as an
    explicit input sharding cannot pad.  E.g. granite's 49155 vocab or
    llama4's 40 heads on a 16-way axis fall back to replication of that
    dim."""
    from torch.distributed.tensor import Replicate, Shard

    out: List[Any] = [Replicate()] * rules.mesh.ndim
    for dim, axis in enumerate(rules.pspec(axes)):
        if axis is None or shape[dim] % rules.axis_size(axis):
            continue
        for a in axis if isinstance(axis, tuple) else (axis,):
            out[rules.axis_names.index(a)] = Shard(dim)
    return out


def _distribute(tree, axes_tree, rules: MeshRules):
    """``tree``'s (fake) tensors as DTensors on the rules' mesh, each placed
    by :func:`_checked`; each rank keeps its own shard, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    def place(axes, t):
        return distribute_tensor(t, rules.mesh, _checked(rules, t.shape, axes), src_data_rank=None)

    return map_axes(place, axes_tree, tree)


def _batch_axes(batch) -> Dict[str, tuple]:
    """Every batch input is sharded over its leading (batch) dim only."""
    return {k: ("batch",) + (None,) * (v.dim() - 1) for k, v in batch.items()}


def _local_bytes(tree) -> int:
    local = [t.to_local() if is_dtensor(t) else t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in local)


def build_cell(arch_id: str, shape_name: str, multi_pod: bool, *,
               seq_parallel: bool = True,
               microbatches: Optional[int] = None,
               remat: Optional[str] = None,
               opt_kind: Optional[str] = None,
               device: str = "cuda"):
    """Returns ``(step, args, meta, rules)``: the cell's step and its
    arguments as DTensors over fake tensors.  Call it inside a
    ``FakeTensorMode`` on a process group of at least the mesh's size."""
    cfg = get_config(arch_id)
    if microbatches is not None:
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name]
    api = get_model(cfg)
    with unset_fake_temporarily():  # the mesh reads its ranks off a real tensor
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    rules = rules_for(cfg, mesh, seq_parallel=seq_parallel)
    dev = torch.device(device)
    specs = {k: v if isinstance(v, dict) else torch.empty_like(v, device=dev)
             for k, v in input_specs(cfg, shape).items()}
    meta = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": describe_mesh(mesh),
        "n_chips": mesh.size(),
        "kind": shape.kind,
        "seq_parallel": seq_parallel,
        "microbatches": cfg.microbatches,
        "remat": cfg.remat,
    }
    gen = torch.Generator(device=dev)
    if shape.kind == "train":
        kind = opt_kind or DEFAULT_OPT.get(arch_id, "adamw")
        opt_cfg = OptimizerConfig(kind=kind, moment_dtype="bfloat16")
        meta["optimizer"] = kind
        state = make_init_state(api, opt_cfg)(gen, dev)
        state = _distribute(state, state_logical_axes(api.param_logical_axes(), state.opt), rules)
        batch = _distribute(specs, _batch_axes(specs), rules)
        return make_train_step(api, opt_cfg), (state, batch), meta, rules

    params = _distribute(api.init_params(gen, dev), api.param_logical_axes(), rules)
    if shape.kind == "prefill":
        tokens = _distribute(specs["tokens"], ("batch", None), rules)
        prefix = specs.get("prefix_embeds")
        if prefix is not None:
            prefix = _distribute(prefix, ("batch", None, None), rules)
        S = shape.seq_len

        def prefill(params, tokens, prefix_embeds=None):
            return api.prefill(params, tokens, prefix_embeds, max_len=S)

        return prefill, (params, tokens, prefix), meta, rules

    if shape.kind == "decode":
        cache = {k: torch.empty_like(v, device=dev) for k, v in specs["cache"].items()}
        cache = _distribute(cache, api.cache_logical_axes(), rules)
        tokens = _distribute(specs["tokens"], ("batch", None), rules)
        return api.decode_step, (params, tokens, cache), meta, rules

    raise ValueError(shape.kind)


def model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def model_min_bytes(cfg, shape) -> float:
    """Analytic lower bound on global HBM traffic per step — the memory-
    roofline's "useful bytes" (counterpart of 6·N·D for compute).

    train  : params read (fwd) + read (bwd) + grads written + opt update
             read+write ≈ 5 × param_bytes, plus one activation write+read
             per layer boundary (bf16).
    prefill: params once + KV cache written once.
    decode : ACTIVE params once + full KV/state cache read + one slot
             written (≈ read).
    """
    pb = 2.0  # bf16 bytes/param
    n = cfg.param_count()
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        act = 2.0 * shape.tokens * cfg.d_model * cfg.num_layers * 2  # write+read
        return 5.0 * n * pb + act
    if cfg.is_attention_free:
        state = (
            shape.global_batch * cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state
            * 4.0 * cfg.num_layers
        )
    else:
        T = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window else shape.seq_len
        state = (
            2.0 * shape.global_batch * T * cfg.num_kv_heads
            * cfg.resolved_head_dim * pb * cfg.num_layers
        )
    if shape.kind == "prefill":
        return n * pb + state
    return n_active * pb + state  # decode


def memory_tracker():
    """``MemTracker`` (per-device live bytes and their peak, on real, fake
    and DTensor-local tensors) blind to DTensor's sharding propagation,
    whose global-shape fake tensors hold no device memory."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if in_sharding_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def cost_step(step, args, *, train: bool):
    """Runs ``step(*args)`` once under the cost model and a memory tracker,
    with autograd on for a train step and off for serving.  The tensors may
    be real, fake or DTensors (the caller holds any ``FakeTensorMode`` and
    the rules).  Returns ``(CostModel, memory record, outputs)``; the
    memory record's bytes are one device's."""
    tracker = memory_tracker()
    tracker.track_external(*[t for t in tree_leaves(args) if isinstance(t, torch.Tensor)])
    with torch.set_grad_enabled(train), tracker, CostCounter() as counter:
        out = step(*args)
    peak = tracker.get_tracker_snapshot("peak")
    peak_bytes = max((v["Total"] for v in peak.values()), default=0)
    arg_bytes = _local_bytes(args)
    arg_ids = {id(t) for t in tree_leaves(args)}
    out_leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    alias = [t for t in out_leaves if id(t) in arg_ids]
    memory = {
        "argument_bytes": arg_bytes,
        "output_bytes": _local_bytes(out_leaves),
        "temp_bytes": max(0, peak_bytes - arg_bytes),
        "alias_bytes": _local_bytes(alias),
        "code_bytes": None,
        "peak_bytes": peak_bytes,
    }
    return counter.result(), memory, out


def _ensure_world(world: int = WORLD) -> None:
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str,
             tag: str = "", device: str = "cuda", **knobs) -> Dict[str, Any]:
    multi_pod = mesh_kind == "multi"
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    ok, reason = cell_is_runnable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind}
    suffix = f"-{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh_kind}{suffix}.json")
    os.makedirs(out_dir, exist_ok=True)
    if not ok:
        rec["status"] = reason
        # skip records are artifacts too: the 40-cell coverage audit must
        # see all 80 (arch × shape × mesh) decisions on disk
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    t0 = time.time()
    try:
        with FakeTensorMode():
            step, args, meta, rules = build_cell(arch_id, shape_name, multi_pod, device=device, **knobs)
            rec.update(meta)
            t_build = time.time() - t0
            with use_rules(rules):
                cost, memory, _ = cost_step(step, args, train=shape.kind == "train")
            t_run = time.time() - t0 - t_build
        n_chips = meta["n_chips"]
        coll = {k.replace("coll_", ""): int(v) for k, v in cost.as_dict().items() if k.startswith("coll_")}
        coll["total"] = int(cost.collective_bytes)
        coll["count"] = int(cost.collective_count)
        roof = roofline_report(
            flops_per_device=cost.flops,
            hbm_bytes_per_device=cost.bytes_accessed,
            collective_bytes_per_device=cost.collective_bytes,
            n_chips=n_chips,
            model_flops_total=model_flops(cfg, shape),
            model_min_bytes_total=model_min_bytes(cfg, shape),
        )
        rec.update(
            status="ok",
            build_s=round(t_build, 1),
            run_s=round(t_run, 1),
            flops_per_device=cost.flops,
            bytes_per_device=cost.bytes_accessed,
            collectives=coll,
            roofline=roof,
            memory=memory,
        )
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


# ---------------------------------------------------------------- pipeline
PIPELINE_CELL = {"D": 128, "MB": 4, "SEQ": 64}


def _tanh_layer(x, lp):
    return torch.tanh(x @ lp["W"])


def _sum_sq(y, aux):
    d = (y - aux["tgt"]).float()
    return torch.sum(d * d), float(d.numel())


def _pipeline_rank(rank, S: int, micros: Sequence[int]) -> Dict:
    """One stage of the pipeline cell: both schedules at each M, each call
    once under a memory tracker (this rank's peak) after a warm-up call."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.pipeline import StageWire, pipeline_value_and_grad, stack_stage_params

    D, MB, SEQ = PIPELINE_CELL["D"], PIPELINE_CELL["MB"], PIPELINE_CELL["SEQ"]
    L, dev = 2 * S, rank.device
    mesh = init_device_mesh(rank.mesh_device, (S,), mesh_dim_names=("pp",))
    wire = StageWire(mesh, "pp", dev)
    gen = torch.Generator().manual_seed(0)
    Ws = torch.randn((L, D, D), generator=gen) * D**-0.5
    local = {"W": stack_stage_params({"W": Ws}, S)["W"][rank.rank : rank.rank + 1].to(dev)}
    out = {}
    for M in micros:
        xs = torch.randn((M, MB, SEQ, D), generator=gen).to(dev)
        aux = {"tgt": torch.randn((M, MB, SEQ, D), generator=gen).to(dev)}
        for sched in ("gpipe", "1f1b"):
            pipeline_value_and_grad(mesh, _tanh_layer, _sum_sq, local, xs, aux, schedule=sched, wire=wire)
            tracker = MemTracker()
            tracker.track_external(local["W"], xs, aux["tgt"])
            t0 = time.time()
            with tracker:
                pipeline_value_and_grad(mesh, _tanh_layer, _sum_sq, local, xs, aux, schedule=sched, wire=wire)
            peak = max(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
            out[f"{M}/{sched}"] = {"run_s": time.time() - t0, "peak_bytes": int(peak)}
    return out


def run_pipeline_cells(out_dir: str, stages: int, micros, workdir: Optional[str] = None) -> list:
    """Run the 1F1B and GPipe pipeline TRAINING programs on ``stages`` CPU
    ranks (``spawn_ranks``, gloo) and persist bubble + activation-memory
    artifacts (same JSON-cell currency as the arch × shape × mesh grid);
    each rank's peak memory stands in for XLA's ``temp_bytes``."""
    import tempfile

    from repro_torch.dist.pipeline import schedule_report
    from repro_torch.dist.ranks import spawn_ranks

    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(_pipeline_rank, stages, workdir or tmp, args=(stages, tuple(micros)),
                            device="cpu", timeout_s=600)
    mb_bytes = PIPELINE_CELL["MB"] * PIPELINE_CELL["SEQ"] * PIPELINE_CELL["D"] * 4
    records = []
    for M in micros:
        rep = schedule_report(stages, M, mb_bytes)
        rec = {"kind": "pipeline", "n_stages": stages, "n_micro": M, "schedule_report": rep, "schedules": {}}
        for sched in ("gpipe", "1f1b"):
            per_rank = [r[f"{M}/{sched}"] for r in ranks]
            rec["schedules"][sched] = {
                "run_s": round(max(r["run_s"] for r in per_rank), 3),
                "peak_bytes_per_rank": [r["peak_bytes"] for r in per_rank],
                "bubble": rep[f"bubble_{sched}"],
                "peak_stash_bytes": rep[f"peak_stash_bytes_{sched}"],
            }
            print(f"[pipeline] S={stages} M={M} {sched}: peak per rank "
                  f"{rec['schedules'][sched]['peak_bytes_per_rank']} B "
                  f"bubble={rec['schedules'][sched]['bubble']:.3f}", flush=True)
        with open(os.path.join(out_dir, f"pipeline__s{stages}_m{M}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        records.append(rec)
    return records


def _print_cell(rec: Dict[str, Any]) -> None:
    roof = rec.get("roofline", {})
    print(
        f"       -> {rec.get('status', '?')} "
        f"compute={roof.get('compute_s', 0):.4f}s "
        f"memory={roof.get('memory_s', 0):.4f}s "
        f"coll={roof.get('collective_s', 0):.4f}s "
        f"dominant={roof.get('dominant', '-')} "
        f"(build {rec.get('build_s', 0)}s run {rec.get('run_s', 0)}s)",
        flush=True,
    )


def _run_cells_apart(cells, argv: List[str], jobs: int) -> List[Dict[str, Any]]:
    """Each cell in a ``python -m repro_torch.launch.dryrun`` of its own
    (the same options, one arch, shape and mesh), ``jobs`` at a time; a
    cell's process is single-threaded Python, so cells spread over cores."""
    from concurrent.futures import ThreadPoolExecutor

    keep: List[str] = []
    skip = {"--arch", "--shape", "--mesh", "--jobs"}
    it = iter(argv)
    for a in it:
        if a in skip:
            next(it, None)
        elif a.split("=")[0] not in skip and a != "--all":
            keep.append(a)

    def one(cell):
        arch, shape, mesh_kind, path = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *keep,
               "--arch", arch, "--shape", shape, "--mesh", mesh_kind]
        if os.path.exists(path):
            os.remove(path)  # the record read below must be this run's
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        print(f"[cell] {arch} {shape} {mesh_kind} ({time.time() - t0:.1f} s wall)", flush=True)
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
        else:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "status": f"FAIL: the cell's process exited {proc.returncode}",
                   "traceback": proc.stderr[-4000:]}
        _print_cell(rec)
        return rec

    def guess(cell):  # longest first: a step's ops grow with its layers and microbatches
        cfg, shape = get_config(cell[0]), SHAPES[cell[1]]
        per_layer = {"train": cfg.microbatches, "prefill": shape.seq_len / 4096}.get(shape.kind, 0.1)
        return -cfg.num_layers * per_layer * (1.3 if cell[2] == "multi" else 1.0)

    with ThreadPoolExecutor(jobs) as pool:
        return list(pool.map(one, sorted(cells, key=guess)))


def grid_table(out_dir: str) -> str:
    """The records under ``out_dir`` as one markdown table, a row an (arch,
    shape) and each number as "single-pod / multi-pod" ("-" for a mesh not
    run): status, per-device peak memory, FLOPs, HBM bytes and collective
    bytes, the three roofline terms and the dominant one.  Pairs whose
    cells all SKIP or FAIL are listed under the table with their status."""
    import glob

    recs: Dict[tuple, Dict[str, Any]] = {}
    for path in glob.glob(os.path.join(out_dir, "*__*__*.json")):
        arch, shape, mesh = os.path.basename(path)[:-5].split("__")
        with open(path) as f:
            recs[arch, shape, mesh] = json.load(f)
    out = ["| arch | shape | status | peak GB/dev | TFLOP/dev | HBM GB/dev | coll GB/dev | compute s "
           "| memory s | collective s | dominant |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    cols = [
        lambda r: f"{r['memory']['peak_bytes'] / 1e9:.2f}",
        lambda r: f"{r['flops_per_device'] / 1e12:.2f}",
        lambda r: f"{r['bytes_per_device'] / 1e9:.1f}",
        lambda r: f"{r['collectives']['total'] / 1e9:.2f}",
        lambda r: f"{r['roofline']['compute_s']:.4f}",
        lambda r: f"{r['roofline']['memory_s']:.4f}",
        lambda r: f"{r['roofline']['collective_s']:.4f}",
        lambda r: r["roofline"]["dominant"].replace("_s", ""),
    ]
    rest: Dict[str, List[str]] = {}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            pair = [recs.get((arch, shape, m)) for m in ("single", "multi")]
            if not any(pair):
                continue
            status = " / ".join(str(r["status"])[:40] if r else "-" for r in pair)
            if not any(r and r["status"] == "ok" for r in pair):
                rest.setdefault(status, []).append(f"{arch} {shape}")
                continue
            vals = [" / ".join(col(r) if r and r["status"] == "ok" else "-" for r in pair) for col in cols]
            out.append(f"| {arch} | {shape} | {status} | " + " | ".join(vals) + " |")
    out += [f"\n{status}: {', '.join(cells)}." for status, cells in rest.items()]
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default="all")
    ap.add_argument("--all", action="store_true", help="every arch and shape (the default)")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the mesh's device type; nothing is allocated on either")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", choices=["none", "full", "dots"], default=None)
    ap.add_argument("--opt", choices=["adamw", "adafactor"], default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as one markdown table and exit")
    ap.add_argument("--pipeline", action="store_true",
                    help="run 1F1B/GPipe pipeline cells instead of the arch grid")
    ap.add_argument("--pipeline-stages", type=int, default=8)
    ap.add_argument("--pipeline-micro", default="8,32")
    args = ap.parse_args(argv)

    if args.table:
        print(grid_table(args.out))
        return 0
    if args.pipeline:
        micros = [int(m) for m in args.pipeline_micro.split(",")]
        run_pipeline_cells(args.out, args.pipeline_stages, micros)
        return 0

    archs = ARCH_IDS if args.all or args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    knobs = dict(
        seq_parallel=not args.no_seq_parallel,
        microbatches=args.microbatches,
        remat=args.remat,
        opt_kind=args.opt,
    )
    cells = []
    results = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                suffix = f"-{args.tag}" if args.tag else ""
                path = os.path.join(args.out, f"{arch}__{shape}__{mesh_kind}{suffix}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") == "ok" or prev.get("status", "").startswith("SKIP"):
                        print(f"[skip] {arch} {shape} {mesh_kind}: {prev['status']}")
                        results.append(prev)
                        continue
                cells.append((arch, shape, mesh_kind, path))
    if args.jobs > 1 and len(cells) > 1:
        results += _run_cells_apart(cells, argv if argv is not None else sys.argv[1:], args.jobs)
    else:
        _ensure_world()
        for arch, shape, mesh_kind, _ in cells:
            print(f"[cell] {arch} {shape} {mesh_kind} ...", flush=True)
            rec = run_cell(arch, shape, mesh_kind, args.out, tag=args.tag, device=args.device, **knobs)
            _print_cell(rec)
            results.append(rec)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if str(r.get("status", "")).startswith("SKIP"))
    n_fail = len(results) - n_ok - n_skip
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED of {len(results)}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
