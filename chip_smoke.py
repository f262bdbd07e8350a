"""Smoke run of the PyTorch port on one CUDA card.

1. Builds the port's four CUDA kernels from the sources in this checkout,
   one ``nvcc`` per source, all started at once.
2. Kernel phase: holds each kernel against its plain torch version on the
   card and times it at its main path's shapes beside its bound, its plain
   version and one PyTorch library call where there is one.
   ``fragment_gather`` is held bitwise for every bool/int/uint/float width
   and for tiled and row-granular layouts, and its run-table kernel
   (``fragment_union``) bitwise against ``union_ref``: every width, with
   int8 and float32 columns in the same launch, aligned, unaligned,
   mismatched-residue, empty and single runs and three providers, into
   typed outputs and into byte outputs 1, 3 and 8 bytes off alignment.  The
   UNION is timed at BENCH_8's ``split`` shape and the service's t3 shape
   (every column in one launch) beside its bound, ``torch.cat`` of the
   slice views and ``device_union``'s synced wall, after and (a recorded
   constant) before the run table.  ``dequant`` is held bitwise in
   bf16 and f32 at kernel_bench's (2048, 1024), at a (2^24, 8) page, at
   ragged shapes and on a view that is not 16-byte aligned, and the kernels
   entry point (``repro_torch.kernels.dequant``, its only caller) decodes
   the page.  ``flash_attention`` is held at zamba2-1.2b's, granite-3-2b's
   (4 query heads a KV head), mixtral-8x22b's (6 a KV head, head dim 128, a
   4096-position window), phi3-mini-3.8b's (head dim 96) and
   nemotron-4-340b's heads (12 a KV head, head dim 192), its backward
   (``flash_attention_bwd``) at granite-3-2b's heads and training length
   against the plain f32 path, timed beside its bound, the plain version's
   and SDPA's autograd backward, and ``mamba2_ssd``
   at zamba2's widths, in f32 (CUDA-core route) and bf16 (tensor-core
   route), at the reference's tolerances (SSD also against the sequential
   recurrence).  The tensor-core instructions (``HMMA``/``HGMMA``) of each
   built library are counted from ``cuobjdump -sass``.
3. Pipeline path: a declarative ``@model`` pipeline over the lakehouse (the
   BENCH_8 project: a differential torch ``feats`` node and a full-window
   torch ``score`` node) runs nine edits on a 2^24-row events table, about
   one month of NYC high-volume for-hire trips.  A workspace with the device
   tier must match a workspace without it bitwise at every edit, and match a
   numpy computation of the same function; warm edits must upload at least
   5x fewer host->device bytes and count the gather's tiled path, and every
   UNION that copies must launch the kernel exactly once.
4. Service path: the multi-tenant ``PipelineService(workers=4)`` over the
   same 2^24-row table, one device tier attached to both shared stores,
   running BENCH_4's four-stage project with ``feats`` on torch.  t0 fills
   [0, 0.8R] cold; t1 (widened to [0, R]), t2 (nested, [0, 0.6R]) and t3
   (two disjoint windows inside t0's, gathered by ``fragment_gather``) are
   submitted together, one kernel launch for each UNION that copies.
   Every run must end DONE, equal bitwise a fresh
   no-tier cold service of its own and numpy, and, warm, move at least 3x
   fewer object-store bytes than cold; t2 and t3 must hit the tier.  Then
   BENCH_5 on the same spill-backed service: a clean shutdown and a restart
   over its root replaying t0..t3 (at least 5x fewer store bytes, bitwise),
   and four tenants submitting one pipeline together (0 duplicate
   user-function rows).  The explain CLI's 11-edit matrix then runs on the
   card and must diagnose 11 of 11 causes.
5. Examples: the port's runnable examples (``examples/torch/``) on the
   card, each through its ``main`` with its own asserts and every kernel's
   launch count read before and after it (they attach no device tier and
   keep the model kernels off, as their references do): quickstart,
   incremental_iteration, multi_tenant_service, serve_batch (reduced
   mixtral-8x22b, ten requests on four slots), train_e2e at its defaults
   (the reference's 8-layer granite family, D 512, 28 M parameters in
   f32, 200 steps of 8 x 256; ms a step, tokens/s and one profiled step),
   then 20 steps on a fresh workdir twice (the second resumes from step
   20), multi_user_cache, incremental_join, trace_iteration and
   chaos_restart; lint_pipeline only where the bytecode walker runs
   (CPython 3.10/3.11); and quickstart once more as
   ``python examples/torch/quickstart.py`` in a process of its own.
6. Consistency phase, f32, prefill logits with the kernels on against off
   within 2e-3: zamba2-1.2b and granite-3-2b at full width and depth (greedy
   engine runs agree token for token up to a near-tie), and mixtral-8x22b at
   full width with its depth cut to 2 of 56 layers at S 8192 (a difference
   beyond the bar must trace to a router near-tie).
7. Serve paths, bf16, kernels on, each with its launch counts set to 0 just
   before the run and read just after: zamba2-1.2b and granite-3-2b at full
   width and depth behind ``ServeEngine(slots=4, max_context=2048)``, eight
   requests of 256-1536 prompt tokens and 32 new tokens each (every prefill
   launches ``flash_attention`` once per attention layer, ``mamba2_ssd``
   once per Mamba2 layer, every launch on the tensor-core route); mixtral-8x22b (2 layers) behind
   ``ServeEngine(slots=2, max_context=8192)``, two greedy prompts of 5000
   and 6500 tokens past its window, 16 new tokens each, on a 4096-slot ring
   cache.
8. Training path, with the model kernels' launch counts set to 0 before it:
   the bf16 steps train attention through ``flash_attention``'s forward
   and backward kernels, the f32 step takes the plain path, and the SSD
   (no backward) launches nothing: (a) ``repro_torch.launch.train.main`` trains
   granite-3-2b at its published size (bf16, AdamW with an f32 master, two
   microbatches, full remat) for 8 steps of 4 x 1024 tokens on a
   lakehouse corpus of two steps served by the differential cache: finite
   losses that fall, store bytes flat after epoch 1; (b) one f32 step of
   granite at full width with 2 of 40 layers, card against CPU; (c) a
   checkpoint round trip at that size in bf16, bitwise; (d) 4 steps of
   EF-int8 compressed gradients at that size.
9. Distributed path, with the model kernels' launch counts set to 0 before
   it and still 0 after it: (a) ``python -m repro_torch.launch.train
   --pipeline 4 --steps 30`` through ``main``, four ranks sharing the card
   over gloo (NCCL refuses two ranks on one card; gloo carries host
   tensors, so every hop goes through a pinned host buffer): finite losses
   that fall, checkpoints of the stage-stacked state in the reference's
   format, one restored; (b) the reference dry-run's pipeline cell (S 4,
   L 8, D 128, MB 4, SEQ 64) at M 4 and 12, both schedules, on four ranks
   against the card's own sequential stack at the reference's bars (loss
   rtol 1e-6, gradients rtol 1e-5 / atol 1e-7), each rank's peak memory
   under 1F1B below GPipe's at M 12 (read after a warm-up call), ms per
   call (median of 5 after those, min, max); (c) granite-3-2b at full width with 2 of 40 layers
   (bf16): one train step under the rules of a (data=1, model=1) mesh, the
   state and batch as DTensors, against the plain step (bitwise, or the
   largest difference printed) with 0 collectives (``CommDebugMode``), and
   a checkpoint written unsharded and restored with ``shardings=`` onto
   the mesh, bitwise; then a (data=1, model=2) mesh of two ranks sharing
   the card over gloo is tried with the first collective its step needs,
   and whether gloo carried it is printed.

10. Cost analysis, with the model kernels' launch counts set to 0 before
   it and still 0 after it: (a) ``python -m repro_torch.launch.dryrun`` on
   five production cells (granite-3-2b train_4k, mixtral-8x22b
   prefill_32k, zamba2-1.2b decode_32k on the 16x16 mesh, granite-3-2b
   decode_32k on 2x16x16, and granite-3-2b long_500k, which must give the
   SKIP record), each in a process of its own on a ``fake`` process group,
   each cell's three roofline terms under ``HW_H100`` printed; (b) the cost
   model on granite-3-2b's training cut (2 of 40 layers, batch 2 x 128)
   against a real step on the card: FLOPs equal those counted on fake
   tensors, the profiled device busy time at least the roofline bound, the
   memory tracker's peak within 10% of ``max_memory_allocated``; (c) that
   cut's sharded step on a (2, 2) mesh of a ``fake`` world of 4, forward
   and backward; a pinned H2D rate beside ``HW_H100``'s ``host_bw``.

``four_card_phase`` (not run by ``main``, which needs one card) drives
parts a and b of the distributed path with a card a rank (NCCL, hops as
device tensors) and a real (2, 2) sharded step of the training cut
against the plain step; run it on four cards with
``python3 -c "import tempfile, chip_smoke; chip_smoke.four_card_phase(tempfile.mkdtemp())"``.

Prints the card, the build time, the kernel checks and timings, each edit's
wall time, each tenant's ledger, the service's profile and spans, the serve
runs' timings and profiles, the training numbers (ms per step, tokens/s,
peak memory, a profiled step), the distributed numbers and the dry-run's
cells and checks (each beside the card's name and power limit), a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Any failure raises (non-zero exit).  Exits non-zero without a CUDA card.

Run from the repository root:  python3 chip_smoke.py [--rows N] [--frag N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.columnar import Table  # noqa: E402
from repro_torch.launch.roofline import HW_H100  # noqa: E402
from repro_torch.pipeline.dsl import Model, Project, model, runtime  # noqa: E402

HBM_BYTES_PER_S = HW_H100["hbm_bw"]  # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOP_PER_S = HW_H100["peak_flops_bf16"]  # H100 SXM dense bf16 tensor-core peak (data sheet)
ROWS = 1 << 24
FRAG = 1 << 16  # rows per fragment; windows stay multiples -> aligned runs

EVENTS_TABLE = "events.raw"
EVENTS_SCHEMA = {
    "eventTime": "<i8",
    "v1": "<f8",
    "v2": "<f8",
    "v3": "<f8",
    "flag": "<i8",
}


# ---------------------------------------------------------------- workload
def events(rows: int, seed: int = 0, lo: int = 0) -> Table:
    """``rows`` events with unique keys ``[lo, lo+rows)`` — the same draws,
    in the same order, as ``benchmarks/workloads.py::write_events``."""
    rng = np.random.default_rng(seed)
    return Table(
        {
            "eventTime": np.arange(lo, lo + rows, dtype=np.int64),
            "v1": rng.standard_normal(rows),
            "v2": rng.standard_normal(rows),
            "v3": rng.standard_normal(rows),
            "flag": rng.integers(0, 4, rows).astype(np.int64),
        }
    )


def write_events(catalog, rows: int, seed: int = 0, lo: int = 0) -> None:
    try:
        catalog.table(EVENTS_TABLE)
    except KeyError:
        ns, name = EVENTS_TABLE.rsplit(".", 1)
        catalog.create_table(ns, name, EVENTS_SCHEMA, "eventTime")
    catalog.append(EVENTS_TABLE, events(rows, seed, lo))


def _win(lo: int, hi: int) -> str:
    return f"(eventTime >= {lo} AND eventTime < {hi})"


def device_project(where: str) -> Project:
    """scan -> feats (torch rowwise) -> score (torch full-window): BENCH_8's
    project with the same exactly-rounded ops (compare, select, multiply),
    so residual recomputes stay bitwise-stable across batch shapes."""
    p = Project("bench8")

    @model(project=p, incremental="rowwise")
    @runtime("torch")
    def feats(data=Model(EVENTS_TABLE, columns=["v1", "v2"], filter=where)):
        return {
            k: (torch.where(v >= 0, v, v * 0.5) if v.is_floating_point() else v)
            for k, v in data.items()
        }

    @model(project=p, incremental="none")
    @runtime("torch")
    def score(data=Model("feats")):
        return {k: (v * 2.0 if v.is_floating_point() else v) for k, v in data.items()}

    return p


def bench_edits(total: int, frag: int) -> List[Tuple[str, List[Tuple[int, int]], Optional[dict]]]:
    """BENCH_8's nine edits: (label, key windows, append).  ``total`` is a
    multiple of ``frag`` so every hit/residual boundary is block-aligned;
    ``append`` names the rows an edit appends first."""
    a, b, c = total // 3 // frag * frag, 2 * total // 3 // frag * frag, total
    return [
        ("cold", [(0, b)], None),
        ("rerun", [(0, b)], None),
        ("widen", [(0, c)], None),
        ("narrow", [(0, a)], None),
        # two disjoint hit intervals of one merged element -> one
        # fragment_gather with multiple block runs (the kernel's tiled path)
        ("split", [(0, a), (b, c)], None),
        ("widen_back", [(0, c)], None),
        ("append", [(0, c + frag)], dict(rows=frag, seed=7, lo=c)),
        ("rerun2", [(0, c + frag)], None),
        ("narrow2", [(0, b)], None),
    ]


def where_of(windows: List[Tuple[int, int]]) -> str:
    return " OR ".join(_win(lo, hi) for lo, hi in windows)


def expected_score(raw: Dict[str, np.ndarray], windows) -> Dict[str, np.ndarray]:
    """``score``'s output computed in numpy from the generated rows: the
    torch runtime narrows float64 to float32 as the reference's jax x32 mode
    does, then applies feats and score."""
    keys = raw["eventTime"]
    mask = np.zeros(keys.shape[0], bool)
    for lo, hi in windows:
        mask |= (keys >= lo) & (keys < hi)
    out = {"eventTime": keys[mask].astype(np.int32)}
    for c in ("v1", "v2"):
        v = raw[c][mask].astype(np.float32)
        out[c] = np.where(v >= 0, v, v * np.float32(0.5)) * np.float32(2.0)
    return out


# ------------------------------------------------------------------ timing
def _time_ms(fn, launches: int = 20, repeats: int = 7) -> float:
    """Milliseconds per call: CUDA events around ``launches`` back-to-back
    calls, divided by the count; the median of ``repeats`` such windows."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


# ------------------------------------------------------------ kernel phase
# the kernels whose bf16 route runs its products on the tensor cores
TENSOR_CORE_KERNELS = ("flash_attention", "mamba2_ssd")


def count_mma() -> Dict[str, Dict[str, int]]:
    """The tensor-core instructions of each kernel's built libraries (every
    variant summed), from ``cuobjdump -sass``: ``HMMA`` (mma.sync) and
    ``HGMMA`` (wgmma).  Raises when a kernel of TENSOR_CORE_KERNELS has
    none."""
    from repro_torch.kernels import _build

    counts = {}
    for name, variant in _build.libraries():
        sass = subprocess.run(
            [_build.cuda_tool("cuobjdump"), "-sass", str(_build.target(name, variant))],
            capture_output=True, text=True, check=True,
        ).stdout.splitlines()
        seen = {op: sum(f" {op}." in line or f" {op} " in line for line in sass) for op in ("HMMA", "HGMMA")}
        counts[name] = {op: counts.get(name, {}).get(op, 0) + n for op, n in seen.items()}
        label = name if variant is None else f"{name} (variant {variant})"
        print(f"{label}: {seen['HMMA']} HMMA and {seen['HGMMA']} HGMMA instructions in its SASS")
    for name in TENSOR_CORE_KERNELS:
        if not (counts[name]["HMMA"] or counts[name]["HGMMA"]):
            raise AssertionError(f"{name}'s library holds no tensor-core instruction")
    return counts


GATHER_DTYPES = [
    torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.uint8, torch.uint16, torch.uint32, torch.uint64,
    torch.float16, torch.bfloat16, torch.float32, torch.float64,
]


def _random_tensor(dtype: torch.dtype, shape, gen: torch.Generator) -> torch.Tensor:
    """Random bits of ``dtype`` on the card (every byte pattern, NaNs too)."""
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, generator=gen)
    if dtype == torch.bool:
        raw = raw % 2
    return raw.cuda().view(dtype).reshape(shape)


def check_fragment_gather() -> None:
    """The row-tile API against the plain gather on the card, bitwise, every
    dtype: block-run layouts at RB 8 and 4096, and non-aligned runs (RB=1);
    then the run-table kernel itself (``check_fragment_union``)."""
    from repro_torch.kernels.fragment_gather import fragment_gather, gather_ref
    from repro_torch.kernels.fragment_gather.ops import GATHER_STATS

    gen = torch.Generator().manual_seed(0)
    # name: (source rows, columns, row indices, row_block asked for)
    layouts = {
        "rb8": (4096, 1, np.r_[1024:2048, 0:512], 8),
        "rb4096": (3 << 14, 1, np.r_[1 << 14:3 << 14, 0:4096], 4096),
        "rb1": (4099, 1, np.r_[3:1500, 2001:4099], 8),
        "rb8-c3": (512, 3, np.r_[256:512, 8:64], 8),
        "rb1-c3": (517, 3, np.r_[5:300, 301:517], 8),
    }
    for dtype in GATHER_DTYPES:
        for name, (rows, cols, idx, rb) in layouts.items():
            src = _random_tensor(dtype, (rows, cols), gen)
            fast_before = GATHER_STATS.fast_path
            got = fragment_gather(src, idx.astype(np.int32), row_block=rb)
            if (GATHER_STATS.fast_path > fast_before) != (not name.startswith("rb1")):
                raise AssertionError(f"fragment_gather took the wrong mode for {name}")
            want = gather_ref(src, torch.from_numpy(idx.astype(np.int32)))
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(
                got.view(torch.uint8), want.view(torch.uint8)
            ):
                raise AssertionError(f"fragment_gather != plain on {dtype} {name}")
        print(f"fragment_gather bitwise == plain: {dtype} x {sorted(layouts)}")
    check_fragment_union()


# name: (provider rows, runs as (provider, lo, hi)) in output order; runs of
# tens of thousands of rows span many 32 KiB table entries
UNION_LAYOUTS = {
    "aligned": ((1 << 16,), [(0, 0, 1 << 14), (0, 1 << 15, 1 << 16)]),
    "unaligned": ((70001,), [(0, 3, 30001), (0, 30007, 69999)]),
    "mismatched": ((50000,), [(0, 5, 20005), (0, 20077, 49000), (0, 49001, 49002)]),
    "empty+single": ((40000,), [(0, 4, 4), (0, 9, 39999), (0, 50, 50)]),
    "three-providers": (
        (40000, 9001, 777),
        [(0, 0, 4096), (0, 4096, 20001), (1, 3, 5000), (2, 0, 8), (2, 13, 777),
         (0, 30000, 40000), (1, 6000, 9001)],
    ),
}
UNION_MIXED = (torch.int8, torch.float32)  # the other columns of each UNION


def check_fragment_union() -> None:
    """The run-table kernel against ``union_ref`` on the card, bitwise, for
    every dtype and layout: three columns of mixed widths in one launch,
    written into typed outputs and, as bytes, into an output 1, 3 and 8
    bytes past 16-byte alignment (every source/destination residue pair
    occurs), each output pre-filled so a stray write shows."""
    from repro_torch.kernels.fragment_gather import fragment_union, kernel, union_ref

    gen = torch.Generator().manual_seed(2)
    for dtype in GATHER_DTYPES:
        for name, (provider_rows, runs) in UNION_LAYOUTS.items():
            cols = (dtype,) + UNION_MIXED
            provs = [[_random_tensor(dt, (n,), gen) for dt in cols] for n in provider_rows]
            rows = sum(hi - lo for _p, lo, hi in runs)
            for shift in (None, 1, 3, 8):
                # runs as (source, source row, output index, output row, rows)
                if shift is None:  # typed outputs, one per column
                    outs = [_random_tensor(dt, (rows,), gen) for dt in cols]
                    table, at = [], [0] * len(cols)
                    for p, lo, hi in runs:
                        for j in range(len(cols)):
                            table.append((provs[p][j], lo, j, at[j], hi - lo))
                            at[j] += hi - lo
                else:  # every column as bytes, into one byte buffer
                    sizes = [torch.empty((), dtype=dt).element_size() for dt in cols]
                    outs = [_random_tensor(torch.uint8, (shift + rows * sum(sizes),), gen)]
                    table, at = [], shift
                    for p, lo, hi in runs:
                        for j, size in enumerate(sizes):
                            n = (hi - lo) * size
                            table.append((provs[p][j].view(torch.uint8), lo * size, 0, at, n))
                            at += n
                wants = [o.clone() for o in outs]
                before = kernel.launches
                fragment_union([(src, sr, outs[j], dr, n) for src, sr, j, dr, n in table])
                union_ref([(src, sr, wants[j], dr, n) for src, sr, j, dr, n in table])
                torch.cuda.synchronize()
                if kernel.launches != before + 1:
                    raise AssertionError(f"fragment_union launched {kernel.launches - before} times")
                for got, want in zip(outs, wants):
                    if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
                        raise AssertionError(f"fragment_union != union_ref on {dtype} {name} shift {shift}")
        print(f"fragment_union bitwise == union_ref: {dtype} (+ int8, float32) x {sorted(UNION_LAYOUTS)} "
              f"x outputs typed and 1/3/8 bytes off alignment")


def check_device_tier_dtypes() -> None:
    """The tier on the card for every dtype it admits: upload (with the x32
    narrowing), zero padding, a multi-run gather, concatenation across
    providers and the clone a torch node receives, bitwise against the
    same rows narrowed on the host."""
    from repro_torch.core.device import DeviceTier, device_union, to_device

    rng = np.random.default_rng(0)
    dtypes = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64", "float16", "float32", "float64"]
    for name in dtypes:
        dt = np.dtype(name)
        cols = [
            rng.integers(0, 2, n).astype(dt) if dt.kind == "b"
            else rng.standard_normal(n).astype(dt) if dt.kind == "f"
            else rng.integers(0, np.iinfo(dt).max, n, endpoint=True, dtype=dt)
            for n in (1037, 515)
        ]
        tier = DeviceTier()
        provs = [{"x": tier.pin(_Elem(Table({"x": c})), "x")} for c in cols]
        runs = [(provs[0], 8, 64), (provs[0], 128, 1037), (provs[1], 3, 515)]
        got = device_union(runs, ["x"])["x"].clone()
        want = to_device(
            np.concatenate([cols[0][8:64], cols[0][128:1037], cols[1][3:515]]),
            torch.device("cpu"),
        )
        torch.cuda.synchronize()
        if got.device.type != "cuda" or not np.array_equal(
            got.cpu().view(torch.uint8).numpy(), want.view(torch.uint8).numpy()
        ):
            raise AssertionError(f"device tier differs from host narrowing for {name}")
    print(f"device tier pin/pad/gather/cat/clone bitwise == host: {dtypes}")


class _Elem:
    """A cache element as the tier sees it: an id and a RAM payload."""

    _ids = iter(range(1 << 40, 1 << 41))

    def __init__(self, data: Table):
        self.elem_id = next(self._ids)
        self.data = data


def union_shapes(total: int, frag: int) -> Dict[str, Tuple[Dict[str, torch.dtype], int, List[Tuple[int, int]]]]:
    """The two UNIONs of the pipeline paths that copy: ``shape -> (columns,
    provider rows, row runs)``.  ``split``: the feats node of BENCH_8's
    split edit, [0, a) and [b, c) of the c-row element (block-aligned).
    ``t3``: the service's t3, whose feats rows are t0's element (keys in
    [0, 0.8R] with flag > 0) inside its two windows (row-granular)."""
    a, b, c = total // 3 // frag * frag, 2 * total // 3 // frag * frag, total
    (_t0, _k, t0), *_rest, (_t3, _k3, t3) = service_tenants(total, frag)
    keep = events(total).column("flag") > 0
    before = np.concatenate([[0], np.cumsum(keep)])  # kept rows below each key
    t3_runs = [(int(before[lo]), int(before[hi])) for lo, hi in t3["windows"]]
    f32, i32 = torch.float32, torch.int32
    return {
        "split": ({"eventTime": i32, "v1": f32, "v2": f32}, c, [(0, a), (b, c)]),
        "t3": ({"eventTime": i32, "flag": i32, "mag": f32, "v1": f32, "v2": f32},
               int(before[t0["hi"] + 1]), t3_runs),
    }


def _union_inputs(columns, rows: int) -> Dict[str, torch.Tensor]:
    """One provider's padded columns of random values on the card."""
    from repro_torch.core.device import _pad_rows

    return {
        name: _pad_rows(
            torch.randn(rows, device="cuda").to(dtype) if dtype.is_floating_point
            else torch.randint(0, 1 << 30, (rows,), dtype=dtype, device="cuda")
        )
        for name, dtype in columns.items()
    }


def _union_case(columns, rows: int, bounds):
    """One UNION of ``union_shapes`` on the card: a provider, the kernel's
    outputs, the plain version's outputs already filled by ``union_ref``,
    and the chunked table on the card for every column's runs."""
    from repro_torch.kernels.fragment_gather import kernel, union_ref

    prov = _union_inputs(columns, rows)
    out_rows = sum(hi - lo for lo, hi in bounds)
    got = {c: torch.empty(out_rows, dtype=dt, device="cuda") for c, dt in columns.items()}
    want = {c: torch.empty_like(t) for c, t in got.items()}
    plain, src_at, dst_at, nbytes = [], [], [], []
    for c in columns:
        at, size = 0, got[c].element_size()
        for lo, hi in bounds:
            plain.append((prov[c], lo, want[c], at, hi - lo))
            src_at.append(prov[c].data_ptr() + lo * size)
            dst_at.append(got[c].data_ptr() + at * size)
            nbytes.append((hi - lo) * size)
            at += hi - lo
    union_ref(plain)
    table = torch.from_numpy(kernel.chunk_table(src_at, dst_at, nbytes)).cuda()
    return prov, got, want, plain, table


def union_walls(columns, prov: Dict[str, torch.Tensor], bounds, reps: int = 7) -> Tuple[float, Dict[str, torch.Tensor]]:
    """``device_union``'s wall in ms over ``bounds`` of the provider
    ``prov``, host work included and ending in a sync: the median of
    ``reps`` calls after two, and the last call's output.  It uses only
    what every version of the port's tier has, so a checkout of an earlier
    commit can be measured with it (its ``src`` first on the path)."""
    from repro_torch.core.device import device_union

    runs = [(prov, lo, hi) for lo, hi in bounds]
    times = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = device_union(runs, list(columns))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times[2:])), out


# device_union's wall before the run-table kernel: union_walls on the parent
# commit (e36a94a, one fragment_gather launch per column on a per-row host
# index), NVIDIA H100 80GB HBM3, 700.00 W, in one chip call with the
# run-table version (parent, change, change, parent): the mean of the
# parent's two (split 203.0094 and 195.3515 ms, t3 55.2633 and 55.0821 ms;
# the run table's 0.4092 and 0.4451 ms, 0.4142 and 0.3674 ms)
UNION_WALL_BEFORE_MS = {"split": 199.18043049999668, "t3": 55.17266049999847}


def time_fragment_union(total: int, frag: int) -> dict:
    """The run-table kernel at the two UNIONs of ``union_shapes``: every
    column of the UNION in one launch, against its bound, the plain version
    on the card (one slice copy per run and column), ``torch.cat`` of the
    slice views per column (summed over the columns) and ``device_union``'s
    wall before and after.  The kernel's table launch and ``device_union``
    on the same provider are each held bitwise against the plain version.
    The ``split`` numbers fill the kernels line."""
    from repro_torch.kernels.fragment_gather import kernel, union_ref
    from repro_torch.kernels.fragment_gather.ref import signed_view

    result = {}
    for shape, (columns, rows, bounds) in union_shapes(total, frag).items():
        prov, got, want, plain, table = _union_case(columns, rows, bounds)
        # the wrapper itself (checks, table build, pinned upload) on the same
        # provider, held against the plain version too
        wall, out = union_walls(columns, prov, bounds)
        for c in columns:
            if not torch.equal(out[c].view(torch.uint8), want[c].view(torch.uint8)):
                raise AssertionError(f"device_union differs from plain at the {shape} shape ({c})")
        out_rows = got[next(iter(columns))].shape[0]
        launch = lambda: kernel.launch_table(table)
        launch()
        torch.cuda.synchronize()
        for c in columns:
            if not torch.equal(got[c].view(torch.uint8), want[c].view(torch.uint8)):
                raise AssertionError(f"fragment_union differs from plain at the {shape} shape ({c})")
        err = max(float((got[c] - want[c]).abs().max()) for c in columns if got[c].is_floating_point())
        views = [[signed_view(prov[c][lo:hi]) for lo, hi in bounds] for c in columns]
        out_bytes = sum(t.nbytes for t in got.values())
        moved = 2 * out_bytes + table.nbytes  # gathered bytes read + written, the table read
        r = result[shape] = {
            "columns": len(columns), "out_rows": out_rows, "table_entries": int(table.shape[0]),
            "ms": _time_ms(launch), "plain_ms": _time_ms(lambda: union_ref(plain)),
            "library_ms": _time_ms(lambda: [torch.cat(v) for v in views]),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "max_abs_err": err,
            "wall_ms": wall, "wall_before_ms": UNION_WALL_BEFORE_MS[shape],
        }
        print(
            f"fragment_union @ {shape} shape: {len(columns)} columns x {out_rows} rows out "
            f"({out_bytes} B) from {len(bounds)} runs each, {r['table_entries']} table entries: "
            f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({moved / r['ms'] / 1e6:.1f} GB/s achieved), torch.cat of views {r['library_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms; device_union wall {r['wall_ms']:.4f} ms, before "
            f"{r['wall_before_ms']:.4f} ms (recorded: parent commit e36a94a on NVIDIA H100 80GB HBM3, 700.00 W)"
        )
    split = result["split"]
    return {
        "name": "fragment_gather",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fragment_gather/csrc/fragment_gather.cu",
        "replaces": "src/repro/kernels/fragment_gather/kernel.py:61",
        **{k: split[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes",
        "library_ms": split["library_ms"],
        "library": "torch.cat of the slice views, summed over the columns",
        "shapes": result,
    }


# ---------------------------------------------- model kernels (serve path)
ZAMBA2 = "zamba2-1.2b"
GRANITE = "granite-3-2b"
MIXTRAL = "mixtral-8x22b"
# mixtral-8x22b's 56 layers hold 140.6 B parameters, four cards' worth; two
# of them at full width (5.4 B, 21.6 GB in f32) exercise every layer kind
MIXTRAL_LAYERS = 2
PROMPT_LENS = (512, 1000, 1536)  # 1000 is a multiple of neither 64 nor 256
# the reference's bars: tests/test_kernels.py:25-26 (attention), :97-99 (SSD)
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
SSD_Y_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (5e-2, 5e-2)}
SSD_H_TOL = (1e-3, 1e-3)
# The reference set its f32 bar for y at test sizes (chunk <= 64, S <= 256).
# At zamba2's widths an output sums up to 256 x 64 f32 products of terms far
# larger than itself, in another order than the plain version, and the
# difference grows with S through the carried state: 8.7e-4 at S 1536 on the
# H100.  Full-width f32 y is held at this bar, and both sides are measured
# against an f64 recurrence.
SSD_Y_TOL_FULL_F32 = (1e-3, 1e-3)


def _closeness(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> Tuple[bool, float, float]:
    """(within the bar and finite, largest absolute error, largest error
    over its bar)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    worst = float((err / (atol + rtol * w.abs())).max())
    return bool(torch.isfinite(g).all()) and worst <= 1.0, float(err.max()), worst


def _compare(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> Tuple[bool, float]:
    """Prints whether ``|got - want| <= atol + rtol * |want|`` everywhere
    (numpy's allclose) with every value finite, and returns that and the
    largest absolute error."""
    ok, max_err, worst = _closeness(got, want, rtol, atol)
    print(
        f"  {what}: max |err| {max_err:.3e}, worst err/bar {worst:.3f} "
        f"(rtol {rtol}, atol {atol}) {'ok' if ok else 'FAIL'}"
    )
    return ok, max_err


def _hold(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> float:
    """``_compare``, raising outside the bar.  Returns the largest absolute
    error."""
    ok, max_err = _compare(got, want, rtol, atol, what)
    if not ok:
        raise AssertionError(f"{what}: outside the bar")
    return max_err


def _bound_ms(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes at the memory rate."""
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _attention_work(S: int, H: int, KV: int, hd: int, window: int) -> Tuple[float, float]:
    """(flops, bytes) of causal attention over this run's shapes: QK^T and
    PV over the keys each query sees (S(S+1)/2 causal, fewer under a
    window), and q, k, v read and the output written once in bf16."""
    seen = sum(min(q + 1, window) if window else q + 1 for q in range(S))
    return 4.0 * hd * H * seen, 2.0 * S * hd * (2 * H + 2 * KV)


# (label, H, KV, hd, S, window): zamba2-1.2b's shared block (and grouped or
# windowed variants of it), granite-3-2b's layers (4 query heads a KV head),
# mixtral-8x22b's (6 a KV head, head dim 128, a 4096-position window
# crossed by both lengths), phi3-mini-3.8b's (head dim 96) and
# nemotron-4-340b's (12 a KV head, head dim 192), and the reduced configs'
# head widths (32, 16: narrower than the 64-column TMA box, zero-filled)
ATTN_CASES = (
    [("zamba2-1.2b", 32, 32, 64, S, 0) for S in PROMPT_LENS]
    + [("zamba2 G4", 32, 8, 64, 1000, 0), ("zamba2 window 256", 32, 32, 64, 1536, 256),
       ("zamba2 G4 window 256", 32, 8, 64, 1000, 256)]
    + [("granite-3-2b", 32, 8, 64, S, 0) for S in PROMPT_LENS]
    + [("mixtral-8x22b", 48, 8, 128, S, 4096) for S in (5000, 8192)]
    + [("phi3-mini-3.8b", 32, 32, 96, 1000, 0), ("nemotron-4-340b", 96, 8, 192, 1000, 0)]
    + [("reduced configs", 4, 1, 32, 1000, 0), ("reduced configs", 2, 2, 16, 130, 0)]
)


def check_flash_attention() -> dict:
    """The kernel against its plain version (materialised scores) at each
    case of ATTN_CASES, f32 (CUDA-core route) and bf16 (tensor-core route),
    at the reference's bars.  Times it in bf16 at zamba2's heads for each
    prompt length, at granite-3-2b's for S 1536 (the entry of the kernels
    line: granite is the slice's main path), at mixtral-8x22b's for S 8192
    and at phi3-mini's and nemotron's for S 1000, beside its bound, the
    plain version and PyTorch's ``scaled_dot_product_attention`` (which the
    port never calls)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_call, route

    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(S, H, KV, hd, dtype):
        return [
            torch.randn((1, S, h, hd), generator=gen, device="cuda").to(dtype)
            for h in (H, KV, KV)
        ]

    print("flash_attention vs plain, B 1, causal")
    for label, H, KV, hd, S, window in ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = inputs(S, H, KV, hd, dtype)
            kw = dict(scale=hd**-0.5, causal=True, window=window)
            got = flash_attention_call(q, k, v, **kw)
            want = attention_ref(q, k, v, **kw)
            _hold(got, want, *ATTN_TOL[dtype], f"{label} (H {H}, KV {KV}, hd {hd}) S {S} window {window} {dtype}")
            del q, k, v, got, want
        torch.cuda.empty_cache()
    torch.cuda.synchronize()

    timed = [("zamba2-1.2b", 32, 32, 64, S, 0) for S in PROMPT_LENS]
    timed += [("granite-3-2b", 32, 8, 64, 1536, 0), ("mixtral-8x22b", 48, 8, 128, 8192, 4096),
              ("phi3-mini-3.8b", 32, 32, 96, 1000, 0), ("nemotron-4-340b", 96, 8, 192, 1000, 0)]
    for label, H, KV, hd, S, window in timed:
        q, k, v = inputs(S, H, KV, hd, torch.bfloat16)
        kw = dict(scale=hd**-0.5, causal=True, window=window)
        got = flash_attention_call(q, k, v, **kw)
        err = float((got.float() - attention_ref(q, k, v, **kw).float()).abs().max())
        ms = _time_ms(lambda: flash_attention_call(q, k, v, **kw))
        seen, device_ms = _device_kernels(lambda: flash_attention_call(q, k, v, **kw))
        device = f"{device_ms:.4f} ms" if seen else "not measured"
        flops, nbytes = _attention_work(S, H, KV, hd, window)
        bound_ms, bound_by = _bound_ms(flops, nbytes)
        plain_ms = library_ms = None
        if not window:  # the materialised plain version and SDPA (no window argument)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            plain_ms = _time_ms(lambda: attention_ref(q, k, v, **kw), launches=5)
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=KV != H))
        print(
            f"flash_attention bf16 ({route(torch.bfloat16)} route) {label} (H {H}, KV {KV}, hd {hd}) "
            f"S {S} window {window}: "
            f"kernel {ms:.4f} ms (device time alone {device}), plain {'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}, "
            f"scaled_dot_product_attention {'not timed' if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {bound_ms:.4f} ms ({bound_by}); {flops / ms / 1e9:.1f} TFLOP/s achieved"
        )
        if label == "granite-3-2b":
            entry = {
                "name": "flash_attention",
                "route": "cuda",
                "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:121",
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
                "shape": f"q (1, {S}, {H}, {hd}), k/v (1, {S}, {KV}, {hd}) bf16, causal",
            }
        del q, k, v, got
    torch.cuda.empty_cache()
    return entry


# granite-3-2b.pretrain's attention call: one microbatch, 1 sequence of 4096,
# 32 query heads on 8 KV heads of width 64
GRANITE_TRAIN_ATTENTION = (1, 4096, 32, 8, 64)


def check_flash_attention_bwd() -> dict:
    """The backward kernel at granite-3-2b's heads and training length
    (``GRANITE_TRAIN_ATTENTION``, causal): dq, dk and dv against the plain
    f32 path within twice the bf16 control's largest error (the bar of
    ``tests/test_torch_flash_attention_grad.py``), then timed beside its
    bound (the backward's five products over the causal pairs at the bf16
    peak: Sᵀ recomputed, dPᵀ, dV, dK and dQ), the plain version's autograd
    backward in bf16 and PyTorch's ``scaled_dot_product_attention``
    backward (which the port never calls)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_call, flash_attention_call

    B, S, H, KV, hd = GRANITE_TRAIN_ATTENTION
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, dout = (torch.randn((B, S, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
                     for h in (H, KV, KV, H))
    kw = dict(scale=hd**-0.5, causal=True, window=0)
    out, lse = flash_attention_call(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_call(q, k, v, out, lse, dout, **kw)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, dout.float())
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_out = attention_ref(*leaves, **kw)
    control = torch.autograd.grad(plain_out, leaves, dout, retain_graph=True)
    err = lambda x, w: float((x.float() - w).abs().max() / w.abs().max())
    bar = 2 * max(err(c, w) for c, w in zip(control, want))
    errs = {name: err(g, w) for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    print(f"flash_attention_bwd vs the plain f32 path (B {B}, S {S}, H {H}, KV {KV}, hd {hd}, causal): "
          f"largest error over the largest gradient {', '.join(f'{n} {e:.3e}' for n, e in errs.items())}; "
          f"bf16 control {', '.join(f'{n} {err(c, w):.3e}' for n, c, w in zip(('dq', 'dk', 'dv'), control, want))}; "
          f"bar {bar:.3e} {'ok' if max(errs.values()) <= bar else 'FAIL'}")
    if max(errs.values()) > bar or not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError("flash_attention_bwd: outside the bar")
    del want, got
    ms = _time_ms(lambda: flash_attention_bwd_call(q, k, v, out, lse, dout, **kw))
    seen, device_ms = _device_kernels(lambda: flash_attention_bwd_call(q, k, v, out, lse, dout, **kw))
    plain_ms = _time_ms(lambda: torch.autograd.grad(plain_out, leaves, dout, retain_graph=True), launches=3)
    del plain_out, leaves, control
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()
    library_ms = _time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True))
    fwd_flops, _ = _attention_work(S, H, KV, hd, 0)
    flops = 2.5 * fwd_flops * B  # five products against the forward's two
    nbytes = 2.0 * B * S * hd * (4 * H + 4 * KV) + 4.0 * B * H * S  # q k v o dO in, dq dk dv out; lse
    bound_ms, bound_by = _bound_ms(flops, nbytes)
    print(f"flash_attention_bwd bf16 granite-3-2b (B {B}, S {S}, H {H}, KV {KV}, hd {hd}): kernel {ms:.4f} ms "
          f"(device time alone {f'{device_ms:.4f} ms over {seen} kernels' if seen else 'not measured'}), plain "
          f"autograd {plain_ms:.4f} ms, scaled_dot_product_attention backward {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); {flops / ms / 1e9:.1f} TFLOP/s achieved")
    del q, k, v, dout, out, lse, qt, kt, vt, lib_out
    torch.cuda.empty_cache()
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "none: the TPU kernel has no backward",
        "max_rel_err": max(errs.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "torch.autograd.grad through scaled_dot_product_attention (causal, GQA)",
        "shape": f"q (B {B}, {S}, {H}, {hd}), k/v ({B}, {S}, {KV}, {hd}) bf16, causal",
    }


DEQUANT_PAGE = (ROWS, 8)  # one month of the events table as an 8-column int8 page
DEQUANT_SHAPES = [(2048, 1024), DEQUANT_PAGE, (100, 70), (1, 5), (257, 1029)]


def _dequant_inputs(R: int, C: int, gen: torch.Generator):
    """int8 values over the whole range and scales in [0.001, 2), as the
    reference's tests draw them."""
    x = torch.randint(-128, 128, (R, C), dtype=torch.int8, generator=gen, device="cuda")
    scale = torch.rand((C,), generator=gen, device="cuda") * 1.999 + 0.001
    return x, scale


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int16 if a.element_size() == 2 else torch.int32),
        b.view(torch.int16 if b.element_size() == 2 else torch.int32),
    )


def _device_kernels(fn) -> Tuple[int, float]:
    """The device kernels one call of ``fn`` launches and their device time
    in ms, from the profiler (0 kernels where it sees no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    return sum(e.count for e in ops), sum(_device_us(e) for e in ops) / 1e3


def check_dequant() -> dict:
    """The kernel against its plain version on the card, bitwise, at every
    shape of DEQUANT_SHAPES and on a view whose data is not 16-byte aligned,
    for bf16 and f32.  Then the kernels entry point (``repro_torch.kernels
    .dequant``, the only caller the system has) decodes the page in both
    dtypes with the launch count set to 0 just before and read just after.
    Times the kernel at kernel_bench's shape and at the page beside its
    bound, its plain version and ``torch.mul(x, scale, out=)``, one
    TensorIterator pass that computes in f32 and rounds on the store."""
    import repro_torch.kernels as kernels
    from repro_torch.kernels.dequant import dequant_ref
    from repro_torch.kernels.dequant import kernel as dq_kernel
    from repro_torch.kernels.dequant.kernel import dequant_call

    gen = torch.Generator(device="cuda").manual_seed(4)
    dtypes = (torch.bfloat16, torch.float32)
    for R, C in DEQUANT_SHAPES:
        x, scale = _dequant_inputs(R, C, gen)
        flat = torch.empty(R * C + 3, dtype=torch.int8, device="cuda")
        view = flat[3:].view(R, C)
        view.copy_(x)
        if view.data_ptr() % 16 == 0:
            raise AssertionError("the offset view is aligned")
        for dt in dtypes:
            want = dequant_ref(x, scale, out_dtype=dt)
            for name, src in (("aligned", x), ("offset view", view)):
                if not _same_bits(dequant_call(src, scale, out_dtype=dt), want):
                    raise AssertionError(f"dequant != plain at ({R}, {C}) {dt} {name}")
        del x, scale, flat, view, want
    torch.cuda.synchronize()
    print(f"dequant bitwise == plain: {DEQUANT_SHAPES} x {[str(d) for d in dtypes]} x aligned/offset view")

    x, scale = _dequant_inputs(*DEQUANT_PAGE, gen)
    dq_kernel.launches = 0
    outs = {dt: kernels.dequant(x, scale, out_dtype=dt) for dt in dtypes}
    torch.cuda.synchronize()
    launches = dq_kernel.launches
    for dt, out in outs.items():
        if not _same_bits(out, dequant_ref(x, scale, out_dtype=dt)):
            raise AssertionError(f"kernels.dequant != plain on the page, {dt}")
    if launches != len(dtypes):
        raise AssertionError(f"kernels.dequant launched the kernel {launches} times for {len(dtypes)} calls")
    print(f"kernels entry point: dequant of the {DEQUANT_PAGE} page in {len(dtypes)} dtypes, {launches} launches")
    del outs, x, scale

    for R, C in [(2048, 1024), DEQUANT_PAGE]:
        x, scale = _dequant_inputs(R, C, gen)
        for dt in dtypes:
            out = torch.empty((R, C), dtype=dt, device="cuda")
            library = lambda: torch.mul(x, scale, out=out)  # noqa: E731
            library()
            same = _same_bits(out, dequant_ref(x, scale, out_dtype=dt))
            n, library_device_ms = _device_kernels(library)
            _, kernel_device_ms = _device_kernels(lambda: dequant_call(x, scale, out_dtype=dt))
            ms = _time_ms(lambda: dequant_call(x, scale, out_dtype=dt))
            plain_ms = _time_ms(lambda: dequant_ref(x, scale, out_dtype=dt))
            # "none" only when the call is more than one kernel; a profiler
            # that saw no kernel at all leaves the count unknown, not zero
            library_ms = _time_ms(library) if n <= 1 else None
            nbytes = R * C * (1 + out.element_size()) + 4 * C
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3  # one multiply a value: bytes bound it
            print(
                f"dequant ({R}, {C}) int8 -> {dt}: kernel {ms:.4f} ms (device time alone "
                f"{kernel_device_ms:.4f} ms), plain {plain_ms:.4f} ms, torch.mul(out=) "
                f"{'none' if library_ms is None else f'{library_ms:.4f} ms'} "
                f"({n or 'no'} device kernels a call seen by the profiler, "
                f"device time alone {library_device_ms:.4f} ms, bitwise {'==' if same else '!='} plain), "
                f"bound {bound_ms:.4f} ms (bytes: {nbytes}); {nbytes / ms / 1e6:.1f} GB/s achieved"
            )
            if (R, C) == DEQUANT_PAGE and dt == torch.bfloat16:
                entry = {
                    "name": "dequant",
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/dequant/csrc/dequant.cu",
                    "replaces": "src/repro/kernels/dequant/kernel.py:33",
                    "launches": launches,
                    "max_abs_err": 0.0,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": "bytes",
                    "library_ms": library_ms,
                    "note": "no path of the system calls dequant: launches are those of its "
                            "entry point, repro_torch.kernels.dequant, on the page in bf16 and f32",
                }
            del out
        del x, scale
    torch.cuda.empty_cache()
    return entry


def _ssd_inputs(S, H, P, N, dtype, gen):
    """The reference tests' draws: x, B, C ~ N(0, 1) in ``dtype``,
    dt = softplus(N(0, 1)) and A = -exp(N(0, 1/4)) in f32."""
    x = torch.randn((1, S, H, P), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((1, S, H), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.5)
    Bm = torch.randn((1, S, N), generator=gen, device="cuda").to(dtype)
    Cm = torch.randn((1, S, N), generator=gen, device="cuda").to(dtype)
    return x, dt, A, Bm, Cm


def _ssd_f64(x, dt, A, Bm, Cm) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step recurrence in f64: an arbiter for the f32 sides."""
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    B, S, H, P = x.shape
    h = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float64, device=x.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhpn", Bm[:, t], dt[:, t], x[:, t]
        )
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def check_mamba2_ssd() -> dict:
    """The kernel against the chunked plain version at zamba2's SSM widths
    for each prompt length, f32 and bf16, once at mamba2-780m's (N 128) and
    the reduced configs' (P 32, N 16), and against the sequential
    recurrence; timed at each prompt length in bf16 beside its bound and the
    plain version (no single PyTorch call computes the scan), with the block
    count of each of its three passes."""
    from repro_torch.kernels.mamba2_ssd import ssd_ref_chunked, ssd_ref_sequential
    from repro_torch.kernels.mamba2_ssd.kernel import grid_blocks, route, ssd_call
    from repro_torch.models import get_config

    cfg = get_config(ZAMBA2)
    H, P, N, Q = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    gen = torch.Generator(device="cuda").manual_seed(3)
    print(f"mamba2_ssd vs plain at {cfg.name}'s widths (H {H}, P {P}, N {N}, chunk {Q}), B 1")
    print(
        f"  f32 y is held at rtol/atol {SSD_Y_TOL_FULL_F32[0]} here, not the reference's "
        f"{SSD_Y_TOL[torch.float32][0]}: full-width sums of 256 x 64 products in another "
        "order, growing with S through the carried state"
    )
    y_tol = {torch.float32: SSD_Y_TOL_FULL_F32, torch.bfloat16: SSD_Y_TOL[torch.bfloat16]}
    m780 = get_config("mamba2-780m")
    # zamba2's widths at each prompt length, mamba2-780m's (N 128) and the
    # reduced configs' (P 32, N 16)
    cases = [(S, H, P, N) for S in PROMPT_LENS] + [(1000, m780.ssm_nheads, P, m780.ssm_state), (1000, 8, 32, 16)]
    err = 0.0
    for S, h, p_, n in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(S, h, p_, n, dtype, gen)
            y, hT = ssd_call(*args, chunk=min(Q, S))
            y_ref, h_ref = ssd_ref_chunked(*args, chunk=Q)
            what = f"S {S} H {h} P {p_} N {n} {dtype}"
            e = _hold(y, y_ref, *y_tol[dtype], what + " y")
            _hold(hT, h_ref, *SSD_H_TOL, what + " final state")
            if (S, h, dtype) == (PROMPT_LENS[-1], H, torch.bfloat16):
                err = e
            if (S, h, dtype) == (PROMPT_LENS[-1], H, torch.float32):
                y64, _ = _ssd_f64(*args)
                print(
                    f"  {what} y vs an f64 recurrence: kernel max |err| "
                    f"{float((y.double() - y64).abs().max()):.3e}, plain "
                    f"{float((y_ref.double() - y64).abs().max()):.3e}"
                )
    args = _ssd_inputs(PROMPT_LENS[0], H, P, N, torch.float32, gen)
    y, hT = ssd_call(*args, chunk=Q)
    y_seq, h_seq = ssd_ref_sequential(*args)
    _hold(y, y_seq, *SSD_Y_TOL_FULL_F32, f"S {PROMPT_LENS[0]} f32 y vs the recurrence")
    _hold(hT, h_seq, *SSD_H_TOL, f"S {PROMPT_LENS[0]} f32 final state vs the recurrence")
    torch.cuda.synchronize()

    for S in PROMPT_LENS:
        args = _ssd_inputs(S, H, P, N, torch.bfloat16, gen)
        ms = _time_ms(lambda: ssd_call(*args, chunk=min(Q, S)))
        seen, device_ms = _device_kernels(lambda: ssd_call(*args, chunk=min(Q, S)))
        device = f"{device_ms:.4f} ms" if seen else "not measured"
        plain_ms = _time_ms(lambda: ssd_ref_chunked(*args, chunk=Q), launches=5)
        macs = 0.0
        for c0 in range(0, S, Q):
            q = min(Q, S - c0)
            # C·Bᵀ once per chunk (one B/C group), then per head the masked
            # product with x, the carry-in and the chunk's state
            macs += q * (q + 1) / 2 * N + H * (q * (q + 1) / 2 * P + 2 * q * P * N)
        nbytes = 2.0 * (2 * S * H * P + 2 * S * N) + 4.0 * (S * H + H + H * P * N)
        bound_ms, bound_by = _bound_ms(2 * macs, nbytes)
        blocks = grid_blocks(1, S, H, P, N, min(Q, S), torch.bfloat16)
        print(
            f"mamba2_ssd bf16 ({route(torch.bfloat16)} route) S {S}: kernel {ms:.4f} ms (device time "
            f"alone, three passes {device}), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{2 * macs / ms / 1e9:.1f} TFLOP/s achieved; blocks of the three passes "
            f"{blocks[0]} / {blocks[1]} / {blocks[2]} on "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs"
        )
    return {  # the longest prompt's
        "name": "mamba2_ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:100",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


# --------------------------------------------------------------- main path
@contextlib.contextmanager
def counting_unions():
    """Counts, while active, the ``device_union`` calls that copy (more than
    one non-empty run): each must launch the kernel exactly once.  Every
    caller looks ``device_union`` up in its module when it calls it."""
    from repro_torch.core import device

    inner, counts, lock = device.device_union, {"copying": 0}, threading.Lock()

    def counted(runs, columns, **kw):
        if sum(hi > lo for _arrays, lo, hi in runs) > 1:
            with lock:
                counts["copying"] += 1
        return inner(runs, columns, **kw)

    device.device_union = counted
    try:
        yield counts
    finally:
        device.device_union = inner


def _ledger(res) -> Dict[str, int]:
    return {
        k: int(getattr(res, k))
        for k in (
            "bytes_h2d", "bytes_d2h", "device_hits", "gather_fast",
            "gather_fallbacks", "device_union_bytes", "rows_to_user_fns",
        )
    }


def main_path(rows: int, frag: int, workdir: str, device: str = "cuda") -> Dict:
    """BENCH_8's edits through a device-tier workspace and a no-tier one,
    both running their torch nodes on ``device``.  Raises at the first edit
    whose outputs differ; the caller gates the ledgers."""
    from repro_torch.core.device import DeviceTier
    from repro_torch.kernels.fragment_gather import kernel
    from repro_torch.pipeline.executor import Workspace

    def sync() -> None:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    total = rows // frag * frag
    edits = bench_edits(total, frag)
    dev_ws = Workspace(
        os.path.join(workdir, "device"),
        rows_per_fragment=frag,
        device=DeviceTier(device=device),
    )
    ref_ws = Workspace(
        os.path.join(workdir, "plain"), rows_per_fragment=frag, torch_device=device
    )
    t0 = time.perf_counter()
    write_events(dev_ws.catalog, rows)
    write_events(ref_ws.catalog, rows)
    raw = {c: events(rows).column(c) for c in ("eventTime", "v1", "v2")}
    print(f"lake written: {rows} rows x 2 lakes, {time.perf_counter() - t0:.2f} s")

    iterations = []
    with counting_unions() as copying:
        kernel.launches = 0
        for label, windows, append in edits:
            if append is not None:
                write_events(dev_ws.catalog, **append)
                write_events(ref_ws.catalog, **append)
                extra = events(**append)
                raw = {c: np.concatenate([raw[c], extra.column(c)]) for c in raw}
            where = where_of(windows)
            t = time.perf_counter()
            dres = dev_ws.run(device_project(where))
            sync()
            dwall = time.perf_counter() - t
            t = time.perf_counter()
            rres = ref_ws.run(device_project(where))
            sync()
            rwall = time.perf_counter() - t
            want = expected_score(raw, windows)
            for name, table in dres.outputs.items():
                other = rres.outputs[name]
                if table.column_names != other.column_names:
                    raise AssertionError(f"{label}:{name} columns differ")
                for col in table.column_names:
                    if not np.array_equal(table.column(col), other.column(col)):
                        raise AssertionError(f"device tier != no tier at {label}:{name}:{col}")
            for name, table in dres.outputs.items():
                for col, t in getattr(table, "device_columns", {}).items():
                    if t.device.type != torch.device(device).type:
                        raise AssertionError(f"{label}:{name}:{col} served from {t.device}")
            score = dres.outputs["score"]
            for col, arr in want.items():
                if not np.array_equal(score.column(col), arr):
                    raise AssertionError(f"score != numpy reference at {label}:{col}")
            d, r = _ledger(dres), _ledger(rres)
            iterations.append({"label": label, "device": d, "plain": r})
            print(
                f"edit {label:10s} rows_out {score.num_rows:>9d}  wall device {dwall:.4f} s  "
                f"no-tier {rwall:.4f} s  h2d {d['bytes_h2d']:>11d} vs {r['bytes_h2d']:>11d} B  "
                f"gather fast/fb {d['gather_fast']}/{d['gather_fallbacks']}  bitwise ok"
            )
        launches = kernel.launches

    def warm(side: str, key: str) -> int:
        return sum(it[side][key] for it in iterations[1:])

    ratio = warm("plain", "bytes_h2d") / max(warm("device", "bytes_h2d"), 1)
    result = {
        "rows": rows,
        "frag": frag,
        "h2d_ratio": ratio,
        "gather_fast": warm("device", "gather_fast"),
        "launches": launches,
        "copying_unions": copying["copying"],
        "tier": dev_ws.device.stats(),
        "iterations": iterations,
    }
    print(
        f"main path: warm H2D {warm('plain', 'bytes_h2d')} B no-tier vs "
        f"{warm('device', 'bytes_h2d')} B tier = {ratio:.3f}x, gather_fast "
        f"{result['gather_fast']}, fragment_gather launches {launches} for "
        f"{result['copying_unions']} UNIONs that copy"
    )
    if torch.device(device).type == "cuda":
        profile_warm_edits(dev_ws, [e for e in edits if e[0] in ("split", "rerun2")])
    return result


# ----------------------------------------------------------- service path
def iteration_project(
    hi: int = 0,
    windows: Optional[List[Tuple[int, int]]] = None,
    columns=("v1", "v2"),
    gain: float = 1.0,
    materialize: bool = False,
) -> Project:
    """BENCH_4's four-stage pipeline (``benchmarks/workloads.py``'s
    ``iteration_project``) with ``feats`` on torch: cleaned (numpy, drops
    ``flag == 0``) -> enriched (numpy, adds ``mag``) -> feats (torch) ->
    final (numpy, gain-scaled).  The key window is ``[0, hi]`` (the
    reference's filter text) or, when given, the union of the half-open
    ``windows``."""
    where = where_of(windows) if windows else f"eventTime BETWEEN 0 AND {hi}"
    p = Project("iteration")
    cols = list(columns)

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def cleaned(data=Model(EVENTS_TABLE, columns=cols + ["flag"], filter=where)):
        return data.filter(data.column("flag") > 0)

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def enriched(data=Model("cleaned")):
        out = {n: data.column(n) for n in data.column_names}
        feats = [data.column(c) for c in data.column_names if c.startswith("v")]
        out["mag"] = np.sqrt(sum(f * f for f in feats))
        return out

    @model(project=p, incremental="rowwise")
    @runtime("torch")
    def feats(data=Model("enriched")):
        return {
            k: (torch.where(v >= 0, v, v * 0.5) if v.is_floating_point() else v)
            for k, v in data.items()
        }

    @model(project=p, incremental="rowwise", materialize=materialize)
    @runtime("numpy")
    def final(data=Model("feats")):
        out = {n: data.column(n) for n in data.column_names}
        out["score"] = gain * np.asarray(data.column("mag"), dtype=np.float64)
        return out

    return p


def service_tenants(rows: int, frag: int) -> List[Tuple[str, str, dict]]:
    """BENCH_4's tenants (``benchmarks/bench4_service.py``) and one that
    splits its window: ``(tenant, kind, iteration_project kwargs)``.  t3's two
    windows are aligned to ``frag`` and lie inside t0's."""
    q = lambda f: int(f * rows) // frag * frag
    return [
        ("t0", "cold fill", dict(hi=int(0.8 * rows))),
        ("t1", "widened", dict(hi=rows)),
        ("t2", "nested", dict(hi=int(0.6 * rows))),
        ("t3", "split", dict(windows=[(0, q(0.2)), (q(0.4), q(0.7))])),
    ]


def expected_final(raw: Dict[str, np.ndarray], hi: int = 0, windows=None) -> Dict[str, np.ndarray]:
    """``final``'s output computed in numpy from the generated rows, with
    the torch node's x32 narrowing of its inputs (the executor keeps the
    sort key's own width)."""
    keys = raw["eventTime"]
    if windows:
        mask = np.zeros(keys.shape[0], bool)
        for lo, hi_ in windows:
            mask |= (keys >= lo) & (keys < hi_)
    else:
        mask = (keys >= 0) & (keys <= hi)
    mask &= raw["flag"] > 0
    v1, v2 = raw["v1"][mask], raw["v2"][mask]
    half = np.float32(0.5)
    relu = lambda v: np.where(v >= 0, v, v * half)
    out = {
        "eventTime": keys[mask],
        "flag": raw["flag"][mask].astype(np.int32),
        "v1": relu(v1.astype(np.float32)),
        "v2": relu(v2.astype(np.float32)),
        "mag": relu(np.sqrt(0 + v1 * v1 + v2 * v2).astype(np.float32)),
    }
    out["score"] = out["mag"].astype(np.float64)
    return out


def _same_outputs(a, b, what: str) -> None:
    """Every output table of two runs, bitwise."""
    if set(a.outputs) != set(b.outputs):
        raise AssertionError(f"{what}: outputs {sorted(a.outputs)} != {sorted(b.outputs)}")
    for name, table in a.outputs.items():
        other = b.outputs[name]
        if table.column_names != other.column_names:
            raise AssertionError(f"{what}:{name} columns differ")
        for col in table.column_names:
            x, y = np.asarray(table.column(col)), np.asarray(other.column(col))
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                raise AssertionError(f"{what}:{name}:{col} differs")


def _check_final(res, raw, kw: dict, what: str) -> None:
    final = res.outputs["final"]
    want = expected_final(raw, **kw)
    if sorted(final.column_names) != sorted(want):
        raise AssertionError(f"{what}: final columns {final.column_names}")
    for col, arr in want.items():
        got = np.asarray(final.column(col))
        if got.dtype != arr.dtype or not np.array_equal(got, arr):
            raise AssertionError(f"{what}: final != numpy at {col}")


def _attach_tier(svc, device) -> None:
    """One device tier behind both shared stores, before the first session."""
    from repro_torch.core.device import DeviceTier

    svc.scan_cache.device = svc.model_store.device = DeviceTier(device=device)


def _raise_unless_done(handle) -> None:
    """A run that did not end DONE re-raises its exception: the scheduler
    isolates failures, so none may pass quietly."""
    from repro_torch.service import DONE

    if handle.state != DONE:
        raise handle.error or AssertionError(f"run {handle.run_id} ended {handle.state}")


def _run_tenants(svc, tenants) -> Dict[str, Tuple[object, float]]:
    """BENCH_4's discipline: t0 alone (the fill), then the rest submitted
    together.  Returns tenant -> (result, wall seconds)."""
    name, _kind, kw = tenants[0]
    t = time.perf_counter()
    first = svc.session(name).run(iteration_project(**kw))
    out = {name: (first, time.perf_counter() - t)}
    handles = [svc.submit(n, iteration_project(**kw)) for n, _k, kw in tenants[1:]]
    svc.drain()
    for h in handles:
        _raise_unless_done(h)
        out[h.tenant] = (h.result, h.wall_seconds)
    return out


def service_phase(rows: int, frag: int, workdir: str, device: str = "cuda") -> Dict:
    """The multi-tenant service over one device tier: BENCH_4's tenants
    (and t3, which splits its window) on a spill-backed
    ``PipelineService(workers=4)``, each held bitwise against a fresh
    no-tier cold service of its own and against numpy, with BENCH_4's >= 3x
    store-byte gate per warm tenant; then BENCH_5 on the same service: a
    clean shutdown and a restart over its root replaying t0..t3 (>= 5x
    fewer store bytes, bitwise), and four tenants submitting one pipeline
    together (0 duplicate user-function rows).  Raises at the first failed
    gate; the caller gates the kernel launches."""
    from repro_torch.kernels.fragment_gather import kernel
    from repro_torch.obs.trace import Tracer
    from repro_torch.service import PipelineService
    from repro_torch.trace import summarize

    cuda = torch.device(device).type == "cuda"
    tenants = service_tenants(rows, frag)
    raw = {c: events(rows).column(c) for c in ("eventTime", "v1", "v2", "flag")}

    def service(root, **kw):
        return PipelineService(root, rows_per_fragment=frag, torch_device=device, **kw)

    # cold references: one lake, and a fresh no-tier service per tenant
    cold = {}
    cold_root = os.path.join(workdir, "cold")
    for i, (name, _kind, kw) in enumerate(tenants):
        with service(cold_root, workers=1) as svc:
            if i == 0:
                write_events(svc.catalog, rows)
            t = time.perf_counter()
            res = svc.session(name).run(iteration_project(**kw))
            cold[name] = (res, time.perf_counter() - t)
        _check_final(res, raw, kw, f"cold {name}")

    root = os.path.join(workdir, "shared")
    tracer = Tracer()
    with service(root, workers=4, spill=True, tracer=tracer) as svc:
        _attach_tier(svc, device)
        write_events(svc.catalog, rows)
        before = svc.store.stats.snapshot()
        with counting_unions() as copying:
            kernel.launches = 0
            warm = _run_tenants(svc, tenants)
            launches = kernel.launches
        first_bytes = svc.store.stats.delta(before).bytes_read
        tenant_rows = {}
        for name, kind, kw in tenants:
            res, wall = warm[name]
            cres, cwall = cold[name]
            _same_outputs(res, cres, f"{name} vs its cold service")
            _check_final(res, raw, kw, name)
            ratio = cres.bytes_from_store / max(res.bytes_from_store, 1)
            tenant_rows[name] = {
                "kind": kind, "wall": wall, "cold_wall": cwall,
                "bytes_from_store": int(res.bytes_from_store),
                "cold_bytes_from_store": int(cres.bytes_from_store), "bytes_ratio": ratio,
                **_ledger(res),
            }
            r = tenant_rows[name]
            print(
                f"service {name} ({kind}): wall {wall:.4f} s (cold {cwall:.4f} s), "
                f"store bytes {r['bytes_from_store']} vs cold {r['cold_bytes_from_store']} "
                f"({ratio:.3f}x), rows_to_user_fns {r['rows_to_user_fns']} (cold "
                f"{int(cres.rows_to_user_fns)}), h2d {r['bytes_h2d']} B, device_hits "
                f"{r['device_hits']}, gather fast/fb {r['gather_fast']}/{r['gather_fallbacks']}, bitwise ok"
            )
            if name != tenants[0][0] and ratio < 3:
                raise AssertionError(f"{name}: store bytes only {ratio:.3f}x under its cold run")
        for name in ("t2", "t3"):
            if tenant_rows[name]["device_hits"] < 1:
                raise AssertionError(f"{name} was served nothing from the device tier")
        stats = svc.model_store.stats()
        print(
            f"service cross_tenant_hits model {stats['cross_tenant_hits']} scan "
            f"{svc.scan_cache.stats()['cross_tenant_hits']}; tier {svc.model_store.device.stats()}"
        )
        t3 = [sp for sp in tracer.roots() if sp.attrs.get("tenant") == "t3"]
        print("spans of t3:\n" + summarize(t3))
        if cuda:
            # one more warm run of t3, profiled; after the launches were read
            from torch.profiler import ProfilerActivity, profile

            split = next(kw for n, _k, kw in tenants if n == "t3")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                svc.session("t3").run(iteration_project(**split))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            print_profile("service t3 warm", prof, wall)

    # BENCH_5: restart over the same root with a new tier, replay t0..t3
    t = time.perf_counter()
    with service(root, workers=4, spill=True) as svc:
        _attach_tier(svc, device)
        restored = svc.model_store.spill_restored + svc.scan_cache.spill_restored
        again = _run_tenants(svc, tenants)
        restart_wall = time.perf_counter() - t
        restart_bytes = svc.store.stats.bytes_read
        promotions = svc.model_store.stats()["promotions"]
        for name, _kind, _kw in tenants:
            _same_outputs(again[name][0], warm[name][0], f"restart {name}")
    restart_ratio = first_bytes / max(restart_bytes, 1)
    print(
        f"service restart: store bytes {restart_bytes} vs {first_bytes} before "
        f"({restart_ratio:.3f}x), {restored} elements restored, {promotions} promotions, "
        f"rows_to_user_fns {sum(int(r.rows_to_user_fns) for r, _w in again.values())}, "
        f"wall {restart_wall:.4f} s, bitwise ok"
    )
    if restart_ratio < 5:
        raise AssertionError(f"restart moved only {restart_ratio:.3f}x fewer store bytes")

    # BENCH_5: four tenants submit the identical pipeline together
    single, _w = cold[tenants[0][0]]
    with service(os.path.join(workdir, "coalesced"), workers=4) as svc:
        _attach_tier(svc, device)
        write_events(svc.catalog, rows)
        kw = tenants[0][2]
        handles = [svc.submit(n, iteration_project(**kw)) for n, _k, _kw in tenants]
        svc.drain()
        for h in handles:
            _raise_unless_done(h)
            _same_outputs(h.result, single, f"coalesced {h.tenant}")
        total = sum(int(h.result.rows_to_user_fns) for h in handles)
        waits = svc.model_store.coalesced_waits + svc.scan_cache.coalesced_waits
    duplicate = total - int(single.rows_to_user_fns)
    print(
        f"service coalesced x{len(handles)}: rows_to_user_fns {total} vs one run "
        f"{int(single.rows_to_user_fns)}, duplicates {duplicate}, coalesced waits {waits}, bitwise ok"
    )
    if duplicate != 0:
        raise AssertionError(f"{duplicate} duplicate user-function rows when coalesced")
    return {
        "rows": rows,
        "frag": frag,
        "launches": launches,
        "copying_unions": copying["copying"],
        "tenants": tenant_rows,
        "cross_tenant_hits": stats["cross_tenant_hits"],
        "restart_ratio": restart_ratio,
        "duplicate_rows": duplicate,
    }


def explain_phase(workdir: str, device: str = "cuda") -> int:
    """The explain CLI's 11-edit matrix on ``device``; raises unless every
    diagnosed cause is the one the edit injected."""
    from repro_torch.explain import edit_matrix_demo

    results = edit_matrix_demo(workdir, device=device)
    ok = sum(expected == got for _label, expected, got, _res in results)
    print(f"explain on {device}: {ok}/{len(results)} causes diagnosed correctly")
    if ok != len(results):
        raise AssertionError(
            "explain: " + ", ".join(f"{l} {e}!={g}" for l, e, g, _r in results if e != g)
        )
    return ok


# ---------------------------------------------------------------- examples
EXAMPLES_DIR = os.path.join(ROOT, "examples", "torch")
EXAMPLES = [
    "quickstart", "incremental_iteration", "multi_tenant_service", "serve_batch", "train_e2e",
    "multi_user_cache", "incremental_join", "trace_iteration", "chaos_restart", "lint_pipeline",
]
WALKER_RUNS = sys.implementation.name == "cpython" and (3, 10) <= sys.version_info[:2] <= (3, 11)
RESUME_STEPS = 20  # train_e2e checkpoints every 10 steps at this length


def _all_launch_counts() -> Dict[str, int]:
    from repro_torch.kernels.dequant import kernel as dq_kernel
    from repro_torch.kernels.fragment_gather import kernel as fg_kernel

    return {"fragment_gather": fg_kernel.launches, "dequant": dq_kernel.launches, **_launch_counts()}


def _zero_all_launch_counts() -> None:
    from repro_torch.kernels.dequant import kernel as dq_kernel
    from repro_torch.kernels.fragment_gather import kernel as fg_kernel

    fg_kernel.launches = dq_kernel.launches = 0
    _zero_launch_counts()


def _with_arg(args: List[str], flag: str, value: str) -> List[str]:
    """``args`` with ``flag`` set to ``value``."""
    if flag not in args:
        return list(args) + [flag, value]
    i = args.index(flag)
    return list(args[: i + 1]) + [value] + list(args[i + 2:])


def load_example(name: str):
    """``examples/torch/<name>.py`` as a module (``examples/`` is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: List[str], device) -> Tuple[object, str, float]:
    """One example's ``main(argv)`` in this process, as a user's script runs
    it (its own asserts included): (its return value, its stdout, wall
    seconds).  The stdout is echoed indented, also when the example fails."""
    import io

    mod = load_example(name)
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            ret = mod.main(argv)
        _sync(device)
    finally:
        wall = time.perf_counter() - t
        for line in buf.getvalue().splitlines():
            print(f"  | {line}")
    return ret, buf.getvalue(), wall


def profile_example_step(device, batch: int = 8, seq: int = 256) -> None:
    """One step of train_e2e's model and optimizer at its default batch,
    after two warm-up steps, under the profiler: the card's busy time, its
    idle share and the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import get_model
    from repro_torch.train.loop import make_init_state, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig

    api = get_model(load_example("train_e2e").build_100m_config())
    opt = OptimizerConfig(kind="adamw", peak_lr=3e-4, warmup_steps=20, decay_steps=200)
    state = make_init_state(api, opt)(torch.Generator().manual_seed(0), device)
    step = make_train_step(api, opt)
    toks = np.random.default_rng(0).integers(0, api.cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    batch_ = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "loss_mask": np.ones((batch, seq), np.float32)}
    for _ in range(2):
        state, metrics = step(state, batch_)
        float(metrics["loss"])
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, metrics = step(state, batch_)
        float(metrics["loss"])
        _sync(device)
        wall = time.perf_counter() - t
    print_profile(f"train_e2e step ({batch} x {seq}, f32)", prof, wall, top_n=8)


def examples_phase(workdir: str, device="cuda", train_args: Optional[List[str]] = None,
                   resume_steps: int = RESUME_STEPS) -> Dict:
    """The port's ten examples (``examples/torch/``) on ``device``, each
    through its ``main`` in this process with its own asserts: the nine
    other than ``lint_pipeline``, which runs only where the bytecode walker
    runs (CPython 3.10/3.11; elsewhere it abstains and the example's lint
    asserts, like its reference's, cannot hold).  ``train_e2e`` runs with
    ``train_args`` (default: its own defaults, 200 steps of 8 x 256), then
    at ``resume_steps`` on a fresh workdir twice: the second call must
    resume from that step.  ``quickstart`` also runs as a user types it,
    ``python examples/torch/quickstart.py``, in a process of its own without
    ``PYTHONPATH``.  Every kernel's launch count is set to 0 before the
    phase; each example's line gives the four counts before and after it.
    Returns the counts at the end and each example's wall."""
    cpu = torch.device(device).type == "cpu"
    dev = ["--device", "cpu"] if cpu else []
    card = _card(device)
    print(f"examples phase | {card}", flush=True)
    _zero_all_launch_counts()
    t0 = time.perf_counter()
    walls: Dict[str, float] = {}
    train: Dict[str, float] = {}

    def line(label: str, wall: float, before: Dict[str, int], extra: str = "") -> None:
        after = _all_launch_counts()
        print(f"  example {label}: wall {wall:.3f} s, kernel launches before {before} after {after}{extra} "
              f"| {card}", flush=True)

    old_tmp = tempfile.tempdir
    tempfile.tempdir = workdir  # the examples' temporary lakes and trace land in the phase's directory
    try:
        for name in EXAMPLES:
            if name == "lint_pipeline" and not WALKER_RUNS:
                print(f"  example lint_pipeline: not run: Python {sys.version.split()[0]}, where the bytecode "
                      f"walker abstains (it runs on CPython 3.10/3.11), so the example's lint asserts fail "
                      f"as its reference's do | {card}", flush=True)
                continue
            argv = list(dev)
            if name == "train_e2e":
                argv += list(train_args or []) + ["--workdir", os.path.join(workdir, "train")]
            before = _all_launch_counts()
            ret, _text, wall = run_example(name, argv, device)
            walls[name] = wall
            extra = ""
            if name == "train_e2e":
                sec, tokens = ret["step_seconds"], ret["tokens_per_step"]
                med = float(np.median(sec[1:-1]))  # step 1 warms up; the last may wait on a checkpoint
                train = {"steps": len(sec), "median_ms": med * 1e3, "tokens_per_s": tokens / med,
                         "loss_first": ret["losses"][0], "loss_last": ret["losses"][-1]}
                extra = (f"; {len(sec)} steps of {tokens} tokens: {med * 1e3:.2f} ms a step (median of steps "
                         f"2-{len(sec) - 1}), {tokens / med:.0f} tokens/s, loss {ret['losses'][0]:.4f} -> "
                         f"{ret['losses'][-1]:.4f}")
            line(name, wall, before, extra)

        # train_e2e's restart path: a fresh workdir, then the same one again
        resume = os.path.join(workdir, "resume")
        short = dev + _with_arg(train_args or [], "--steps", str(resume_steps)) + ["--workdir", resume]
        for attempt in ("fresh", "resumed"):
            before = _all_launch_counts()
            _ret, text, wall = run_example("train_e2e", short, device)
            said = f"resumed from checkpoint step {resume_steps}" in text
            if said != (attempt == "resumed"):
                raise AssertionError(f"train_e2e {attempt} run on {resume}: "
                                     f"{'no' if not said else 'an unexpected'} resume line")
            line(f"train_e2e --steps {resume_steps} ({attempt})", wall, before)

        # quickstart as a user types it: its own process, no PYTHONPATH
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["TMPDIR"] = workdir
        cmd = [sys.executable, os.path.join("examples", "torch", "quickstart.py")] + dev
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        for out_line in proc.stdout.splitlines():
            print(f"  | {out_line}")
        if proc.returncode != 0 or "final training_data columns" not in proc.stdout:
            raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr[-2000:]}")
        print(f"  example quickstart as `python {' '.join(cmd[1:])}` (a process of its own, no PYTHONPATH): "
              f"wall {wall:.3f} s, exit 0 | {card}", flush=True)
        walls["quickstart (process)"] = wall
    finally:
        tempfile.tempdir = old_tmp
    if not cpu:
        profile_example_step(device)
    launches = _all_launch_counts()
    seconds = time.perf_counter() - t0
    print(f"examples phase: {seconds:.1f} s, kernel launches {launches} | {card}", flush=True)
    return {"launches": launches, "walls": walls, "train": train, "seconds": seconds}


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total", 0) or 0)


def profile_warm_edits(ws, edits) -> None:
    """One more warm run of each edit under torch.profiler: its wall time,
    the workspace's spans by total time, the card's busy time (kernels and
    copies) and idle share, and the device ops that took the most time.
    Runs after the main path's counts are read, so it adds no launches to
    them."""
    from torch.profiler import ProfilerActivity, profile

    for label, windows, _append in edits:
        where = where_of(windows)
        ws.run(device_project(where))
        torch.cuda.synchronize()
        ws.tracer.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            ws.run(device_project(where))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        spans = sorted(ws.tracer.summary().items(), key=lambda kv: -kv[1]["total_s"])
        print(
            f"spans {label}: "
            + "; ".join(f"{n} {v['total_s']:.4f} s x{v['count']}" for n, v in spans[:8])
        )
        print_profile(label, prof, wall)


def print_profile(label: str, prof, wall: float, top_n: int = 6) -> None:
    """One line: the wall, the card's busy time (kernels and copies), its
    idle share and the device ops that took the most time."""
    device_ops = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
    ]
    if not device_ops:
        print(f"profile {label}: wall {wall:.4f} s, device time not measured")
        return
    busy = sum(_device_us(e) for e in device_ops) / 1e6
    top = sorted(device_ops, key=_device_us, reverse=True)[:top_n]
    print(
        f"profile {label}: wall {wall:.4f} s, device busy {busy:.6f} s, "
        f"idle share {1 - busy / wall:.4f}; top device ops: "
        + "; ".join(f"{e.key[:60]} {_device_us(e) / 1e3:.3f} ms x{e.count}" for e in top)
    )


# the device kernels of each port kernel's launch, by name
PORT_KERNEL_NAMES = {
    "flash_attention": ("flash_attention_wgmma", "flash_attention_tc", "flash_attention_fwd"),
    "flash_attention_bwd": ("flash_attention_bwd_delta", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq"),
    "mamba2_ssd": ("ssd_states_", "ssd_pass_states", "ssd_outputs_"),
}


def print_kernel_time(label: str, prof) -> None:
    """One line: each port kernel's device time in the profile, all its
    device kernels summed (the SSD's three passes are one launch of the
    wrapper), and each device kernel's own."""
    parts = []
    for name, keys in PORT_KERNEL_NAMES.items():
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.key for k in keys)]
        if ops:
            by_op = ", ".join(
                f"{next(k for k in keys if k in e.key).strip('_')} {_device_us(e) / 1e3:.3f} ms x{e.count}" for e in ops
            )
            parts.append(f"{name} {sum(_device_us(e) for e in ops) / 1e3:.3f} ms ({by_op})")
    print(f"kernel time {label}: " + ("; ".join(parts) if parts else "no port kernel"))


# ------------------------------------------------------------- serve path
def _prompts(rng: np.random.Generator, lengths, vocab: int) -> List[np.ndarray]:
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lengths]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def model_config(arch: str, *, dtype: str, kernels: bool, layers: Optional[int] = None):
    """The arch's published config in ``dtype``, kernels on or off, and its
    depth cut to ``layers`` where given; widths are never changed."""
    import dataclasses

    from repro_torch.models import get_config

    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, dtype=dtype, use_pallas_kernels=kernels, num_layers=layers or cfg.num_layers
    )


def _depth(cfg) -> str:
    from repro_torch.models import get_config

    full = get_config(cfg.name)
    width = "full width" if cfg.d_model == full.d_model else f"reduced width (d_model {cfg.d_model})"
    if cfg.num_layers == full.num_layers:
        return f"{width} and depth"
    return f"{width}, depth cut to {cfg.num_layers} of {full.num_layers} layers"


@contextlib.contextmanager
def _router_logits():
    """Records the f32 router logits of every MoE layer the model runs, in
    order, as ``moe_apply`` computes them from its input."""
    from repro_torch.models import transformer

    records: List[torch.Tensor] = []
    inner = transformer.moe_apply

    def traced(cfg, x, w):
        records.append(torch.einsum("bsd,de->bse", x.float(), w["router"].float()))
        return inner(cfg, x, w)

    transformer.moe_apply = traced
    try:
        yield records
    finally:
        transformer.moe_apply = inner


NEAR_TIE = 1e-3  # a margin under this is a tie that rounding may break


def _routing_flips(on: List[torch.Tensor], off: List[torch.Tensor], k: int) -> Optional[Tuple[int, float]]:
    """Prints, per MoE layer, the tokens whose top-k experts differ between
    the two sides and the kernels-off margin between the k-th and (k+1)-th
    router logit.  Returns the first layer that differs and the largest
    margin among its differing tokens, or None."""
    first = None
    for layer, (a, b) in enumerate(zip(on, off)):
        ids_a = torch.topk(a, k, dim=-1).indices.sort(dim=-1).values
        ids_b = torch.topk(b, k, dim=-1).indices.sort(dim=-1).values
        flipped = (ids_a != ids_b).any(dim=-1)
        top = torch.topk(b, k + 1, dim=-1).values
        margin = top[..., k - 1] - top[..., k]
        n = int(flipped.sum())
        line = f"  MoE layer {layer}: {n} tokens routed differently; smallest top-{k} margin {float(margin.min()):.4e}"
        if n:
            worst = float(margin[flipped].max())
            line += f"; largest margin among them {worst:.4e}"
            if first is None:
                first = (layer, worst)
        print(line)
    return first


@contextlib.contextmanager
def _attention_calls(cfg):
    """Records the input, arguments and output of every full-sequence
    attention call the model family makes, in order."""
    from repro_torch.models.registry import _family_module

    module = _family_module(cfg.family)
    records: List[tuple] = []
    inner = module.attention_train

    def traced(cfg, x, *args, **kw):
        out = inner(cfg, x, *args, **kw)
        records.append((x, args, kw, out[0] if isinstance(out, tuple) else out))
        return out

    module.attention_train = traced
    try:
        yield records
    finally:
        module.attention_train = inner


def _one_ulp(t: torch.Tensor, seed: int = 5) -> torch.Tensor:
    """``t`` with every value moved one float step up or down at random:
    the size of one rounding of the value."""
    gen = torch.Generator(device=t.device).manual_seed(seed)
    sign = torch.randint(0, 2, t.shape, generator=gen, device=t.device).to(t.dtype) * 2 - 1
    return torch.nextafter(t, t + sign)


def _attribute_to_the_chain(cfg, api_off, params, toks, calls_off, err: float) -> None:
    """Logits of the kernels-on and -off stacks differ beyond the bar: pass
    only when (1) every attention layer, fed the kernels-off stack's own
    input, gives the kernel's output within the bar of the plain one, and
    (2) the kernels-off stack alone moves its logits beyond the bar when
    its embeddings move by one rounding step, so the stack, not an
    attention layer, grows rounding-sized differences.  Raises otherwise."""
    import dataclasses

    from repro_torch.models.layers import attention_train

    on_cfg = dataclasses.replace(cfg, use_pallas_kernels=True)
    worst = (0.0, 0.0, -1)
    for i, (x, args, kw, out_off) in enumerate(calls_off):
        out_on = attention_train(on_cfg, x, *args, **kw)
        out_on = out_on[0] if isinstance(out_on, tuple) else out_on
        ok, max_err, ratio = _closeness(out_on, out_off, 2e-3, 2e-3)
        if not ok:
            raise AssertionError(f"attention layer {i}: kernel vs plain on one input, max |err| {max_err:.3e}")
        worst = max(worst, (ratio, max_err, i))
    print(
        f"  each of {len(calls_off)} attention layers, kernel vs plain on the kernels-off stack's "
        f"input: within the bar, worst err/bar {worst[0]:.3f} (max |err| {worst[1]:.3e}, layer {worst[2]})"
    )
    lg_off, _ = api_off.prefill(params, toks)
    lg_ulp, _ = api_off.prefill(dict(params, embed=_one_ulp(params["embed"])), toks)
    ok, max_err = _compare(lg_ulp, lg_off, 2e-3, 2e-3, "kernels-off logits, embeddings moved by one rounding step")
    if ok:
        raise AssertionError("the stack keeps rounding-sized differences inside the bar, the kernel's do not")
    print(
        f"  the kernels on/off difference ({err:.3e}) is the stack's growth of rounding differences "
        f"(one rounding step of the embeddings: {max_err:.3e}); logits not held, greedy tokens not compared"
    )


def consistency_phase(cfg, lengths, *, greedy: bool, device="cuda", new_tokens: int = 16) -> None:
    """``cfg`` in f32: prefill logits with the kernels on equal those with
    them off within 2e-3 (the reference's bar, tests/test_kernels.py:205-208).
    A difference beyond the bar must trace to a router near-tie in an MoE
    model (``_routing_flips``) or, failing that, to the stack's own growth of
    rounding differences with every attention layer held alone
    (``_attribute_to_the_chain``).  With ``greedy``, and the logits held,
    engine runs on both sides give the same tokens up to the first step
    whose kernels-off top-2 logit margin is under 1e-3."""
    import dataclasses

    from repro_torch.models import get_model
    from repro_torch.serve import GenerateRequest, ServeEngine

    apis = {
        "on": get_model(dataclasses.replace(cfg, use_pallas_kernels=True)),
        "off": get_model(dataclasses.replace(cfg, use_pallas_kernels=False)),
    }
    params = apis["on"].init_params(torch.Generator(device=device).manual_seed(0), device)
    prompts = _prompts(np.random.default_rng(1), lengths, cfg.vocab_size)
    print(f"consistency: {cfg.name} {cfg.dtype}, {_depth(cfg)} ({cfg.param_count()} parameters)")
    held = True  # every prompt's logits within the bar, or traced to a router near-tie
    with torch.inference_mode():
        for p in prompts:
            toks = torch.tensor(p, device=device)[None]
            with _router_logits() as routed_on:
                lg_on, _ = apis["on"].prefill(params, toks)
            with _router_logits() as routed_off, _attention_calls(cfg) as calls_off:
                lg_off, _ = apis["off"].prefill(params, toks)
            ok, err = _compare(lg_on, lg_off, 2e-3, 2e-3, f"prefill logits, kernels on vs off, S {len(p)}")
            first = _routing_flips(routed_on, routed_off, cfg.experts_per_token) if cfg.num_experts else None
            if not ok and first is not None:
                if first[1] >= NEAR_TIE:
                    raise AssertionError(f"routing differs in MoE layer {first[0]} at a margin of {first[1]:.3e}")
                print(f"  the difference traces to router near-ties: first in MoE layer {first[0]}, "
                      f"margins < {NEAR_TIE}")
            elif not ok:
                _attribute_to_the_chain(cfg, apis["off"], params, toks, calls_off, err)
                held = False
            del lg_on, lg_off, routed_on, routed_off, calls_off

    if greedy and held:
        tokens, margins = {}, []

        def recording(api, record: bool):
            def note(logits):
                if record:
                    top = torch.topk(logits[0, -1].float(), 2).values
                    margins.append(float(top[0] - top[1]))
                return logits

            def prefill(params, tokens, prefix_embeds=None, max_len=None):
                lg, cache = api.prefill(params, tokens, prefix_embeds, max_len)
                return note(lg), cache

            def decode_step(params, tokens, cache):
                lg, cache = api.decode_step(params, tokens, cache)
                return note(lg), cache

            return dataclasses.replace(api, prefill=prefill, decode_step=decode_step)

        for name, api in apis.items():
            # one slot: each logits row belongs to the one active request, in order
            eng = ServeEngine(recording(api, name == "off"), params, slots=1,
                              max_context=max(2048, max(lengths) + new_tokens + 1), device=device)
            rids = [eng.submit(GenerateRequest(prompt=p, max_new_tokens=new_tokens)) for p in prompts]
            res = eng.run_until_drained()
            tokens[name] = [res[r].tokens.tolist() for r in rids]
            del eng
        for i, p in enumerate(prompts):
            on, off = tokens["on"][i], tokens["off"][i]
            m = margins[i * new_tokens : (i + 1) * new_tokens]
            first = next((k for k in range(new_tokens) if on[k] != off[k]), None)
            if first is not None and m[first] >= NEAR_TIE:
                raise AssertionError(
                    f"greedy tokens differ at step {first} of prompt {len(p)} with a margin of {m[first]:.3e}"
                )
            print(
                f"  greedy S {len(p)}: {new_tokens} tokens, kernels on == off "
                + ("for all" if first is None else f"up to step {first}")
                + f"; smallest kernels-off top-2 margin {min(m):.4e}"
                + ("" if first is None else f", at the divergence {m[first]:.4e}")
            )
    del params
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


SERVE_REQUESTS = 8
SERVE_NEW_TOKENS = 32


def serve_phase(
    cfg,
    *,
    slots: int,
    max_context: int,
    lengths: Optional[List[int]] = None,
    new_tokens: int = SERVE_NEW_TOKENS,
    sampled: bool = True,
    profile_len: int = 1000,
    device="cuda",
) -> Dict[str, int]:
    """``cfg`` behind ``ServeEngine(slots, max_context)``.  Without
    ``lengths``, eight requests of 256-1536 prompt tokens from a seeded
    numpy generator (one length not a multiple of 256); ``sampled`` makes
    every other request sample at temperature 0.8 with top-k 20, the rest
    are greedy.  The kernels' launch counts are set to 0 just before the run
    and read just after; every prefill must launch flash_attention once per
    attention layer (per shared-block application in the hybrid) and
    mamba2_ssd once per Mamba2 layer.  A sliding-window model must hold a
    ring cache of the window.  Prints the timings, the peak device memory
    and profiles of four decode steps and one prefill of ``profile_len``
    tokens.  Returns the launch counts."""
    import dataclasses

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mamba2_ssd import kernel as ssd_kernel
    from repro_torch.models import get_model
    from repro_torch.models.hybrid import n_shared_applications
    from repro_torch.models.transformer import cache_len
    from repro_torch.serve import GenerateRequest, ServeEngine
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    api = get_model(cfg)
    params = api.init_params(torch.Generator(device=device).manual_seed(0), device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()  # serving's peak, not the f32 draws of the init
    rng = np.random.default_rng(0)
    if lengths is None:
        lengths = rng.integers(256, 1537, SERVE_REQUESTS).tolist()
        if not any(n % 256 for n in lengths):
            raise AssertionError("every prompt length is a multiple of 256")
    prompts = _prompts(rng, lengths, cfg.vocab_size)
    requests = [
        GenerateRequest(
            prompt=p, max_new_tokens=new_tokens,
            temperature=0.8 if sampled and i % 2 else 0.0, top_k=20 if sampled and i % 2 else 0,
        )
        for i, p in enumerate(prompts)
    ]
    if cfg.family == "hybrid":
        per_prefill = {"flash_attention": n_shared_applications(cfg), "mamba2_ssd": cfg.num_layers}
    elif cfg.family == "ssm":
        per_prefill = {"flash_attention": 0, "mamba2_ssd": cfg.num_layers}
    else:
        per_prefill = {"flash_attention": cfg.num_layers, "mamba2_ssd": 0}
    print(
        f"serve: {cfg.name} {cfg.dtype}, {_depth(cfg)} ({cfg.param_count()} parameters), "
        f"kernel launches a prefill {per_prefill}, slots {slots}, max_context {max_context}, "
        f"prompts {lengths}, {new_tokens} new tokens each"
    )

    prefill_ms: List[Tuple[int, float]] = []
    decode_ms: List[float] = []

    def timed(api):
        def prefill(params, tokens, prefix_embeds=None, max_len=None):
            _sync(device)
            t = time.perf_counter()
            out = api.prefill(params, tokens, prefix_embeds, max_len)
            _sync(device)
            prefill_ms.append((tokens.shape[1], (time.perf_counter() - t) * 1e3))
            return out

        def decode_step(params, tokens, cache):
            _sync(device)
            t = time.perf_counter()
            out = api.decode_step(params, tokens, cache)
            _sync(device)
            decode_ms.append((time.perf_counter() - t) * 1e3)
            return out

        return dataclasses.replace(api, prefill=prefill, decode_step=decode_step)

    # warm-up (library loads, cuBLAS handles) on an engine of its own
    warm = ServeEngine(api, params, slots=1, max_context=max_context, device=device)
    warm.submit(GenerateRequest(prompt=prompts[0][:256], max_new_tokens=2))
    warm.run_until_drained()
    del warm

    eng = ServeEngine(timed(api), params, slots=slots, max_context=max_context, device=device)
    for r in requests:
        eng.submit(r)
    fa_kernel.launches = 0
    ssd_kernel.launches = 0
    for counts in (fa_kernel.launches_by_route, ssd_kernel.launches_by_route):
        counts.update(dict.fromkeys(counts, 0))
    t0 = time.perf_counter()
    results = eng.run_until_drained()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa_kernel.launches, "mamba2_ssd": ssd_kernel.launches}
    by_route = {"flash_attention": dict(fa_kernel.launches_by_route),
                "mamba2_ssd": dict(ssd_kernel.launches_by_route)}

    n = len(requests)
    if len(results) != n or eng.prefills != n:
        raise AssertionError(f"{len(results)} results and {eng.prefills} prefills for {n} requests")
    for r in requests:
        t = results[r.req_id].tokens
        if t.shape != (new_tokens,) or not ((0 <= t) & (t < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.req_id}: tokens {t}")
    # off the card the wrappers take the plain versions and launch nothing
    want = {k: (v * eng.prefills if cuda else 0) for k, v in per_prefill.items()}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} for {eng.prefills} prefills")
    dtype_route = fa_kernel.route(getattr(torch, cfg.dtype))
    for name, counts in by_route.items():
        if counts[dtype_route] != launches[name]:
            raise AssertionError(f"{name}: {counts} by route, not all {launches[name]} on {dtype_route}")
    if cfg.sliding_window:
        T = eng.cache["k"].shape[2]
        if T != cache_len(cfg, max_context) or T != cfg.sliding_window:
            raise AssertionError(f"the KV cache holds {T} slots, not the {cfg.sliding_window}-slot ring")
        print(f"  KV cache: a ring of {T} slots for a {max_context}-token context")
    generated = n * new_tokens
    peak = f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB" if cuda else "not measured"
    print(
        f"  {eng.prefills} prefills, {eng.decode_steps} decode steps, wall {wall:.3f} s, "
        f"{generated} tokens generated = {generated / wall:.1f} tokens/s; launches {launches} "
        f"(route {dtype_route}); "
        f"peak device memory {peak}"
    )
    print("  prefill ms by prompt length: " + ", ".join(f"{n}: {ms:.2f}" for n, ms in prefill_ms))
    print(
        f"  decode ms per step: median {float(np.median(decode_ms)):.3f}, "
        f"mean {float(np.mean(decode_ms)):.3f}, min {min(decode_ms):.3f}, max {max(decode_ms):.3f}"
    )

    if cuda:
        # profiles, after the counts are read: a few decode steps of the
        # full batch, and one prefill of profile_len tokens
        tokens = torch.zeros((slots, 1), dtype=torch.int32, device=device)
        with torch.inference_mode():
            _, cache = api.decode_step(params, tokens, eng.cache)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for _ in range(4):
                    _, cache = api.decode_step(params, tokens, cache)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            print_profile(f"{cfg.name} decode x4 (batch {slots})", prof, wall, top_n=8)
            toks = torch.tensor(_prompts(rng, [profile_len], cfg.vocab_size)[0], device=device)[None]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                api.prefill(params, toks, max_len=max_context)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            print_profile(f"{cfg.name} prefill S {profile_len}", prof, wall, top_n=8)
            print_kernel_time(f"{cfg.name} prefill S {profile_len}", prof)
        del cache
        torch.cuda.empty_cache()
    del params, eng
    if cuda:
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- training
TRAIN_ARGS = ["--arch", GRANITE, "--steps", "8", "--batch", "4", "--seq", "1024"]
CUT_LAYERS = 2  # parts b-d: granite's full width, depth cut to 2 of 40 layers


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mamba2_ssd import kernel as ssd_kernel

    return {"flash_attention": fa_kernel.launches, "flash_attention_bwd": fa_kernel.launches_bwd,
            "mamba2_ssd": ssd_kernel.launches}


def _zero_launch_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mamba2_ssd import kernel as ssd_kernel

    fa_kernel.launches = 0
    fa_kernel.launches_bwd = 0
    ssd_kernel.launches = 0


@contextlib.contextmanager
def plain_attention():
    """Training attention on its plain path whatever the inputs: for the
    comparisons whose other side cannot take the kernel (a step under
    sharding rules, on DTensors; the cost model's count of a step on fake
    tensors), so both sides run the same attention."""
    from repro_torch.models import layers

    route = layers.trains_on_the_kernel
    layers.trains_on_the_kernel = lambda q, k, v: False
    try:
        yield
    finally:
        layers.trains_on_the_kernel = route


def launch_phase(workdir: str, args: List[str], device="cuda") -> Dict[str, float]:
    """Part a: ``repro_torch.launch.train.main`` as a user runs it, with the
    last step profiled.  Every loss and gradient norm finite, the last loss
    below the first, the object-store bytes flat from the end of step 2 on
    (the launcher's corpus holds two steps, so steps 3-8 are epochs 2-4,
    served by the differential cache).  Prints ms per step (median of steps
    2-7, with min and max: step 1 warms up, and the profiler's collection
    lands in the last step's time), tokens/s and the peak device memory."""
    from repro_torch.launch import train

    steps = int(args[args.index("--steps") + 1])
    tokens = int(args[args.index("--batch") + 1]) * int(args[args.index("--seq") + 1])
    argv = args + ["--workdir", workdir, "--profile-step", str(steps)]
    if torch.device(device).type == "cpu":
        argv += ["--device", "cpu"]
    print("train: python -m repro_torch.launch.train " + " ".join(argv))
    if train.main(argv) != 0:
        raise AssertionError("the launcher failed")
    with open(os.path.join(workdir, train.LOG_NAME)) as f:
        log = [json.loads(line) for line in f]
    if [r["step"] for r in log] != list(range(1, steps + 1)):
        raise AssertionError(f"the launcher logged steps {[r['step'] for r in log]}")
    losses = [r["loss"] for r in log]
    norms = [r["grad_norm"] for r in log]
    store = [r["store_bytes"] for r in log]
    ms = [r["seconds"] * 1e3 for r in log[1:-1]]
    med = float(np.median(ms))
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
            if torch.device(device).type == "cuda" else "not measured")
    print(f"  losses {[round(x, 4) for x in losses]}")
    print(f"  gradient norms {[round(x, 4) for x in norms]}")
    print(f"  store bytes after each step {store}: epoch 1 read {store[1]}, epochs 2-{steps // 2} read "
          f"{store[-1] - store[1]}")
    print(f"  ms per step, steps 2-{steps - 1}: median {med:.1f}, min {min(ms):.1f}, max {max(ms):.1f} "
          f"(step 1 {log[0]['seconds'] * 1e3:.1f}, step {steps} profiled {log[-1]['seconds'] * 1e3:.1f}); "
          f"{tokens / med * 1e3:.0f} tokens/s; peak device memory {peak}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"losses {losses}, gradient norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if len(set(store[1:])) != 1:
        raise AssertionError(f"store bytes grew after step 2: {store}")
    return {"median_ms": med, "min_ms": min(ms), "max_ms": max(ms), "tokens_per_s": tokens / med * 1e3}


def _corpus_pipe(workdir: str, cfg, batch: int, seq: int, steps_per_epoch: int, start_step: int = 0):
    """A token corpus of ``steps_per_epoch`` batches in a lake under
    ``workdir`` (written once: the writer is idempotent) and a fresh
    pipeline over it, with a cache of its own."""
    from repro_torch.core.cache import DifferentialCache
    from repro_torch.core.planner import ScanExecutor
    from repro_torch.data import TokenBatchPipeline, write_token_corpus
    from repro_torch.lake.catalog import Catalog
    from repro_torch.lake.s3sim import ObjectStore

    store = ObjectStore(os.path.join(workdir, "s3"))
    catalog = Catalog(store, rows_per_fragment=1 << 16)
    write_token_corpus(catalog, "data.corpus", batch * (seq + 1) * steps_per_epoch, cfg.vocab_size, seed=0)
    scans = ScanExecutor(store, catalog, cache=DifferentialCache())
    return TokenBatchPipeline(scans, "data.corpus", global_batch=batch, seq_len=seq,
                              start_step=start_step, prefetch_depth=0)


def _launcher_opt():
    from repro_torch.train import OptimizerConfig

    return OptimizerConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)  # the launcher's


def step_parity_phase(cfg, workdir: str, device="cuda", batch: int = 2, seq: int = 128) -> None:
    """Part b: one f32 train step of ``cfg`` (two microbatches) from one
    seeded state and batch, on the card and on the CPU, at step 10 so the
    learning rate is the peak's 1e-3.  Bars: the loss and the gradient norm
    at 1e-4 relative; every leaf of AdamW's first moment (0.1 of the
    clipped gradient) within 1e-3 of the leaf's largest; every parameter
    within the learning rate (a first AdamW step moves a weight by about
    0.43 of it whatever the gradient's size, so a gradient near 0 whose
    sign differs between the devices moves it by up to 0.86 of it)."""
    import dataclasses

    from repro_torch.models import get_model
    from repro_torch.train import make_init_state, make_train_step
    from repro_torch.train.state import tree_leaves, tree_map

    cfg = dataclasses.replace(cfg, dtype="float32", microbatches=2)
    api, opt = get_model(cfg), _launcher_opt()
    cpu = make_init_state(api, opt)(torch.Generator().manual_seed(0), "cpu")
    cpu.step.fill_(10)
    card = tree_map(lambda t: t.to(device, copy=True), cpu)
    b = _corpus_pipe(workdir, cfg, batch, seq, 1).batch_at(0)
    step = make_train_step(api, opt)
    t = time.perf_counter()
    card, m_card = step(card, b)
    _sync(device)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu, m_cpu = step(cpu, b)
    cpu_s = time.perf_counter() - t
    rel = {k: abs(float(m_card[k]) - float(m_cpu[k])) / abs(float(m_cpu[k])) for k in ("loss", "grad_norm")}
    m_err = max(float((a.cpu() - c).abs().max() / c.abs().max())
                for a, c in zip(tree_leaves(card.opt["m"]), tree_leaves(cpu.opt["m"])))
    p_err, p_off, n = 0.0, 0, 0
    for a, c in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        d = (a.cpu() - c).abs()
        p_err, p_off, n = max(p_err, float(d.max())), p_off + int((d > 1e-6).sum()), n + d.numel()
    lr = float(m_cpu["lr"])
    print(f"train step parity: {cfg.name} f32, {_depth(cfg)}, batch {batch} x {seq}, card {card_s:.3f} s, "
          f"CPU {cpu_s:.3f} s; loss {float(m_cpu['loss']):.6f} (rel diff {rel['loss']:.3e}), gradient norm "
          f"{float(m_cpu['grad_norm']):.6f} (rel diff {rel['grad_norm']:.3e}), first moment {m_err:.3e} of each "
          f"leaf's largest, parameters max abs diff {p_err:.3e} (lr {lr:.1e}; {p_off} of {n} off by > 1e-6)")
    if rel["loss"] > 1e-4 or rel["grad_norm"] > 1e-4 or m_err > 1e-3 or p_err > lr:
        raise AssertionError("the card's train step left the CPU's bars")
    del card, cpu


def _same_tree(a, b) -> bool:
    from repro_torch.train.state import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb)
    )


def checkpoint_phase(cfg, workdir: str, device="cuda", batch: int = 2, seq: int = 128) -> None:
    """Part c: ``cfg`` (bf16, AdamW with its f32 master) trains 4 steps and
    saves step 2 asynchronously; a fresh state (another seed) restores it,
    a fresh pipeline resumes at step 2, and steps 3-4 run again.  The
    restored tensors equal the saved state, the resumed batches the
    uninterrupted run's, and the final losses and state the uninterrupted
    run's, all bitwise."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import get_model
    from repro_torch.train import make_init_state, make_train_step
    from repro_torch.train.state import tree_map

    api, opt = get_model(cfg), _launcher_opt()
    init, step = make_init_state(api, opt), make_train_step(api, opt)
    pipe = _corpus_pipe(workdir, cfg, batch, seq, 2)
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"), keep=2, async_save=True)
    state = init(torch.Generator(device=device).manual_seed(0), device)
    batches, losses = [], []
    for s in range(4):
        batches.append(pipe.batch_at(s))
        state, m = step(state, batches[-1])
        losses.append(float(m["loss"]))
        if int(state.step) == 2:
            t = time.perf_counter()
            mgr.save(2, state, extra={"data_step": 2})
            snap_s = time.perf_counter() - t
            saved = tree_map(lambda x: x.detach().to("cpu", copy=True), state)
    t = time.perf_counter()
    mgr.wait()
    write_s = time.perf_counter() - t
    fresh = init(torch.Generator(device=device).manual_seed(1), device)
    t = time.perf_counter()
    step0, resumed = mgr.restore(target_struct=fresh)
    _sync(device)
    restore_s = time.perf_counter() - t
    del fresh
    if step0 != 2 or not _same_tree(resumed, saved):
        raise AssertionError(f"the restored state (step {step0}) is not the saved one")
    it = iter(_corpus_pipe(workdir, cfg, batch, seq, 2, start_step=step0))
    again = []
    for s in range(2, 4):
        b = next(it)
        if set(b) != set(batches[s]) or any(b[k].tobytes() != batches[s][k].tobytes() for k in b):
            raise AssertionError(f"the resumed batch of step {s + 1} differs")
        resumed, m = step(resumed, b)
        again.append(float(m["loss"]))
    if again != losses[2:] or not _same_tree(resumed, state):
        raise AssertionError(f"resumed losses {again} != {losses[2:]}, or the final state differs")
    nbytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(mgr.root) for f in fs)
    print(f"checkpoint round trip: {cfg.name} {cfg.dtype}, {_depth(cfg)}, AdamW with an f32 master, "
          f"batch {batch} x {seq}: losses {[round(x, 4) for x in losses]}; step 2 saved ({nbytes} bytes, "
          f"host snapshot {snap_s:.3f} s, files written in the background {write_s:.3f} s more), restored "
          f"in {restore_s:.3f} s into a fresh state; restored tensors, resumed batches, losses of steps 3-4 "
          f"and the final state bitwise equal to the uninterrupted run")
    del state, resumed, saved


def compress_phase(cfg, workdir: str, device="cuda", batch: int = 2, seq: int = 128, steps: int = 4) -> None:
    """Part d: the launcher's ``--compress-grads`` step (EF-int8) on
    ``cfg`` for ``steps`` steps on one batch: every loss finite, the last
    below the first; prints the wire ratio."""
    from repro_torch.dist.compression import compressed_bytes, init_error_state
    from repro_torch.launch.train import compressed_step
    from repro_torch.models import get_model
    from repro_torch.train import make_init_state
    from repro_torch.train.state import tree_leaves

    api, opt = get_model(cfg), _launcher_opt()
    state = make_init_state(api, opt)(torch.Generator(device=device).manual_seed(0), device)
    step = compressed_step(api, opt, init_error_state(tree_leaves(state.params)))
    b = _corpus_pipe(workdir, cfg, batch, seq, 1).batch_at(0)
    losses = []
    for _ in range(steps):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"EF-int8 losses {losses}")
    wire = compressed_bytes(state.params)
    print(f"EF-int8 gradients: {cfg.name} {cfg.dtype}, {_depth(cfg)}, {steps} steps on one batch of "
          f"{batch} x {seq}: losses {[round(x, 4) for x in losses]}; wire {wire['int8_bytes']} of "
          f"{wire['fp32_bytes']} f32 bytes, ratio {wire['ratio']:.4f} over {wire['tensors']} tensors")
    del state


def training_phase(workdir: str, *, args: List[str] = TRAIN_ARGS, cut=None, device="cuda",
                   batch: int = 2, seq: int = 128) -> Dict[str, float]:
    """The training path: part a through the launcher (``args``), parts b-d
    on ``cut`` (by default granite-3-2b at full width, depth cut to
    ``CUT_LAYERS``).  The model kernels' launch counts are set to 0 before
    the phase.  On the card the bf16 steps train attention through the
    flash-attention kernel (its forward, again in each remat recomputation,
    and its backward), the f32 step takes the plain path, and the SSD,
    which has no backward, is never launched."""
    cut = cut or model_config(GRANITE, dtype="bfloat16", kernels=False, layers=CUT_LAYERS)
    _zero_launch_counts()
    t0 = time.perf_counter()
    out = launch_phase(os.path.join(workdir, "launch"), args, device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    step_parity_phase(cut, os.path.join(workdir, "parity"), device, batch, seq)
    checkpoint_phase(cut, os.path.join(workdir, "ckpt"), device, batch, seq)
    compress_phase(cut, os.path.join(workdir, "ef"), device, batch, seq)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    launches = _launch_counts()
    trained = launches["flash_attention_bwd"] > 0 and launches["flash_attention"] >= launches["flash_attention_bwd"]
    if launches["mamba2_ssd"] or trained != (torch.device(device).type == "cuda"):
        raise AssertionError(f"training's kernel launches {launches}: bf16 attention through the kernel on the "
                             f"card only, forward and backward, and no SSD")
    print(f"training phase: {time.perf_counter() - t0:.1f} s, kernel launches {launches}")
    return {**out, "launches": launches}


# ------------------------------------------------------------- distributed
PIPELINE_ARGS = ["--pipeline", "4", "--steps", "30"]
# the reference dry-run's pipeline cell (src/repro/launch/dryrun.py:331): S 4, L 2S, D 128, MB 4, SEQ 64
PIPELINE_CELL = {"S": 4, "D": 128, "MB": 4, "SEQ": 64}
PIPELINE_MICRO = (4, 12)
SCHEDULE_REPS = 5


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, for the
    result lines; on the CPU, "CPU"."""
    if torch.device(device).type != "cuda":
        return "CPU"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def pipeline_launch_phase(workdir: str, args: List[str], device="cuda") -> Dict[str, float]:
    """Part a: ``python -m repro_torch.launch.train --pipeline 4`` as a user
    runs it, its four ranks sharing the card (gloo, hops through pinned host
    buffers).  Every loss finite, the last below the first; the
    checkpoints hold the stage-stacked ``(S, L/S, 64, 64)`` state in the
    reference's on-disk format and one restores."""
    from repro_torch.checkpoint import restore_state
    from repro_torch.launch import train

    argv = args + ["--workdir", workdir] + (["--device", "cpu"] if torch.device(device).type == "cpu" else [])
    print("pipeline: python -m repro_torch.launch.train " + " ".join(argv), flush=True)
    t = time.perf_counter()
    if train.main(argv) != 0:
        raise AssertionError("the pipeline launcher failed")
    wall = time.perf_counter() - t
    with open(os.path.join(workdir, train.LOG_NAME)) as f:
        log = [json.loads(line) for line in f]
    steps = int(args[args.index("--steps") + 1])
    S = int(args[args.index("--pipeline") + 1])
    losses = [r["loss"] for r in log]
    if [r["step"] for r in log] != list(range(1, steps + 1)) or not all(np.isfinite(losses)):
        raise AssertionError(f"the pipeline launcher logged {log}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the pipeline loss did not fall: {losses}")
    step, tree = restore_state(os.path.join(workdir, "ckpt"))
    if tree["0"]["W"].shape != (S, 2, 64, 64) or int(tree["2"]) != step:
        raise AssertionError(f"checkpoint step {step}: W {tree['0']['W'].shape}, step leaf {tree['2']}")
    ms = [r["seconds"] * 1e3 for r in log[1:]]
    print(f"  pipeline launcher: {steps} steps in {wall:.1f} s wall (spawn included); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; ms per step, steps 2-{steps}: median {np.median(ms):.2f}, min {min(ms):.2f}, "
          f"max {max(ms):.2f}; checkpoint step {step} restored, W {tuple(tree['0']['W'].shape)} | {_card(device)}")
    return {"median_ms": float(np.median(ms)), "first_loss": losses[0], "last_loss": losses[-1]}


def _tanh_layer(x, lp):
    return torch.tanh(x @ lp["W"])


def _sum_sq(y, aux):
    d = (y - aux["tgt"]).float()
    return torch.sum(d * d), float(d.numel())


def _schedule_rank(rank, cell: Dict[str, int], micros, reps: int) -> Dict:
    """One stage of part b: both schedules at each M in ``micros``, the
    loss and the gathered gradients held (on rank 0) against the card's own
    sequential stack, each rank's peak memory of the call, and its time
    (median of ``reps`` calls after the checked one)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.pipeline import StageWire, pipeline_value_and_grad, stack_stage_params

    torch.backends.cuda.matmul.allow_tf32 = False
    S, D, MB, SEQ = cell["S"], cell["D"], cell["MB"], cell["SEQ"]
    L, dev, on_card = 2 * S, rank.device, rank.device.type == "cuda"
    mesh = init_device_mesh(rank.mesh_device, (S,), mesh_dim_names=("pp",))
    wire = StageWire(mesh, "pp", dev)
    rng = np.random.default_rng(0)
    Ws = (rng.standard_normal((L, D, D)) * D**-0.5).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((max(micros), MB, SEQ, D)).astype(np.float32)).to(dev)
    tgt = torch.from_numpy(rng.standard_normal((max(micros), MB, SEQ, D)).astype(np.float32)).to(dev)
    staged = stack_stage_params({"W": torch.from_numpy(Ws)}, S)
    local = {"W": staged["W"][rank.rank : rank.rank + 1].to(dev)}
    out: Dict = {"route": rank.route, "backend": rank.backend}
    for M in micros:
        xs, aux = x[:M], {"tgt": tgt[:M]}
        if rank.rank == 0:  # the card's own sequential stack, microbatch by microbatch
            W = torch.from_numpy(Ws).to(dev).requires_grad_()
            l_ref, g_ref = 0.0, torch.zeros_like(W)
            for m in range(M):
                y = xs[m]
                for i in range(L):
                    y = _tanh_layer(y, {"W": W[i]})
                l, c = _sum_sq(y, {"tgt": tgt[m]})
                (g,) = torch.autograd.grad(l, W)
                l_ref, g_ref = l_ref + float(l.detach()), g_ref + g
        for sched in ("1f1b", "gpipe"):
            # a first call warms up (cuBLAS's workspace lands in it); the
            # second is checked and its peak memory read
            pipeline_value_and_grad(mesh, _tanh_layer, _sum_sq, local, xs, aux, schedule=sched, wire=wire)
            if on_card:
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            (loss, count), grads = pipeline_value_and_grad(mesh, _tanh_layer, _sum_sq, local, xs, aux,
                                                           schedule=sched, wire=wire)
            peak = torch.cuda.max_memory_allocated(dev) - base if on_card else None
            times = []
            for _ in range(reps):
                t = time.perf_counter()
                pipeline_value_and_grad(mesh, _tanh_layer, _sum_sq, local, xs, aux, schedule=sched, wire=wire)
                if on_card:
                    torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t) * 1e3)
            full = wire.gather(grads["W"][0]).reshape(L, D, D)
            entry = {"peak_bytes": peak, "stash_slots": wire.stash_shape[0], "ms": times}
            if rank.rank == 0:
                err = (full - g_ref).abs()
                entry.update(
                    loss=float(loss), ref_loss=l_ref,
                    loss_ok=abs(float(loss) - l_ref) <= 1e-6 * abs(l_ref),
                    grad_max_abs=float(err.max()),
                    grad_ok=bool((err <= 1e-7 + 1e-5 * g_ref.abs()).all()),
                )
            out[M, sched] = entry
    return out


def pipeline_schedule_phase(workdir: str, device="cuda", cell=PIPELINE_CELL, micros=PIPELINE_MICRO,
                            reps: int = SCHEDULE_REPS) -> Dict:
    """Part b: both schedules on S ranks against the card's own sequential
    stack (``tests/test_pipeline_1f1b.py:71-78``'s bars: loss rtol 1e-6,
    gradients rtol 1e-5 / atol 1e-7), and 1F1B's peak memory below
    GPipe's on every rank at the largest M (the counterpart of the
    reference's compiled ``temp_size_in_bytes`` gate)."""
    from repro_torch.dist.ranks import spawn_ranks

    kind = torch.device(device).type
    ranks = spawn_ranks(_schedule_rank, cell["S"], workdir, args=(cell, tuple(micros), reps), device=kind,
                        timeout_s=300)
    card = _card(device)
    mb_bytes = cell["MB"] * cell["SEQ"] * cell["D"] * 4
    print(f"  pipeline schedules: S {cell['S']}, L {2 * cell['S']}, D {cell['D']}, MB {cell['MB']}, "
          f"SEQ {cell['SEQ']} ({mb_bytes} B a stash slot), {ranks[0]['backend']}, hops through "
          f"{ranks[0]['route']} | {card}")
    out = {}
    for M in micros:
        for sched in ("1f1b", "gpipe"):
            r0 = ranks[0][M, sched]
            ms = [float(np.median([r[M, sched]["ms"][i] for r in ranks])) for i in range(reps)]
            peaks = [r[M, sched]["peak_bytes"] for r in ranks]
            print(f"  M {M} {sched}: loss {r0['loss']:.6f} vs sequential {r0['ref_loss']:.6f}, gradients max abs "
                  f"diff {r0['grad_max_abs']:.3e} (bars {'held' if r0['loss_ok'] and r0['grad_ok'] else 'MISSED'}); "
                  f"stash {r0['stash_slots']} slots; peak per rank {peaks} B; ms per call: median "
                  f"{np.median(ms):.3f}, min {min(ms):.3f}, max {max(ms):.3f} ({2 * (M + cell['S'] - 1)} ticks) "
                  f"| {card}")
            if not (r0["loss_ok"] and r0["grad_ok"]):
                raise AssertionError(f"M {M} {sched}: the pipeline left the sequential stack's bars")
            out[M, sched] = {"median_ms": float(np.median(ms)), "peaks": peaks}
    big = max(micros)
    if kind == "cuda":
        over = [i for i, (a, b) in enumerate(zip(out[big, "1f1b"]["peaks"], out[big, "gpipe"]["peaks"])) if a >= b]
        if over:
            raise AssertionError(f"M {big}: 1F1B's peak is not below GPipe's on ranks {over}")
    return out


def sharded_step_phase(cfg, workdir: str, device="cuda", batch: int = 2, seq: int = 128) -> Dict:
    """Part c: one train step of ``cfg`` under ``use_rules(rules_for(cfg,
    make_mesh((1, 1), ("data", "model"))))``, the state and the batch
    distributed by their logical axes, against the same step without
    rules (bitwise, or the largest difference printed), with 0 collectives
    (``CommDebugMode``); then a checkpoint written unsharded and restored
    with ``shardings=`` onto the mesh, bitwise.  Runs on a process group of
    one rank, which it starts and ends."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.dist.ranks import backend_for
    from repro_torch.dist.sharding import distribute_tree, map_axes, use_rules
    from repro_torch.launch.mesh import describe_mesh, make_mesh, rules_for
    from repro_torch.models import get_model
    from repro_torch.train import make_init_state, make_train_step, state_logical_axes
    from repro_torch.train.state import tree_leaves, tree_map

    kind = torch.device(device).type
    backend, _ = backend_for(1, kind)
    os.makedirs(workdir, exist_ok=True)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(workdir, "rendezvous"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=kind)
        rules = rules_for(cfg, mesh)
        api, opt = get_model(cfg), _launcher_opt()
        plain = make_init_state(api, opt)(torch.Generator(device=device).manual_seed(0), device)
        plain.step.fill_(10)
        axes = state_logical_axes(api.param_logical_axes(), plain.opt)
        sharded = distribute_tree(tree_map(lambda t: t.clone(), plain), axes, rules)
        b = _corpus_pipe(workdir, cfg, batch, seq, 1).batch_at(0)
        step = make_train_step(api, opt)
        t = time.perf_counter()
        with plain_attention():  # the sharded step's attention, which takes no kernel
            plain, m_plain = step(plain, b)
        _sync(device)
        plain_s = time.perf_counter() - t
        with use_rules(rules), CommDebugMode() as comm:
            t = time.perf_counter()
            sb = distribute_tree(b, {k: ("batch", None) for k in b}, rules)
            sharded, m_sharded = step(sharded, sb)
            _sync(device)
            sharded_s = time.perf_counter() - t
        collectives = comm.get_total_counts()
        pairs = list(zip(tree_leaves(sharded), tree_leaves(plain)))
        same = all(a.to_local().dtype == c.dtype and torch.equal(a.to_local(), c) for a, c in pairs)
        diff = max(float((a.to_local().float() - c.float()).abs().max()) for a, c in pairs)
        loss_same = float(m_sharded["loss"]) == float(m_plain["loss"])
        del sharded
        root = os.path.join(workdir, "ckpt")
        save_state(root, 11, plain)
        shardings = map_axes(lambda a, leaf: (mesh, rules.placements(leaf.shape, a)), axes, plain)
        t = time.perf_counter()
        _, back = restore_state(root, target_struct=plain, shardings=shardings)
        _sync(device)
        restore_s = time.perf_counter() - t
        restored = all(torch.equal(a.to_local(), c) for a, c in zip(tree_leaves(back), tree_leaves(plain)))
        del back, plain
    finally:
        dist.destroy_process_group()
    print(f"  sharded step: {cfg.name} {cfg.dtype}, {_depth(cfg)}, batch {batch} x {seq}, mesh "
          f"{describe_mesh(mesh)} ({backend}): state and batch as DTensors, step {sharded_s:.3f} s against "
          f"{plain_s:.3f} s plain; loss {'equal' if loss_same else 'DIFFERS'}; state after the step "
          f"{'bitwise equal' if same else f'largest difference {diff:.3e}'}; {collectives} collectives; "
          f"checkpoint restored with shardings= onto the mesh in {restore_s:.3f} s, "
          f"{'bitwise' if restored else 'NOT bitwise'} | {_card(device)}")
    if collectives != 0 or not restored or not loss_same:
        raise AssertionError("the (1, 1) sharded step or the elastic restore left its bars")
    return {"bitwise": same, "max_diff": diff, "collectives": collectives}


def _gloo_card_collective(rank) -> str:
    """What part c's two-rank try needs first: DTensor gathers a CUDA
    tensor's shards over the mesh's group (``all_gather_into_tensor``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
    x = distribute_tensor(torch.arange(8.0, device=rank.device).reshape(4, 2), mesh, [Replicate(), Shard(0)],
                          src_data_rank=None)
    full = x.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    torch.cuda.synchronize()
    return f"{tuple(full.shape)} {float(full.sum())}"


def gloo_mesh_try(workdir: str) -> str:
    """Part c's last step: a (data=1, model=2) mesh of two ranks sharing
    the card over gloo (NCCL refuses two ranks on one card).  gloo's
    collectives take host tensors; a DTensor step's are CUDA tensors.  The
    try runs the first collective such a step needs and reports whether
    gloo carried it; a rank that gloo aborts is the answer, not a failure
    of the phase."""
    from repro_torch.dist.ranks import spawn_ranks

    try:
        got = spawn_ranks(_gloo_card_collective, 2, workdir, device="cuda", timeout_s=120)
        return f"gloo carried all_gather_into_tensor of CUDA tensors: {got}"
    except RuntimeError as e:
        return f"gloo did not carry all_gather_into_tensor of CUDA tensors ({str(e).splitlines()[0]})"


def distributed_phase(workdir: str, *, device="cuda", pipeline_args: List[str] = PIPELINE_ARGS,
                      cell=PIPELINE_CELL, micros=PIPELINE_MICRO, reps: int = SCHEDULE_REPS, cut=None) -> Dict:
    """The distributed path: part a through the launcher, part b the
    schedules on the reference dry-run's cell, part c a sharded step of
    ``cut`` (by default granite-3-2b at full width, depth cut to
    ``CUT_LAYERS``, the training phase's cut).  The model kernels' launch
    counts are set to 0 before the phase and must still be 0 after it."""
    cut = cut or model_config(GRANITE, dtype="bfloat16", kernels=False, layers=CUT_LAYERS)
    _zero_launch_counts()
    t0 = time.perf_counter()
    print(f"distributed phase | {_card(device)}", flush=True)
    launch = pipeline_launch_phase(os.path.join(workdir, "pp_launch"), pipeline_args, device)
    schedules = pipeline_schedule_phase(os.path.join(workdir, "pp_sched"), device, cell, micros, reps)
    sharded = sharded_step_phase(cut, os.path.join(workdir, "sharded"), device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        print(f"  (data=1, model=2), two ranks on the card over gloo: {gloo_mesh_try(os.path.join(workdir, 'gloo'))}")
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the distributed phase launched model kernels: {launches}")
    print(f"distributed phase: {time.perf_counter() - t0:.1f} s, kernel launches {launches}", flush=True)
    return {"launch": launch, "schedules": schedules, "sharded": sharded}


def _sharded_cut_rank(rank, cfg, batch: int, seq: int) -> Dict:
    """One rank of a (data=2, model=2) mesh over the process group: one
    train step of ``cfg`` under the rules, the state and batch distributed
    from the same seeded full tensors on every rank, with its collectives
    counted; and the same step plain, on this rank alone."""
    from repro_torch.dist.sharding import distribute_tree, use_rules
    from repro_torch.launch.hlo_cost import CollectiveBytes
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models import get_model
    from repro_torch.train import make_init_state, make_train_step, state_logical_axes
    from repro_torch.train.state import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank.device
    mesh = make_mesh((2, 2), ("data", "model"), device=rank.mesh_device)
    rules = rules_for(cfg, mesh)
    api, opt = get_model(cfg), _launcher_opt()
    step = make_train_step(api, opt)
    plain = make_init_state(api, opt)(torch.Generator(device=dev).manual_seed(0), dev)
    sharded = distribute_tree(tree_map(lambda t: t.clone(), plain),
                              state_logical_axes(api.param_logical_axes(), plain.opt), rules)
    b = _cut_batch(cfg, batch, seq, dev)
    _sync(dev)
    t = time.perf_counter()
    with use_rules(rules), CollectiveBytes() as wire:
        sharded, m_sharded = step(sharded, distribute_tree(b, {k: ("batch", None) for k in b}, rules))
        loss = float(m_sharded["loss"].full_tensor())
    sharded_s = time.perf_counter() - t
    t = time.perf_counter()
    plain, m_plain = step(plain, b)
    plain_loss = float(m_plain["loss"])
    plain_s = time.perf_counter() - t
    return {"loss": loss, "plain_loss": plain_loss, "seconds": sharded_s, "plain_seconds": plain_s,
            "wire_bytes": wire.bytes, "collectives": wire.count, "backend": rank.backend}


def sharded_mesh_phase(cfg, workdir: str, device="cuda", batch: int = 2, seq: int = 128) -> Dict:
    """One train step of ``cfg`` on a real (data=2, model=2) mesh of four
    ranks, against the plain step: the loss within 1e-2 (bf16 sums in
    another order).  On the cards each rank has one (NCCL); on the CPU four
    gloo ranks rehearse it."""
    from repro_torch.dist.ranks import spawn_ranks

    ranks = spawn_ranks(_sharded_cut_rank, 4, workdir, args=(cfg, batch, seq),
                        device=torch.device(device).type, timeout_s=600)
    r0 = ranks[0]
    diff = max(abs(r["loss"] - r["plain_loss"]) for r in ranks)
    print(f"  sharded step on a (2, 2) mesh of 4 ranks ({r0['backend']}): {cfg.name} {cfg.dtype}, {_depth(cfg)}, "
          f"batch {batch} x {seq}: loss {r0['loss']:.6f} against the plain step's {r0['plain_loss']:.6f} (largest "
          f"difference over the ranks {diff:.3e}, bar 1e-2); {r0['collectives']} collectives, "
          f"{r0['wire_bytes']:.0f} wire bytes a rank (ring model); {r0['seconds']:.3f} s against "
          f"{r0['plain_seconds']:.3f} s plain | {_card(device)}", flush=True)
    if diff > 1e-2:
        raise AssertionError(f"the (2, 2) sharded step's loss is {diff:.3e} off the plain step's")
    return {"loss_diff": diff, **r0}


def four_card_phase(workdir: str) -> None:
    """Parts a and b of :func:`distributed_phase` with a card a rank
    (NCCL, hops as device tensors), and :func:`sharded_mesh_phase` on
    granite-3-2b's training cut.  Run it with four cards:
    python3 -c "import tempfile, chip_smoke; chip_smoke.four_card_phase(tempfile.mkdtemp())"
    """
    if torch.cuda.device_count() < 4:
        raise RuntimeError(f"four_card_phase needs 4 cards, found {torch.cuda.device_count()}")
    print(f"four-card phase | {torch.cuda.device_count()} x {_card('cuda')}", flush=True)
    t0 = time.perf_counter()
    pipeline_launch_phase(os.path.join(workdir, "pp_launch"), PIPELINE_ARGS)
    pipeline_schedule_phase(os.path.join(workdir, "pp_sched"))
    cut = model_config(GRANITE, dtype="bfloat16", kernels=False, layers=CUT_LAYERS)
    sharded_mesh_phase(cut, os.path.join(workdir, "mesh"))
    print(f"four-card phase: {time.perf_counter() - t0:.1f} s", flush=True)


# ----------------------------------------------------------------- dry-run
DRYRUN_CELLS = (
    (GRANITE, "train_4k", "single"),  # flattens (batch, seq) under sequence parallelism
    (MIXTRAL, "prefill_32k", "single"),  # MoE and its rule overrides
    (ZAMBA2, "decode_32k", "single"),  # hybrid, SSM state
    (GRANITE, "decode_32k", "multi"),  # the 2x16x16 mesh of a world of 512
    (GRANITE, "long_500k", "single"),  # full attention at 500k: the SKIP record
)
DRYRUN_LIMIT_S = 90.0


def _start_dryrun_cells(workdir: str, device, cells) -> List[Tuple[tuple, subprocess.Popen, float, str]]:
    """Each cell in a ``python -m repro_torch.launch.dryrun`` of its own,
    all started together (a cell is one core's work for up to a minute)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = []
    for arch, shape, mesh in cells:
        log = os.path.join(workdir, f"{arch}__{shape}__{mesh}.log")
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                "--mesh", mesh, "--out", workdir, "--device", torch.device(device).type]
        with open(log, "w") as f:
            proc = subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        out.append(((arch, shape, mesh), proc, time.time(), log))
    return out


def _finish_dryrun_cells(started, workdir: str, timeout_s: float) -> List[Tuple[dict, float]]:
    """Waits for each cell and reads its record; a cell's wall runs from its
    launch to its log's last write (its process's last line)."""
    records = []
    for (arch, shape, mesh), proc, t0, log in started:
        try:
            proc.wait(timeout=max(1.0, timeout_s - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"dry-run cell {arch} {shape} {mesh} outlived {timeout_s:.0f} s")
        wall = os.path.getmtime(log) - t0
        path = os.path.join(workdir, f"{arch}__{shape}__{mesh}.json")
        if not os.path.exists(path):
            with open(log) as f:
                raise AssertionError(f"dry-run cell {arch} {shape} {mesh} wrote no record:\n{f.read()[-3000:]}")
        with open(path) as f:
            records.append((json.load(f), wall))
    return records


def h2d_rate(nbytes: int = 1 << 28, reps: int = 5) -> float:
    """Pinned host -> card copy rate in B/s: median of ``reps`` copies of
    ``nbytes``, timed with CUDA events."""
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    del src, dst
    return nbytes / float(np.median(times))


def _cut_batch(cfg, batch: int, seq: int, device) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device),
            "loss_mask": torch.ones((batch, seq), dtype=torch.float32, device=device)}


def cost_model_phase(cfg, device="cuda", batch: int = 2, seq: int = 128) -> Dict:
    """Part b: the dry-run's cost model and memory tracker held against a
    real train step of ``cfg`` (kernels off, as in the dry-run: the real
    steps run under ``plain_attention``).  The FLOPs
    counted on the card must equal those counted on fake tensors of the
    same shapes exactly; on the card, the profiled device busy time must be
    at least the roofline bound of the counted FLOPs and bytes (share
    <= 1.0), and the tracker's peak, plus what is resident on the card
    before the step beyond its state and batch (cuBLAS's workspace and the
    allocator's rounding, which no tracker of the step sees), within 10% of
    ``max_memory_allocated`` after a warm-up step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.dryrun import cost_step
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.launch.roofline import roofline_report
    from repro_torch.models import get_model
    from repro_torch.train import make_init_state, make_train_step
    from repro_torch.train.state import tree_leaves

    api, opt = get_model(cfg), _launcher_opt()
    kernels_off = make_train_step(api, opt)

    def step(*args):
        with plain_attention():
            return kernels_off(*args)

    on_card = torch.device(device).type == "cuda"
    shapes = {k: (v.shape, v.dtype) for k, v in _cut_batch(cfg, batch, seq, "cpu").items()}
    with FakeTensorMode():
        fake_state = make_init_state(api, opt)(torch.Generator(device=device), device)
        fake_batch = {k: torch.empty(shape, dtype=dt, device=device) for k, (shape, dt) in shapes.items()}
        predicted, memory, _ = cost_step(step, (fake_state, fake_batch), train=True)
    del fake_state, fake_batch
    state = make_init_state(api, opt)(torch.Generator(device=device).manual_seed(0), device)
    b = _cut_batch(cfg, batch, seq, device)
    step(state, b)  # warm-up: cuBLAS's workspace and the allocator's blocks
    _sync(device)
    held = sum(t.numel() * t.element_size() for t in tree_leaves((state, b)))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() - held
    with CostCounter() as counter:
        step(state, b)
        _sync(device)
    real = counter.result()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    roof = roofline_report(flops_per_device=real.flops, hbm_bytes_per_device=real.bytes_accessed,
                           collective_bytes_per_device=0.0, n_chips=1)
    line = (f"  cost model: {cfg.name} {cfg.dtype}, {_depth(cfg)}, batch {batch} x {seq}, kernels off: FLOPs "
            f"counted on the {torch.device(device).type} {real.flops:.6e}, on fake tensors {predicted.flops:.6e} "
            f"({'equal' if real.flops == predicted.flops else 'DIFFERENT'}); bytes {real.bytes_accessed:.6e} "
            f"(fake {predicted.bytes_accessed:.6e}); roofline bound {roof['bound_s'] * 1e3:.4f} ms "
            f"({roof['dominant']}: compute {roof['compute_s'] * 1e3:.4f} ms, memory {roof['memory_s'] * 1e3:.4f} ms)")
    out = {"flops": real.flops, "flops_fake": predicted.flops, "bytes": real.bytes_accessed,
           "bound_s": roof["bound_s"], "predicted_peak": memory["peak_bytes"]}
    if not on_card:
        print(line + f"; device busy time and peak memory not measured | {_card(device)}")
        if real.flops != predicted.flops:
            raise AssertionError("the FLOPs counted on real and fake tensors differ")
        return out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy = sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0) / 1e6
    share = roof["bound_s"] / busy if busy else float("nan")
    want = memory["peak_bytes"] + resident
    gap = abs(want - peak) / peak
    print(line + f"; device busy {busy * 1e3:.4f} ms (wall {wall * 1e3:.4f} ms), roofline share {share:.4f}; peak "
          f"memory: tracker {memory['peak_bytes']} B + resident beyond state and batch {resident} B (cuBLAS "
          f"workspace, allocator rounding) = {want} B against max_memory_allocated {peak} B ({gap * 100:.2f}% "
          f"off) | {_card(device)}")
    out.update(busy_s=busy, share=share, peak=peak, resident=resident, gap=gap)
    if real.flops != predicted.flops:
        raise AssertionError("the FLOPs counted on the card and on fake tensors differ")
    if not busy or share > 1.0:
        raise AssertionError(f"device busy {busy} s under the roofline bound {roof['bound_s']} s")
    if gap > 0.10:
        raise AssertionError(f"the tracker's peak is {gap * 100:.1f}% off max_memory_allocated")
    del state, b
    torch.cuda.empty_cache()
    return out


def fake_mesh_step_phase(cfg, device="cuda", batch: int = 2, seq: int = 128) -> Dict:
    """Part c: one train step of ``cfg`` under the rules of a (data=2,
    model=2) mesh on a ``fake`` process group of world 4 (its collectives
    move nothing, so the numbers mean nothing): forward and backward must
    run on this torch without raising.  Starts and ends its own process
    group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.dist.sharding import distribute_tree, use_rules
    from repro_torch.launch.mesh import describe_mesh, make_mesh, rules_for
    from repro_torch.models import get_model
    from repro_torch.train import make_init_state, make_train_step, state_logical_axes

    kind = torch.device(device).type
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device=kind)
        rules = rules_for(cfg, mesh)
        api, opt = get_model(cfg), _launcher_opt()
        state = make_init_state(api, opt)(torch.Generator(device=device).manual_seed(0), device)
        state = distribute_tree(state, state_logical_axes(api.param_logical_axes(), state.opt), rules)
        b = _cut_batch(cfg, batch, seq, device)
        t = time.perf_counter()
        with use_rules(rules):
            db = distribute_tree(b, {k: ("batch", None) for k in b}, rules)
            state, metrics = make_train_step(api, opt)(state, db)
            _sync(device)
        seconds = time.perf_counter() - t
        placements = [str(p) for p in state.params["embed"].placements]
        del state
    finally:
        dist.destroy_process_group()
    print(f"  sharded step on a fake world of 4: {cfg.name} {cfg.dtype}, {_depth(cfg)}, batch {batch} x {seq}, "
          f"mesh {describe_mesh(mesh)}: forward and backward ran in {seconds:.3f} s (the fake group moves "
          f"nothing, so its values mean nothing; embed placed {placements}) | torch {torch.__version__} | "
          f"{_card(device)}")
    return {"seconds": seconds}


def dryrun_phase(workdir: str, device="cuda", cells=DRYRUN_CELLS, cut=None) -> Dict:
    """The cost analysis: (a) ``python -m repro_torch.launch.dryrun`` on
    ``cells``, each in a process of its own, started first and read last
    (each must end ``ok``, or ``SKIP`` where the coverage rule says so),
    with each cell's roofline terms under ``HW_H100``; (b)
    :func:`cost_model_phase` and (c) :func:`fake_mesh_step_phase` on ``cut``
    (by default granite-3-2b at full width, depth cut to ``CUT_LAYERS``,
    bf16, the training phase's cut) while the cells run.  The model
    kernels' launch counts are set to 0 before the phase and must still be
    0 after it; on the card the phase must end within ``DRYRUN_LIMIT_S``."""
    from repro_torch.launch.roofline import HW_H100
    from repro_torch.models import cell_is_runnable, get_config

    cut = cut or model_config(GRANITE, dtype="bfloat16", kernels=False, layers=CUT_LAYERS)
    os.makedirs(workdir, exist_ok=True)
    _zero_launch_counts()
    t0 = time.perf_counter()
    card = _card(device)
    print(f"dry-run phase | {card}", flush=True)
    started = _start_dryrun_cells(workdir, device, cells)
    if torch.device(device).type == "cuda":
        rate = h2d_rate()
        print(f"  pinned H2D copy: {rate / 1e9:.2f} GB/s measured, HW_H100 host_bw {HW_H100['host_bw'] / 1e9:.0f} "
              f"GB/s (PCIe Gen5 x16) | {card}")
    cost = cost_model_phase(cut, device)
    fake_mesh_step_phase(cut, device)
    records = _finish_dryrun_cells(started, workdir, timeout_s=DRYRUN_LIMIT_S * 2)
    bad = []
    for rec, wall in records:
        runnable, _ = cell_is_runnable(get_config(rec["arch"]), rec["shape"])
        status = rec["status"]
        if not (status == "ok" if runnable else status.startswith("SKIP")):
            bad.append(f"{rec['arch']} {rec['shape']} {rec['mesh']}: {status}")
        roof = rec.get("roofline")
        terms = ("compute {compute_s:.6f} s, memory {memory_s:.6f} s, collective {collective_s:.6f} s, dominant "
                 "{dominant}".format(**roof) if roof else "no roofline")
        mem = rec.get("memory", {})
        print(f"  dry-run {rec['arch']} {rec['shape']} {rec['mesh']}: {status}; {terms}; peak "
              f"{mem.get('peak_bytes', 'n/a')} B a device; wall {wall:.1f} s (HW_H100) | {card}", flush=True)
    launches = _launch_counts()
    seconds = time.perf_counter() - t0
    print(f"dry-run phase: {seconds:.1f} s, kernel launches {launches}", flush=True)
    if bad:
        raise AssertionError("dry-run cells failed: " + "; ".join(bad))
    if any(launches.values()):
        raise AssertionError(f"the dry-run phase launched model kernels: {launches}")
    if torch.device(device).type == "cuda" and seconds > DRYRUN_LIMIT_S:
        raise AssertionError(f"the dry-run phase took {seconds:.1f} s > {DRYRUN_LIMIT_S:.0f} s")
    return {"cells": [r for r, _ in records], "cost": cost, "seconds": seconds}


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--frag", type=int, default=FRAG)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke runs only on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.fragment_gather import kernel

    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall ({built})")
    mma = count_mma()
    for name in built:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name} ptxas: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False

    check_fragment_gather()
    check_device_tier_dtypes()
    total = args.rows // args.frag * args.frag
    gather = time_fragment_union(total, args.frag)
    dequant = check_dequant()
    attention = check_flash_attention()
    attention_bwd = check_flash_attention_bwd()
    scan = check_mamba2_ssd()

    with tempfile.TemporaryDirectory() as tmp:
        result = main_path(args.rows, args.frag, tmp)
    if result["h2d_ratio"] < 5:
        raise AssertionError(f"warm H2D ratio {result['h2d_ratio']:.3f} < 5")
    if result["gather_fast"] < 1:
        raise AssertionError("the main path never took the gather's tiled path")
    if result["launches"] < 1:
        raise AssertionError("the main path never launched fragment_gather")
    with tempfile.TemporaryDirectory() as tmp:
        service = service_phase(args.rows, args.frag, tmp)
    if service["launches"] < 1:
        raise AssertionError("the service phase never launched fragment_gather")
    for path, run in (("main path", result), ("service", service)):
        if run["launches"] != run["copying_unions"]:
            raise AssertionError(
                f"{path}: {run['launches']} fragment_gather launches for "
                f"{run['copying_unions']} UNIONs that copy (one each expected)"
            )
        print(f"{path}: one fragment_gather launch per UNION that copies ({run['launches']})")
    with tempfile.TemporaryDirectory() as tmp:
        explain_phase(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        examples = examples_phase(tmp)["launches"]
    gather["launches"] = result["launches"] + service["launches"] + examples["fragment_gather"]
    gather["launches_by_path"] = {"main": result["launches"], "service": service["launches"],
                                  "examples": examples["fragment_gather"]}
    dequant["launches_by_path"] = {"kernels entry point": dequant["launches"], "examples": examples["dequant"]}
    dequant["launches"] += examples["dequant"]

    f32 = dict(dtype="float32", kernels=False)
    consistency_phase(model_config(ZAMBA2, **f32), (512, 1000), greedy=True)
    consistency_phase(model_config(GRANITE, **f32), (512, 1000), greedy=True)
    consistency_phase(model_config(MIXTRAL, layers=MIXTRAL_LAYERS, **f32), (8192,), greedy=False)

    bf16 = dict(dtype="bfloat16", kernels=True)
    runs = {
        ZAMBA2: serve_phase(model_config(ZAMBA2, **bf16), slots=4, max_context=2048),
        GRANITE: serve_phase(model_config(GRANITE, **bf16), slots=4, max_context=2048),
        f"{MIXTRAL} ({MIXTRAL_LAYERS} layers)": serve_phase(
            model_config(MIXTRAL, layers=MIXTRAL_LAYERS, **bf16), slots=2, max_context=8192,
            lengths=[5000, 6500], new_tokens=16, sampled=False, profile_len=5000,
        ),
    }
    with tempfile.TemporaryDirectory() as tmp:
        trained = training_phase(tmp)["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        distributed_phase(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        dryrun_phase(tmp)
    attention["launches_by_run"] = {name: r["flash_attention"] for name, r in runs.items()}
    attention["launches_by_run"]["examples"] = examples["flash_attention"]
    attention["launches_by_run"]["training"] = trained["flash_attention"]
    attention["launches"] = sum(attention["launches_by_run"].values())
    attention_bwd["launches_by_run"] = {"training": trained["flash_attention_bwd"],
                                        "examples": examples["flash_attention_bwd"]}
    attention_bwd["launches"] = sum(attention_bwd["launches_by_run"].values())
    scan["launches_by_run"] = {ZAMBA2: runs[ZAMBA2]["mamba2_ssd"], "examples": examples["mamba2_ssd"]}
    scan["launches"] = sum(scan["launches_by_run"].values())
    for entry in (gather, dequant, attention, scan):
        entry["sass_mma"] = mma[entry["name"]]
    attention_bwd["sass_mma"] = mma["flash_attention"]  # one library holds both
    attention["device_route"] = "bf16 on the tensor cores (wgmma, TMA loads), f32 on the CUDA cores"
    attention_bwd["device_route"] = "bf16 on the tensor cores (wgmma, TMA loads)"
    scan["device_route"] = "bf16 on the tensor cores (mma.sync), f32 on the CUDA cores"
    print(json.dumps({"kernels": [gather, dequant, attention, attention_bwd, scan]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
