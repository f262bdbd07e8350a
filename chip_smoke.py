"""Smoke run of the PyTorch port on one CUDA card.

1. Builds the port's CUDA kernels from the sources in this checkout.
2. Kernel phase: holds each kernel against its plain torch version on the
   card, bitwise, for every bool/int/uint/float width and for tiled and
   row-granular layouts; times it at the main path's shapes beside its
   memory-bandwidth bound, its plain version and one PyTorch library call.
3. Main path: a declarative ``@model`` pipeline over the lakehouse (the
   BENCH_8 project: a differential torch ``feats`` node and a full-window
   torch ``score`` node) runs nine edits on a 2^24-row events table, about
   one month of NYC high-volume for-hire trips.  A workspace with the device
   tier must match a workspace without it bitwise at every edit, and match a
   numpy computation of the same function; warm edits must upload at least
   5x fewer host->device bytes and go through the kernel's tiled path.

Prints the card, the build time, the kernel checks and timings, each edit's
wall time, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit).
Exits non-zero without a CUDA card.

Run from the repository root:  python3 chip_smoke.py [--rows N] [--frag N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.columnar import Table  # noqa: E402
from repro_torch.pipeline.dsl import Model, Project, model, runtime  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
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
    """Kernel vs plain version on the card, bitwise, every dtype: block-run
    layouts at RB 8 and 4096, and non-aligned runs (RB=1)."""
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


def time_fragment_gather(total: int, frag: int) -> dict:
    """The kernel at the main path's shape: the ``split`` edit gathers
    [0, a) and [b, c) of one c-row float32 column (the merged element's pin)
    in one tiled launch."""
    from repro_torch.core.device import _choose_row_block
    from repro_torch.kernels.fragment_gather.kernel import fragment_gather_call
    from repro_torch.kernels.fragment_gather.ref import gather_ref

    a, b, c = total // 3 // frag * frag, 2 * total // 3 // frag * frag, total
    bounds = [(0, a), (b, c)]
    rb = _choose_row_block(bounds)
    idx = np.concatenate([np.arange(lo, hi, dtype=np.int32) for lo, hi in bounds])
    gen = torch.Generator().manual_seed(1)
    src = torch.randn((c, 1), generator=gen).cuda()
    block_idx = torch.from_numpy(np.ascontiguousarray(idx[::rb] // rb)).cuda()
    idx32 = torch.from_numpy(idx).cuda()
    idx64 = idx32.long()
    rows = idx.shape[0]

    kernel = lambda: fragment_gather_call(src, block_idx, row_block=rb, out_rows=rows)
    plain = lambda: gather_ref(src, idx32)
    library = lambda: torch.index_select(src, 0, idx64)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
        raise AssertionError("fragment_gather differs from plain at the main-path shape")
    out_bytes = rows * src.element_size()
    moved = 2 * out_bytes + block_idx.numel() * 4  # gathered bytes read + written, indices read
    ms, plain_ms, library_ms = _time_ms(kernel), _time_ms(plain), _time_ms(library)
    # the row-granular mode on the same rows, for the record
    rb1_ms = _time_ms(lambda: fragment_gather_call(src, idx32, row_block=1, out_rows=rows))
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(
        f"fragment_gather @ split shape: src ({c}, 1) float32, {rows} rows out, "
        f"RB={rb}: kernel {ms:.4f} ms, RB=1 mode {rb1_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"index_select {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({moved / ms / 1e6:.1f} GB/s achieved)"
    )
    return {
        "name": "fragment_gather",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fragment_gather/csrc/fragment_gather.cu",
        "replaces": "src/repro/kernels/fragment_gather/kernel.py:44",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


# --------------------------------------------------------------- main path
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
        "tier": dev_ws.device.stats(),
        "iterations": iterations,
    }
    print(
        f"main path: warm H2D {warm('plain', 'bytes_h2d')} B no-tier vs "
        f"{warm('device', 'bytes_h2d')} B tier = {ratio:.3f}x, gather_fast "
        f"{result['gather_fast']}, fragment_gather launches {launches}"
    )
    if torch.device(device).type == "cuda":
        profile_warm_edits(dev_ws, [e for e in edits if e[0] in ("split", "rerun2")])
    return result


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
        device_ops = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
        ]
        if not device_ops:
            print(f"profile {label}: wall {wall:.4f} s, device time not measured")
            continue
        busy = sum(_device_us(e) for e in device_ops) / 1e6
        top = sorted(device_ops, key=_device_us, reverse=True)[:6]
        print(
            f"profile {label}: wall {wall:.4f} s, device busy {busy:.6f} s, "
            f"idle share {1 - busy / wall:.4f}; top device ops: "
            + "; ".join(f"{e.key[:60]} {_device_us(e) / 1e3:.3f} ms x{e.count}" for e in top)
        )


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
    for name in built:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name} ptxas: {line.strip()}")

    check_fragment_gather()
    check_device_tier_dtypes()
    total = args.rows // args.frag * args.frag
    entry = time_fragment_gather(total, args.frag)

    with tempfile.TemporaryDirectory() as tmp:
        result = main_path(args.rows, args.frag, tmp)
    if result["h2d_ratio"] < 5:
        raise AssertionError(f"warm H2D ratio {result['h2d_ratio']:.3f} < 5")
    if result["gather_fast"] < 1:
        raise AssertionError("the main path never took the gather's tiled path")
    if result["launches"] < 1:
        raise AssertionError("the main path never launched fragment_gather")
    entry["launches"] = result["launches"]
    print(json.dumps({"kernels": [entry]}))
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
