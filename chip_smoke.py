"""Smoke run of the PyTorch port on one CUDA card.

1. Builds the port's CUDA kernels from the sources in this checkout, one
   ``nvcc`` per source, all started at once.
2. Kernel phase: holds each kernel against its plain torch version on the
   card and times it at its main path's shapes beside its bound, its plain
   version and one PyTorch library call where there is one.
   ``fragment_gather`` is held bitwise for every bool/int/uint/float width
   and for tiled and row-granular layouts; ``flash_attention`` and
   ``mamba2_ssd`` at zamba2-1.2b's widths, prompt lengths 512, 1000 and
   1536, in f32 and bf16, at the reference's tolerances (attention also
   with grouped heads and a sliding window; SSD also against the
   sequential recurrence).
3. Pipeline path: a declarative ``@model`` pipeline over the lakehouse (the
   BENCH_8 project: a differential torch ``feats`` node and a full-window
   torch ``score`` node) runs nine edits on a 2^24-row events table, about
   one month of NYC high-volume for-hire trips.  A workspace with the device
   tier must match a workspace without it bitwise at every edit, and match a
   numpy computation of the same function; warm edits must upload at least
   5x fewer host->device bytes and go through the gather's tiled path.
4. Consistency phase: zamba2-1.2b at full width and depth in f32; prefill
   logits with the kernels on equal those with them off within 2e-3, and
   greedy engine runs agree token for token up to a near-tie.
5. Serve path: zamba2-1.2b at full width and depth in bf16 behind
   ``ServeEngine(slots=4, max_context=2048)`` with the kernels on, eight
   requests of 256-1536 prompt tokens and 32 new tokens each; every prefill
   must launch ``flash_attention`` 7 times and ``mamba2_ssd`` 38 times.

Prints the card, the build time, the kernel checks and timings, each edit's
wall time, the serve run's timings and profile, a ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.  Any failure raises
(non-zero exit).  Exits non-zero without a CUDA card.

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
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
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


# ---------------------------------------------- model kernels (serve path)
ZAMBA2 = "zamba2-1.2b"
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


def _hold(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> float:
    """``|got - want| <= atol + rtol * |want|`` everywhere (numpy's
    allclose) and every value finite, or raise.  Returns the largest
    absolute error."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    worst = float((err / (atol + rtol * w.abs())).max())
    max_err = float(err.max())
    ok = bool(torch.isfinite(g).all()) and worst <= 1.0
    print(
        f"  {what}: max |err| {max_err:.3e}, worst err/bar {worst:.3f} "
        f"(rtol {rtol}, atol {atol}) {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError(f"{what}: outside the bar")
    return max_err


def _bound_ms(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes at the memory rate."""
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_flash_attention() -> dict:
    """The kernel against its plain version (materialised scores) at
    zamba2's heads for each prompt length, f32 and bf16; also grouped heads
    (KV 8, G 4) and a 256-position window.  Times it at the longest prompt
    in bf16 beside its bound, the plain version and PyTorch's
    ``scaled_dot_product_attention`` (which the port never calls)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_call
    from repro_torch.models import get_config

    cfg = get_config(ZAMBA2)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    scale = hd**-0.5
    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(S, kv, dtype):
        return [
            torch.randn((1, S, h, hd), generator=gen, device="cuda").to(dtype)
            for h in (H, kv, kv)
        ]

    print(f"flash_attention vs plain at {cfg.name}'s heads (H {H}, KV {KV}, hd {hd}), B 1, causal")
    cases = [(S, KV, 0) for S in PROMPT_LENS] + [(1000, 8, 0), (1536, KV, 256), (1000, 8, 256)]
    err = 0.0
    for S, kv, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = inputs(S, kv, dtype)
            got = flash_attention_call(q, k, v, scale=scale, causal=True, window=window)
            want = attention_ref(q, k, v, scale=scale, causal=True, window=window)
            e = _hold(got, want, *ATTN_TOL[dtype], f"S {S} KV {kv} window {window} {dtype}")
            if (S, kv, window, dtype) == (PROMPT_LENS[-1], KV, 0, torch.bfloat16):
                err = e
    torch.cuda.synchronize()

    for S in PROMPT_LENS:
        q, k, v = inputs(S, KV, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = _time_ms(lambda: flash_attention_call(q, k, v, scale=scale, causal=True))
        plain_ms = _time_ms(lambda: attention_ref(q, k, v, scale=scale, causal=True), launches=5)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        flops = 4.0 * hd * H * S * (S + 1) / 2  # QK^T and PV over the causal half
        nbytes = 2.0 * S * hd * (2 * H + 2 * KV)  # q, k, v read, o written (bf16)
        bound_ms, bound_by = _bound_ms(flops, nbytes)
        print(
            f"flash_attention bf16 S {S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); {flops / ms / 1e9:.1f} TFLOP/s achieved"
        )
    return {  # the longest prompt's
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
    }


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
    for each prompt length, f32 and bf16, once at mamba2-780m's (N 128), and
    against the sequential recurrence; timed at the longest prompt in bf16
    beside its bound and the plain version (no single PyTorch call computes
    the scan)."""
    from repro_torch.kernels.mamba2_ssd import ssd_ref_chunked, ssd_ref_sequential
    from repro_torch.kernels.mamba2_ssd.kernel import ssd_call
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
    cases = [(S, H, N) for S in PROMPT_LENS] + [(1000, m780.ssm_nheads, m780.ssm_state)]
    err = 0.0
    for S, h, n in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(S, h, P, n, dtype, gen)
            y, hT = ssd_call(*args, chunk=min(Q, S))
            y_ref, h_ref = ssd_ref_chunked(*args, chunk=Q)
            what = f"S {S} H {h} N {n} {dtype}"
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
        plain_ms = _time_ms(lambda: ssd_ref_chunked(*args, chunk=Q), launches=5)
        macs = 0.0
        for c0 in range(0, S, Q):
            q = min(Q, S - c0)
            # C·Bᵀ once per chunk (one B/C group), then per head the masked
            # product with x, the carry-in and the chunk's state
            macs += q * (q + 1) / 2 * N + H * (q * (q + 1) / 2 * P + 2 * q * P * N)
        nbytes = 2.0 * (2 * S * H * P + 2 * S * N) + 4.0 * (S * H + H + H * P * N)
        bound_ms, bound_by = _bound_ms(2 * macs, nbytes)
        print(
            f"mamba2_ssd bf16 S {S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); {2 * macs / ms / 1e9:.1f} TFLOP/s achieved; "
            f"{H} blocks on {torch.cuda.get_device_properties(0).multi_processor_count} SMs"
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


# ------------------------------------------------------------- serve path
def _prompts(rng: np.random.Generator, lengths, vocab: int) -> List[np.ndarray]:
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lengths]


def consistency_phase() -> None:
    """zamba2-1.2b at full width and depth in f32: prefill logits with the
    kernels on equal those with them off within 2e-3 (the reference's bar,
    tests/test_kernels.py:205-208), and greedy engine runs give the same
    tokens up to the first step whose kernels-off top-2 logit margin is
    under 1e-3."""
    import dataclasses

    from repro_torch.models import get_config, get_model
    from repro_torch.serve import GenerateRequest, ServeEngine

    new_tokens = 16
    cfg = dataclasses.replace(get_config(ZAMBA2), dtype="float32")
    apis = {
        "on": get_model(dataclasses.replace(cfg, use_pallas_kernels=True)),
        "off": get_model(dataclasses.replace(cfg, use_pallas_kernels=False)),
    }
    params = apis["on"].init_params(torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = _prompts(np.random.default_rng(1), (512, 1000), cfg.vocab_size)
    print(f"consistency: {cfg.name} f32, full width and depth ({cfg.param_count()} parameters)")
    with torch.inference_mode():
        for p in prompts:
            toks = torch.tensor(p, device="cuda")[None]
            lg_on, _ = apis["on"].prefill(params, toks)
            lg_off, _ = apis["off"].prefill(params, toks)
            _hold(lg_on, lg_off, 2e-3, 2e-3, f"prefill logits, kernels on vs off, S {len(p)}")

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
        eng = ServeEngine(recording(api, name == "off"), params, slots=1, max_context=2048)
        rids = [eng.submit(GenerateRequest(prompt=p, max_new_tokens=new_tokens)) for p in prompts]
        res = eng.run_until_drained()
        tokens[name] = [res[r].tokens.tolist() for r in rids]
    for i, p in enumerate(prompts):
        on, off = tokens["on"][i], tokens["off"][i]
        m = margins[i * new_tokens : (i + 1) * new_tokens]
        first = next((k for k in range(new_tokens) if on[k] != off[k]), None)
        if first is not None and m[first] >= 1e-3:
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
    torch.cuda.empty_cache()


SERVE_REQUESTS = 8
SERVE_NEW_TOKENS = 32


def serve_phase() -> Dict[str, int]:
    """The slice's main path: zamba2-1.2b at full width and depth in bf16
    behind ``ServeEngine(slots=4, max_context=2048)`` with the kernels on.
    Eight requests of 256-1536 prompt tokens (from a seeded numpy
    generator, one length not a multiple of 256), 32 new tokens each, half
    greedy and half at temperature 0.8 with top-k 20.  The kernels' launch
    counts are set to 0 just before the run and read just after; every
    prefill must launch flash_attention once per shared-block application
    and mamba2_ssd once per Mamba2 layer.  Returns the launch counts."""
    import dataclasses

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mamba2_ssd import kernel as ssd_kernel
    from repro_torch.models import get_config, get_model
    from repro_torch.models.hybrid import n_shared_applications
    from repro_torch.serve import GenerateRequest, ServeEngine
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(get_config(ZAMBA2), use_pallas_kernels=True)
    api = get_model(cfg)
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.reset_peak_memory_stats()  # serving's peak, not the f32 draws of the init
    rng = np.random.default_rng(0)
    lengths = rng.integers(256, 1537, SERVE_REQUESTS)
    if not (lengths % 256).any():
        raise AssertionError("every prompt length is a multiple of 256")
    prompts = _prompts(rng, lengths, cfg.vocab_size)
    requests = [
        GenerateRequest(
            prompt=p, max_new_tokens=SERVE_NEW_TOKENS,
            temperature=0.0 if i % 2 == 0 else 0.8, top_k=0 if i % 2 == 0 else 20,
        )
        for i, p in enumerate(prompts)
    ]
    print(
        f"serve: {cfg.name} {cfg.dtype}, full width and depth ({cfg.param_count()} parameters, "
        f"{cfg.num_layers} Mamba2 layers, {n_shared_applications(cfg)} shared-attention "
        f"applications), slots 4, max_context 2048, prompts {lengths.tolist()}"
    )

    prefill_ms: List[Tuple[int, float]] = []
    decode_ms: List[float] = []

    def timed(api):
        def prefill(params, tokens, prefix_embeds=None, max_len=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = api.prefill(params, tokens, prefix_embeds, max_len)
            torch.cuda.synchronize()
            prefill_ms.append((tokens.shape[1], (time.perf_counter() - t) * 1e3))
            return out

        def decode_step(params, tokens, cache):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = api.decode_step(params, tokens, cache)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t) * 1e3)
            return out

        return dataclasses.replace(api, prefill=prefill, decode_step=decode_step)

    # warm-up (library loads, cuBLAS handles) on an engine of its own
    warm = ServeEngine(api, params, slots=1, max_context=2048)
    warm.submit(GenerateRequest(prompt=prompts[0][:256], max_new_tokens=2))
    warm.run_until_drained()
    del warm

    eng = ServeEngine(timed(api), params, slots=4, max_context=2048)
    for r in requests:
        eng.submit(r)
    fa_kernel.launches = 0
    ssd_kernel.launches = 0
    t0 = time.perf_counter()
    results = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa_kernel.launches, "mamba2_ssd": ssd_kernel.launches}

    if len(results) != SERVE_REQUESTS or eng.prefills != SERVE_REQUESTS:
        raise AssertionError(f"{len(results)} results and {eng.prefills} prefills for {SERVE_REQUESTS} requests")
    for r in requests:
        t = results[r.req_id].tokens
        if t.shape != (SERVE_NEW_TOKENS,) or not ((0 <= t) & (t < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.req_id}: tokens {t}")
    want = {
        "flash_attention": n_shared_applications(cfg) * eng.prefills,
        "mamba2_ssd": cfg.num_layers * eng.prefills,
    }
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} for {eng.prefills} prefills")
    generated = SERVE_REQUESTS * SERVE_NEW_TOKENS
    peak = torch.cuda.max_memory_allocated()
    print(
        f"  {eng.prefills} prefills, {eng.decode_steps} decode steps, wall {wall:.3f} s, "
        f"{generated} tokens generated = {generated / wall:.1f} tokens/s; launches {launches}; "
        f"peak device memory {peak / 2**30:.3f} GiB"
    )
    print("  prefill ms by prompt length: " + ", ".join(f"{n}: {ms:.2f}" for n, ms in prefill_ms))
    print(
        f"  decode ms per step: median {float(np.median(decode_ms)):.3f}, "
        f"mean {float(np.mean(decode_ms)):.3f}, min {min(decode_ms):.3f}, max {max(decode_ms):.3f}"
    )

    # profiles, after the counts are read: a few decode steps of the full
    # batch, and one prefill of the ragged prompt length
    tokens = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        _, cache = api.decode_step(params, tokens, eng.cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(4):
                _, cache = api.decode_step(params, tokens, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        print_profile("decode x4 (batch 4)", prof, wall, top_n=8)
        toks = torch.tensor(_prompts(rng, [1000], cfg.vocab_size)[0], device="cuda")[None]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            api.prefill(params, toks, max_len=2048)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        print_profile("prefill S 1000", prof, wall, top_n=8)
    del params, eng, cache
    torch.cuda.empty_cache()
    return launches


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

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False

    check_fragment_gather()
    check_device_tier_dtypes()
    total = args.rows // args.frag * args.frag
    gather = time_fragment_gather(total, args.frag)
    attention = check_flash_attention()
    scan = check_mamba2_ssd()

    with tempfile.TemporaryDirectory() as tmp:
        result = main_path(args.rows, args.frag, tmp)
    if result["h2d_ratio"] < 5:
        raise AssertionError(f"warm H2D ratio {result['h2d_ratio']:.3f} < 5")
    if result["gather_fast"] < 1:
        raise AssertionError("the main path never took the gather's tiled path")
    if result["launches"] < 1:
        raise AssertionError("the main path never launched fragment_gather")
    gather["launches"] = result["launches"]

    consistency_phase()
    launches = serve_phase()
    attention["launches"] = launches["flash_attention"]
    scan["launches"] = launches["mamba2_ssd"]
    print(json.dumps({"kernels": [gather, attention, scan]}))
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
