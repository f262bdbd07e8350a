"""Wrappers: the UNION of row runs in one launch, and the reference's
arbitrary row-index gather.

:func:`fragment_union` copies row runs between 1-D tensors — the device
tier's hit∪residual UNION, every column and provider at once — through one
launch of the run-table CUDA kernel.  It takes the runs' bounds, never a
per-row index.

:func:`fragment_gather` keeps the reference wrapper's contract: it converts
a per-row index vector into block-run form, exactly as the reference does.
If every RB-aligned group of indices is a contiguous run starting at an
RB-aligned source row, rows move in RB-row tiles; otherwise the gather falls
back to RB=1 (row-granular).  Fallback downgrades are counted in
:data:`GATHER_STATS` under the reference's rule.  The tiles reach the same
run-table kernel, consecutive tiles merged into runs.

A CPU tensor takes the plain version (``ref.union_ref``, ``ref.gather_ref``);
a CUDA tensor launches the kernel or raises.  The TPU wrapper's column tiling
and lane padding have no counterpart: the kernel moves rows as byte strings,
so ``col_block`` is accepted for signature parity and has no effect.

:data:`GATHER_STATS` counts calls of :func:`fragment_gather` only.  The
reference's device tier gathers through its ``fragment_gather``, so there
the process-wide counters also count the tier's multi-run groups; the
port's tier goes through :func:`fragment_union` and leaves them alone.  The
tier's own per-run ``gather_fast`` / ``gather_fallbacks`` ledger is the
reference's, group for group.
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.fragment_gather.kernel import fragment_gather_call, fragment_union_call
from repro_torch.kernels.fragment_gather.ref import gather_ref, union_ref

__all__ = ["fragment_gather", "fragment_union", "GATHER_STATS", "GatherStats"]

# (src, src_row, dst, dst_row, rows): dst[dst_row:dst_row+rows] = src[src_row:src_row+rows]
Run = Tuple[torch.Tensor, int, torch.Tensor, int, int]


class GatherStats:
    """Process-wide gather path counters (thread-safe increments)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.calls = 0
        self.fast_path = 0
        self.fallbacks = 0  # RB=1 downgrades (non-block-aligned indices)

    def count(self, fast: bool) -> None:
        with self._lock:
            self.calls += 1
            if fast:
                self.fast_path += 1
            else:
                self.fallbacks += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "calls": self.calls,
                "fast_path": self.fast_path,
                "fallbacks": self.fallbacks,
            }


GATHER_STATS = GatherStats()


def fragment_union(runs: Sequence[Run]) -> None:
    """Copy every run ``(src, src_row, dst, dst_row, rows)`` between 1-D
    contiguous tensors of one dtype per run.  CPU tensors take
    ``union_ref``; CUDA tensors on one card take one kernel launch for all
    the runs, or raise."""
    if all(src.device.type == "cpu" and dst.device.type == "cpu" for src, _s, dst, _d, _n in runs):
        union_ref(runs)
        return
    device = runs[0][2].device
    src_at, dst_at, nbytes = [], [], []
    for src, src_row, dst, dst_row, rows in runs:
        if not (src.is_cuda and dst.is_cuda and src.device == dst.device == device):
            raise ValueError("fragment_union takes CUDA tensors on one device")
        if src.dtype != dst.dtype:
            raise TypeError(f"a run copies {src.dtype} into {dst.dtype}")
        if src.dim() != 1 or dst.dim() != 1 or not (src.is_contiguous() and dst.is_contiguous()):
            raise ValueError("fragment_union takes contiguous 1-D tensors")
        # the kernel does no bounds check: a run past either end would copy
        # memory beyond the column
        if rows < 0 or src_row < 0 or dst_row < 0 or src_row + rows > src.shape[0] or dst_row + rows > dst.shape[0]:
            raise IndexError(
                f"run of {rows} rows from {src_row} (of {src.shape[0]}) to {dst_row} (of {dst.shape[0]})"
            )
        size = src.element_size()
        src_at.append(src.data_ptr() + src_row * size)
        dst_at.append(dst.data_ptr() + dst_row * size)
        nbytes.append(rows * size)
    fragment_union_call(src_at, dst_at, nbytes, device)


def fragment_gather(
    src: torch.Tensor,  # (Ns, C)
    row_idx,  # (R,) int — host-known fragment layout (numpy or list)
    *,
    row_block: int = 8,
    col_block: int = 512,
) -> torch.Tensor:
    row_idx = np.asarray(row_idx, np.int32)
    R = int(row_idx.shape[0])
    Ns, C = src.shape
    if R == 0:
        return src[:0]
    # every index must address a REAL source row: the kernel does no bounds
    # check, so an index past the end would copy memory beyond the column
    lo_i, hi_i = int(row_idx.min()), int(row_idx.max())
    if lo_i < 0 or hi_i >= Ns:
        raise IndexError(
            f"row_idx out of range: [{lo_i}, {hi_i}] vs {Ns} source rows"
        )

    # try RB-tiled: indices in each RB group contiguous AND tile-aligned
    rb = row_block
    ok = R % rb == 0
    if ok:
        grouped = row_idx.reshape(-1, rb)
        runs = (grouped == grouped[:, :1] + np.arange(rb, dtype=np.int32)).all()
        aligned = (grouped[:, 0] % rb == 0).all()
        ok = bool(runs and aligned)
    if not ok:
        rb = 1
    GATHER_STATS.count(fast=rb > 1)

    if src.device.type == "cpu":
        return gather_ref(src, torch.from_numpy(row_idx))
    return fragment_gather_call(
        src, row_idx.reshape(-1, rb)[:, 0] // rb, row_block=rb, out_rows=R
    )
