"""Wrapper: arbitrary row-index gather via the block-run CUDA kernel.

Converts a per-row index vector into the kernel's block-run form, exactly as
the reference wrapper does: if every RB-aligned group of indices is a
contiguous run starting at an RB-aligned source row (the common case —
fragments are contiguous row ranges), rows move in RB-row tiles; otherwise
the gather falls back to RB=1 (row-granular).  Fallback downgrades are
counted in :data:`GATHER_STATS` under the reference's rule.

A CPU tensor takes the plain version (``ref.gather_ref``); a CUDA tensor
launches the kernel or raises.  The TPU wrapper's column tiling and lane
padding have no counterpart: the kernel moves rows as byte strings, so
``col_block`` is accepted for signature parity and has no effect.

One ledger differs from the reference's on CUDA: the reference's device tier
sends non-aligned gathers above ``FALLBACK_KERNEL_MAX_ROWS`` rows to an XLA
take, which bypasses this wrapper; the port's tier sends them here, to the
kernel's row-granular mode, so the process-wide ``GATHER_STATS.fallbacks``
counts them too.  The per-run ``gather_fallbacks`` ledger is unaffected.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels.fragment_gather.kernel import fragment_gather_call
from repro_torch.kernels.fragment_gather.ref import gather_ref

__all__ = ["fragment_gather", "GATHER_STATS", "GatherStats"]


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
    block_idx = np.ascontiguousarray(row_idx.reshape(-1, rb)[:, 0] // rb)
    return fragment_gather_call(
        src,
        torch.from_numpy(block_idx).to(src.device),
        row_block=rb,
        out_rows=R,
    )
