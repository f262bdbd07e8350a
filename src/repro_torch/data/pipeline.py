"""TokenBatchPipeline: deterministic, cache-served, prefetching batches.

Determinism contract: ``batch_at(step)`` is a pure function of
(table snapshot, global_batch, seq_len, step) — resume = restart at step k.
Every batch is one *scan* through the differential cache, so:

- repeated epochs are served from the cache (zero store bytes),
- a concurrent consumer with overlapping windows (eval job, second trainer,
  a data scientist's ad-hoc query) shares the same cache elements — the
  paper's §III-A pattern at training scale.

The prefetcher is a daemon thread running ``prefetch_depth`` steps ahead
(host-side scan/assembly overlapped with device compute).

On the scan executor's tracer, each batch built is a ``data.batch`` span
(attribute ``step``; the scan's spans nest under it) and each wait of the
consumer for its next batch a ``data.wait`` span: the queue's ``get``, or
the whole build when nothing is prefetched.

The port of ``repro.data.pipeline``: ``TokenBatchPipeline`` is the
reference's, line for line (numpy over ``ScanExecutor``), with the two
spans above.  ``shard_batch``
places a host batch on one device; its mesh form is
``dist.sharding.distribute_tree`` with the batch dims' logical axes.
"""

from __future__ import annotations

import queue
import threading
import warnings
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.intervals import IntervalSet
from repro_torch.core.planner import ScanExecutor
from repro_torch.data.packing import mask_from_doc_ids

__all__ = ["TokenBatchPipeline", "shard_batch"]


class TokenBatchPipeline:
    def __init__(
        self,
        scans: ScanExecutor,
        table: str,
        *,
        global_batch: int,
        seq_len: int,
        token_col: str = "token",
        doc_col: Optional[str] = "doc_id",
        start_step: int = 0,
        prefetch_depth: int = 2,
        snapshot_id: Optional[str] = None,
    ):
        self.scans = scans
        self.table = table
        self.B = global_batch
        self.S = seq_len
        self.token_col = token_col
        self.doc_col = doc_col
        self.step = start_step
        self.prefetch_depth = prefetch_depth
        # pin the snapshot: a concurrent append must not change epoch layout
        snap = (
            scans.catalog.snapshot(table, snapshot_id)
            if snapshot_id
            else scans.catalog.current_snapshot(table)
        )
        self.snapshot_id = snap.snapshot_id
        self.total_tokens = sum(f.row_count for f in snap.fragments)
        self.tokens_per_step = self.B * (self.S + 1)
        if self.total_tokens < self.tokens_per_step:
            raise ValueError(
                f"corpus {table} has {self.total_tokens} tokens < one batch "
                f"({self.tokens_per_step})"
            )
        self.steps_per_epoch = self.total_tokens // self.tokens_per_step
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._q: Optional[queue.Queue] = None

    # ------------------------------------------------------------ pure fetch
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (epoch-wrapping window)."""
        with self.scans.tracer.span("data.batch", step=step):
            return self._batch_at(step)

    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        idx = step % self.steps_per_epoch
        lo = idx * self.tokens_per_step
        hi = lo + self.tokens_per_step
        cols = [self.token_col] + ([self.doc_col] if self.doc_col else [])
        out = self.scans.scan(
            self.table,
            cols,
            window=IntervalSet.of((lo, hi)),
            snapshot_id=self.snapshot_id,
            sorted_output=False,
        )
        tbl = out.combine()
        toks = np.asarray(tbl.column(self.token_col), np.int32).reshape(
            self.B, self.S + 1
        )
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
        if self.doc_col:
            docs = np.asarray(tbl.column(self.doc_col)).reshape(self.B, self.S + 1)
            batch["loss_mask"] = mask_from_doc_ids(docs)
        else:
            batch["loss_mask"] = np.ones((self.B, self.S), np.float32)
        return batch

    # ------------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch_depth <= 0:
            while True:
                with self.scans.tracer.span("data.wait"):
                    b = self.batch_at(self.step)
                self.step += 1
                yield b
        else:
            yield from self._prefetching_iter()

    def _prefetching_iter(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        start = self.step

        def worker():
            s = start
            while not stop.is_set():
                try:
                    item = (s, self.batch_at(s))
                except Exception as e:  # surface in consumer
                    q.put(("error", e))
                    return
                q.put(item)
                s += 1

        t = threading.Thread(target=worker, daemon=True, name="data-prefetch")
        t.start()
        self._thread, self._q, self._stop = t, q, stop
        try:
            while True:
                with self.scans.tracer.span("data.wait"):
                    tag, payload = q.get()
                if tag == "error":
                    raise payload
                assert tag == self.step, f"prefetch out of order: {tag} != {self.step}"
                self.step += 1
                yield payload
        finally:
            stop.set()
            # drain so the worker unblocks and exits
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    # ----------------------------------------------------------------- state
    def state(self) -> Dict[str, int]:
        """Checkpointable pipeline state — resume is exact (tested)."""
        return {"step": self.step, "snapshot_id": self.snapshot_id}

    def close(self) -> None:
        self._stop.set()


def shard_batch(batch: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """Place a host batch on one device (``None``: the CUDA card).  On a
    card each array goes through a pinned host tensor and one
    ``non_blocking`` copy, ordered on the current stream before whatever
    consumes it there; on the CPU it is ``torch.from_numpy`` (no copy).  A
    value that is already a tensor is moved to the device."""
    device = resolve_device(device)
    out = {k: v.to(device) for k, v in batch.items() if isinstance(v, torch.Tensor)}
    host = {k: v for k, v in batch.items() if k not in out}
    if device.type == "cpu":
        with warnings.catch_warnings():  # scanned columns are read-only; so is the batch
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            out.update((k, torch.from_numpy(v)) for k, v in host.items())
    else:
        out.update(
            (k, torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True))
            for k, v in host.items()
        )
    return out
