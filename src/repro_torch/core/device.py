"""The device tier: hot cache elements pinned as torch tensors on the card.

The differential cache saves bytes *recomputed*, but every byte served still
transits host memory: residual assembly and the hit∪residual UNION run in
numpy, so a torch-runtime node pays a host→device copy for data the cache
already "had".  :class:`DeviceTier` closes that gap:

- **pinning**: a cache element's payload columns are uploaded once as
  tensors on the tier's device (column-major — one 1-D tensor per
  ``(element, column)``, padded with zeros to :data:`ROW_BLOCK` rows so
  every fragment boundary the gather kernel sees is tile-addressable).  Pins
  are keyed by ``elem_id``; element ids are never reused (merges mint new
  elements), so a stale pin can never alias a different payload.
- **serving**: :func:`device_union` assembles hit∪residual output columns
  *on device* — every row run of every column, from every pinned provider,
  is copied into the preallocated outputs by one launch of the
  ``fragment_gather`` CUDA kernel, driven by a table of the runs' bounds
  (non-aligned multi-run groups are counted as fallback downgrades, as the
  reference counts them).  No host round-trip, no per-row index.
- **merge replication**: when the store merges two pinned elements, the
  merged element's device columns are built by the same UNION from the
  parents' pins (device→device), so a warm iteration loop re-uploads only
  the fresh residual — H2D bytes stay proportional to the *edit*, exactly
  like the RAM tier's recompute bytes.
- **demotion**: the tier has its own byte budget with LRU eviction.  The
  RAM tier stays authoritative (a device pin is a *copy*, never the only
  copy), so demotion is just a drop — the next torch consumer re-pins.

Bitwise discipline: the reference pins with ``jnp.asarray``, which under
jax's default x32 mode narrows int64→int32, uint64→uint32 and
float64→float32.  :func:`to_device` narrows the same way, so the port's
columns, user-fn outputs and byte ledgers equal the reference's.  The
narrowing is elementwise, so it commutes with gather and concatenation.

Mutability: jax buffers are immutable; torch tensors are not.  Uploads never
share memory with the RAM tier's numpy arrays, and the executor hands
torch user fns clones of device columns, so an in-place write in a user fn
cannot reach a pin.

Everything here is advisory: any unsupported dtype, non-torch runtime, or
missing pin falls back to the numpy path with no semantic change.
"""

from __future__ import annotations

import threading
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.columnar import ChunkedTable, Table
from repro_torch.kernels.fragment_gather.ops import fragment_union
from repro_torch.kernels.fragment_gather.ref import signed_view
from repro_torch.obs.metrics import MetricAttr, Metrics
from repro_torch.obs.trace import Tracer, get_tracer

__all__ = [
    "ROW_BLOCK",
    "DeviceTier",
    "DeviceTable",
    "DeviceChunkedTable",
    "device_union",
    "resolve_device",
    "to_device",
]

# pin-time padding granularity: every pinned column is padded to a multiple
# of ROW_BLOCK rows, as the reference pads them for its gather kernel's
# smallest tile; the tier's byte ledgers count the padding
ROW_BLOCK = 8

# the reference's row-block sizes for a union gather, largest first; a
# multi-run group is counted gather_fast when one of them divides every run
_RB_CANDIDATES = (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8)

# jax's x32 narrowing on jnp.asarray, mirrored so port and reference agree
_X32 = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.float32),
}


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the CUDA card.  A CUDA device without a card raises —
    the port never carries on silently on the CPU.  A CUDA device without an
    index is the current card, so ``"cuda"`` and ``"cuda:0"`` resolve to the
    same device when card 0 is current."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(col: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload one host column, narrowed as ``jnp.asarray`` narrows it under
    x32.  The tensor never shares memory with ``col``."""
    dt = np.dtype(col.dtype).newbyteorder("=")
    target = _X32.get(dt, dt)
    if device.type == "cpu" or col.dtype != target or not col.flags.c_contiguous:
        # narrow on the host, as jax does, so the bits match the reference's
        host = torch.from_numpy(np.array(col, dtype=target, order="C", copy=True))
        return host if device.type == "cpu" else host.to(device)
    with warnings.catch_warnings():
        # read-only host arrays are fine: .to() copies them off at once
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(col).to(device)


def _bump(ledger: Optional[Dict[str, int]], key: str, by: int = 1) -> None:
    if ledger is not None:
        ledger[key] = ledger.get(key, 0) + by


def _pad_rows(arr: torch.Tensor, mult: int = ROW_BLOCK) -> torch.Tensor:
    pad = (-arr.shape[0]) % mult
    if pad == 0:
        return arr
    signed = signed_view(arr)
    return torch.cat([signed, signed.new_zeros(pad)]).view(arr.dtype)


class _DeviceEntry:
    __slots__ = ("arr", "rows", "nbytes", "last_used")

    def __init__(self, arr: torch.Tensor, rows: int, last_used: int):
        self.arr = arr  # 1-D tensor on the tier's device, padded to ROW_BLOCK rows
        self.rows = rows  # real (unpadded) rows
        self.nbytes = int(arr.nbytes)
        self.last_used = last_used


class DeviceTier:
    """Byte-budgeted LRU cache of ``(elem_id, column) → device tensor``.

    ``device=None`` means the CUDA card (and raises without one); tests pass
    ``device="cpu"``, where the gathers take the kernel's plain version.
    """

    # ledger (surfaced through SharedStore.stats() / ScanReport / RunResult);
    # registry-backed — see DifferentialStore's counters
    bytes_h2d = MetricAttr("device_bytes_h2d")  # host→device bytes uploaded by pins
    device_hits = MetricAttr("device_hits")  # pin/get requests served resident
    device_evictions = MetricAttr("device_evictions")  # LRU-demoted entries
    pins = MetricAttr("device_pins")  # entries uploaded (misses)
    bytes_replicated = MetricAttr("device_bytes_replicated")  # d2d merge bytes

    def __init__(
        self,
        max_bytes: Optional[int] = None,
        device: Union[None, str, torch.device] = None,
    ):
        self.max_bytes = max_bytes
        self.device = resolve_device(device)
        self.lock = threading.RLock()
        self._entries: Dict[Tuple[int, str], _DeviceEntry] = {}
        self._by_elem: Dict[int, set] = {}
        self._clock = 0
        self._metrics: Optional[Metrics] = None
        self._tracer: Optional[Tracer] = None
        self.metrics_labels: Dict[str, str] = {}

    @property
    def metrics(self) -> Metrics:
        if self._metrics is None:
            self._metrics = Metrics()
        return self._metrics

    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    def adopt_obs(self, metrics: Optional[Metrics], tracer: Tracer) -> None:
        """Join an owner's registry/tracer (``metrics=None``: the tracer
        alone).  One tier often backs both the scan cache and the model
        store — the first owner wins, so the tier's counters land in exactly
        one registry."""
        if self._metrics is None and metrics is not None:
            self._metrics = metrics
        if self._tracer is None:
            self._tracer = tracer

    # -- inspection ----------------------------------------------------------
    @property
    def nbytes(self) -> int:
        with self.lock:
            return sum(e.nbytes for e in self._entries.values())

    def __len__(self) -> int:
        with self.lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self.lock:
            return {
                "device_nbytes": sum(e.nbytes for e in self._entries.values()),
                "device_entries": len(self._entries),
                "bytes_h2d": self.bytes_h2d,
                "device_hits": self.device_hits,
                "device_evictions": self.device_evictions,
                "device_pins": self.pins,
                "bytes_replicated": self.bytes_replicated,
            }

    @staticmethod
    def supported(dtype) -> bool:
        """Dtypes the device path serves; everything else stays on the
        numpy path (strings/objects/datetimes have no tensor analog here)."""
        return np.dtype(dtype).kind in "fiub"

    # -- pinning -------------------------------------------------------------
    def get(self, elem_id: int, column: str) -> Optional[torch.Tensor]:
        """The resident tensor for ``(elem_id, column)``, or None.  Never
        uploads."""
        with self.lock:
            e = self._entries.get((elem_id, column))
            if e is None:
                return None
            self._clock += 1
            e.last_used = self._clock
            self.device_hits += 1
            return e.arr

    def pin(self, elem, column: str, ledger: Optional[Dict[str, int]] = None):
        """The device tensor for one element column, uploading on miss.
        Returns None when the element is demoted (no RAM payload to read)
        or the dtype is unsupported — callers fall back to numpy."""
        with self.lock:
            e = self._entries.get((elem.elem_id, column))
            if e is not None:
                self._clock += 1
                e.last_used = self._clock
                self.device_hits += 1
                _bump(ledger, "device_hits")
                return e.arr
        data = elem.data
        if data is None or column not in data.column_names:
            return None
        col = data.column(column)
        if not self.supported(col.dtype):
            return None
        with self.tracer.span("device.h2d", elem=elem.elem_id, column=column) as sp:
            arr = to_device(col, self.device)
            h2d = int(arr.nbytes)
            sp.attrs["bytes"] = h2d
        return self._insert(
            elem.elem_id, column, _pad_rows(arr), int(col.shape[0]),
            h2d=h2d, ledger=ledger,
        )

    def pin_columns(
        self, elem, columns: Sequence[str], ledger: Optional[Dict[str, int]] = None
    ) -> Optional[Dict[str, torch.Tensor]]:
        """All-or-nothing pin of several columns (a partial union provider
        would force a per-column host/device split downstream)."""
        out: Dict[str, torch.Tensor] = {}
        for c in columns:
            arr = self.pin(elem, c, ledger)
            if arr is None:
                return None
            out[c] = arr
        return out

    def pin_table(
        self, elem_id: int, table: Table, ledger: Optional[Dict[str, int]] = None
    ) -> bool:
        """Upload every supported column of ``table`` under ``elem_id`` —
        the spill tier's straight-to-device promotion (mmap → H2D once).
        Returns True when all columns landed."""
        ok = True
        with self.tracer.span("device.h2d", elem=elem_id) as sp:
            total = 0
            for c in table.column_names:
                col = table.column(c)
                if not self.supported(col.dtype):
                    ok = False
                    continue
                with self.lock:
                    if (elem_id, c) in self._entries:
                        continue
                arr = to_device(col, self.device)
                h2d = int(arr.nbytes)
                total += h2d
                self._insert(
                    elem_id, c, _pad_rows(arr), int(col.shape[0]),
                    h2d=h2d, ledger=ledger,
                )
            sp.attrs["bytes"] = total
        return ok

    def adopt(
        self,
        elem_id: int,
        arrays: Mapping[str, torch.Tensor],
        rows: int,
        *,
        replicated: bool = False,
    ) -> None:
        """Register already-on-device columns for ``elem_id`` (a fresh
        residual the executor just converted, or a merge replica) — no H2D
        is counted here; the producer accounted for the transfer.  The tier
        takes ownership: the producer must not write to them afterwards."""
        for c, arr in arrays.items():
            padded = _pad_rows(arr)
            if replicated:
                with self.lock:
                    self.bytes_replicated += int(padded.nbytes)
            self._insert(elem_id, c, padded, rows, h2d=0, ledger=None)

    def _insert(self, elem_id, column, arr, rows, *, h2d, ledger):
        with self.lock:
            key = (elem_id, column)
            existing = self._entries.get(key)
            if existing is not None:  # lost an upload race: keep the first
                self.device_hits += 1
                return existing.arr
            self._clock += 1
            self._entries[key] = _DeviceEntry(arr, rows, self._clock)
            self._by_elem.setdefault(elem_id, set()).add(column)
            self.pins += 1
            if h2d:
                self.bytes_h2d += h2d
                _bump(ledger, "bytes_h2d", h2d)
            self._evict()
        return arr

    # -- merge replication ---------------------------------------------------
    def element_arrays(
        self, elem, columns: Sequence[str]
    ) -> Optional[Dict[str, torch.Tensor]]:
        """Resident tensors for all ``columns`` of ``elem`` — None unless
        every one is already pinned (replication never uploads)."""
        out: Dict[str, torch.Tensor] = {}
        with self.lock:
            for c in columns:
                e = self._entries.get((elem.elem_id, c))
                if e is None:
                    return None
                out[c] = e.arr
        return out

    def replicate_merge(self, a, b, merged, a_window, b_window) -> bool:
        """Build the merged element's device columns from its parents'
        pins (device→device — zero H2D).  Mirrors
        ``DifferentialStore._merge_pair`` exactly: ``a`` contributes its
        rows inside ``a_window``, ``b`` inside ``b_window`` (disjoint), and
        the merged payload is their key-ordered union (one
        :func:`device_union`, so one launch).  Returns False (and
        pins nothing) when either parent is not fully resident here."""
        cols = list(merged.columns)
        prov_a = self.element_arrays(a, cols)
        prov_b = self.element_arrays(b, cols)
        if prov_a is None or prov_b is None:
            return False
        runs: List[Tuple[Any, Mapping[str, torch.Tensor], int, int]] = []
        for side, window, prov in ((a, a_window, prov_a), (b, b_window, prov_b)):
            for iv, lo, hi in side.window_runs(window):
                runs.append((iv.lo, prov, lo, hi))
        if not runs:
            return True  # empty merge: nothing to pin, trivially replicated
        runs.sort(key=lambda r: r[0])
        arrays = device_union(
            [(prov, lo, hi) for _key, prov, lo, hi in runs], cols, tracer=self.tracer
        )
        rows = sum(hi - lo for _key, _prov, lo, hi in runs)
        self.adopt(merged.elem_id, arrays, rows, replicated=True)
        return True

    # -- demotion ------------------------------------------------------------
    def drop_element(self, elem_id: int) -> None:
        """Forget every pin of ``elem_id`` (the element merged away or left
        the store index).  Handed-out tensors stay valid — they hold their
        own reference to the storage."""
        with self.lock:
            for c in self._by_elem.pop(elem_id, ()):
                self._entries.pop((elem_id, c), None)

    def clear(self) -> None:
        with self.lock:
            self._entries.clear()
            self._by_elem.clear()

    def _evict(self) -> None:
        if self.max_bytes is None:
            return
        with self.lock:
            while (
                sum(e.nbytes for e in self._entries.values()) > self.max_bytes
                and self._entries
            ):
                key = min(self._entries, key=lambda k: self._entries[k].last_used)
                self._entries.pop(key)
                elem_id, column = key
                cols = self._by_elem.get(elem_id)
                if cols is not None:
                    cols.discard(column)
                    if not cols:
                        del self._by_elem[elem_id]
                self.device_evictions += 1


# ---------------------------------------------------------------------------
# device-side UNION assembly
# ---------------------------------------------------------------------------

def _choose_row_block(bounds: Sequence[Tuple[int, int]]) -> Optional[int]:
    """Largest candidate RB for which every run is block-aligned (start and
    length both multiples of RB) — the kernel's tiled fast path; None when
    no candidate fits (the RB=1 fallback)."""
    for rb in _RB_CANDIDATES:
        if all(lo % rb == 0 and (hi - lo) % rb == 0 for lo, hi in bounds):
            return rb
    return None


def device_union(
    runs: Sequence[Tuple[Mapping[str, torch.Tensor], int, int]],
    columns: Sequence[str],
    *,
    ledger: Optional[Dict[str, int]] = None,
    tracer: Optional[Tracer] = None,
) -> Dict[str, torch.Tensor]:
    """Assemble the hit∪residual UNION on device.

    ``runs`` is the output's row layout **in final row order**: each entry is
    ``(arrays, lo, hi)`` — a provider mapping of padded 1-D device columns
    and the half-open real-row range it contributes.  A UNION of one run is
    a device slice of each column (a copy would be the identity).  Any other
    allocates each output column once and copies every run of every column
    in ONE ``fragment_union`` launch, from a table of the runs' bounds: no
    per-row index is built.  Consecutive runs from the same provider form a
    group; each multi-run group of each column is counted in the ledger as
    the reference's gather counts it (``gather_fast`` where every run is
    block-aligned, else ``gather_fallbacks``).  Returns exact-length device
    columns, bitwise-equal to the numpy reference ``np.concatenate`` of the
    same slices followed by :func:`to_device`.  A column may be a view of a
    provider's tensor: callers that hand columns to user code clone them.

    With an enabled ``tracer`` the call is a ``device.union`` span (the
    host's run table, pinned upload and launch; the kernel's own device
    time is the profiler's) with the output ``bytes`` the ledger counts,
    the ``runs`` and ``launched`` (0 or 1).
    """
    if not runs:
        return {}
    if tracer is None or not tracer.enabled:
        return _union(runs, columns, ledger, None)
    with tracer.span("device.union") as sp:
        return _union(runs, columns, ledger, sp)


def _union(runs, columns, ledger, sp) -> Dict[str, torch.Tensor]:
    # group consecutive runs by provider identity
    groups: List[Tuple[Mapping[str, torch.Tensor], List[Tuple[int, int]]]] = []
    for arrays, lo, hi in runs:
        if hi <= lo:
            continue
        if groups and groups[-1][0] is arrays:
            groups[-1][1].append((lo, hi))
        else:
            groups.append((arrays, [(lo, hi)]))
    if not groups:
        first = runs[0][0]
        return {c: first[c][0:0] for c in columns}

    total_rows = sum(hi - lo for _arrays, bounds in groups for lo, hi in bounds)
    launched = len(groups) > 1 or len(groups[0][1]) > 1
    if not launched:
        arrays, ((lo, hi),) = groups[0]
        out = {c: arrays[c][lo:hi] for c in columns}
    else:
        out, table = {}, []
        for c in columns:
            like = groups[0][0][c]
            col = out[c] = torch.empty(total_rows, dtype=like.dtype, device=like.device)
            at = 0
            for arrays, bounds in groups:
                if len(bounds) > 1:
                    fast = _choose_row_block(bounds) is not None
                    _bump(ledger, "gather_fast" if fast else "gather_fallbacks")
                for lo, hi in bounds:
                    table.append((arrays[c], lo, col, at, hi - lo))
                    at += hi - lo
        fragment_union(table)
    if sp is not None:
        sp.attrs["bytes"] = sum(int(out[c].nbytes) for c in columns)
        sp.attrs["runs"] = sum(len(bounds) for _arrays, bounds in groups)
        sp.attrs["launched"] = int(launched)
    for c in columns:
        _bump(ledger, "device_union_bytes", int(out[c].nbytes))
    _bump(ledger, "device_unions")
    _bump(ledger, "device_union_rows", total_rows)
    return out


# ---------------------------------------------------------------------------
# device-aware table wrappers
# ---------------------------------------------------------------------------

class DeviceTable(Table):
    """A host :class:`Table` carrying device-resident copies of (some of)
    its columns.  The host columns stay authoritative; ``device_columns``
    are advisory, bitwise-equal tensors a torch-runtime consumer uses to
    skip the H2D conversion.  Views (``select``/``slice``/…) return plain
    Tables — device association does not survive reshaping."""

    __slots__ = ("device_columns",)

    def __init__(self, host: Table, device_columns: Mapping[str, torch.Tensor]):
        super().__init__({n: host.column(n) for n in host.column_names})
        self.device_columns = dict(device_columns)


class DeviceChunkedTable(ChunkedTable):
    """A :class:`ChunkedTable` whose *combined* columns are also resident on
    device.  ``device_columns[c]`` equals ``to_device(self.column(c))``
    bitwise (chunk concatenation order)."""

    __slots__ = ("device_columns",)

    def __init__(self, chunks, device_columns: Mapping[str, torch.Tensor]):
        super().__init__(chunks)
        self.device_columns = dict(device_columns)

    def select(self, names):
        return DeviceChunkedTable(
            [c.select(names) for c in self.chunks],
            {n: self.device_columns[n] for n in names if n in self.device_columns},
        )
