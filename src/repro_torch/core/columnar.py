"""Arrow-analog columnar tables with true zero-copy views.

The paper stores cache elements as **Arrow tables** so that (a) *k* downstream
consumers share one scan without copies and (b) Parquet decode costs are paid
once. Offline we reproduce those semantics with numpy:

- :class:`Column` / :class:`Table` — immutable columnar batches; ``slice`` and
  ``select`` are O(1) views (``np.shares_memory`` holds, asserted in tests).
- :class:`ChunkedTable` — a dataframe assembled from multiple fragments
  (paper Fig. 4 bottom row: cache hits + residual scan) *without* copying;
  consumers either iterate chunks or ``combine()`` lazily.
- ``write_ipc`` / ``read_ipc`` — an IPC format whose reader memory-maps column
  buffers (the paper's Arrow IPC row in Table I: ~0 s to "move" a dataframe).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Table", "ChunkedTable", "write_ipc", "read_ipc", "concat_tables"]

_MAGIC = b"RIPC0001"


class Table:
    """An immutable columnar batch: ordered ``{name: 1-D np.ndarray}``."""

    __slots__ = ("_cols", "_nrows")

    def __init__(self, columns: Mapping[str, np.ndarray]):
        cols: Dict[str, np.ndarray] = {}
        nrows: Optional[int] = None
        for name, arr in columns.items():
            arr = np.asarray(arr)
            if arr.ndim != 1:
                raise ValueError(f"column {name!r} must be 1-D, got {arr.shape}")
            if nrows is None:
                nrows = arr.shape[0]
            elif arr.shape[0] != nrows:
                raise ValueError(
                    f"column {name!r} length {arr.shape[0]} != {nrows}"
                )
            if arr.flags.writeable:
                # freeze an internal VIEW, never the caller's array: the
                # caller keeps write access to the buffer it handed us,
                # while every array reachable through this Table is
                # read-only.  Like Arrow's zero-copy numpy ingestion, the
                # buffer is still aliased — a caller that keeps writing
                # into it sees those writes reflected in the Table; copy
                # at the call site if the source must stay mutable.
                arr = arr.view()
                arr.flags.writeable = False
            cols[name] = arr
        self._cols = cols
        self._nrows = nrows or 0

    # -- metadata ----------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._nrows

    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(self._cols)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self._cols.values())

    def column(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def schema(self) -> Dict[str, str]:
        return {k: str(v.dtype) for k, v in self._cols.items()}

    # -- zero-copy views ---------------------------------------------------
    def select(self, names: Sequence[str]) -> "Table":
        """Projection — zero-copy (columns are shared, never copied)."""
        return Table({n: self._cols[n] for n in names})

    def slice(self, start: int, stop: int) -> "Table":
        """Row window — zero-copy numpy views."""
        return Table({n: c[start:stop] for n, c in self._cols.items()})

    # -- copying operations --------------------------------------------
    def take(self, indices: np.ndarray) -> "Table":
        return Table({n: c[indices] for n, c in self._cols.items()})

    def filter(self, mask: np.ndarray) -> "Table":
        return Table({n: c[mask] for n, c in self._cols.items()})

    def sort_by(self, name: str) -> "Table":
        order = np.argsort(self._cols[name], kind="stable")
        return self.take(order)

    def equals(self, other: "Table") -> bool:
        if self.column_names != other.column_names or self.num_rows != other.num_rows:
            return False
        return all(np.array_equal(self._cols[n], other._cols[n]) for n in self._cols)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Table({self.num_rows} rows, cols={list(self._cols)})"


class ChunkedTable:
    """A logical dataframe made of physical fragments, shared zero-copy.

    This is the differential scan's output shape (paper Fig. 4): some chunks
    come from the cache, some from fresh object-storage reads; no chunk is
    copied on assembly. ``combine()`` materializes a contiguous Table only when
    a consumer explicitly needs one.
    """

    __slots__ = ("chunks", "_col_memo")

    def __init__(self, chunks: Iterable[Table]):
        # Keep zero-row chunks that still carry a schema (column names +
        # dtypes) so empty results don't degenerate into a column-less
        # Table({}); drop only truly schema-less tables.
        chunks = [c for c in chunks if c.column_names]
        names = None
        for c in chunks:
            if names is None:
                names = c.column_names
            elif c.column_names != names:
                raise ValueError(
                    f"chunk schema mismatch: {c.column_names} vs {names}"
                )
        non_empty = [c for c in chunks if c.num_rows > 0]
        # retain one schema-bearing empty chunk only when ALL are empty
        self.chunks: List[Table] = non_empty if non_empty else chunks[:1]
        # per-column concatenation memo, keyed by chunk identity (callers
        # may replace ``self.chunks``); see ``column()``
        self._col_memo: Dict[str, Tuple[tuple, np.ndarray]] = {}

    @property
    def num_rows(self) -> int:
        return sum(c.num_rows for c in self.chunks)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    @property
    def column_names(self) -> Tuple[str, ...]:
        return self.chunks[0].column_names if self.chunks else ()

    def select(self, names: Sequence[str]) -> "ChunkedTable":
        return ChunkedTable([c.select(names) for c in self.chunks])

    def combine(self) -> Table:
        """Materialize (the UNION in the paper's rewritten scan)."""
        if len(self.chunks) == 1:
            return self.chunks[0]
        if not self.chunks:
            return Table({})
        names = self.chunks[0].column_names
        return Table(
            {n: np.concatenate([c.column(n) for c in self.chunks]) for n in names}
        )

    def column(self, name: str) -> np.ndarray:
        """One logical column — concatenates ONLY the requested column's
        chunks (``combine()`` would materialize every column to read one).

        Single-chunk tables return the chunk's column itself (a zero-copy,
        read-only view); multi-chunk concatenations are memoized per column
        so repeated reads (jax conversion, windowing, materialization) pay
        the copy once.  The memo is invalidated whenever chunk identity
        changes, and memoized arrays are frozen read-only — they are shared
        across callers, like every other array a Table hands out."""
        if len(self.chunks) == 1:
            return self.chunks[0].column(name)
        if not self.chunks:
            return Table({}).column(name)  # KeyError, like combine() would
        token = tuple(id(c) for c in self.chunks)
        hit = self._col_memo.get(name)
        if hit is not None and hit[0] == token:
            return hit[1]
        arr = np.concatenate([c.column(name) for c in self.chunks])
        arr.flags.writeable = False
        self._col_memo[name] = (token, arr)
        return arr

    def sort_by(self, name: str) -> Table:
        return self.combine().sort_by(name)

    def __repr__(self) -> str:  # pragma: no cover
        return f"ChunkedTable({len(self.chunks)} chunks, {self.num_rows} rows)"


def concat_tables(tables: Sequence[Table]) -> Table:
    return ChunkedTable(tables).combine()


# ---------------------------------------------------------------------------
# IPC: length-prefixed header JSON + raw aligned column buffers.  The reader
# memory-maps buffers, so "moving" a table into a consumer is O(1) — this is
# the Arrow-IPC row of paper Table I.
# ---------------------------------------------------------------------------

def write_ipc(table: Table, dest) -> int:
    """Serialize ``table`` to ``dest`` (a path or a writable binary file
    object); returns total bytes written.

    Column buffers are handed to the file layer as ``memoryview``s over the
    arrays themselves — serialization never holds a second copy of a column
    (the old ``tobytes()`` + pad-concatenation path transiently doubled the
    table's footprint, which matters when spilling a large cache element)."""
    cols = []
    offset = 0
    arrs: List[Tuple[np.ndarray, int]] = []
    for name in table.column_names:
        arr = table.column(name)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        pad = (-arr.nbytes) % 64  # 64-byte alignment like Arrow
        cols.append(
            {
                "name": name,
                "dtype": arr.dtype.str,
                "rows": int(arr.shape[0]),
                "offset": offset,
                "nbytes": int(arr.nbytes),
            }
        )
        arrs.append((arr, pad))
        offset += arr.nbytes + pad
    header = json.dumps({"columns": cols}).encode()
    head_pad = (-(len(_MAGIC) + 8 + len(header))) % 64

    def _write(f) -> None:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(b"\0" * head_pad)
        for arr, pad in arrs:
            f.write(memoryview(arr).cast("B"))  # zero-copy buffer handoff
            if pad:
                f.write(b"\0" * pad)

    if hasattr(dest, "write"):
        _write(dest)
    else:
        with open(dest, "wb") as f:
            _write(f)
    return len(_MAGIC) + 8 + len(header) + head_pad + offset


def read_ipc(path: str, mmap: bool = True) -> Table:
    """Deserialize; with ``mmap=True`` column buffers are memory-mapped
    (zero-copy until touched)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"bad IPC magic in {path}")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        body_start = f.tell()
        body_start += (-body_start) % 64
    if mmap:
        buf = np.memmap(path, dtype=np.uint8, mode="r")
    else:
        with open(path, "rb") as f:
            buf = np.frombuffer(f.read(), dtype=np.uint8)
    cols: Dict[str, np.ndarray] = {}
    for c in header["columns"]:
        start = body_start + c["offset"]
        raw = buf[start : start + c["nbytes"]]
        cols[c["name"]] = raw.view(np.dtype(c["dtype"]))[: c["rows"]]
    return Table(cols)


def table_size_bytes(table: Table, columns: Optional[Sequence[str]] = None) -> int:
    names = columns if columns is not None else table.column_names
    return sum(table.column(n).nbytes for n in names)
