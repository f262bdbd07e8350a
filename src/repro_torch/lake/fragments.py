"""Immutable columnar fragments — the Parquet-file analogue.

A fragment is one object-store blob holding a row group sorted by the
table's sort key, laid out column-after-column so that a *projection* maps
to range-byte reads of exactly the requested columns' buffers (Parquet
column chunks).  Fragment **metadata** (row count, per-column byte extents,
sort-key min/max) lives in the catalog manifest, so planning — including
min/max pruning and byte-cost estimation — touches zero data bytes, and
reading N columns costs N range GETs.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.columnar import Table
from repro_torch.lake.s3sim import ObjectStore

__all__ = ["ColumnChunkMeta", "FragmentMeta", "write_fragment", "read_fragment_columns"]


@dataclass(frozen=True)
class ColumnChunkMeta:
    name: str
    dtype: str
    offset: int  # byte offset inside the fragment blob
    nbytes: int

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype, "offset": self.offset, "nbytes": self.nbytes}

    @staticmethod
    def from_json(d: dict) -> "ColumnChunkMeta":
        return ColumnChunkMeta(d["name"], d["dtype"], d["offset"], d["nbytes"])


@dataclass(frozen=True)
class FragmentMeta:
    """Catalog-resident description of one immutable data blob."""

    fragment_id: str
    key: str  # object-store key
    row_count: int
    sort_key: str
    key_min: int  # sort-key min (inclusive)
    key_max: int  # sort-key max (inclusive)
    columns: Tuple[ColumnChunkMeta, ...]
    total_bytes: int

    def column_meta(self, name: str) -> ColumnChunkMeta:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"fragment {self.fragment_id} has no column {name!r}")

    def columns_bytes(self, names: Sequence[str]) -> int:
        """Cost (bytes) of projecting ``names`` out of this fragment."""
        return sum(self.column_meta(n).nbytes for n in names)

    def overlaps(self, lo: int, hi: int) -> bool:
        """Does this fragment's sort-key range intersect ``[lo, hi)``?"""
        return self.key_min < hi and lo <= self.key_max

    def to_json(self) -> dict:
        return {
            "fragment_id": self.fragment_id,
            "key": self.key,
            "row_count": self.row_count,
            "sort_key": self.sort_key,
            "key_min": self.key_min,
            "key_max": self.key_max,
            "columns": [c.to_json() for c in self.columns],
            "total_bytes": self.total_bytes,
        }

    @staticmethod
    def from_json(d: dict) -> "FragmentMeta":
        return FragmentMeta(
            fragment_id=d["fragment_id"],
            key=d["key"],
            row_count=d["row_count"],
            sort_key=d["sort_key"],
            key_min=d["key_min"],
            key_max=d["key_max"],
            columns=tuple(ColumnChunkMeta.from_json(c) for c in d["columns"]),
            total_bytes=d["total_bytes"],
        )


def write_fragment(
    store: ObjectStore,
    key: str,
    fragment_id: str,
    table: Table,
    sort_key: str,
) -> FragmentMeta:
    """Serialize ``table`` (must be sorted by ``sort_key``) as one blob."""
    sk = table.column(sort_key)
    if table.num_rows == 0:
        raise ValueError("empty fragment")
    if not np.all(sk[:-1] <= sk[1:]):
        raise ValueError("fragment rows must be sorted by the sort key")
    bufs = []
    metas = []
    offset = 0
    for name in table.column_names:
        arr = np.ascontiguousarray(table.column(name))
        raw = arr.tobytes()
        pad = (-len(raw)) % 64
        metas.append(ColumnChunkMeta(name, arr.dtype.str, offset, len(raw)))
        bufs.append(raw + b"\0" * pad)
        offset += len(raw) + pad
    blob = b"".join(bufs)
    store.put(key, blob)
    return FragmentMeta(
        fragment_id=fragment_id,
        key=key,
        row_count=table.num_rows,
        sort_key=sort_key,
        key_min=int(sk[0]),
        key_max=int(sk[-1]),
        columns=tuple(metas),
        total_bytes=len(blob),
    )


def read_fragment_columns(
    store: ObjectStore,
    meta: FragmentMeta,
    names: Sequence[str],
) -> Table:
    """Range-read exactly the requested column chunks (projection pushdown).

    Every call hits object storage — cache-or-not decisions live a layer up,
    in :mod:`repro_torch.core.cache`.  Bytes read are accounted in ``store.stats``.
    """
    cols: Dict[str, np.ndarray] = {}
    for n in names:
        cm = meta.column_meta(n)
        raw = store.get_range(meta.key, cm.offset, cm.nbytes)
        cols[n] = np.frombuffer(raw, dtype=np.dtype(cm.dtype))[: meta.row_count]
    return Table(cols)
