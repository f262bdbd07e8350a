"""Iceberg-style catalog: namespaces → tables → immutable snapshot chains.

Semantics reproduced from the paper's requirements:

- **Immutable data files**: a commit never mutates a fragment, it publishes a
  new :class:`Snapshot` referencing a (possibly different) fragment set.  This
  is what makes cache invalidation "free" — cache elements pin fragment ids and
  simply stop matching when a snapshot drops those fragments.
- **Snapshot isolation / time travel**: scans name a snapshot id ("running
  today's code on last Friday's rows"); concurrent readers are never affected
  by commits.
- **Atomic commits with optimistic concurrency**: the table pointer advances by
  compare-and-swap on the expected parent snapshot; losers retry.

Metadata lives in the object store as write-once JSON blobs plus one
atomically-replaced pointer file per table (the Iceberg "version hint").

**Crash consistency.**  A materializing publish is many physical writes
(one per fragment) followed by one atomic pointer swap; a crash anywhere
before the swap leaves orphaned fragment objects, and a crash between the
swap and cleanup leaves a stale intent.  Every publish therefore journals
an *intent* — the full list of fragment keys it is about to write — to
``_catalog/_journal/`` BEFORE the first data put, and deletes it after the
commit lands.  :meth:`Catalog.recover_journal`, run at restart, resolves
each surviving intent against the table's snapshot chain: keys all
referenced ⇒ the commit landed (roll forward = drop the intent); otherwise
the commit never happened and the orphaned objects are GC'd.  Readers are
safe either way — they only follow the pointer — so the journal's job is
purely to keep a chaotic store from leaking unreachable bytes.
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.columnar import Table
from repro_torch.lake.fragments import FragmentMeta, write_fragment
from repro_torch.lake.s3sim import ObjectStore

__all__ = ["Snapshot", "TableMeta", "Catalog", "CommitConflict"]


class CommitConflict(RuntimeError):
    """Raised when an optimistic commit loses the race."""


@dataclass(frozen=True)
class Snapshot:
    snapshot_id: str
    parent_id: Optional[str]
    sequence: int
    fragments: Tuple[FragmentMeta, ...]
    operation: str  # "append" | "overwrite" | "create"

    @property
    def fragment_ids(self) -> frozenset:
        return frozenset(f.fragment_id for f in self.fragments)

    def live_fragments(self) -> Tuple[FragmentMeta, ...]:
        return self.fragments

    def to_json(self) -> dict:
        return {
            "snapshot_id": self.snapshot_id,
            "parent_id": self.parent_id,
            "sequence": self.sequence,
            "operation": self.operation,
            "fragments": [f.to_json() for f in self.fragments],
        }

    @staticmethod
    def from_json(d: dict) -> "Snapshot":
        return Snapshot(
            snapshot_id=d["snapshot_id"],
            parent_id=d["parent_id"],
            sequence=d["sequence"],
            operation=d["operation"],
            fragments=tuple(FragmentMeta.from_json(f) for f in d["fragments"]),
        )


@dataclass
class TableMeta:
    namespace: str
    name: str
    schema: Dict[str, str]  # column -> dtype str
    sort_key: str

    @property
    def full_name(self) -> str:
        return f"{self.namespace}.{self.name}"


class Catalog:
    """The control-plane metadata service."""

    def __init__(self, store: ObjectStore, rows_per_fragment: int = 1 << 16):
        self.store = store
        self.rows_per_fragment = rows_per_fragment
        self._lock = threading.Lock()
        # pointer files live OUTSIDE the write-once store (they must be
        # replaceable); everything else is immutable blobs inside it.
        self._meta_dir = os.path.join(store.root, "_catalog")
        self._journal_dir = os.path.join(self._meta_dir, "_journal")
        os.makedirs(self._journal_dir, exist_ok=True)
        # late-wired observability sink (repro_torch.obs.Metrics): journal
        # recovery counts what it rolled forward / GC'd when present
        self.metrics = None
        self._snapshots: Dict[str, Snapshot] = {}  # id -> snapshot (cache)
        self._tables: Dict[str, TableMeta] = {}

    # -- pointer management --------------------------------------------------
    def _ptr_path(self, full_name: str) -> str:
        return os.path.join(self._meta_dir, f"{full_name}.ptr.json")

    def _read_ptr(self, full_name: str) -> Optional[dict]:
        path = self._ptr_path(full_name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _write_ptr(self, full_name: str, ptr: dict) -> None:
        path = self._ptr_path(full_name)
        tmp = f"{path}.{uuid.uuid4().hex}.tmp"
        with open(tmp, "w") as f:
            json.dump(ptr, f)
        os.replace(tmp, path)  # atomic pointer swap

    # -- table lifecycle -------------------------------------------------------
    def create_table(
        self,
        namespace: str,
        name: str,
        schema: Dict[str, str],
        sort_key: str,
    ) -> TableMeta:
        if sort_key not in schema:
            raise ValueError(f"sort key {sort_key!r} not in schema")
        meta = TableMeta(namespace, name, dict(schema), sort_key)
        full = meta.full_name
        with self._lock:
            if self._read_ptr(full) is not None:
                raise FileExistsError(f"table {full} exists")
            root = Snapshot(
                snapshot_id=uuid.uuid4().hex[:16],
                parent_id=None,
                sequence=0,
                fragments=(),
                operation="create",
            )
            self._persist_snapshot(full, root)
            self._write_ptr(
                full,
                {
                    "schema": meta.schema,
                    "sort_key": sort_key,
                    "current_snapshot": root.snapshot_id,
                },
            )
            self._tables[full] = meta
        return meta

    def table(self, full_name: str) -> TableMeta:
        # filling the cache must hold the commit lock: a concurrent schema
        # swap (full republish of a materialized model) pops the entry, and
        # an unlocked check-then-act here could re-cache the pre-swap schema
        # permanently
        with self._lock:
            if full_name not in self._tables:
                ptr = self._read_ptr(full_name)
                if ptr is None:
                    raise KeyError(f"no such table {full_name}")
                ns, name = full_name.rsplit(".", 1)
                self._tables[full_name] = TableMeta(
                    ns, name, ptr["schema"], ptr["sort_key"]
                )
            return self._tables[full_name]

    def list_tables(self) -> List[str]:
        return sorted(
            fn[: -len(".ptr.json")]
            for fn in os.listdir(self._meta_dir)
            if fn.endswith(".ptr.json")
        )

    # -- snapshots ---------------------------------------------------------
    def _snap_key(self, full_name: str, snapshot_id: str) -> str:
        return f"_meta/{full_name}/snap-{snapshot_id}.json"

    def _persist_snapshot(self, full_name: str, snap: Snapshot) -> None:
        self.store.put(self._snap_key(full_name, snap.snapshot_id), json.dumps(snap.to_json()).encode())
        self._snapshots[snap.snapshot_id] = snap

    def snapshot(self, full_name: str, snapshot_id: str) -> Snapshot:
        if snapshot_id not in self._snapshots:
            raw = self.store.get(self._snap_key(full_name, snapshot_id))
            self._snapshots[snapshot_id] = Snapshot.from_json(json.loads(raw))
        return self._snapshots[snapshot_id]

    def current_snapshot(self, full_name: str) -> Snapshot:
        ptr = self._read_ptr(full_name)
        if ptr is None:
            raise KeyError(f"no such table {full_name}")
        return self.snapshot(full_name, ptr["current_snapshot"])

    def current_snapshot_id(self, full_name: str) -> str:
        """The head snapshot id from the pointer alone — no snapshot object
        is loaded, so this never touches the object store's ledger (the
        explainer uses it to detect snapshot-travel without perturbing
        per-run byte attribution)."""
        ptr = self._read_ptr(full_name)
        if ptr is None:
            raise KeyError(f"no such table {full_name}")
        return ptr["current_snapshot"]

    def pointer_state(self, full_name: str) -> Tuple[Snapshot, Dict[str, str]]:
        """One consistent pointer read: ``(current snapshot, properties)``.
        Callers needing both (the incremental materializer) must not issue
        two reads — a commit between them would pair a snapshot with another
        commit's properties."""
        with self._lock:
            ptr = self._read_ptr(full_name)
            if ptr is None:
                raise KeyError(f"no such table {full_name}")
            snap = self.snapshot(full_name, ptr["current_snapshot"])
            return snap, dict(ptr.get("properties", {}))

    # -- table properties ---------------------------------------------------
    def table_property(self, full_name: str, key: str) -> Optional[str]:
        """A string property riding on the table pointer (Iceberg table
        properties).  Properties change atomically WITH a commit (see the
        ``properties`` argument of :meth:`append`/:meth:`overwrite_range`),
        so a reader observing snapshot S observes the properties written by
        S's commit — the incremental materializer relies on this to pair a
        published signature with the fragment set it describes."""
        ptr = self._read_ptr(full_name)
        if ptr is None:
            raise KeyError(f"no such table {full_name}")
        return ptr.get("properties", {}).get(key)

    def history(self, full_name: str) -> List[Snapshot]:
        out = []
        snap: Optional[Snapshot] = self.current_snapshot(full_name)
        while snap is not None:
            out.append(snap)
            snap = self.snapshot(full_name, snap.parent_id) if snap.parent_id else None
        return list(reversed(out))

    # -- commits -----------------------------------------------------------
    def _commit(
        self,
        full_name: str,
        new_fragments: Sequence[FragmentMeta],
        dropped_ids: frozenset,
        operation: str,
        expected_parent: Optional[str],
        properties: Optional[Dict[str, str]] = None,
        schema: Optional[Dict[str, str]] = None,
    ) -> Snapshot:
        with self._lock:
            ptr = self._read_ptr(full_name)
            if ptr is None:
                raise KeyError(f"no such table {full_name}")
            cur = self.snapshot(full_name, ptr["current_snapshot"])
            if expected_parent is not None and cur.snapshot_id != expected_parent:
                raise CommitConflict(
                    f"{full_name}: expected parent {expected_parent}, found {cur.snapshot_id}"
                )
            kept = tuple(f for f in cur.fragments if f.fragment_id not in dropped_ids)
            snap = Snapshot(
                snapshot_id=uuid.uuid4().hex[:16],
                parent_id=cur.snapshot_id,
                sequence=cur.sequence + 1,
                fragments=kept + tuple(new_fragments),
                operation=operation,
            )
            self._persist_snapshot(full_name, snap)
            ptr["current_snapshot"] = snap.snapshot_id
            if properties:
                ptr.setdefault("properties", {}).update(properties)
            if schema is not None:
                # full-republish path (materialized model changed shape): the
                # new fragment set carries the new schema, swap it atomically
                ptr["schema"] = dict(schema)
                self._tables.pop(full_name, None)  # drop cached TableMeta
            self._write_ptr(full_name, ptr)
            return snap

    def _plan_fragments(
        self, full_name: str, data: Table, sort_key: str
    ) -> List[Tuple[str, str, Table]]:
        """Chunk ``data`` and assign fragment ids/keys WITHOUT writing —
        the publish journal must know every key before the first put."""
        data = data.sort_by(sort_key)
        out: List[Tuple[str, str, Table]] = []
        n = data.num_rows
        for start in range(0, n, self.rows_per_fragment):
            chunk = data.slice(start, min(start + self.rows_per_fragment, n))
            fid = uuid.uuid4().hex[:16]
            key = f"data/{full_name}/frag-{fid}.bin"
            out.append((fid, key, chunk))
        return out

    # -- publish journal (crash consistency) --------------------------------
    def _begin_publish(self, full_name: str, keys: List[str]) -> str:
        """Journal the intent to write ``keys`` — atomically published (tmp +
        replace) BEFORE any fragment put, so a crash at any later point
        leaves an intent that names every possibly-orphaned object."""
        intent_id = uuid.uuid4().hex[:16]
        path = os.path.join(self._journal_dir, f"{intent_id}.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"intent_id": intent_id, "table": full_name, "keys": keys}, f)
        os.replace(tmp, path)
        return intent_id

    def _end_publish(self, intent_id: str) -> None:
        try:
            os.remove(os.path.join(self._journal_dir, f"{intent_id}.json"))
        except FileNotFoundError:  # pragma: no cover - already recovered
            pass

    def _publish(
        self,
        full_name: str,
        planned: List[Tuple[str, str, Table]],
        dropped_ids: frozenset,
        operation: str,
        expected_parent: Optional[str],
        properties: Optional[Dict[str, str]] = None,
        schema: Optional[Dict[str, str]] = None,
        sort_key: Optional[str] = None,
    ) -> Snapshot:
        """The journaled write path every commit with data goes through:
        intent → fragment puts → commit → intent delete.  A crash (or a
        retry-exhausted store error) anywhere in the middle leaves the
        intent for :meth:`recover_journal`; a :class:`CommitConflict` is a
        *clean* in-process failure, so its freshly written fragments are
        GC'd inline rather than lingering until the next restart."""
        keys = [key for _fid, key, _chunk in planned]
        intent = self._begin_publish(full_name, keys) if keys else None
        try:
            frags = [
                write_fragment(self.store, key, fid, chunk, sort_key)
                for fid, key, chunk in planned
            ]
            snap = self._commit(
                full_name, frags, dropped_ids, operation,
                expected_parent, properties, schema,
            )
        except CommitConflict:
            for key in keys:
                if self.store.exists(key):
                    self.store.delete(key)
            if intent is not None:
                self._end_publish(intent)
            raise
        if intent is not None:
            self._end_publish(intent)
        return snap

    def _referenced_keys(self, full_name: str) -> set:
        """Every fragment key reachable from the table's snapshot chain
        (current AND historical — time-travel readers still hold the past)."""
        try:
            snaps = self.history(full_name)
        except (KeyError, FileNotFoundError):
            return set()
        return {f.key for snap in snaps for f in snap.fragments}

    def recover_journal(self) -> Dict[str, int]:
        """Resolve intents a crashed publish left behind; run at restart,
        before serving traffic.  For each intent: if every key it names is
        referenced by its table's snapshot chain, the commit landed and the
        crash hit between the pointer swap and cleanup — roll forward by
        dropping the intent.  Otherwise the commit never happened:
        delete whichever fragment objects made it to the store (orphans no
        snapshot will ever reference) along with the intent."""
        stats = {"completed": 0, "rolled_back": 0, "orphans_deleted": 0}
        if not os.path.isdir(self._journal_dir):
            return stats
        for fn in sorted(os.listdir(self._journal_dir)):
            if not fn.endswith(".json"):
                continue
            path = os.path.join(self._journal_dir, fn)
            try:
                with open(path) as f:
                    intent = json.load(f)
                table, keys = intent["table"], list(intent["keys"])
            except (ValueError, KeyError, OSError):
                # unreadable intent: intents publish atomically BEFORE any
                # data put, so a half-written one precedes all writes and
                # there is nothing to GC
                os.remove(path)
                continue
            referenced = self._referenced_keys(table)
            if keys and all(k in referenced for k in keys):
                stats["completed"] += 1
            else:
                for k in keys:
                    if k not in referenced and self.store.exists(k):
                        self.store.delete(k)
                        stats["orphans_deleted"] += 1
                stats["rolled_back"] += 1
            os.remove(path)
        m = self.metrics
        if m is not None and (stats["completed"] or stats["rolled_back"]):
            m.counter("journal_rolled_forward").inc(stats["completed"])
            m.counter("journal_rolled_back").inc(stats["rolled_back"])
            m.counter("journal_orphans_deleted").inc(stats["orphans_deleted"])
        return stats

    def append(
        self,
        full_name: str,
        data: Table,
        expected_parent: Optional[str] = None,
        properties: Optional[Dict[str, str]] = None,
    ) -> Snapshot:
        meta = self.table(full_name)
        planned = self._plan_fragments(full_name, data, meta.sort_key)
        return self._publish(
            full_name, planned, frozenset(), "append", expected_parent,
            properties, sort_key=meta.sort_key,
        )

    def overwrite_range(
        self,
        full_name: str,
        lo: int,
        hi: int,
        data: Optional[Table] = None,
        expected_parent: Optional[str] = None,
        properties: Optional[Dict[str, str]] = None,
        schema: Optional[Dict[str, str]] = None,
    ) -> Snapshot:
        """Drop every fragment overlapping ``[lo, hi)`` (rewriting the
        survivors outside the window) and optionally add new rows.

        This is the mutation path that exercises "free" cache invalidation.
        """
        return self.overwrite_ranges(
            full_name, [(lo, hi)], data, expected_parent, properties, schema
        )

    def overwrite_ranges(
        self,
        full_name: str,
        ranges: Sequence[Tuple[int, int]],
        data: Optional[Table] = None,
        expected_parent: Optional[str] = None,
        properties: Optional[Dict[str, str]] = None,
        schema: Optional[Dict[str, str]] = None,
    ) -> Snapshot:
        """:meth:`overwrite_range` over several disjoint windows in ONE
        atomic commit: drop every fragment overlapping any window, rewrite
        surviving rows outside all of them, add ``data``.  The incremental
        materializer publishes its whole diff (overwritten + deleted +
        appended windows) through one call, so readers never observe a
        torn, mid-publish table state."""
        meta = self.table(full_name)
        cur = self.current_snapshot(full_name)
        dropped = frozenset(
            f.fragment_id
            for f in cur.fragments
            if any(f.overlaps(lo, hi) for lo, hi in ranges)
        )
        planned: List[Tuple[str, str, Table]] = []
        # rewrite surviving rows of dropped fragments (outside every window)
        from repro_torch.lake.fragments import read_fragment_columns

        for f in cur.fragments:
            if f.fragment_id not in dropped:
                continue
            tbl = read_fragment_columns(self.store, f, list(meta.schema))
            keys = tbl.column(meta.sort_key)
            keep = np.ones(len(keys), dtype=bool)
            for lo, hi in ranges:
                keep &= (keys < lo) | (keys >= hi)
            if keep.any():
                planned.extend(self._plan_fragments(full_name, tbl.filter(keep), meta.sort_key))
        if data is not None and data.num_rows:
            planned.extend(self._plan_fragments(full_name, data, meta.sort_key))
        return self._publish(
            full_name, planned, dropped, "overwrite", expected_parent,
            properties, schema, sort_key=meta.sort_key,
        )
