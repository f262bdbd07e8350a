"""The spill tier: cache elements parked as IPC files in the object store.

The paper's cache "works transparently across programming languages, schemas
and time windows" precisely because its elements are columnar *artifacts* in
object storage, not process memory.  :class:`SpillTier` gives the in-memory
:class:`~repro_torch.core.cache.DifferentialStore` that second tier:

- **demotion** streams an element's payload through ``write_ipc`` into the
  object store (no second in-memory copy of the buffers) and records the
  element's full identity — signature, window, pins, columns, owner — in a
  JSON *sidecar manifest*;
- **promotion** memory-maps the payload back (``read_ipc(mmap=True)``), so a
  spilled window re-enters the RAM tier zero-copy until touched; only the
  IPC header is read eagerly, and those bytes go through ``get_range`` so
  the store's ledger stays exact;
- **restart warm-up**: a fresh store pointed at a populated spill root
  rebuilds its element index from the manifests alone (payloads stay on
  disk, demoted) — a restarted service starts warm instead of paying the
  full cold fill.

Spill objects are write-once (one immutable IPC file + one manifest per
element) and are garbage-collected when their element is merged away,
invalidated, or liveness-evicted.  An element, once spilled, never changes
(merges create *new* elements), so re-demoting a promoted element is free:
the existing spill copy is still authoritative and demotion just drops the
RAM reference.
"""

from __future__ import annotations

import json
import struct
import uuid
import zlib
from typing import List, Optional

from repro_torch.core.cache import CacheElement, FragmentPin, next_elem_id
from repro_torch.core.columnar import Table, read_ipc, write_ipc
from repro_torch.core.intervals import Interval, IntervalSet
from repro_torch.lake.s3sim import ObjectStore
from repro_torch.obs.metrics import MetricAttr, Metrics
from repro_torch.obs.trace import Tracer, get_tracer

__all__ = ["SpillCorruption", "SpillEntry", "SpillTier"]


class SpillCorruption(RuntimeError):
    """A spilled payload failed integrity verification (missing, truncated,
    or checksum mismatch).  Raised *instead of* returning bytes: the cache
    quarantines the element and recomputes the window — corrupt data is
    never served."""


class _CRC32Writer:
    """File-object shim that accumulates a crc32 of everything written, so
    the spill checksum costs one streaming pass — no second buffer copy."""

    __slots__ = ("_f", "crc")

    def __init__(self, f):
        self._f = f
        self.crc = 0

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc)
        return self._f.write(b)

    def __getattr__(self, name):
        return getattr(self._f, name)


class SpillEntry:
    """One spilled element: where its payload and manifest live.

    ``checksum``/``stored_nbytes`` carry the end-to-end integrity facts
    (crc32 + on-store size of the IPC file); ``None`` on entries restored
    from pre-checksum manifests, which load unverified (back-compat)."""

    __slots__ = ("data_key", "manifest_key", "nbytes", "checksum", "stored_nbytes")

    def __init__(
        self,
        data_key: str,
        manifest_key: str,
        nbytes: int,
        checksum: Optional[int] = None,
        stored_nbytes: Optional[int] = None,
    ):
        self.data_key = data_key
        self.manifest_key = manifest_key
        self.nbytes = nbytes  # payload bytes as they were in RAM
        self.checksum = checksum
        self.stored_nbytes = stored_nbytes

    def __repr__(self) -> str:  # pragma: no cover - debug sugar
        return f"SpillEntry({self.data_key}, {self.nbytes}B)"


class SpillTier:
    """IPC-file spill tier behind an :class:`ObjectStore`.

    ``prefix`` namespaces this tier's keys inside the store (a service runs
    one tier for the scan cache and one for the model store over the same
    store, so restart warm-up and byte attribution ride the same root).
    ``mmap=False`` forces eager promotion reads (useful in tests)."""

    # observability (surfaced through the owning store's stats()); the
    # values live in a Metrics registry — the owning store adopts the tier
    # into its own registry so one scrape covers both tiers
    spills = MetricAttr("spill_writes")
    promotions = MetricAttr("spill_promotions")
    device_promotions = MetricAttr("spill_device_promotions")
    bytes_spilled = MetricAttr("spill_bytes_written")
    bytes_promoted = MetricAttr("spill_bytes_promoted")
    bytes_mmap = MetricAttr("spill_bytes_mmap")
    # integrity ledger: payloads that failed verification and were GC'd
    # (quarantined), and the raw count of corruption events detected —
    # the chaos gate asserts detected ≥ 1 with ZERO corrupt bytes served
    quarantined = MetricAttr("spill_quarantined")
    corruption = MetricAttr("corruption_detected")
    # payloads no surviving manifest references (e.g. the manifest upload
    # itself was torn): swept at restore so they cannot accrete forever
    orphans = MetricAttr("spill_orphans_deleted")

    def __init__(
        self,
        store: ObjectStore,
        prefix: str = "_spill",
        mmap: bool = True,
        metrics: "Metrics" = None,
        tracer: "Tracer" = None,
        restore_verify: str = "size",
    ):
        assert restore_verify in ("off", "size", "full")
        self.store = store
        self.prefix = prefix.rstrip("/")
        self.mmap = mmap
        # restart warm-up verification depth: "size" (default) catches torn
        # and missing payloads in O(manifests); "full" re-checksums every
        # payload (one read pass per spilled element); "off" trusts disk —
        # promotion still verifies the crc either way.
        self.restore_verify = restore_verify
        self._metrics = metrics
        self._tracer = tracer
        self.metrics_labels: dict = {}

    @property
    def metrics(self) -> Metrics:
        if self._metrics is None:
            self._metrics = Metrics()
        return self._metrics

    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    # -- identity ------------------------------------------------------------
    @staticmethod
    def spillable(elem: CacheElement) -> bool:
        """Only elements whose signature survives a JSON round-trip can be
        re-indexed after a restart; every signature the system produces is a
        string (table names for scans, hex digests for model nodes)."""
        return isinstance(elem.signature, str)

    # -- demote --------------------------------------------------------------
    def spill(self, elem: CacheElement) -> SpillEntry:
        """Write ``elem``'s payload + manifest; returns the entry.  The
        caller (the store, under its lock) drops the RAM payload after."""
        assert elem.data is not None, "cannot spill a demoted element"
        eid = uuid.uuid4().hex[:16]
        data_key = f"{self.prefix}/data/{eid}.ripc"
        manifest_key = f"{self.prefix}/manifest/{eid}.json"
        with self.tracer.span("spill.write", bytes=int(elem.data.nbytes)):
            with self.store.put_stream(data_key) as f:
                w = _CRC32Writer(f)
                stored = write_ipc(elem.data, w)
                checksum = w.crc
        manifest = {
            "signature": elem.signature,
            "table": elem.table,
            "sort_key": elem.sort_key,
            "columns": list(elem.columns),
            "window": [[iv.lo, iv.hi] for iv in elem.window],
            # labeled pins (multi-input elements) carry a 4th entry; the
            # 3-element form stays byte-identical to old manifests
            "pins": [
                [p.fragment_id, p.key_min, p.key_max]
                if p.table is None
                else [p.fragment_id, p.key_min, p.key_max, p.table]
                for p in elem.pins
            ],
            "owner": elem.owner,
            "nbytes": int(elem.data.nbytes),
            "data_key": data_key,
            # end-to-end integrity: crc32 + size of the IPC file as written;
            # load()/restore() refuse payloads that no longer match
            "checksum": int(checksum),
            "stored_nbytes": int(stored),
        }
        try:
            self.store.put(manifest_key, json.dumps(manifest).encode())
        except BaseException:
            # no manifest -> no restore/drop path would ever reclaim the
            # data object; don't leave the orphan behind
            try:
                self.store.delete(data_key)
            except OSError:  # pragma: no cover - best-effort cleanup
                pass
            raise
        self.spills += 1
        self.bytes_spilled += int(elem.data.nbytes)
        return SpillEntry(
            data_key,
            manifest_key,
            int(elem.data.nbytes),
            checksum=int(checksum),
            stored_nbytes=int(stored),
        )

    # -- integrity -----------------------------------------------------------
    def verify(self, entry: SpillEntry, full: bool = True) -> None:
        """Check a spilled payload against its recorded size and (``full``)
        crc32; raises :class:`SpillCorruption` — and counts the detection —
        on any mismatch.  Entries from pre-checksum manifests pass (there is
        nothing to verify against)."""
        try:
            path = self.store.local_path(entry.data_key)
        except FileNotFoundError:
            self.corruption += 1
            raise SpillCorruption(f"spill payload missing: {entry.data_key}")
        if entry.stored_nbytes is not None:
            import os

            actual = os.path.getsize(path)
            if actual != entry.stored_nbytes:
                self.corruption += 1
                raise SpillCorruption(
                    f"spill payload truncated: {entry.data_key} "
                    f"({actual}B on store, {entry.stored_nbytes}B written)"
                )
        if full and entry.checksum is not None:
            crc = 0
            with open(path, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
            if crc != entry.checksum:
                self.corruption += 1
                raise SpillCorruption(
                    f"spill payload checksum mismatch: {entry.data_key}"
                )

    def quarantine(self, entry: SpillEntry) -> None:
        """GC a payload that failed verification and count it.  The element
        it backed is the caller's to drop — the window recomputes as a miss
        instead of serving the bad bytes."""
        self.quarantined += 1
        self.drop(entry)

    # -- promote -------------------------------------------------------------
    def load(self, entry: SpillEntry) -> Table:
        """Bring a spilled payload back: the IPC header is read eagerly
        (through ``get_range``, so it lands on the ledger) and the column
        buffers are memory-mapped — zero-copy until touched.  The mapped
        payload bytes land on the ledger's ``bytes_mmap`` counter so per-run
        byte attribution is complete.  The payload is verified (size + crc)
        *before* any byte is parsed — a corrupt or torn file raises
        :class:`SpillCorruption` rather than ever reaching a consumer."""
        with self.tracer.span("spill.promote", key=entry.data_key) as sp:
            self.verify(entry)
            head = self.store.get_range(entry.data_key, 0, 16)
            (hlen,) = struct.unpack("<Q", head[8:16])
            # the head travelled over the (faultable) GET path *after* the
            # at-rest verify: a transport-corrupted header must not steer
            # the parse — magic + a sane header length or it's corruption
            if head[:8] != b"RIPC0001" or (
                entry.stored_nbytes is not None
                and 16 + hlen > entry.stored_nbytes
            ):
                self.corruption += 1
                raise SpillCorruption(
                    f"spill payload header corrupt: {entry.data_key}"
                )
            self.store.get_range(entry.data_key, 16, hlen)
            tbl = read_ipc(self.store.local_path(entry.data_key), mmap=self.mmap)
            body = max(0, self.store.size(entry.data_key) - 16 - int(hlen))
            self.store.record_mmap(body)
            self.bytes_mmap += body
            self.promotions += 1
            self.bytes_promoted += tbl.nbytes
            sp.attrs["bytes"] = tbl.nbytes
        return tbl

    def load_to_device(self, entry: SpillEntry, elem: CacheElement, device) -> Table:
        """Promote straight to the device tier: one pass over the mmap'd
        column buffers uploads them (H2D) while the returned Table keeps the
        usual zero-copy mmap views for the RAM tier.  With the plan's
        consumer being a jax node, this is the single host-memory touch the
        spilled payload ever pays — the serving path then reads the device
        copy.  Unsupported dtypes simply stay host-only (``pin_table`` skips
        them)."""
        tbl = self.load(entry)
        with self.tracer.span("spill.h2d", elem=elem.elem_id, bytes=tbl.nbytes):
            device.pin_table(elem.elem_id, tbl)
        self.device_promotions += 1
        return tbl

    # -- GC ------------------------------------------------------------------
    def drop(self, entry: SpillEntry) -> None:
        """Delete a spilled element's objects (merge-away / invalidation /
        liveness eviction).  Readers holding mmap views of the payload keep
        them — the unlinked file's pages survive until the views die."""
        for key in (entry.data_key, entry.manifest_key):
            if not key:  # quarantined manifests may never have named a payload
                continue
            try:
                self.store.delete(key)
            except FileNotFoundError:  # pragma: no cover - already gone
                pass

    # -- restart warm-up -----------------------------------------------------
    def restore(self) -> List[CacheElement]:
        """Rebuild demoted elements from every manifest under this tier's
        prefix.  Manifest bytes are read through the store API (accounted);
        payloads stay spilled until a plan promotes them.

        A crash can leave this prefix in any state — manifests whose payload
        is missing, truncated (``restore_verify="size"``), bit-rotted
        (``"full"``), or whose JSON never finished uploading are *skipped and
        GC'd* (``spill_quarantined``), never trusted: a poisoned spill root
        costs cache warmth, not correctness and not a crashed restart."""
        out: List[CacheElement] = []
        for key in self.store.list(f"{self.prefix}/manifest/"):
            entry = None
            try:
                m = json.loads(self.store.get(key))
                entry = SpillEntry(
                    m["data_key"],
                    key,
                    int(m["nbytes"]),
                    checksum=m.get("checksum"),
                    stored_nbytes=m.get("stored_nbytes"),
                )
                elem = CacheElement(
                    elem_id=next_elem_id(),
                    table=m["table"],
                    sort_key=m["sort_key"],
                    columns=tuple(m["columns"]),
                    window=IntervalSet(
                        [Interval(int(lo), int(hi)) for lo, hi in m["window"]]
                    ),
                    pins=tuple(
                        FragmentPin(
                            p[0],
                            int(p[1]),
                            int(p[2]),
                            p[3] if len(p) > 3 else None,
                        )
                        for p in m["pins"]
                    ),
                    data=None,
                    signature=m["signature"],
                    owner=m["owner"],
                    spill=entry,
                )
                if self.restore_verify != "off":
                    self.verify(entry, full=self.restore_verify == "full")
            except SpillCorruption:
                self.quarantine(entry)
                continue
            except (KeyError, TypeError, ValueError):
                # unparseable or structurally-wrong manifest (e.g. a torn
                # manifest upload): corrupt metadata, same discipline
                self.corruption += 1
                self.quarantine(entry or SpillEntry("", key, 0))
                continue
            out.append(elem)
        # orphan sweep: a torn manifest upload leaves a payload no manifest
        # names (the data_key is unrecoverable from the broken JSON) — GC it
        # here or it leaks on every crashed restart
        referenced = {e.spill.data_key for e in out}
        for key in self.store.list(f"{self.prefix}/data/"):
            if key not in referenced:
                self.orphans += 1
                try:
                    self.store.delete(key)
                except FileNotFoundError:  # pragma: no cover - racing GC
                    pass
        return out

    @property
    def nbytes(self) -> int:
        """Payload bytes currently parked in this tier (manifest-recorded
        sizes; cheap enough to recompute from the store's size index)."""
        return sum(
            self.store.size(k) for k in self.store.list(f"{self.prefix}/data/")
        )
