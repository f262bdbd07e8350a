"""Simulated object storage with range-byte reads and exact byte accounting.

The paper's Table II metric is *GB processed* (bytes read from object
storage); its Table I metric is the *latency* of moving bytes into a user
function.  This module provides both: an on-disk key/value store whose
``get_range`` is the only way to read data (mirroring S3 range-byte GETs),
a :class:`StoreStats` ledger counting requests and bytes, and a
:class:`LatencyModel` that converts the access pattern into simulated
seconds (first-byte latency + bandwidth), calibrated to the paper's
c5.9xlarge S3 numbers.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

__all__ = ["StoreStats", "LatencyModel", "ObjectStore", "TransientStoreError"]


class TransientStoreError(IOError):
    """A request-scoped store failure (timeout, 500, throttle) that a retry
    is expected to cure.  ``retryable`` is the duck-typed marker the store's
    retry loop keys on, so injection layers can raise their own exception
    types without an import cycle."""

    retryable = True


@dataclass
class StoreStats:
    """Cumulative ledger of object-store traffic."""

    get_requests: int = 0
    put_requests: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    simulated_seconds: float = 0.0
    # bytes promoted via local_path() + mmap (zero-copy reads outside the
    # GET path); kept separate from bytes_read so API traffic stays exact
    bytes_mmap: int = 0

    def snapshot(self) -> "StoreStats":
        return StoreStats(
            self.get_requests,
            self.put_requests,
            self.bytes_read,
            self.bytes_written,
            self.simulated_seconds,
            self.bytes_mmap,
        )

    def delta(self, since: "StoreStats") -> "StoreStats":
        return StoreStats(
            self.get_requests - since.get_requests,
            self.put_requests - since.put_requests,
            self.bytes_read - since.bytes_read,
            self.bytes_written - since.bytes_written,
            self.simulated_seconds - since.simulated_seconds,
            self.bytes_mmap - since.bytes_mmap,
        )

    def reset(self) -> None:
        self.get_requests = 0
        self.put_requests = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.simulated_seconds = 0.0
        self.bytes_mmap = 0


@dataclass(frozen=True)
class LatencyModel:
    """S3-ish cost model: ``seconds = first_byte + nbytes / bandwidth``.

    Defaults approximate the paper's environment: ~30 ms first-byte latency
    and ~5 GB/s effective aggregate throughput (16 parallel streams on a
    c5.9xlarge — Table I reads 6 GB of Arrow from Parquet-in-S3 in 1.26 s,
    dominated by decode + transfer).
    """

    first_byte_s: float = 0.030
    bandwidth_bytes_per_s: float = 5.0e9

    def seconds(self, nbytes: int, requests: int = 1) -> float:
        return requests * self.first_byte_s + nbytes / self.bandwidth_bytes_per_s


class ObjectStore:
    """A flat key → immutable-blob store rooted at a directory.

    Keys are slash-separated paths. Blobs are write-once (matching S3 +
    Iceberg semantics: data files are never mutated, only added/dropped by
    metadata commits).
    """

    def __init__(
        self,
        root: str,
        latency: Optional[LatencyModel] = None,
        retry=None,
    ):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.stats = StoreStats()
        self.latency = latency or LatencyModel()
        # retry discipline around the raw I/O primitives: None (default)
        # means fail fast — the raw ops never raise TransientStoreError, so
        # plain stores pay zero overhead.  A RetryPolicy (repro_torch.lake.faults)
        # bounds attempts with backoff; `metrics`/`tracer` are optional
        # late-wired observability sinks for retry/giveup accounting.
        self.retry = retry
        self.metrics = None
        self.tracer = None
        self._lock = threading.Lock()
        self._sizes: Dict[str, int] = {}
        # per-thread ledger: with many concurrent runs sharing one store
        # (repro_torch.service), the global ledger interleaves traffic from all of
        # them; a run measures ITS bytes against the calling thread's ledger
        self._tls = threading.local()

    def thread_stats(self) -> StoreStats:
        """The calling thread's private ledger (one run executes on one
        thread, so per-run deltas against this ledger are exact even under
        concurrency; single-threaded it mirrors ``stats``)."""
        st = getattr(self._tls, "stats", None)
        if st is None:
            st = self._tls.stats = StoreStats()
        return st

    def _record(
        self, gets: int = 0, puts: int = 0, read: int = 0, written: int = 0,
        secs: float = 0.0, mmapped: int = 0,
    ) -> None:
        """Apply one I/O event to both ledgers (global under the lock, the
        thread-local one lock-free)."""
        with self._lock:
            self._tally(self.stats, gets, puts, read, written, secs, mmapped)
        self._tally(self.thread_stats(), gets, puts, read, written, secs, mmapped)

    @staticmethod
    def _tally(
        st: StoreStats, gets: int, puts: int, read: int, written: int,
        secs: float, mmapped: int = 0,
    ) -> None:
        st.get_requests += gets
        st.put_requests += puts
        st.bytes_read += read
        st.bytes_written += written
        st.simulated_seconds += secs
        st.bytes_mmap += mmapped

    def record_mmap(self, nbytes: int) -> None:
        """Account bytes a caller read through :meth:`local_path` (mmap
        promotion).  Zero-copy reads bypass the GET path, so they carry no
        request count or simulated latency — only the byte attribution."""
        self._record(mmapped=nbytes)

    # -- paths -------------------------------------------------------------
    def _path(self, key: str) -> str:
        if ".." in key or key.startswith("/"):
            raise ValueError(f"bad key {key!r}")
        return os.path.join(self.root, key)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def size(self, key: str) -> int:
        if key not in self._sizes:
            self._sizes[key] = os.path.getsize(self._path(key))
        return self._sizes[key]

    # -- retry discipline ----------------------------------------------------
    def _attempt(self, op: str, key: str, fn):
        """Run one logical operation through the retry policy.  Errors whose
        type carries ``retryable = True`` (:class:`TransientStoreError` and
        friends) are retried with backoff up to ``retry.max_attempts``; the
        loop is bypassed entirely when no policy is configured."""
        retry = self.retry
        if retry is None:
            return fn()
        attempt = 1
        while True:
            try:
                return fn()
            except Exception as e:
                if not getattr(e, "retryable", False):
                    raise
                if attempt >= retry.max_attempts:
                    self._note_retry("store_giveups", op, key)
                    raise
                self._note_retry("store_retries", op, key)
                delay = retry.delay(attempt)
                tracer = self.tracer
                if tracer is not None:
                    with tracer.span(
                        "store.retry", op=op, attempt=attempt, key=key
                    ) as sp:
                        sp.attrs["delay_s"] = round(delay, 6)
                        retry.sleep(delay)
                else:
                    retry.sleep(delay)
                attempt += 1

    def _note_retry(self, counter: str, op: str, key: str) -> None:
        m = self.metrics
        if m is not None:
            m.counter(counter, op=op).inc()

    # -- raw primitives (the per-attempt physical ops; fault layers override)
    # put/publish return the *published* object size: a torn upload lands
    # short, and the size index must answer like a HEAD on the real object
    # or integrity checks downstream would be blinded.
    def _read_range_raw(self, key: str, start: int, length: int) -> bytes:
        with open(self._path(key), "rb") as f:
            f.seek(start)
            return f.read(length)

    def _put_raw(self, key: str, path: str, data: bytes) -> int:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish
        return len(data)

    def _publish_raw(self, key: str, tmp: str, path: str, size: int) -> int:
        os.replace(tmp, path)  # atomic publish
        return size

    # -- I/O ----------------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        if os.path.exists(path):
            raise FileExistsError(f"object {key!r} is immutable")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        published = self._attempt("put", key, lambda: self._put_raw(key, path, data))
        with self._lock:
            self._sizes[key] = published
        self._record(puts=1, written=len(data))

    @contextmanager
    def put_stream(self, key: str) -> Iterator:
        """Streaming variant of :meth:`put`: yields a writable binary file
        the caller fills incrementally (e.g. ``write_ipc`` spilling a cache
        element without a second in-memory copy of its buffers).  On clean
        exit the object is atomically published and the written bytes are
        accounted; on error the partial upload is discarded.  The publish
        step (not the local streaming) is the retried physical operation —
        the tmp upload survives across attempts."""
        path = self._path(key)
        if os.path.exists(path):
            raise FileExistsError(f"object {key!r} is immutable")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                yield f
                size = f.tell()
            published = self._attempt(
                "put", key, lambda: self._publish_raw(key, tmp, path, size)
            )
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self._sizes[key] = published
        self._record(puts=1, written=size)

    def local_path(self, key: str) -> str:
        """Filesystem path of an existing object, for zero-copy (mmap)
        readers.  Bytes touched through the returned path are not GETs —
        callers account them via :meth:`record_mmap` (the spill tier reads
        the IPC header through the API, memory-maps the column payloads,
        and records the payload size as ``bytes_mmap``)."""
        path = self._path(key)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no such object {key!r}")
        return path

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """Range-byte GET — the paper's atomic physical operation."""
        data = self._attempt(
            "get", key, lambda: self._read_range_raw(key, start, length)
        )
        self._record(gets=1, read=len(data), secs=self.latency.seconds(len(data)))
        return data

    def get(self, key: str) -> bytes:
        return self.get_range(key, 0, self.size(key))

    def delete(self, key: str) -> None:
        # only used by GC of unreferenced fragments
        os.remove(self._path(key))
        self._sizes.pop(key, None)

    def list(self, prefix: str = "") -> list:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix) and not key.endswith(".tmp"):
                    out.append(key)
        return sorted(out)
