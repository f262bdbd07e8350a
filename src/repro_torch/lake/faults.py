"""Deterministic fault injection + retry policy at the object-store boundary.

Production object stores fail: requests time out, tail latencies spike,
uploads tear mid-flight, and (rarely) bits rot at rest.  The paper's cache
only earns its keep if a warm restart over object storage can be *trusted*
under exactly those conditions, so this module provides the chaos half of
that argument:

- :class:`FaultPlan` — a seeded, op-count-keyed schedule of faults.  Every
  decision is a pure function of ``(seed, op-type, op-index)``, so a chaos
  run is exactly reproducible: same seed + same workload ⇒ same faults at
  the same operations, every time.
- :class:`FaultyObjectStore` — an :class:`~repro_torch.lake.s3sim.ObjectStore`
  whose raw I/O primitives consult the plan: transient errors
  (:class:`TransientStoreError`), latency spikes (simulated seconds only),
  torn/truncated puts (the object publishes short — caught downstream by
  checksums), and bit-flip corruption on reads.
- :class:`RetryPolicy` — bounded attempts with exponential backoff +
  deterministic jitter.  The clock is injectable and SimClock-compatible
  (``advance(dt)``), so tests retry "for seconds" in microseconds.
- :class:`InjectedCrash` — a non-retryable fault that models the *process*
  dying mid-operation; chaos tests raise it at a chosen put, abandon the
  wounded store, and restart fresh objects over the same root.

Faults are injected *below* the retry loop, so every retry draws a fresh
fault decision; request/byte accounting stays at the logical-op level
(failed attempts land on the ``store_retries``/``store_giveups`` counters,
not the byte ledger, keeping fault-free runs bitwise-identical).
"""

from __future__ import annotations

import threading
import zlib
from typing import Iterable, Optional

from repro_torch.lake.s3sim import LatencyModel, ObjectStore, TransientStoreError

__all__ = [
    "TransientStoreError",
    "InjectedCrash",
    "FaultDecision",
    "FaultPlan",
    "RetryPolicy",
    "FaultyObjectStore",
]


class InjectedCrash(RuntimeError):
    """The simulated process death: NOT retryable (``retryable`` is absent),
    so it escapes the store's retry loop and unwinds the whole run — the test
    then plays the restart."""


class FaultDecision:
    """What the plan injects at one physical operation."""

    __slots__ = ("index", "transient", "latency_s", "torn", "corrupt", "crash")

    NONE: "FaultDecision"

    def __init__(
        self,
        index: int = -1,
        transient: bool = False,
        latency_s: float = 0.0,
        torn: bool = False,
        corrupt: bool = False,
        crash: bool = False,
    ):
        self.index = index
        self.transient = transient
        self.latency_s = latency_s
        self.torn = torn
        self.corrupt = corrupt
        self.crash = crash


FaultDecision.NONE = FaultDecision()


def _unit(seed: int, op: str, index: int, salt: str) -> float:
    """Deterministic uniform draw in [0, 1) from the fault coordinates."""
    h = zlib.crc32(f"{seed}|{op}|{index}|{salt}".encode())
    return h / 2**32


class FaultPlan:
    """A seeded schedule of object-store faults.

    Rates are per *physical attempt* keyed by a per-op-type counter, so a
    retried operation draws fresh coordinates (with rate ``p`` the retry
    succeeds with probability ``1-p`` — chaos converges, it does not wedge).
    ``torn_puts`` / ``corrupt_reads`` / ``crash_puts`` name exact op indices
    (0-based, counted over operations that pass ``key_prefix``) for the
    surgical faults a test wants at a known place.

    ``key_prefix`` restricts the whole plan to matching keys (e.g.
    ``"_spill/"`` to torture only the spill tier); non-matching operations
    neither fault nor advance the counters, so indices stay stable when the
    surrounding workload changes.
    """

    def __init__(
        self,
        seed: int = 0,
        transient_rate: float = 0.0,
        latency_spike_rate: float = 0.0,
        latency_spike_s: float = 0.25,
        torn_puts: Iterable[int] = (),
        corrupt_reads: Iterable[int] = (),
        corrupt_puts: Iterable[int] = (),
        crash_puts: Iterable[int] = (),
        key_prefix: str = "",
    ):
        self.seed = int(seed)
        self.transient_rate = float(transient_rate)
        self.latency_spike_rate = float(latency_spike_rate)
        self.latency_spike_s = float(latency_spike_s)
        self.torn_puts = frozenset(int(i) for i in torn_puts)
        self.corrupt_reads = frozenset(int(i) for i in corrupt_reads)
        # at-rest corruption: the object publishes with one bit flipped
        # (disk rot / bad upload the transport checksum missed)
        self.corrupt_puts = frozenset(int(i) for i in corrupt_puts)
        self.crash_puts = frozenset(int(i) for i in crash_puts)
        self.key_prefix = key_prefix
        self._lock = threading.Lock()
        self._counts = {"get": 0, "put": 0}
        # injected-fault ledger: tests assert the chaos actually happened
        self.transients_injected = 0
        self.spikes_injected = 0
        self.torn_injected = 0
        self.corruptions_injected = 0
        self.crashes_injected = 0

    def reset_counters(self) -> None:
        with self._lock:
            self._counts = {"get": 0, "put": 0}

    def decide(self, op: str, key: str) -> FaultDecision:
        if self.key_prefix and not key.startswith(self.key_prefix):
            return FaultDecision.NONE
        # inert fast path: with nothing scheduled there is no reason to pay
        # the lock + hash per op (op counters only matter to the surgical
        # index sets, which are empty here — note they start counting from
        # the first op after a plan is made non-inert by mutation)
        if not (
            self.transient_rate
            or self.latency_spike_rate
            or self.torn_puts
            or self.corrupt_reads
            or self.corrupt_puts
            or self.crash_puts
        ):
            return FaultDecision.NONE
        with self._lock:
            idx = self._counts.get(op, 0)
            self._counts[op] = idx + 1
        d = FaultDecision(index=idx)
        if op == "put" and idx in self.crash_puts:
            d.crash = True
            with self._lock:
                self.crashes_injected += 1
            return d  # the process "dies" here; nothing else matters
        if _unit(self.seed, op, idx, "transient") < self.transient_rate:
            d.transient = True
            with self._lock:
                self.transients_injected += 1
            return d  # the op never happened; no spike/tear on top
        if _unit(self.seed, op, idx, "latency") < self.latency_spike_rate:
            d.latency_s = self.latency_spike_s
            with self._lock:
                self.spikes_injected += 1
        if op == "put" and idx in self.torn_puts:
            d.torn = True
            with self._lock:
                self.torn_injected += 1
        if (op == "get" and idx in self.corrupt_reads) or (
            op == "put" and idx in self.corrupt_puts
        ):
            d.corrupt = True
            with self._lock:
                self.corruptions_injected += 1
        return d

    def flip_bit(self, data: bytes) -> bytes:
        """Deterministically flip one bit somewhere in ``data``."""
        if not data:
            return data
        pos = zlib.crc32(f"{self.seed}|flip|{len(data)}".encode()) % len(data)
        out = bytearray(data)
        out[pos] ^= 0x40
        return bytes(out)


class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``clock`` is anything exposing either ``advance(dt)`` (a
    :class:`~repro_torch.dist.fault.SimClock` — sleeps become instant clock
    advances) or nothing special (``None`` ⇒ real ``time.sleep``).  Jitter
    is drawn deterministically from the attempt number so chaos runs stay
    exactly reproducible.
    """

    def __init__(
        self,
        max_attempts: int = 4,
        base_delay_s: float = 0.01,
        multiplier: float = 2.0,
        max_delay_s: float = 1.0,
        jitter: float = 0.25,
        clock=None,
        seed: int = 0,
    ):
        assert max_attempts >= 1
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.multiplier = float(multiplier)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.clock = clock
        self.seed = int(seed)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1), self.max_delay_s)
        j = _unit(self.seed, "retry", attempt, "jitter")  # [0, 1)
        return d * (1.0 + self.jitter * (2.0 * j - 1.0))

    def sleep(self, seconds: float) -> None:
        adv = getattr(self.clock, "advance", None)
        if adv is not None:
            adv(seconds)
            return
        import time

        time.sleep(seconds)


class FaultyObjectStore(ObjectStore):
    """An object store whose raw I/O consults a :class:`FaultPlan`.

    The fault sits *inside* the per-attempt primitive, below the retry loop
    in :class:`ObjectStore`: a transient error consumes an attempt and a
    ledger entry exactly like a real failed request; a latency spike lands
    on ``simulated_seconds``; a torn put publishes a truncated object (the
    integrity layer, not the store, must catch it); a corrupt read hands
    back bit-flipped bytes.
    """

    def __init__(
        self,
        root: str,
        plan: FaultPlan,
        latency: Optional[LatencyModel] = None,
        retry: Optional[RetryPolicy] = None,
    ):
        super().__init__(
            root,
            latency=latency,
            retry=retry if retry is not None else RetryPolicy(),
        )
        self.plan = plan

    # -- faulted raw primitives ---------------------------------------------
    def _read_range_raw(self, key: str, start: int, length: int) -> bytes:
        d = self.plan.decide("get", key)
        if d.crash:
            raise InjectedCrash(f"injected crash reading {key!r}")
        if d.transient:
            raise TransientStoreError(f"injected transient GET failure on {key!r}")
        if d.latency_s:
            self._record(secs=d.latency_s)
        data = super()._read_range_raw(key, start, length)
        if d.corrupt:
            data = self.plan.flip_bit(data)
        return data

    def _put_raw(self, key: str, path: str, data: bytes) -> int:
        d = self.plan.decide("put", key)
        if d.crash:
            raise InjectedCrash(f"injected crash writing {key!r}")
        if d.transient:
            raise TransientStoreError(f"injected transient PUT failure on {key!r}")
        if d.latency_s:
            self._record(secs=d.latency_s)
        if d.torn and len(data) > 1:
            data = data[: max(1, len(data) // 2)]  # publishes short
        if d.corrupt:
            data = self.plan.flip_bit(data)  # publishes rotted
        return super()._put_raw(key, path, data)

    def _publish_raw(self, key: str, tmp: str, path: str, size: int) -> int:
        d = self.plan.decide("put", key)
        if d.crash:
            raise InjectedCrash(f"injected crash publishing {key!r}")
        if d.transient:
            raise TransientStoreError(f"injected transient publish failure on {key!r}")
        if d.latency_s:
            self._record(secs=d.latency_s)
        if d.torn and size > 1:
            size = max(1, size // 2)
            with open(tmp, "r+b") as f:
                f.truncate(size)  # the upload tore mid-flight
        if d.corrupt and size > 0:
            pos = zlib.crc32(f"{self.plan.seed}|flip|{size}".encode()) % size
            with open(tmp, "r+b") as f:
                f.seek(pos)
                b = f.read(1)
                f.seek(pos)
                f.write(bytes([b[0] ^ 0x40]))  # publishes rotted
        return super()._publish_raw(key, tmp, path, size)
