"""Fault tolerance: failure detection → rollback → exact replay.

The control loop a preemptible-capacity deployment needs, scaled to this
container and driven entirely by an injectable clock so every scenario is
testable in simulated time:

- :class:`HeartbeatMonitor` — deadline-based failure detection.  A worker
  that misses its deadline is moved to ``dead`` and reported ONCE by
  :meth:`~HeartbeatMonitor.check`; later beats from it are ignored (a
  zombie that wakes up after the coordinator already rescheduled its shard
  must not flap the membership) until :meth:`~HeartbeatMonitor.revive`
  readmits it after a restart.
- :class:`StragglerDetector` — robust z-score over the workers' latest step
  times (median/MAD, so one outlier cannot inflate the spread it is judged
  against), with a *patience* window: a worker is flagged only after
  ``patience`` consecutive slow checks, so a single GC pause or checkpoint
  stall never triggers a restart.  Flagged once, not repeatedly.
- :class:`RestartCoordinator` — glues the two to the checkpoint manager:
  on failure, roll back to the latest checkpoint (``on_restore(step)`` —
  the caller rewinds model state AND data position, which with the
  deterministic ``batch_at(step)`` pipeline gives bit-exact replay) and
  revive the failed workers.
"""

from __future__ import annotations

import time
from statistics import median
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "SimClock",
    "HeartbeatMonitor",
    "StragglerDetector",
    "RestartCoordinator",
]


class SimClock:
    """Manually-advanced clock for deterministic FT tests."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time only moves forward")
        self._now += float(dt)

    def time(self) -> float:
        return self._now


class _WallClock:
    def time(self) -> float:
        return time.monotonic()


# ------------------------------------------------------------------ monitor
class HeartbeatMonitor:
    """Deadline-based liveness over a fixed worker set."""

    def __init__(
        self,
        workers: Iterable[str],
        deadline_s: float = 30.0,
        clock=None,
    ):
        self._clock = clock if clock is not None else _WallClock()
        self.deadline_s = float(deadline_s)
        now = self._clock.time()
        self._last: Dict[str, float] = {w: now for w in workers}
        self._dead: set = set()

    def beat(self, worker: str) -> None:
        if worker in self._dead:
            return  # zombie: already declared dead, ignore until revived
        if worker not in self._last:
            raise KeyError(f"unknown worker {worker!r}")
        self._last[worker] = self._clock.time()

    def check(self) -> List[str]:
        """Newly-dead workers (each reported exactly once)."""
        now = self._clock.time()
        newly = sorted(
            w
            for w, t in self._last.items()
            if w not in self._dead and now - t > self.deadline_s
        )
        self._dead.update(newly)
        return newly

    def revive(self, workers: Iterable[str]) -> None:
        """Readmit restarted workers with a fresh beat."""
        now = self._clock.time()
        for w in workers:
            self._dead.discard(w)
            self._last[w] = now

    @property
    def alive(self) -> List[str]:
        return [w for w in self._last if w not in self._dead]

    @property
    def dead(self) -> List[str]:
        return sorted(self._dead)


# ---------------------------------------------------------------- straggler
class StragglerDetector:
    """Flag workers persistently slower than the fleet's robust spread OR
    than their own learned baseline.

    Per :meth:`check`, each worker's *latest* step time is judged two ways:

    1. **Relative (fleet) test** — robust z-score
       ``z = (t - median) / (1.4826·MAD + small)``; median/MAD rather than
       mean/std so the straggler itself cannot inflate the spread it is
       judged against.
    2. **Self (EWMA) test** — each worker keeps an exponentially-weighted
       moving average of its own *healthy* step times; a sample over
       ``slowdown_factor ×`` that baseline is slow even when the whole fleet
       degrades in lockstep — the case the relative test is structurally
       blind to (the median moves with the slowdown, z stays ~0).
       The baseline absorbs only non-slow samples, so a sustained slowdown
       cannot launder itself into the norm.

    Either test trips a *strike*; ``patience`` consecutive strikes flag the
    worker (once).
    """

    def __init__(
        self,
        z_threshold: float = 3.0,
        patience: int = 2,
        min_relative_excess: float = 0.1,
        ewma_alpha: float = 0.3,
        slowdown_factor: float = 2.0,
    ):
        self.z_threshold = float(z_threshold)
        self.patience = int(patience)
        # a "straggler" must be at least this fraction slower than the
        # median in absolute terms: on a near-identical fleet MAD collapses
        # to ~0 and the z-score alone would flag microsecond timer noise
        self.min_relative_excess = float(min_relative_excess)
        self.ewma_alpha = float(ewma_alpha)
        self.slowdown_factor = float(slowdown_factor)
        self._latest: Dict[str, float] = {}
        self._ewma: Dict[str, float] = {}
        self._strikes: Dict[str, int] = {}
        self._flagged: set = set()

    def record(self, worker: str, step_time: float) -> None:
        self._latest[worker] = float(step_time)

    def baseline(self, worker: str) -> Optional[float]:
        """The worker's EWMA of healthy step times (None before first check)."""
        return self._ewma.get(worker)

    def check(self) -> List[str]:
        """Workers newly crossing the patience threshold, sorted."""
        if len(self._latest) < 2:
            return []  # no fleet to compare against
        times = list(self._latest.values())
        med = median(times)
        mad = median([abs(t - med) for t in times])
        # MAD→σ under normality is 1.4826·MAD; the relative floor keeps an
        # all-identical fleet (MAD = 0) from dividing by zero
        denom = 1.4826 * mad + 1e-3 * abs(med) + 1e-12
        floor = self.min_relative_excess * abs(med)
        newly: List[str] = []
        for w, t in self._latest.items():
            fleet_slow = (t - med) / denom > self.z_threshold and (t - med) > floor
            base = self._ewma.get(w)
            self_slow = base is not None and t > self.slowdown_factor * base
            if fleet_slow or self_slow:
                self._strikes[w] = self._strikes.get(w, 0) + 1
            else:
                self._strikes[w] = 0
                # only healthy samples feed the baseline (first sample seeds)
                self._ewma[w] = (
                    t
                    if base is None
                    else (1 - self.ewma_alpha) * base + self.ewma_alpha * t
                )
            if self._strikes[w] >= self.patience and w not in self._flagged:
                self._flagged.add(w)
                newly.append(w)
        return sorted(newly)

    def clear(self, worker: str) -> None:
        """Forget a worker (restarted or resharded away)."""
        self._flagged.discard(worker)
        self._strikes.pop(worker, None)
        self._latest.pop(worker, None)
        self._ewma.pop(worker, None)

    @property
    def flagged(self) -> List[str]:
        return sorted(self._flagged)


# -------------------------------------------------------------- coordinator
class RestartCoordinator:
    """Failure → rollback → revive, wired to a checkpoint manager.

    ``latest_checkpoint()`` returns the newest durable step (or None);
    ``on_restore(step)`` is the caller's rewind: restore model state from
    that step and reset the data cursor to it.  With the deterministic
    ``batch_at(step)`` data pipeline the replay is bit-exact — the final
    state equals the never-failed run's.
    """

    def __init__(
        self,
        monitor: HeartbeatMonitor,
        stragglers: Optional[StragglerDetector] = None,
        *,
        latest_checkpoint: Callable[[], Optional[int]],
        on_restore: Callable[[int], None],
    ):
        self.monitor = monitor
        self.stragglers = stragglers
        self.latest_checkpoint = latest_checkpoint
        self.on_restore = on_restore
        self.restarts: List[Tuple[Optional[int], Tuple[str, ...], Optional[int]]] = []

    def tick(self, step: Optional[int] = None) -> List[str]:
        """One control-loop iteration; returns the workers acted upon."""
        failed = list(self.monitor.check())
        if self.stragglers is not None:
            # persistent stragglers are treated as failures: restarting one
            # costs a rollback; NOT restarting it costs every future step
            failed += [w for w in self.stragglers.check() if w not in failed]
        if not failed:
            return []
        ckpt = self.latest_checkpoint()
        if ckpt is not None:
            self.on_restore(ckpt)
        self.monitor.revive(failed)
        if self.stragglers is not None:
            for w in failed:
                self.stragglers.clear(w)
        self.restarts.append((step, tuple(failed), ckpt))
        return failed
