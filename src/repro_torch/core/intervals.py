"""Exact interval algebra over half-open integer intervals ``[lo, hi)``.

The differential cache reasons about scan *filters* as sets of half-open
intervals over a table's sort key (the paper's ``eventTime BETWEEN a AND b``).
Everything the cache needs — "what part of this scan is already covered?",
"what residual must be fetched from object storage?", "can these two cache
elements be merged?" — reduces to exact set algebra on :class:`IntervalSet`.

Intervals are half-open on ``int`` endpoints (timestamps are represented as
integer microseconds / days upstream), which makes union/difference exact and
keeps adjacency well-defined: ``[a, b) ∪ [b, c) == [a, c)``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence, Tuple

__all__ = ["Interval", "IntervalSet", "EMPTY", "EVERYTHING"]

# Sentinels for unbounded scans ("no filter"): a huge-but-finite range keeps the
# algebra closed without special-casing +/-inf.
NEG_INF = -(2**62)
POS_INF = 2**62


@dataclass(frozen=True, order=True)
class Interval:
    """A half-open interval ``[lo, hi)``; empty iff ``lo >= hi``."""

    lo: int
    hi: int

    def __post_init__(self) -> None:
        if not isinstance(self.lo, int) or not isinstance(self.hi, int):
            raise TypeError(f"Interval endpoints must be int, got {self!r}")

    @property
    def empty(self) -> bool:
        return self.lo >= self.hi

    @property
    def length(self) -> int:
        return max(0, self.hi - self.lo)

    def intersects(self, other: "Interval") -> bool:
        return max(self.lo, other.lo) < min(self.hi, other.hi)

    def touches(self, other: "Interval") -> bool:
        """Overlapping *or* adjacent — mergeable into one interval."""
        return max(self.lo, other.lo) <= min(self.hi, other.hi)

    def contains_point(self, x: int) -> bool:
        return self.lo <= x < self.hi

    def __repr__(self) -> str:  # pragma: no cover - debug sugar
        lo = "-inf" if self.lo <= NEG_INF else str(self.lo)
        hi = "+inf" if self.hi >= POS_INF else str(self.hi)
        return f"[{lo},{hi})"


def _normalize(intervals: Iterable[Interval]) -> Tuple[Interval, ...]:
    """Sort, drop empties, merge overlapping/adjacent intervals."""
    nonempty = sorted(i for i in intervals if not i.empty)
    out: list[Interval] = []
    for iv in nonempty:
        if out and iv.lo <= out[-1].hi:  # overlap or adjacency
            if iv.hi > out[-1].hi:
                out[-1] = Interval(out[-1].lo, iv.hi)
        else:
            out.append(iv)
    return tuple(out)


class IntervalSet:
    """An immutable, normalized union of disjoint half-open intervals.

    Normal form: sorted, pairwise-disjoint, non-adjacent, non-empty intervals.
    Two IntervalSets are equal iff they denote the same point set.
    """

    __slots__ = ("_ivs",)

    def __init__(self, intervals: Iterable[Interval] = ()) -> None:
        object.__setattr__(self, "_ivs", _normalize(intervals))

    # -- constructors ------------------------------------------------------
    @staticmethod
    def of(*pairs: Tuple[int, int]) -> "IntervalSet":
        return IntervalSet(Interval(lo, hi) for lo, hi in pairs)

    @staticmethod
    def point_range(lo: int, hi: int) -> "IntervalSet":
        return IntervalSet([Interval(lo, hi)])

    @staticmethod
    def everything() -> "IntervalSet":
        return IntervalSet([Interval(NEG_INF, POS_INF)])

    @staticmethod
    def empty_set() -> "IntervalSet":
        return IntervalSet()

    # -- basic views -------------------------------------------------------
    @property
    def intervals(self) -> Tuple[Interval, ...]:
        return self._ivs

    @property
    def empty(self) -> bool:
        return not self._ivs

    def measure(self) -> int:
        """Total length — the cache's proxy for "how many rows" a window holds
        (exact when the sort key is dense, an upper bound otherwise)."""
        return sum(iv.length for iv in self._ivs)

    def span(self) -> Interval:
        if not self._ivs:
            return Interval(0, 0)
        return Interval(self._ivs[0].lo, self._ivs[-1].hi)

    def __iter__(self) -> Iterator[Interval]:
        return iter(self._ivs)

    def __len__(self) -> int:
        return len(self._ivs)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, IntervalSet) and self._ivs == other._ivs

    def __hash__(self) -> int:
        return hash(self._ivs)

    def __repr__(self) -> str:  # pragma: no cover - debug sugar
        return "{" + ", ".join(map(repr, self._ivs)) + "}"

    # -- set algebra -------------------------------------------------------
    def union(self, other: "IntervalSet") -> "IntervalSet":
        return IntervalSet(self._ivs + other._ivs)

    def intersect(self, other: "IntervalSet") -> "IntervalSet":
        out: list[Interval] = []
        a, b = self._ivs, other._ivs
        i = j = 0
        while i < len(a) and j < len(b):
            lo = max(a[i].lo, b[j].lo)
            hi = min(a[i].hi, b[j].hi)
            if lo < hi:
                out.append(Interval(lo, hi))
            if a[i].hi < b[j].hi:
                i += 1
            else:
                j += 1
        return IntervalSet(out)

    def difference(self, other: "IntervalSet") -> "IntervalSet":
        """Exact ``self \\ other`` — the *residual scan* operator (Listing 3's
        ``(scan_filter) AND NOT (e.filter)``)."""
        out: list[Interval] = []
        j = 0
        b = other._ivs
        for iv in self._ivs:
            lo = iv.lo
            # advance past b-intervals entirely left of iv
            while j < len(b) and b[j].hi <= lo:
                j += 1
            k = j
            while k < len(b) and b[k].lo < iv.hi:
                if b[k].lo > lo:
                    out.append(Interval(lo, b[k].lo))
                lo = max(lo, b[k].hi)
                if lo >= iv.hi:
                    break
                k += 1
            if lo < iv.hi:
                out.append(Interval(lo, iv.hi))
        return IntervalSet(out)

    def intersects(self, other: "IntervalSet") -> bool:
        """True iff the two sets share any point — the boolean fast path the
        differential planners use for pin/window overlap checks (no
        intermediate IntervalSet is built)."""
        a, b = self._ivs, other._ivs
        i = j = 0
        while i < len(a) and j < len(b):
            if max(a[i].lo, b[j].lo) < min(a[i].hi, b[j].hi):
                return True
            if a[i].hi < b[j].hi:
                i += 1
            else:
                j += 1
        return False

    def covers(self, other: "IntervalSet") -> bool:
        return other.difference(self).empty

    def contains_point(self, x: int) -> bool:
        idx = bisect.bisect_right([iv.lo for iv in self._ivs], x) - 1
        return idx >= 0 and self._ivs[idx].contains_point(x)

    # -- convenience -------------------------------------------------------
    __or__ = union
    __and__ = intersect
    __sub__ = difference

    def to_pairs(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((iv.lo, iv.hi) for iv in self._ivs)

    @staticmethod
    def from_pairs(pairs: Sequence[Tuple[int, int]]) -> "IntervalSet":
        return IntervalSet.of(*pairs)


EMPTY = IntervalSet.empty_set()
EVERYTHING = IntervalSet.everything()
