"""Plain NumPy recomputation of one edit of the trips pipeline.

From the generated table alone: the rows inside the edit's key windows,
cleaned, enriched, narrowed to 32 bits as the torch node's inputs are
(float64 -> float32, int64 -> int32, the sort key kept whole), halved where
negative, and scored.  It imports nothing of the program.

``precision`` is the control: ``"float16"`` computes ``feats`` one
precision below the float32 the node states, which must fail the
comparison.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def expected(raw: Dict[str, np.ndarray], key: str, windows: Sequence[Tuple[int, int]],
             columns: Sequence[str], gain: float,
             precision: str = "float32") -> Dict[str, Dict[str, np.ndarray]]:
    """``{"feats": {column: values}, "final": {column: values}}``."""
    keys = raw[key]
    mask = np.zeros(keys.shape[0], bool)
    for lo, hi in windows:
        mask |= (keys >= lo) & (keys < hi)
    mask &= (raw["trip_miles"] > 0) & (raw["base_passenger_fare"] > 0)
    rows = {c: raw[c][mask] for c in list(columns) + [key]}
    rows["fare_per_mile"] = rows["base_passenger_fare"] / rows["trip_miles"]
    rows["mph"] = rows["trip_miles"] * 3600.0 / np.maximum(rows["trip_time"], 1)
    feats = {}
    for c, v in rows.items():
        if c != key:
            v = v.astype(_NARROW.get(v.dtype, v.dtype))
        if v.dtype.kind == "f":
            stated = v.dtype
            if precision == "float16":
                v = v.astype(np.float16)
            v = np.where(v >= 0, v, v * v.dtype.type(0.5)).astype(stated)
        feats[c] = v
    final = dict(feats)
    final["score"] = gain * np.asarray(feats["fare_per_mile"], dtype=np.float64)
    return {"feats": feats, "final": final}


def mismatches(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> int:
    """Values that differ bitwise; a missing or extra column, or one of
    another dtype or length, counts every value of it."""
    bad = 0
    for c in set(got) | set(want):
        if c not in got or c not in want:
            bad += len(got.get(c, want.get(c)))
            continue
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if g.dtype != w.dtype or g.shape != w.shape:
            bad += max(g.size, w.size)
            continue
        gb = g.view(np.uint8).reshape(g.size, -1) if g.size else g
        wb = w.view(np.uint8).reshape(w.size, -1) if w.size else w
        bad += int(np.count_nonzero((gb != wb).any(axis=1))) if g.size else 0
    return bad
