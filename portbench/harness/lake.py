"""A table of a lakehouse configuration, drawn from the seed.

The configuration's ``columns`` give each column's name, dtype and how its
values are drawn (``gen``).  Each column draws from a generator of its own,
seeded by ``(seed, column index)``, so the seed makes every value and
nothing else: row counts, key values and byte sizes do not depend on it.
The sort key lies on an even grid over the configuration's month, so a
window of days always covers the same rows.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

US_PER_DAY = 86_400 * 1_000_000


def key_of_day(config: Mapping[str, Any], day: float) -> int:
    """The sort-key value (microseconds) at ``day`` days into the month."""
    return int(config["month_start_us"] + round(day * US_PER_DAY))


def key_grid(config: Mapping[str, Any], rows: int) -> np.ndarray:
    """``start + floor(i * span / rows)`` for each row ``i``, computed as
    ``i * step + floor(i * rest / rows)`` so that no product overflows
    64 bits (``i * span`` would past 3.4 million rows)."""
    step, rest = divmod(config["month_days"] * US_PER_DAY, rows)
    i = np.arange(rows, dtype=np.int64)
    return config["month_start_us"] + i * step + (i * rest) // rows


def _cents(x: np.ndarray) -> np.ndarray:
    return np.round(x, 2)


def _draw(gen: Mapping[str, Any], rng: np.random.Generator, rows: int,
          cols: Dict[str, np.ndarray], config: Mapping[str, Any]) -> np.ndarray:
    kind = gen["kind"]
    if kind == "key_grid":
        return key_grid(config, rows)
    if kind == "choice":
        return rng.choice(np.asarray(gen["values"]), size=rows, p=gen["p"])
    if kind == "uniform_int":
        return rng.integers(gen["lo"], gen["hi"], rows)
    if kind == "before_key_us":
        return cols[config["sort_key"]] - rng.integers(gen["lo_s"], gen["hi_s"] + 1, rows) * 1_000_000
    if kind == "after_key_by_seconds":
        return cols[config["sort_key"]] + cols[gen["of"]] * 1_000_000
    if kind == "lognormal":
        x = _cents(rng.lognormal(gen["mean"], gen["sigma"], rows))
        return np.where(rng.random(rows) < gen["zero_share"], 0.0, x)
    if kind == "seconds_per_mile":
        return np.round(cols[gen["of"]] * rng.uniform(gen["lo"], gen["hi"], rows)).astype(np.int64) + gen["add"]
    if kind == "fare":
        x = _cents(gen["base"] + gen["per_mile"] * cols[gen["miles"]]
                   + gen["per_minute"] * cols[gen["seconds"]] / 60.0)
        return np.where(rng.random(rows) < gen["negative_share"], -x, x)
    if kind == "share_of":
        return _cents(np.maximum(cols[gen["of"]], 0.0) * gen["share"])
    if kind == "uniform_share_of":
        return _cents(np.maximum(cols[gen["of"]], 0.0) * rng.uniform(gen["lo"], gen["hi"], rows))
    if kind == "exponential":
        x = _cents(rng.exponential(gen["scale"], rows))
        return np.where(rng.random(rows) < gen["zero_share"], 0.0, x)
    raise ValueError(f"unknown column generator {kind!r}")


def table(config: Mapping[str, Any], seed: int, rows: int) -> Dict[str, np.ndarray]:
    """Every column of the configuration's table, ``rows`` rows, in schema
    order."""
    specs = config["columns"]
    cols: Dict[str, np.ndarray] = {}
    pending = list(enumerate(specs))
    while pending:
        left = []
        for i, spec in pending:
            gen = spec["gen"]
            needs = [gen[k] for k in ("of", "miles", "seconds") if k in gen]
            if gen["kind"] in ("before_key_us", "after_key_by_seconds"):
                needs.append(config["sort_key"])
            if any(n not in cols for n in needs):
                left.append((i, spec))
                continue
            rng = np.random.default_rng([seed, i])
            cols[spec["name"]] = _draw(gen, rng, rows, cols, config).astype(np.dtype(spec["dtype"]))
        if len(left) == len(pending):
            raise ValueError("column generators depend on each other in a cycle")
        pending = left
    return {s["name"]: cols[s["name"]] for s in specs}


def schema(config: Mapping[str, Any]) -> Dict[str, str]:
    return {s["name"]: s["dtype"] for s in config["columns"]}
