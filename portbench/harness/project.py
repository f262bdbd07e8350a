"""The data scientist's pipeline that the edit scripts change: chip_smoke's
``iteration_project`` (BENCH_4's four stages) over the trips table.

cleaned (numpy, drops trips with no miles or no positive fare) -> enriched
(numpy, adds fare per mile and miles per hour) -> feats (torch, through the
device tier; halves negative values) -> final (numpy, a gain-scaled score).
An edit chooses the key windows, the columns read and the gain; the
columns hold at least ``trip_miles``, ``trip_time`` and
``base_passenger_fare``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def where_of(key: str, windows: Sequence[Tuple[int, int]]) -> str:
    return " OR ".join(f"({key} >= {lo} AND {key} < {hi})" for lo, hi in windows)


def trips_project(table: str, key: str, windows: Sequence[Tuple[int, int]],
                  columns: Sequence[str], gain: float = 1.0):
    import torch
    from repro_torch.pipeline.dsl import Model, Project, model, runtime

    p = Project("trips")
    cols = list(columns)
    where = where_of(key, windows)

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def cleaned(data=Model(table, columns=cols, filter=where)):
        keep = (data.column("trip_miles") > 0) & (data.column("base_passenger_fare") > 0)
        return data.filter(keep)

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def enriched(data=Model("cleaned")):
        out = {n: data.column(n) for n in data.column_names}
        miles = data.column("trip_miles")
        out["fare_per_mile"] = data.column("base_passenger_fare") / miles
        out["mph"] = miles * 3600.0 / np.maximum(data.column("trip_time"), 1)
        return out

    @model(project=p, incremental="rowwise")
    @runtime("torch")
    def feats(data=Model("enriched")):
        return {
            k: (torch.where(v >= 0, v, v * 0.5) if v.is_floating_point() else v)
            for k, v in data.items()
        }

    @model(project=p, incremental="rowwise")
    @runtime("numpy")
    def final(data=Model("feats")):
        out = {n: data.column(n) for n in data.column_names}
        out["score"] = gain * np.asarray(data.column("fare_per_mile"), dtype=np.float64)
        return out

    return p
