"""The paper's primary contribution: declarative scan abstractions and the
differential columnar cache (FaaS and Furious, §II–§III), plus the scan
planner/executor that realizes logical dataframes from object storage.
"""

from repro_torch.core.intervals import Interval, IntervalSet
from repro_torch.core.columnar import ChunkedTable, Table, concat_tables, read_ipc, write_ipc
from repro_torch.core.scan import Scan, fragments_overlapping, read_window, scan_cost_bytes
from repro_torch.core.cache import CacheElement, CachePlan, DifferentialCache, DifferentialStore
from repro_torch.core.spill import SpillTier
from repro_torch.core.baselines import NoCache, ScanCache
from repro_torch.core.planner import ResultCachingExecutor, ScanExecutor, ScanReport

__all__ = [
    "Interval",
    "IntervalSet",
    "Table",
    "ChunkedTable",
    "concat_tables",
    "read_ipc",
    "write_ipc",
    "Scan",
    "fragments_overlapping",
    "read_window",
    "scan_cost_bytes",
    "CacheElement",
    "CachePlan",
    "DifferentialCache",
    "DifferentialStore",
    "SpillTier",
    "ScanCache",
    "NoCache",
    "ScanExecutor",
    "ResultCachingExecutor",
    "ScanReport",
]
