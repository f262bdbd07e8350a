"""Lakehouse substrate: simulated object storage, immutable columnar
fragments (the Parquet analogue), and an Iceberg-style catalog with
snapshot isolation and atomic commits."""

from repro_torch.lake.s3sim import ObjectStore, StoreStats, LatencyModel, TransientStoreError
from repro_torch.lake.faults import (
    FaultPlan,
    FaultyObjectStore,
    InjectedCrash,
    RetryPolicy,
)
from repro_torch.lake.fragments import FragmentMeta, write_fragment, read_fragment_columns
from repro_torch.lake.catalog import Catalog, TableMeta, Snapshot

__all__ = [
    "ObjectStore",
    "StoreStats",
    "LatencyModel",
    "TransientStoreError",
    "FaultPlan",
    "FaultyObjectStore",
    "InjectedCrash",
    "RetryPolicy",
    "FragmentMeta",
    "write_fragment",
    "read_fragment_columns",
    "Catalog",
    "TableMeta",
    "Snapshot",
]
