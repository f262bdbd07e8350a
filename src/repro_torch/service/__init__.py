"""repro_torch.service — the multi-tenant FaaS pipeline service (paper's setting).

The paper's differential cache pays off because it is *shared*: many data
scientists iterate against the same lakehouse, and one tenant's computed
windows serve every other tenant's overlapping plans.  This package turns
the single-user :class:`~repro_torch.pipeline.executor.Workspace` into that
service:

- :mod:`repro_torch.service.store` — :class:`SharedStore` /
  :class:`SharedScanCache`: process-wide differential stores with the
  scan-executor locking discipline, a global LRU byte budget spanning
  tenants, per-tenant quotas, per-signature reader counts,
  signature-liveness eviction, an optional spill tier (RAM over IPC files
  in the object store — capacity beyond RAM, warm restarts) and in-flight
  residual coalescing (N concurrent identical residuals compute once);
- :mod:`repro_torch.service.session` — :class:`TenantSession`: per-tenant snapshot
  pinning (time travel) and commit-retry for writing runs;
- :mod:`repro_torch.service.scheduler` — :class:`PipelineService`: admission queue
  + worker pool with bounded in-flight runs, per-tenant fairness and a
  :class:`ServiceReport` carrying per-run ledgers and cross-tenant reuse
  counters.
"""

from repro_torch.service.scheduler import (
    DONE,
    FAILED,
    QUEUED,
    RUNNING,
    PipelineService,
    QueueFull,
    RunHandle,
    ServiceReport,
)
from repro_torch.service.session import TenantSession
from repro_torch.service.store import ResidualClaim, SharedScanCache, SharedStore

__all__ = [
    "PipelineService",
    "QueueFull",
    "RunHandle",
    "ServiceReport",
    "TenantSession",
    "SharedScanCache",
    "SharedStore",
    "ResidualClaim",
    "QUEUED",
    "RUNNING",
    "DONE",
    "FAILED",
]
