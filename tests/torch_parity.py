"""Parity harness for the PyTorch port: one seeded catalog history replayed
into twin lakes, one reference (jax) and one port (torch) workspace or
pipeline service, and a run-by-run comparison of outputs (bitwise) and
ledgers (equal).

The reference's device tier runs its Pallas kernel in interpret mode; the
port's runs on the CPU, where its gathers take the kernel's plain version.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from benchmarks.workloads import write_events as ref_write_events
from chip_smoke import write_events as port_write_events
from repro.core.columnar import Table as RefTable
from repro.core.device import DeviceTier as RefTier
from repro.pipeline.executor import Workspace as RefWorkspace
from repro.service import PipelineService as RefService
from repro_torch.core.columnar import Table as PortTable
from repro_torch.core.device import DeviceTier as PortTier
from repro_torch.pipeline.executor import Workspace as PortWorkspace
from repro_torch.service import PipelineService as PortService

__all__ = [
    "LEDGER_KEYS",
    "SERVICE_KEYS",
    "TwinLakes",
    "TwinServices",
    "assert_same_bits",
    "assert_tables_bitwise",
    "ledger",
    "reduced_pair",
    "to_numpy",
    "to_torch",
]

# the per-run device ledger the port must reproduce exactly
LEDGER_KEYS = (
    "bytes_h2d",
    "bytes_d2h",
    "device_hits",
    "gather_fast",
    "gather_fallbacks",
    "device_union_bytes",
    "rows_to_user_fns",
)


# the per-run store ledger of a service run (BENCH_4's columns)
SERVICE_KEYS = (
    "bytes_from_store",
    "rows_to_user_fns",
    "bytes_from_model_cache",
    "bytes_from_cache",
)


def assert_same_bits(a, b, what: str = "") -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bits differ"


def assert_tables_bitwise(ref, port, what: str = "") -> None:
    assert ref.column_names == port.column_names, what
    for c in ref.column_names:
        assert_same_bits(ref.column(c), port.column(c), f"{what}:{c}")


def ledger(res) -> Dict[str, int]:
    return {k: int(getattr(res, k)) for k in LEDGER_KEYS}


class TwinLakes:
    """A reference and a port workspace over two lakes with one history.

    ``device=True`` gives each its device tier (reference: interpret mode;
    port: the CPU).  ``replay`` applies one history step to both catalogs
    with the package's own ``Table``; ``run`` runs a project pair and
    asserts bitwise-equal outputs and equal ledgers."""

    def __init__(self, root: str, *, rows_per_fragment: int, device: bool = True):
        self.ref = RefWorkspace(
            os.path.join(root, "ref"),
            rows_per_fragment=rows_per_fragment,
            device=RefTier(interpret=True) if device else None,
        )
        self.port = PortWorkspace(
            os.path.join(root, "port"),
            rows_per_fragment=rows_per_fragment,
            device=PortTier(device="cpu") if device else None,
            torch_device="cpu",
        )

    def replay(self, step: Callable) -> None:
        """``step(catalog, table_cls)`` on both lakes."""
        step(self.ref.catalog, RefTable)
        step(self.port.catalog, PortTable)

    def write_events(self, rows: int, seed: int = 0, lo: int = 0) -> None:
        """The events writer of each side (same seeded draws)."""
        ref_write_events(self.ref.catalog, rows, seed=seed, lo=lo)
        port_write_events(self.port.catalog, rows, seed=seed, lo=lo)

    def run(self, ref_project, port_project, what: str = "", **kw) -> Tuple:
        rres = self.ref.run(ref_project, **kw)
        pres = self.port.run(port_project, **kw)
        assert set(rres.outputs) == set(pres.outputs), what
        for name in rres.outputs:
            assert_tables_bitwise(rres.outputs[name], pres.outputs[name], f"{what}:{name}")
        assert ledger(pres) == ledger(rres), what
        return rres, pres


class TwinServices:
    """A reference and a port ``PipelineService`` over two lakes with one
    history; the port runs its torch nodes on the CPU.

    ``tiers=True`` attaches one device tier to both shared stores of each
    service before the first session (reference: interpret mode; port: the
    CPU).  ``run`` runs a project pair through one tenant's session on each
    side and asserts bitwise-equal outputs and equal store and device
    ledgers.  Use as a context manager."""

    def __init__(self, root: str, *, rows_per_fragment: int, tiers: bool = False, **kw):
        self.ref = RefService(
            os.path.join(root, "ref"), rows_per_fragment=rows_per_fragment, **kw
        )
        self.port = PortService(
            os.path.join(root, "port"), rows_per_fragment=rows_per_fragment,
            torch_device="cpu", **kw,
        )
        if tiers:
            for svc, tier in ((self.ref, RefTier(interpret=True)), (self.port, PortTier(device="cpu"))):
                svc.scan_cache.device = svc.model_store.device = tier

    def write_events(self, rows: int, seed: int = 0, lo: int = 0) -> None:
        ref_write_events(self.ref.catalog, rows, seed=seed, lo=lo)
        port_write_events(self.port.catalog, rows, seed=seed, lo=lo)

    def run(self, tenant: str, ref_project, port_project, what: str = "") -> Tuple:
        rres = self.ref.session(tenant).run(ref_project)
        pres = self.port.session(tenant).run(port_project)
        assert set(rres.outputs) == set(pres.outputs), what
        for name in rres.outputs:
            assert_tables_bitwise(rres.outputs[name], pres.outputs[name], f"{what}:{name}")
        keys = LEDGER_KEYS + SERVICE_KEYS
        assert {k: int(getattr(pres, k)) for k in keys} == {
            k: int(getattr(rres, k)) for k in keys
        }, what
        return rres, pres

    def shutdown(self) -> None:
        self.ref.shutdown()
        self.port.shutdown()

    def __enter__(self) -> "TwinServices":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ------------------------------------------------------------------ models
def to_numpy(x) -> np.ndarray:
    """A torch tensor (floats as f32) or a jax array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def reduced_pair(arch_id: str, seed: int = 0):
    """(reference config, reference params, port config, port params) of one
    reduced arch: the reference's own weights from ``PRNGKey(seed)``,
    carried over to the port on the CPU by ``params_from_reference``."""
    import jax

    from repro.models.registry import get_config as ref_get_config
    from repro.models.registry import get_model as ref_get_model
    from repro_torch.models import get_config, params_from_reference

    rcfg = ref_get_config(arch_id).reduced()
    rparams = ref_get_model(rcfg).init_params(jax.random.PRNGKey(seed))
    cfg = get_config(arch_id).reduced()
    return rcfg, rparams, cfg, params_from_reference(cfg, jax.tree.map(np.asarray, rparams), "cpu")
