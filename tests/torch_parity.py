"""Parity harness for the PyTorch port: one seeded catalog history replayed
into twin lakes, one reference (jax) and one port (torch) workspace, and a
run-by-run comparison of outputs (bitwise) and ledgers (equal).

The reference's device tier runs its Pallas kernel in interpret mode; the
port's runs on the CPU, where its gathers take the kernel's plain version.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np

from benchmarks.workloads import write_events as ref_write_events
from chip_smoke import write_events as port_write_events
from repro.core.columnar import Table as RefTable
from repro.core.device import DeviceTier as RefTier
from repro.pipeline.executor import Workspace as RefWorkspace
from repro_torch.core.columnar import Table as PortTable
from repro_torch.core.device import DeviceTier as PortTier
from repro_torch.pipeline.executor import Workspace as PortWorkspace

__all__ = [
    "LEDGER_KEYS",
    "TwinLakes",
    "assert_same_bits",
    "assert_tables_bitwise",
    "ledger",
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
