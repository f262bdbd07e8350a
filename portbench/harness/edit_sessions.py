"""Traffic kind ``edit_sessions``: one data scientist's closed loop of edits.

Set-up draws the configuration's table from the seed, writes it into a
lake, and runs the traffic's script once, which builds the kernel and
warms every shape the window uses.  The window then runs whole sessions
back to back, each from a fresh ``Workspace`` over the same lake (an
empty cache and an empty device tier), until ``seconds`` have
passed; the session under way at that moment is finished.  Every session
runs the same script, so what each asks of the store does not depend on
the seed or on how fast the program is.

Correctness: the window keeps the outputs of every edit of its first
session and of one edit of every later session, drawn from the seed, and
compares none of them.  Once it has closed, the first session's are
compared bitwise with the plain NumPy recomputation, and each later
session's with the first session's outputs of that edit.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Any, Callable, Dict

import numpy as np

from portbench.harness import devices, lake, project, yardstick
from portbench.harness.record import Check, Run
from portbench.harness.trace import DeviceTrace, HostSpans, program_spans

KEPT = ("feats", "final")


def windows_of(config, days):
    return [(lake.key_of_day(config, lo), lake.key_of_day(config, hi)) for lo, hi in days]


def outputs_of(res) -> Dict[str, Dict[str, np.ndarray]]:
    """The host columns of the outputs the check reads, as the run returned
    them (references, not copies: a table's columns are read-only)."""
    return {name: {c: np.asarray(res.outputs[name].column(c)) for c in res.outputs[name].column_names}
            for name in KEPT}


class UnionCounter:
    """Counts, while active, the ``device_union`` calls that copy and the
    bytes they must move; every caller looks the function up in its module
    when it calls it."""

    def __init__(self) -> None:
        self.calls = 0
        self.bytes = 0

    def __enter__(self):
        from repro_torch.core import device

        self._module, self._inner = device, device.device_union

        def counted(runs, columns, **kw):
            if yardstick.copying(runs):
                self.calls += 1
                self.bytes += yardstick.union_bytes(runs, columns)
            return self._inner(runs, columns, **kw)

        device.device_union = counted
        return self

    def __exit__(self, *exc) -> None:
        self._module.device_union = self._inner


def run(config: Dict[str, Any], traffic: Dict[str, Any], seed: int, seconds: float,
        trace: bool, workdir: str, device: str, clock0: float) -> Run:
    import torch
    from repro_torch.core.device import DeviceTier
    from repro_torch.core.columnar import Table
    from repro_torch.kernels.fragment_gather import kernel
    from repro_torch.obs.trace import Tracer
    from repro_torch.pipeline.executor import Workspace

    from portbench.reference.fhvhv_iterate import expected, mismatches

    cuda = torch.device(device).type == "cuda"
    sync: Callable[[], None] = torch.cuda.synchronize if cuda else (lambda: None)
    rows, frag = int(config["rows"]), int(config["rows_per_fragment"])
    key, table = config["sort_key"], config["table"]
    script = traffic["script"]
    out = Run("edit_sessions", config, traffic)

    # -- set-up: the lake, then the script run whole to warm every shape
    raw = lake.table(config, seed, rows)
    root = os.path.join(workdir, "lake")
    writer = Workspace(root, rows_per_fragment=frag, torch_device=device)
    ns, name = table.rsplit(".", 1)
    writer.catalog.create_table(ns, name, lake.schema(config), key)
    writer.catalog.append(table, Table(raw))
    del writer
    columns = lambda edit: list(traffic["base_columns"]) + list(edit["columns"])
    raw = {c: v for c, v in raw.items() if c == key or any(c in columns(e) for e in script)}
    tracer = Tracer()
    tier_bytes = config.get("device_tier", {}).get("max_bytes")

    def session(index: int, keep, stats=None) -> Dict[int, Dict[str, Any]]:
        """One session of the script; the outputs of the edits in ``keep``,
        by edit."""
        ws = Workspace(root, rows_per_fragment=frag,
                       device=DeviceTier(max_bytes=tier_bytes, device=device), tracer=tracer)
        kept = {}
        for e, edit in enumerate(script):
            proj = project.trips_project(table, key, windows_of(config, edit["days"]),
                                         columns(edit), edit["gain"])
            before = ws.store.stats.snapshot()
            t = time.perf_counter()
            with spans.span(f"edit:{edit['label']}"):
                res = ws.run(proj)
                sync()
            wall = time.perf_counter() - t
            d = ws.store.stats.delta(before)
            if stats is not None:
                stats.append({"session": index, "label": edit["label"], "wall_s": wall,
                              "gets": d.get_requests, "bytes_read": d.bytes_read,
                              "bytes_from_cache": int(res.bytes_from_cache),
                              "bytes_from_model_cache": int(res.bytes_from_model_cache),
                              "bytes_from_store": int(res.bytes_from_store)})
            if e in keep:
                kept[e] = outputs_of(res)
            del res
        del ws
        gc.collect()
        return kept

    spans = HostSpans()
    session(-1, keep=())
    sync()
    out.setup_s = time.perf_counter() - clock0

    # -- the window
    rng = np.random.default_rng([seed, 1])
    launches0 = kernel.launches
    prof = DeviceTrace() if trace else None
    tracer.clear()
    spans.spans.clear()
    with UnionCounter() as unions:
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        first = session(0, keep=range(len(script)), stats=out.edits)
        later = []
        while time.perf_counter() - t0 < seconds:
            later.append(session(len(later) + 1, keep=(int(rng.integers(len(script))),),
                                 stats=out.edits))
        out.window_s = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
    out.store_gets = sum(e["gets"] for e in out.edits)
    out.store_bytes = sum(e["bytes_read"] for e in out.edits)
    out.union_launches = kernel.launches - launches0
    out.union_bytes = unions.bytes
    if unions.calls != out.union_launches and cuda:
        out.notes.append(("union_calls_without_one_launch", unions.calls - out.union_launches))
    if prof is not None:
        out.trace = prof.summary(program_spans(tracer.roots()) + spans.spans)
    out.attempted = len(out.edits)
    out.device = devices.describe(1, torch.device(device).type)

    # -- correctness, once the window has closed
    worst = bad_sessions = bad_first = 0
    for kept in later:
        m = sum(mismatches(got[n], first[e][n]) for e, got in kept.items() for n in KEPT)
        bad_sessions += m > 0
        worst += m
    del later
    for e, edit in enumerate(script):
        want = expected(raw, key, windows_of(config, edit["days"]), columns(edit), edit["gain"])
        m = sum(mismatches(first[e][n], want[n]) for n in KEPT)
        bad_first += m > 0
        worst += m
    out.failed = bad_first + bad_sessions
    out.checks.append(Check("mismatched_values", float(worst), 0.0))
    return out
